"""Hand-written CUDA kernels for the two SetConvs on the serving path.

Counterpart of ``deepsensornz_tpu/ops/setconv_pallas.py``:

- :func:`encode_offgrid` (``csrc/setconv_encode.cu``) scatters a ragged
  point set onto the internal grid;
- :func:`decode_grid` (``csrc/setconv_decode.cu``) interpolates the U-Net
  output onto a regular target grid.

The device decides, not a flag: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version from :mod:`.setconv`.
There is no fallback from one to the other. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` so a run can show which path it took.

The kernels are forward only: a call that autograd would have to
differentiate raises. They run on the current CUDA stream, allocate
nothing themselves (the wrapper allocates the output) and do not
synchronise.
"""

from __future__ import annotations

import torch

from deepsensornz_tpu_torch.ops import setconv as plain

MAX_ENCODE_CHANNELS = 8  # density + values; the kernel's widest instantiation


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError("the SetConv CUDA kernels are forward only; run under "
                           "torch.no_grad() or torch.inference_mode()")


def _lengthscale(ls, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(ls, dtype=torch.float32, device=device).reshape(1)


def _launch(fn, *args, device: torch.device) -> None:
    from deepsensornz_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.setconv_error_string(rc).decode()})")


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"SetConv kernels run on CPU or CUDA tensors, got {t.device}")
    return t.device.type


def encode_offgrid(x1g, x2g, x, y, mask, lengthscale) -> torch.Tensor:
    """Point-set SetConv encode: x1g (H,), x2g (W,), x (B, N, 2),
    y (B, N, C), mask (B, N) → (B, H, W, C+1), density channel first.
    Same contract as :func:`.setconv.setconv_encode_offgrid`."""
    if _device_of(x) == "cpu":
        return plain.setconv_encode_offgrid(x1g, x2g, x, y, mask, lengthscale)
    _forward_only(x1g, x2g, x, y, mask, lengthscale)
    dev = x.device
    B, N, C = y.shape
    H, W = x1g.shape[0], x2g.shape[0]
    if C + 1 > MAX_ENCODE_CHANNELS:
        raise ValueError(f"encode kernel takes at most {MAX_ENCODE_CHANNELS - 1} "
                         f"value channels, got {C}")
    for name, t, shape in (("x1g", x1g, (H,)), ("x2g", x2g, (W,)), ("x", x, (B, N, 2)),
                           ("y", y, (B, N, C)), ("mask", mask, (B, N))):
        _check(name, t, shape, dev)
    out = torch.empty((B, H, W, C + 1), dtype=torch.float32, device=dev)
    if N == 0:  # empty point set: zero density, zero values
        return out.zero_()
    ls = _lengthscale(lengthscale, dev)
    _launch("setconv_encode_offgrid", x1g.data_ptr(), x2g.data_ptr(), x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), ls.data_ptr(), out.data_ptr(),
            B, N, H, W, C + 1, device=dev)
    encode_offgrid.launches += 1
    return out


encode_offgrid.launches = 0


def decode_grid(x1g, x2g, f, xt1, xt2, lengthscale, normalize: bool = True) -> torch.Tensor:
    """Gridded SetConv decode: f (B, H, W, C) on the internal grid
    x1g (H,) × x2g (W,) → (B, Ht, Wt, C) on xt1 (Ht,) × xt2 (Wt,).
    Same contract as :func:`.setconv.setconv_decode_grid`."""
    if _device_of(f) == "cpu":
        return plain.setconv_decode_grid(x1g, x2g, f, xt1, xt2, lengthscale, normalize)
    _forward_only(x1g, x2g, f, xt1, xt2, lengthscale)
    dev = f.device
    B, H, W, C = f.shape
    Ht, Wt = xt1.shape[0], xt2.shape[0]
    for name, t, shape in (("x1g", x1g, (H,)), ("x2g", x2g, (W,)), ("f", f, (B, H, W, C)),
                           ("xt1", xt1, (Ht,)), ("xt2", xt2, (Wt,))):
        _check(name, t, shape, dev)
    # the RBF weights and their sums are built here, as the Pallas wrapper
    # builds them in XLA; the contractions and the epilogue are the kernel's
    A = plain.rbf(xt1[:, None], x1g[None, :], lengthscale).contiguous()   # (Ht, H)
    Bm = plain.rbf(x2g[:, None], xt2[None, :], lengthscale).contiguous()  # (W, Wt)
    sA = A.sum(-1) if normalize else None
    sB = Bm.sum(0) if normalize else None
    out = torch.empty((B, Ht, Wt, C), dtype=torch.float32, device=dev)
    _launch("setconv_decode_grid", A.data_ptr(), Bm.data_ptr(), f.data_ptr(),
            None if sA is None else sA.data_ptr(), None if sB is None else sB.data_ptr(),
            out.data_ptr(), B, H, W, C, Ht, Wt, device=dev)
    decode_grid.launches += 1
    return out


decode_grid.launches = 0

KERNELS = (encode_offgrid, decode_grid)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
