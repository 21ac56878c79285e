"""Hand-written CUDA kernels for the SetConvs on the serving and training paths.

Counterpart of ``deepsensornz_tpu/ops/setconv_pallas.py``:

- :func:`encode_offgrid` (``csrc/setconv_encode.cu``) scatters a ragged
  point set onto the internal grid;
- :func:`encode_offgrid_grad` (``csrc/setconv_encode_grad.cu``) is its
  gradient with respect to the length-scale, the encode's backward when
  the model trains;
- :func:`decode_grid` (``csrc/setconv_decode.cu``) interpolates the U-Net
  output onto a regular target grid.

The device decides, not a flag: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version from :mod:`.setconv`.
There is no fallback from one to the other. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` so a run can show which path it took.

The encode is differentiable in its length-scale only (the parameter the
model learns through it); the gridded decode is forward only, since no
training path runs it. A call that autograd would have to differentiate
otherwise raises. The kernels run on the current CUDA stream, allocate
nothing themselves (the wrapper allocates outputs, partial sums and the
gradient's ticket counter) and do not synchronise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepsensornz_tpu_torch.ops import setconv as plain

# csrc/setconv_encode_grad.cu: grid rows and columns per block (one partial
# sum each)
GRAD_TILE = 32
# the gradient kernel's culling radius in units of ℓ: exp(-GRAD_REACH²/2)
# rounds to 0 in f32 (denormals kept), so a point farther than
# GRAD_REACH·ℓ from a tile in either coordinate adds exactly 0 there
GRAD_REACH = 14.5
# csrc/setconv_decode.cu: target rows per block, source rows per k-block and
# source columns per chunk (all 64); target-column tiles of 8 per block
DECODE_BLOCK = 64
DECODE_MAX_TILES = 11


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
        raise RuntimeError("this SetConv CUDA kernel is forward only; run it under "
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


def _check_points(x1g, x2g, x, y, mask) -> tuple[int, int, int, int, int]:
    B, N, C = y.shape
    H, W = x1g.shape[0], x2g.shape[0]
    for name, t, shape in (("x1g", x1g, (H,)), ("x2g", x2g, (W,)), ("x", x, (B, N, 2)),
                           ("y", y, (B, N, C)), ("mask", mask, (B, N))):
        _check(name, t, shape, x.device)
    return B, N, C, H, W


def _encode(x1g, x2g, x, y, mask, lengthscale) -> torch.Tensor:
    """The forward without autograd: the plain version on the CPU, the
    kernel on a CUDA device."""
    if _device_of(x) == "cpu":
        return plain.setconv_encode_offgrid(x1g, x2g, x, y, mask, lengthscale)
    dev = x.device
    B, N, C, H, W = _check_points(x1g, x2g, x, y, mask)
    out = torch.empty((B, H, W, C + 1), dtype=torch.float32, device=dev)
    if N == 0:  # empty point set: zero density, zero values
        return out.zero_()
    ls = _lengthscale(lengthscale, dev)
    _launch("setconv_encode_offgrid", x1g.data_ptr(), x2g.data_ptr(), x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), ls.data_ptr(), out.data_ptr(),
            B, N, H, W, C + 1, device=dev)
    encode_offgrid.launches += 1
    return out


class _EncodeOffgrid(torch.autograd.Function):
    """The encode with a gradient for the length-scale: the forward kernel,
    and :func:`encode_offgrid_grad` as the backward."""

    @staticmethod
    def forward(ctx, x1g, x2g, x, y, mask, lengthscale):
        out = _encode(x1g, x2g, x, y, mask, lengthscale)
        ctx.save_for_backward(x1g, x2g, x, y, mask, lengthscale, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x1g, x2g, x, y, mask, ls, out = ctx.saved_tensors
        # the model's upstream is a channel slice of the encodes'
        # concatenation, read in place; any other layout (the expanded
        # gradient of a sum, an NCHW-contiguous one) is copied first
        if grad_out.is_cuda and _cell_stride(grad_out) is None:
            grad_out = grad_out.contiguous()
        g = encode_offgrid_grad(x1g, x2g, x, y, mask, ls, grad_out, out)
        return None, None, None, None, None, g.to(ls.dtype).reshape(ls.shape)


def encode_offgrid(x1g, x2g, x, y, mask, lengthscale) -> torch.Tensor:
    """Point-set SetConv encode: x1g (H,), x2g (W,), x (B, N, 2),
    y (B, N, C), mask (B, N) → (B, H, W, C+1), density channel first.
    Same contract as :func:`.setconv.setconv_encode_offgrid`.

    Differentiable in the length-scale only, on either device: a
    ``lengthscale`` tensor that requires grad makes the backward run
    :func:`encode_offgrid_grad`; any other input that requires grad
    raises."""
    _device_of(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1g, x2g, x, y, mask)):
        raise RuntimeError("the SetConv encode differentiates the length-scale only; "
                           "x1g, x2g, x, y and mask must not require grad")
    if torch.is_grad_enabled() and isinstance(lengthscale, torch.Tensor) \
            and lengthscale.requires_grad:
        return _EncodeOffgrid.apply(x1g, x2g, x, y, mask, lengthscale)
    return _encode(x1g, x2g, x, y, mask, lengthscale)


encode_offgrid.launches = 0


def encode_offgrid_grad(x1g, x2g, x, y, mask, lengthscale, grad_out, out) -> torch.Tensor:
    """dL/dℓ of :func:`encode_offgrid` given ``grad_out`` = dL/d(output)
    (B, H, W, C+1): a 0-d float32 tensor. Same contract as
    :func:`.setconv.setconv_encode_offgrid_grad_ls`, plus ``out``, the
    forward's output on these inputs, from which the kernel reads the
    forward's sums (the plain version on the CPU forms them itself).

    On a CUDA device ``grad_out`` may be any float32 tensor whose channels
    are adjacent and whose cells are evenly strided, such as a channel
    slice of a wider NHWC gradient: the kernel reads it in place. Each
    32×32 cell tile takes only the points of :func:`grad_tile_points`;
    its float64 partial sum is written per tile and the partials are
    summed in a fixed order on the device, so the result is the same from
    run to run."""
    if _device_of(x) == "cpu":
        return plain.setconv_encode_offgrid_grad_ls(x1g, x2g, x, y, mask, lengthscale, grad_out)
    _forward_only(x1g, x2g, x, y, mask, lengthscale, grad_out, out)
    dev = x.device
    B, N, C, H, W = _check_points(x1g, x2g, x, y, mask)
    if grad_out.device != dev or grad_out.dtype != torch.float32 \
            or tuple(grad_out.shape) != (B, H, W, C + 1):
        raise ValueError(f"grad_out must be float32 {(B, H, W, C + 1)} on {dev}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on {grad_out.device}")
    stride = _cell_stride(grad_out)
    if stride is None:
        raise ValueError(f"grad_out's channels must be adjacent and its cells evenly "
                         f"strided, got strides {grad_out.stride()}")
    if N == 0 or B * H * W == 0:  # the output does not depend on ℓ
        return torch.zeros((), dtype=torch.float32, device=dev)
    _check("out", out, (B, H, W, C + 1), dev)
    ls = _lengthscale(lengthscale, dev)
    # one float64 partial per cell tile, then the last block's ticket
    # counter, all zeroed
    scratch = torch.zeros(B * _cdiv(H, GRAD_TILE) * _cdiv(W, GRAD_TILE) + 1,
                          dtype=torch.float64, device=dev)
    result = torch.empty((), dtype=torch.float32, device=dev)
    _launch("setconv_encode_offgrid_grad", x1g.data_ptr(), x2g.data_ptr(), x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), ls.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), stride, scratch.data_ptr(), result.data_ptr(),
            B, N, H, W, C + 1, GRAD_REACH, device=dev)
    encode_offgrid_grad.launches += 1
    return result


encode_offgrid_grad.launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cell_stride(t: torch.Tensor) -> int | None:
    """The elements between neighbouring cells of an NHWC tensor whose
    channels are adjacent and whose cells are evenly strided (contiguous,
    or a channel slice of a wider NHWC tensor); None for any other
    layout."""
    B, H, W, C = t.shape
    if t.is_contiguous():
        return C
    s = t.stride(2)
    want = (H * W * s, W * s, s, 1)
    if s >= C and all(n == 1 or st == w for n, st, w in zip(t.shape, t.stride(), want)):
        return s
    return None


def grad_tile_points(x1g, x2g, x, mask, lengthscale) -> torch.Tensor:
    """The points the ℓ-gradient kernel keeps for each cell tile:
    (B, ⌈H/GRAD_TILE⌉, ⌈W/GRAD_TILE⌉, N) bool. A point is kept where its
    mask is nonzero and its distance to the tile's x1 range and to its x2
    range (min to max over the tile's rows and columns, 0 inside), divided
    by ℓ in f32, is at most ``GRAD_REACH`` in both. Every other (point, cell) pair of
    the tile has an f32 RBF weight of exactly 0."""
    ls = _lengthscale(lengthscale, x.device)[0]

    def near(g, p):  # g (L,), p (B, N) -> (B, tiles, N)
        lo = torch.stack([c.min() for c in g.float().split(GRAD_TILE)])[None, :, None]
        hi = torch.stack([c.max() for c in g.float().split(GRAD_TILE)])[None, :, None]
        p = p.float()[:, None, :]
        gap = torch.fmax(torch.fmax(lo - p, p - hi), torch.zeros((), device=p.device))
        return ~(gap / ls > GRAD_REACH)

    return ((mask != 0)[:, None, None, :] & near(x1g, x[..., 0])[:, :, None, :]
            & near(x2g, x[..., 1])[:, None, :, :])


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x = hi + mid + lo (+ below 2^-24 |x|), each bf16: the bf16x3 split."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _span(nz: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of a (R, L) bool mask, the block range [lo, hi) that holds
    every True entry; (0, 0) for a row without one."""
    L = nz.shape[1]
    has = nz.any(1)
    first = nz.int().argmax(1)
    last = L - 1 - nz.flip(1).int().argmax(1)
    lo = torch.where(has, first // block, 0)
    hi = torch.where(has, last // block + 1, 0)
    return lo, hi


def decode_tiling(Ht: int, W: int, Wt: int) -> dict:
    """How the decode kernel tiles the target grid: target-row tiles (nTT),
    source-column chunks (nWC), target-column tiles of 8 (NTg) and the
    blocks over them (nUT blocks of ``tiles_per_ut`` tiles each)."""
    NTg = _cdiv(Wt, 8)
    nUT = _cdiv(NTg, DECODE_MAX_TILES)
    return dict(nTT=_cdiv(Ht, DECODE_BLOCK), nWC=_cdiv(W, DECODE_BLOCK), NTg=NTg,
                nUT=nUT, tiles_per_ut=_cdiv(NTg, nUT))


def decode_ranges(A: torch.Tensor, Bm: torch.Tensor) -> dict[str, torch.Tensor]:
    """The blocks of the decode that hold a nonzero weight, from A (Ht, H)
    and Bm (W, Wt): for each target-row tile the source-row blocks
    [klo, khi), and for each target-column block the source-column chunks
    [wlo, whi). Every block outside them has only exact-zero weights."""
    (Ht, H), (W, Wt) = A.shape, Bm.shape
    t = decode_tiling(Ht, W, Wt)
    D = DECODE_BLOCK
    rows = F.pad(A != 0, (0, 0, 0, t["nTT"] * D - Ht)).view(t["nTT"], D, H).any(1)
    klo, khi = _span(rows, D)
    tiles = F.pad(Bm != 0, (0, t["NTg"] * 8 - Wt, 0, t["nWC"] * D - W))
    tiles = tiles.view(t["nWC"], D, t["NTg"], 8).any(3).any(1)            # (nWC, NTg)
    per_block = F.pad(tiles, (0, t["nUT"] * t["tiles_per_ut"] - t["NTg"]))
    per_block = per_block.view(t["nWC"], t["nUT"], t["tiles_per_ut"]).any(2).T  # (nUT, nWC)
    wlo, whi = _span(per_block, 1)
    return dict(klo=klo, khi=khi, wlo=wlo, whi=whi)


def _bm_fragments(Bm: torch.Tensor, nWC: int, NTg: int) -> torch.Tensor:
    """Bm in the kernel's stage-2 fragment order, zero-padded:
    (nWC chunks, NTg tiles, 8 steps, 32 lanes, 2); in chunk c, tile n,
    step j, lane 4g + q holds Bm[w, 8n+g] and Bm[w+1, 8n+g] with
    w = 64c + 8j + 2q. A chunk's run of tiles is one contiguous copy."""
    W, Wt = Bm.shape
    Bp = F.pad(Bm, (0, NTg * 8 - Wt, 0, nWC * DECODE_BLOCK - W))
    v = Bp.view(nWC, 8, 4, 2, NTg, 8).permute(0, 4, 1, 5, 2, 3)  # (c, n, j, g, q, e)
    return v.reshape(nWC, NTg, 8, 32, 2).contiguous()


def _channel_first(f: torch.Tensor) -> torch.Tensor:
    """f (B, H, W, C) as contiguous planes (B*C, H, Wq), Wq = W rounded up
    to 8 (TMA's 16-byte row pitch), zero-padded. A channel-first-strided f
    with W % 8 == 0 is read in place; a contiguous NHWC f is copied."""
    B, H, W, C = f.shape
    fc = f.permute(0, 3, 1, 2)
    if W % 8 == 0:
        return fc.contiguous().view(B * C, H, W)
    out = f.new_zeros(B, C, H, _cdiv(W, 8) * 8)
    out[..., :W] = fc
    return out.view(B * C, H, -1)


def decode_grid(x1g, x2g, f, xt1, xt2, lengthscale, normalize: bool = True) -> torch.Tensor:
    """Gridded SetConv decode: f (B, H, W, C) on the internal grid
    x1g (H,) × x2g (W,) → (B, Ht, Wt, C) float32 on xt1 (Ht,) × xt2 (Wt,).
    Same contract as :func:`.setconv.setconv_decode_grid`; f may be float32
    or bfloat16, contiguous NHWC or a channel-first tensor seen as NHWC."""
    if _device_of(f) == "cpu":
        return plain.setconv_decode_grid(x1g, x2g, f, xt1, xt2, lengthscale, normalize)
    _forward_only(x1g, x2g, f, xt1, xt2, lengthscale)
    dev = f.device
    B, H, W, C = f.shape
    Ht, Wt = xt1.shape[0], xt2.shape[0]
    for name, t, shape in (("x1g", x1g, (H,)), ("x2g", x2g, (W,)),
                           ("xt1", xt1, (Ht,)), ("xt2", xt2, (Wt,))):
        _check(name, t, shape, dev)
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f must be float32 or bfloat16, got {f.dtype}")
    if not (f.is_contiguous() or f.permute(0, 3, 1, 2).is_contiguous()):
        raise ValueError("f must be contiguous NHWC or a channel-first tensor seen as NHWC")
    # the RBF weights and their sums are built here, as the Pallas wrapper
    # builds them in XLA; the contractions and the epilogue are the kernel's
    A = plain.rbf(xt1[:, None], x1g[None, :], lengthscale)   # (Ht, H)
    Bm = plain.rbf(x2g[:, None], xt2[None, :], lengthscale)  # (W, Wt)
    sA = A.sum(-1) if normalize else None
    sB = Bm.sum(0) if normalize else None
    t = decode_tiling(Ht, W, Wt)
    Hp = _cdiv(H, DECODE_BLOCK) * DECODE_BLOCK
    A3 = torch.stack(split_bf16x3(F.pad(A, (0, Hp - H, 0, t["nTT"] * DECODE_BLOCK - Ht))))
    bfrag = _bm_fragments(Bm, t["nWC"], t["NTg"])
    r = decode_ranges(A, Bm)
    ranges = torch.cat([r[k] for k in ("klo", "khi", "wlo", "whi")]).int()
    fcf = _channel_first(f)
    out_cf = torch.empty((B * C, Ht, Wt), dtype=torch.float32, device=dev)
    out = torch.empty((B, Ht, Wt, C), dtype=torch.float32, device=dev)
    _launch("setconv_decode_grid", A3.data_ptr(), fcf.data_ptr(),
            int(f.dtype == torch.float32), bfrag.data_ptr(),
            None if sA is None else sA.data_ptr(), None if sB is None else sB.data_ptr(),
            ranges.data_ptr(), out_cf.data_ptr(), out.data_ptr(), B, C, H, fcf.shape[-1],
            A3.shape[1], Hp, Ht, Wt, t["nTT"], t["nUT"], t["NTg"], t["tiles_per_ut"],
            device=dev)
    decode_grid.launches += 1
    return out


decode_grid.launches = 0

KERNELS = (encode_offgrid, encode_offgrid_grad, decode_grid)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
