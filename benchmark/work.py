"""Operations and bytes from shapes and inputs, and the card's peaks.

``encode_work``, ``decode_work`` and ``card_bound`` are frozen copies of
``chip_smoke.py``'s arithmetic (PERF.md §6): a SetConv's work is what its
inputs need, the pairs of points and cells whose f32 RBF weight is not 0
(every other pair adds an exact 0), each input read once and each output
written once. The U-Net's convolutions are counted as 2·outputs·C_in·k²
per output channel; a stride-2 transposed conv over the positions it
really computes, 2·inputs·C_in·k² per output channel. Peaks: NVIDIA's H100
SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12   # the U-Net's compute dtype: the model step's peak
PEAK_TF32_FLOPS = 495e12   # the SetConv kernels keep f32 accuracy through TF32 splits
HBM_BYTES_PER_S = 3.35e12


def card_bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the TF32 rate or
    bytes at the HBM rate, whichever is larger."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def _nonzero(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    """(len(a), len(b)) bool: the f32 RBF weight exp(-(a-b)²/2ℓ²) is not 0."""
    d = (a[:, None].astype(np.float32) - b[None, :].astype(np.float32)) / np.float32(ls)
    return np.exp(np.float32(-0.5) * d * d) != 0


def encode_work(x1g, x2g, x, mask, channels: int, ls: float) -> tuple[float, float]:
    """(FLOPs, bytes) of the station encode of one task: points x (N, 2)
    with mask (N,), C = ``channels`` value channels. 2(C+1) FLOPs a pair
    of an unmasked point and a cell both of whose weights are nonzero; the
    inputs read once, the (H, W, C+1) output written once."""
    live = mask != 0
    nh = _nonzero(x[live, 0], x1g, ls).sum(1)
    nw = _nonzero(x[live, 1], x2g, ls).sum(1)
    c1 = channels + 1
    flops = 2.0 * c1 * float((nh.astype(np.float64) * nw).sum())
    inputs = 4 * (x.size + x.shape[0] * channels + mask.size)
    return flops, inputs + 4.0 * len(x1g) * len(x2g) * c1


def encode_grad_work(x1g, x2g, x, mask, channels: int, ls: float) -> tuple[float, float]:
    """(FLOPs, bytes) of the encode's length-scale gradient of one task:
    two sums a channel over the same pairs; the inputs, and the upstream
    gradient and the forward's output over the cells some unmasked point
    reaches (every other cell's terms are exactly 0)."""
    live = mask != 0
    rows = _nonzero(x1g, x[live, 0], ls).astype(np.float64)     # (H, n)
    cols = _nonzero(x[live, 1], x2g, ls).astype(np.float64)     # (n, W)
    reached = float(((rows @ cols) > 0).sum())
    flops, _ = encode_work(x1g, x2g, x, mask, channels, ls)
    c1 = channels + 1
    inputs = 4 * (x.size + x.shape[0] * channels + mask.size)
    return 2.0 * flops, inputs + 2 * 4.0 * reached * c1 + 4


def decode_grid_work(x1g, x2g, xt1, xt2, ls: float, batch: int, channels: int,
                     f_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the gridded decode of a batch: the two separable
    products over the nonzero weights only, in the cheaper order; f
    (B, H, W, C) read once in its dtype, the f32 output written once."""
    nnz_a = float(_nonzero(xt1, x1g, ls).sum())   # (Ht, H)
    nnz_b = float(_nonzero(x2g, xt2, ls).sum())   # (W, Wt)
    H, W, Ht, Wt = len(x1g), len(x2g), len(xt1), len(xt2)
    flops = 2.0 * batch * channels * min(W * nnz_a + Ht * nnz_b, H * nnz_b + Wt * nnz_a)
    nbytes = (batch * H * W * channels * f_bytes + 4.0 * batch * Ht * Wt * channels
              + 4 * (H + W + Ht + Wt))
    return flops, nbytes


def decode_offgrid_flops(x1g, x2g, xt, channels: int, ls: float) -> float:
    """FLOPs the off-grid decode of one task needs: per target, the
    nonzero rows contracted over the nonzero columns, then those columns."""
    nh = _nonzero(xt[:, 0], x1g, ls).sum(1).astype(np.float64)
    nw = _nonzero(xt[:, 1], x2g, ls).sum(1).astype(np.float64)
    return float((2.0 * channels * nw * (nh + 1)).sum())


def unet_flops(H: int, W: int, cin: int, channels, k: int, cout: int) -> float:
    """Multiply-adds ×2 of every convolution of the U-Net on an H×W grid."""
    ch = list(channels)
    sizes = [(H, W)]
    for _ in ch:
        h, w = sizes[-1]
        sizes.append((-(-h // 2), -(-w // 2)))
    f = 2.0 * H * W * cin * ch[0]                              # 1×1 stem
    c = ch[0]
    for i, w_out in enumerate(ch):                              # stride-2 downs
        h, w = sizes[i + 1]
        f += 2.0 * h * w * c * k * k * w_out
        c = w_out
    h, w = sizes[-1]
    f += 2.0 * h * w * c * k * k * ch[-1]                       # bottleneck
    c = ch[-1]
    skip = [ch[0]] + ch[:-1]
    for i in reversed(range(len(ch))):
        h, w = sizes[i + 1]
        f += 2.0 * h * w * c * k * k * ch[i]                    # transposed conv, inputs
        h, w = sizes[i]
        f += 2.0 * h * w * (ch[i] + skip[i]) * k * k * ch[i]    # mix conv
        c = ch[i]
    return f + 2.0 * H * W * c * cout                           # 1×1 head


def mlp_flops(points: int, widths) -> float:
    """The MLP head over ``points`` positions: widths [in, hidden..., out]."""
    return 2.0 * points * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
