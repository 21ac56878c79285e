"""The numerics the SetConv CUDA kernels rely on, checked on the CPU.

The kernels contract in split precision on the tensor cores (see
``deepsensornz_tpu_torch/csrc/mma_split.cuh``): the decode runs A, split in
three bf16 parts, against bf16 f (stage 1), then 3xTF32 (stage 2); f32 f is
split in three bf16 parts as well. This file emulates those splits in plain
torch, independently of the wrappers:

(a) the split decode meets the kernel tolerance against a float64
    reference, at the serving length-scale and at a wide one;
(b) a single TF32 pass does not, which is why the splits exist;
(c) the wrapper takes bf16 f on the CPU and agrees with the JAX decode on
    the same bf16-exact values;
(d) the zero-block ranges the wrapper hands the kernel cover every nonzero
    weight, and a decode restricted to them equals the full decode exactly;
(e) the wrapper's split of A and its stage-2 fragment order are the ones
    emulated here and documented in the kernel.

Kernel tolerance: |got - ref| <= 1e-4 |ref| + 1e-5 max|ref|.
"""

import numpy as np
import pytest
import torch

from deepsensornz_tpu.ops import setconv as jsc
from deepsensornz_tpu_torch.ops import setconv as tsc
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.ops.grids import internal_grid

RTOL, ATOL_FRAC = 1e-4, 1e-5
SERVING_LS, WIDE_LS = 0.005, 0.3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32: the mantissa cut to 10 bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16_parts(x: torch.Tensor, n: int) -> list:
    """x as a sum of n bf16 values, each the bf16 of the remainder."""
    parts = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def _weights(ls, Ht=278, Wt=40):
    """The serving decode's geometry: the 608-row internal grid of density
    500 onto a 278-row target grid (a narrow target width keeps it quick)."""
    x1g, x2g = (torch.from_numpy(a) for a in internal_grid((0, 1), (0, 1), 500.0, 0.1, 16))
    xt1 = torch.linspace(0, 1, Ht)
    xt2 = torch.linspace(0.2, 0.5, Wt)
    A = tsc.rbf(xt1[:, None], x1g[None, :], ls)   # (Ht, H)
    Bm = tsc.rbf(x2g[:, None], xt2[None, :], ls)  # (W, Wt)
    return x1g, x2g, xt1, xt2, A, Bm


def _features(shape, bf16_exact: bool, seed=0):
    f = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return f.to(torch.bfloat16).float() if bf16_exact else f


def _normalise(out, A, Bm):
    return out / (A.sum(-1)[:, None] * Bm.sum(0)[None, :] + 1e-8)


def _split_decode(A, Bm, f, f_parts: int):
    """The kernels' arithmetic for one (task, channel) plane f (H, W): stage 1
    sums the exact bf16 partial products of weight >= 2^-16 (A in 3 parts;
    f in 1 part when bf16-exact, else 3), stage 2 is 3xTF32."""
    Ap, fp = bf16_parts(A, 3), bf16_parts(f, f_parts)
    T = sum(Ap[i] @ fp[j] for i in range(3) for j in range(f_parts) if i + j <= 2)
    T_hi, B_hi = tf32(T), tf32(Bm)
    T_lo, B_lo = tf32(T - T_hi), tf32(Bm - B_hi)
    return _normalise(T_lo @ B_hi + T_hi @ B_lo + T_hi @ B_hi, A, Bm)


def _reference(A, Bm, f):
    A64, B64 = A.double(), Bm.double()
    return _normalise(A64 @ f.double() @ B64, A64, B64)


def _within_kernel_tolerance(got, ref) -> bool:
    err = (got.double() - ref).abs()
    return bool((err <= RTOL * ref.abs() + ATOL_FRAC * ref.abs().max()).all())


# -- (a) the split decode meets the tolerance --------------------------------------------


@pytest.mark.parametrize("ls", [SERVING_LS, WIDE_LS])
@pytest.mark.parametrize("bf16_f", [True, False])
def test_split_decode_meets_kernel_tolerance(ls, bf16_f):
    *_, A, Bm = _weights(ls)
    for c in range(3):  # a few channels of one task
        f = _features(A.shape[1:] + Bm.shape[:1], bf16_f, seed=c)
        got = _split_decode(A, Bm, f, f_parts=1 if bf16_f else 3)
        assert _within_kernel_tolerance(got, _reference(A, Bm, f))


# -- (b) one TF32 pass does not ----------------------------------------------------------


@pytest.mark.parametrize("ls", [SERVING_LS, WIDE_LS])
def test_single_tf32_pass_misses_kernel_tolerance(ls):
    *_, A, Bm = _weights(ls)
    f = _features(A.shape[1:] + Bm.shape[:1], bf16_exact=True)
    got = _normalise(tf32(tf32(A) @ tf32(f)) @ tf32(Bm), A, Bm)
    assert not _within_kernel_tolerance(got, _reference(A, Bm, f))


# -- (c) bf16 f through the wrapper on the CPU against JAX ----------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_decode_wrapper_takes_bf16_features(normalize):
    x1g, x2g, xt1, xt2, *_ = _weights(SERVING_LS, Ht=50, Wt=30)
    f = _features((2, x1g.shape[0], x2g.shape[0], 3), bf16_exact=True)
    want = np.asarray(jsc.setconv_decode_grid(x1g.numpy(), x2g.numpy(), f.numpy(),
                                              xt1.numpy(), xt2.numpy(), SERVING_LS, normalize))
    before = setconv_cuda.launch_counts()["decode_grid"]
    got = setconv_cuda.decode_grid(x1g, x2g, f.to(torch.bfloat16), xt1, xt2, SERVING_LS,
                                   normalize=normalize)
    assert setconv_cuda.launch_counts()["decode_grid"] == before  # CPU: plain version
    assert got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * scale)


# -- (d) the zero-block ranges ---------------------------------------------------------------


def _blocked_decode(A, Bm, f, ranges=None):
    """The decode as the kernel blocks it: per target-row tile and
    target-column block, source-row blocks then source-column chunks,
    accumulated in one fixed order; restricted to ``ranges`` if given."""
    D = setconv_cuda.DECODE_BLOCK
    (Ht, H), (W, Wt) = A.shape, Bm.shape
    t = setconv_cuda.decode_tiling(Ht, W, Wt)
    cols = t["tiles_per_ut"] * 8
    out = torch.zeros(Ht, Wt)
    for tt in range(t["nTT"]):
        rows = slice(tt * D, (tt + 1) * D)
        kb = range(-(-H // D)) if ranges is None else range(ranges["klo"][tt], ranges["khi"][tt])
        for ut in range(t["nUT"]):
            us = slice(ut * cols, (ut + 1) * cols)
            wc = (range(t["nWC"]) if ranges is None
                  else range(ranges["wlo"][ut], ranges["whi"][ut]))
            acc = torch.zeros(A[rows].shape[0], Bm[:, us].shape[1])
            for c in wc:
                ws = slice(c * D, (c + 1) * D)
                T = torch.zeros(A[rows].shape[0], f[:, ws].shape[1])
                for k in kb:
                    T = T + A[rows, k * D:(k + 1) * D] @ f[k * D:(k + 1) * D, ws]
                acc = acc + T @ Bm[ws, us]
            out[rows, us] = acc
    return out


@pytest.mark.parametrize("ls", [SERVING_LS, WIDE_LS])
def test_zero_block_ranges_cover_every_weight(ls):
    *_, A, Bm = _weights(ls, Wt=260)
    r = {k: v.tolist() for k, v in setconv_cuda.decode_ranges(A, Bm).items()}
    D = setconv_cuda.DECODE_BLOCK
    t = setconv_cuda.decode_tiling(*A.shape[:1], *Bm.shape)
    cols = t["tiles_per_ut"] * 8
    for tt in range(t["nTT"]):
        nz = (A[tt * D:(tt + 1) * D] != 0).any(0).nonzero().flatten()
        assert r["klo"][tt] * D <= int(nz.min()) and int(nz.max()) < r["khi"][tt] * D
    for ut in range(t["nUT"]):
        nz = (Bm[:, ut * cols:(ut + 1) * cols] != 0).any(1).nonzero().flatten()
        assert r["wlo"][ut] * D <= int(nz.min()) and int(nz.max()) < r["whi"][ut] * D
    if ls == WIDE_LS:  # nothing to skip
        assert r["klo"] == [0] * t["nTT"] and r["khi"] == [-(-A.shape[1] // D)] * t["nTT"]
    else:  # a 64-row tile touches a few of the 10 source-row blocks
        assert max(h - l for l, h in zip(r["klo"], r["khi"])) <= 4


@pytest.mark.parametrize("ls", [SERVING_LS, WIDE_LS])
def test_restricted_decode_equals_full_decode(ls):
    *_, A, Bm = _weights(ls, Ht=150, Wt=200)
    f = _features(A.shape[1:] + Bm.shape[:1], bf16_exact=False)
    r = {k: v.tolist() for k, v in setconv_cuda.decode_ranges(A, Bm).items()}
    full = _blocked_decode(A, Bm, f)
    assert torch.equal(_blocked_decode(A, Bm, f, r), full)
    if ls == SERVING_LS:
        # a non-finite value where every weight is 0 reaches only the full sum
        g = f.clone()
        g[-1, -1] = float("nan")
        assert bool(torch.isfinite(_blocked_decode(A, Bm, g, r)).all())
        assert not bool(torch.isfinite(_blocked_decode(A, Bm, g)).all())


# -- (e) the wrapper's helpers ------------------------------------------------------------


def test_wrapper_split_matches_the_emulation():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=1000).astype(np.float32))
    for got, want in zip(setconv_cuda.split_bf16x3(x), bf16_parts(x, 3)):
        torch.testing.assert_close(got.float(), want, rtol=0, atol=0)


def test_stage2_fragment_order():
    """Chunk c, tile n, step j, lane 4g+q holds Bm[w, 8n+g] and Bm[w+1, 8n+g]
    with w = 64c + 8j + 2q: the permuted k order that turns stage 1's C
    fragment into stage 2's A fragment."""
    *_, Bm = _weights(WIDE_LS, Wt=37)
    t = setconv_cuda.decode_tiling(278, *Bm.shape)
    frag = setconv_cuda._bm_fragments(Bm, t["nWC"], t["NTg"])
    W, Wt = Bm.shape
    assert frag.shape == (t["nWC"], t["NTg"], 8, 32, 2)
    for c, n, j, g, q in [(0, 0, 0, 0, 0), (3, 2, 5, 7, 3), (9, 4, 3, 4, 2), (9, 4, 7, 7, 3)]:
        w, u = 64 * c + 8 * j + 2 * q, 8 * n + g
        want = [float(Bm[w + e, u]) if w + e < W and u < Wt else 0.0 for e in (0, 1)]
        assert frag[c, n, j, 4 * g + q].tolist() == want


def test_serving_tiling():
    """278 x 260 from 608 x 608: 5 target-row tiles, 10 source-column
    chunks, 33 column tiles of 8 in 3 blocks of 11."""
    assert setconv_cuda.decode_tiling(278, 608, 260) == dict(nTT=5, nWC=10, NTg=33, nUT=3,
                                                             tiles_per_ut=11)
