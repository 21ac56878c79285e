"""The length-scale gradient of the point-set encode on the CPU.

``setconv_encode_offgrid_grad_ls`` (the closed form, the plain version of
the backward kernel ``csrc/setconv_encode_grad.cu``) against ``jax.grad``
of the JAX package's ``setconv_encode_offgrid`` and against torch autograd
of the port's plain forward, with partial masks, padded points far outside
the domain, several channels and an empty point set. Then the autograd
function around the encode (``setconv_cuda.encode_offgrid``), which on the
CPU runs the plain forward and the closed-form backward.

The loss is Σ out·g for a seeded random g (B, H, W, C+1). Tolerance: the
gradient is a sum over every cell with heavy cancellation, so the error is
judged against both the value and the absolute sum of the summands
(``encode_offgrid_grad_ls_terms``, in float64): |got − ref| ≤ 1e-5·|ref|
+ 1e-7·Σ|terms|, a few f32 roundings per summand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.ops import setconv as jsc
from deepsensornz_tpu_torch.ops import setconv as tsc
from deepsensornz_tpu_torch.ops import setconv_cuda

CASES = [
    (2, 16, 2, 32, 48, 0.12, 0.25),   # partial mask
    (1, 7, 1, 24, 40, 0.2, 0.0),
    (2, 300, 2, 24, 24, 0.15, 0.1),   # many points
    (1, 64, 7, 70, 130, 0.05, 0.0),   # many channels
    (3, 50, 1, 40, 36, 0.01, 0.3),    # narrow kernel, sparse weights
]


def _inputs(rng, B, N, C, H, W, p_mask):
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    x = rng.random((B, N, 2)).astype(np.float32)
    y = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = (rng.random((B, N)) > p_mask).astype(np.float32)
    if N > 4:  # padded tail points, as pad_points lays them out
        x[:, -3:] = -1e3
        y[:, -3:] = 0.0
        mask[:, -3:] = 0.0
    g = rng.normal(size=(B, H, W, C + 1)).astype(np.float32)
    return (x1g, x2g, x, y, mask), g


def _reference(arrays, ls, g) -> tuple[float, float]:
    """(dL/dℓ, Σ|summands|) in float64."""
    t64 = [torch.from_numpy(a).double() for a in arrays]
    terms = tsc.encode_offgrid_grad_ls_terms(*t64, ls, torch.from_numpy(g).double())
    return float(sum(t.sum() for t in terms)), float(sum(t.abs().sum() for t in terms))


def _assert_grad_close(got, ref, scale):
    assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-7 * scale, (got, ref, scale)


def _jax_grad(arrays, ls, g) -> float:
    j = [jnp.asarray(a) for a in arrays]
    return float(jax.grad(lambda l: jnp.sum(jsc.setconv_encode_offgrid(*j, l) * g))(
        jnp.float32(ls)))


def _autograd_plain(arrays, ls, g) -> float:
    lt = torch.tensor(ls, requires_grad=True)
    out = tsc.setconv_encode_offgrid(*(torch.from_numpy(a) for a in arrays), lt)
    return float(torch.autograd.grad((out * torch.from_numpy(g)).sum(), lt)[0])


@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask", CASES)
def test_grad_ls_matches_jax_and_autograd(rng, B, N, C, H, W, ls, p_mask):
    arrays, g = _inputs(rng, B, N, C, H, W, p_mask)
    got = tsc.setconv_encode_offgrid_grad_ls(*(torch.from_numpy(a) for a in arrays), ls,
                                             torch.from_numpy(g))
    assert got.shape == () and got.dtype == torch.float32
    ref, scale = _reference(arrays, ls, g)
    for value in (float(got), _jax_grad(arrays, ls, g), _autograd_plain(arrays, ls, g)):
        _assert_grad_close(value, ref, scale)


def test_grad_ls_empty_point_set(rng):
    arrays, g = _inputs(rng, 2, 0, 1, 16, 16, 0.0)
    got = tsc.setconv_encode_offgrid_grad_ls(*(torch.from_numpy(a) for a in arrays), 0.1,
                                             torch.from_numpy(g))
    assert float(got) == 0.0 == _jax_grad(arrays, 0.1, g)


@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask", [CASES[0], CASES[3], (2, 0, 1, 16, 16, 0.1, 0.0)])
def test_encode_autograd_function_on_cpu(rng, B, N, C, H, W, ls, p_mask):
    """With a length-scale that requires grad the wrapper's autograd
    function runs: the plain forward, then the closed-form backward. It
    equals autograd of the plain forward, and launches no kernel."""
    arrays, g = _inputs(rng, B, N, C, H, W, p_mask)
    t = [torch.from_numpy(a) for a in arrays]
    setconv_cuda.reset_launch_counts()
    lt = torch.tensor(ls, requires_grad=True)
    out = setconv_cuda.encode_offgrid(*t, lt)
    torch.testing.assert_close(out, tsc.setconv_encode_offgrid(*t, ls), rtol=0, atol=0)
    (got,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), lt)
    ref, scale = _reference(arrays, ls, g)
    _assert_grad_close(float(got), ref, scale)
    assert got.shape == lt.shape
    assert set(setconv_cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("which", [2, 3, 4])
def test_encode_refuses_grad_for_points(rng, which):
    """Only ℓ is differentiated: x, y or mask requiring grad raises rather
    than getting a silent None gradient."""
    arrays, _ = _inputs(rng, 1, 8, 1, 16, 16, 0.0)
    t = [torch.from_numpy(a) for a in arrays]
    t[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="length-scale only"):
        setconv_cuda.encode_offgrid(*t, torch.tensor(0.1, requires_grad=True))
    with torch.no_grad():  # nothing to differentiate: the forward runs
        setconv_cuda.encode_offgrid(*t, 0.1)


# -- the gradient kernel's per-tile culling (setconv_cuda.grad_tile_points) -----

def _culling_inputs(rng, grid, ls, layout):
    """Two tasks on a 150 x 100 grid (five row tiles, the last 22 rows;
    four column tiles, the last 4 columns), 40 points with a fifth masked
    and, for ``boundary``, points at exactly GRAD_REACH·ℓ (in f32) from a
    tile edge and one f32 step either side of it."""
    H, W, N = 150, 100, 40
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    if grid == "decreasing":
        x1g, x2g = x1g[::-1].copy(), x2g[::-1].copy()
    x = rng.random((2, N, 2)).astype(np.float32)
    y = rng.normal(size=(2, N, 1)).astype(np.float32)
    mask = (rng.random((2, N)) > 0.2).astype(np.float32)
    if layout == "boundary":
        r = np.float32(setconv_cuda.GRAD_REACH) * np.float32(ls)
        T = setconv_cuda.GRAD_TILE
        edge1 = x1g[:T].max()  # the first row tile's upper edge
        edge2 = x2g[:T].min()  # the first column tile's lower edge
        for i, step in enumerate((-1, 0, 1)):
            p1 = np.float32(edge1 + r)
            p2 = np.float32(edge2 - r)
            for _ in range(abs(step)):
                p1 = np.nextafter(p1, np.float32(np.inf * step), dtype=np.float32)
                p2 = np.nextafter(p2, np.float32(-np.inf * step), dtype=np.float32)
            x[:, i] = (p1, x2g[10])     # at the reach in x1 only
            x[:, 3 + i] = (x1g[10], p2)  # in x2 only
            x[:, 6 + i] = (p1, p2)       # in both
            mask[:, [i, 3 + i, 6 + i]] = 1.0
    g = rng.normal(size=(2, H, W, 2)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x1g, x2g, x, y, mask)], torch.from_numpy(g)


@pytest.mark.parametrize("layout", ["uniform", "boundary"])
@pytest.mark.parametrize("ls", [0.005, 0.05, 0.3])
@pytest.mark.parametrize("grid", ["increasing", "decreasing"])
def test_grad_tile_culling_is_exact(rng, grid, ls, layout):
    """Every (tile, point) pair the kernel drops has an f32 RBF weight of
    exactly 0 at every cell of the tile, and the closed form summed tile
    by tile over the kept points alone equals the full closed form within
    f32 rounding (the kernel's tolerance against float64)."""
    (x1g, x2g, x, y, mask), g = _culling_inputs(rng, grid, ls, layout)
    keep = setconv_cuda.grad_tile_points(x1g, x2g, x, mask, ls)
    T = setconv_cuda.GRAD_TILE
    assert keep.shape == (2, 5, 4, 40) and keep.dtype == torch.bool
    w1 = tsc.rbf(x1g[None, :, None], x[:, None, :, 0], ls)  # (B, H, N)
    w2 = tsc.rbf(x2g[None, None, :], x[:, :, None, 1], ls)  # (B, N, W)
    culled = torch.zeros((), dtype=torch.float32)
    for i in range(keep.shape[1]):
        rows = slice(i * T, (i + 1) * T)
        for j in range(keep.shape[2]):
            cols = slice(j * T, (j + 1) * T)
            dropped = (mask != 0) & ~keep[:, i, j]  # (B, N)
            reach = (w1[:, rows, :] != 0).any(1) & (w2[:, :, cols] != 0).any(2)
            assert not bool((dropped & reach).any()), (i, j)
            culled = culled + tsc.setconv_encode_offgrid_grad_ls(
                x1g[rows], x2g[cols], x, y, mask * keep[:, i, j], ls, g[:, rows, cols])
    if ls == 0.3 and layout == "uniform":  # every point reaches every tile
        assert bool((keep == (mask != 0)[:, None, None, :]).all())
    elif ls < 0.3:
        assert not bool(keep.all())
    full = tsc.setconv_encode_offgrid_grad_ls(x1g, x2g, x, y, mask, ls, g)
    ref, scale = _reference([a.numpy() for a in (x1g, x2g, x, y, mask)], ls, g.numpy())
    _assert_grad_close(float(culled), ref, scale)
    _assert_grad_close(float(full), ref, scale)


@pytest.mark.parametrize("reach,underflows", [(setconv_cuda.GRAD_REACH, True),
                                              (setconv_cuda.GRAD_REACH - 0.5, False)])
def test_grad_reach_underflows_f32(reach, underflows):
    """exp(-R²/2) is exactly 0 in f32 at the kernel's reach R, computed as
    the kernel does (d·d, then ·(−0.5), then exp), and a denormal above 0
    half a unit closer."""
    d = torch.tensor(reach, dtype=torch.float32)
    w = torch.exp(-0.5 * (d * d))
    assert (float(w) == 0.0) is underflows, float(w)
