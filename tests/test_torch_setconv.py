"""PyTorch SetConvs against the JAX package on the CPU.

(a) the four plain SetConvs against ``deepsensornz_tpu.ops.setconv``;
(b) the plain point-set encode and gridded decode (through the kernel
    wrappers, which take the plain version for CPU tensors) against the
    Pallas kernels run in interpret mode, as tests/test_setconv_pallas.py
    runs them.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: both sides compute in f32 and sum in different orders, so
rtol 1e-5 (a few f32 ulps over sums of tens of terms) with an atol of
1e-6 times the output's largest magnitude (at least 1) for entries that
cancel to near zero; the Pallas decode is held at the tolerance its own
tests use (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

from deepsensornz_tpu.ops import setconv as jsc
from deepsensornz_tpu.ops import setconv_pallas as jpl
from deepsensornz_tpu_torch.ops import setconv as tsc
from deepsensornz_tpu_torch.ops import setconv_cuda

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _points(rng, B, N, C, H, W, p_mask=0.0):
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    x = rng.random((B, N, 2)).astype(np.float32)
    y = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = (rng.random((B, N)) > p_mask).astype(np.float32)
    return x1g, x2g, x, y, mask


def _grid(rng, B, H, W, C, Ht, Wt):
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    f = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xt1 = np.linspace(0.1, 0.9, Ht).astype(np.float32)
    xt2 = np.linspace(0.2, 0.8, Wt).astype(np.float32)
    return x1g, x2g, f, xt1, xt2


# -- (a) plain SetConvs against the JAX einsum versions ----------------------------


@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask", [
    (2, 16, 2, 32, 48, 0.12, 0.25),
    (1, 7, 1, 24, 40, 0.2, 0.0),
    (2, 300, 3, 24, 20, 0.05, 0.1),
])
def test_encode_offgrid_matches_jax(rng, B, N, C, H, W, ls, p_mask):
    args = _points(rng, B, N, C, H, W, p_mask)
    want = np.asarray(jsc.setconv_encode_offgrid(*args, ls))
    got = tsc.setconv_encode_offgrid(*_t(*args), ls).numpy()
    _close(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_encode_grid_matches_jax(rng, with_mask):
    B, Hc, Wc, C, H, W = 2, 13, 11, 3, 32, 24
    x1g = np.linspace(-0.1, 1.1, H).astype(np.float32)
    x2g = np.linspace(-0.1, 1.1, W).astype(np.float32)
    xc1 = np.linspace(0, 1, Hc).astype(np.float32)
    xc2 = np.linspace(0, 1, Wc).astype(np.float32)
    y = rng.normal(size=(B, Hc, Wc, C)).astype(np.float32)
    mask = (rng.random((B, Hc, Wc)) > 0.3).astype(np.float32) if with_mask else None
    want = np.asarray(jsc.setconv_encode_grid(x1g, x2g, xc1, xc2, y, 0.08, mask))
    got = tsc.setconv_encode_grid(*_t(x1g, x2g, xc1, xc2, y), 0.08,
                                  None if mask is None else torch.from_numpy(mask)).numpy()
    _close(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_decode_offgrid_matches_jax(rng, normalize):
    B, H, W, C, M = 2, 24, 20, 5, 9
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    f = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xt = rng.random((B, M, 2)).astype(np.float32)
    want = np.asarray(jsc.setconv_decode_offgrid(x1g, x2g, f, xt, 0.1, normalize))
    got = tsc.setconv_decode_offgrid(*_t(x1g, x2g, f, xt), 0.1, normalize).numpy()
    _close(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_decode_grid_matches_jax(rng, normalize):
    args = _grid(rng, 2, 32, 24, 4, 20, 12)
    want = np.asarray(jsc.setconv_decode_grid(*args, 0.07, normalize))
    got = tsc.setconv_decode_grid(*_t(*args), 0.07, normalize).numpy()
    _close(got, want)


def test_lengthscale_tensor_matches_float(rng):
    """A 0-d tensor length-scale (a model parameter) gives the float's result."""
    args = _t(*_points(rng, 1, 10, 1, 16, 16))
    a = tsc.setconv_encode_offgrid(*args, 0.1)
    b = tsc.setconv_encode_offgrid(*args, torch.tensor(0.1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- (b) wrappers on CPU tensors against the Pallas kernels (interpret mode) ---------


@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask,tiles", [
    (2, 16, 2, 32, 48, 0.12, 0.25, dict(th=16, tw=16)),            # partial mask
    (1, 7, 1, 24, 40, 0.2, 0.0, dict(th=16, tw=16)),               # uneven tiles
    (2, 300, 2, 24, 24, 0.15, 0.1, dict(th=16, tw=16, nb=128)),    # N over blocks
    (1, 40, 12, 24, 20, 0.1, 0.2, dict(th=16, tw=16)),             # 12 value channels
])
def test_encode_wrapper_matches_pallas(rng, B, N, C, H, W, ls, p_mask, tiles):
    args = _points(rng, B, N, C, H, W, p_mask)
    want = np.asarray(jpl.encode_offgrid(*args, ls, interpret=True, **tiles))
    before = setconv_cuda.launch_counts()["encode_offgrid"]
    got = setconv_cuda.encode_offgrid(*_t(*args), ls).numpy()
    assert setconv_cuda.launch_counts()["encode_offgrid"] == before  # CPU: plain version
    _close(got, want)


def test_encode_wrapper_empty_point_set_matches_pallas(rng):
    args = _points(rng, 2, 0, 1, 16, 16)
    want = np.asarray(jpl.encode_offgrid(*args, 0.1, interpret=True))
    got = setconv_cuda.encode_offgrid(*_t(*args), 0.1).numpy()
    assert got.shape == want.shape == (2, 16, 16, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,H,W,C,Ht,Wt,ls,normalize,tiles", [
    (2, 32, 24, 4, 20, 12, 0.07, True, dict(tt=8, sh=8)),
    (2, 32, 24, 4, 20, 12, 0.07, False, dict(tt=8, sh=8)),
    (1, 64, 16, 2, 8, 8, 0.3, True, dict(tt=8, sh=16)),      # source blocks accumulate
    (1, 40, 36, 9, 17, 30, 0.05, True, dict(tt=8, sh=16, sw=16, cb=4)),  # uneven tiles
])
def test_decode_wrapper_matches_pallas(rng, B, H, W, C, Ht, Wt, ls, normalize, tiles):
    args = _grid(rng, B, H, W, C, Ht, Wt)
    # the jitted Pallas wrapper traces `normalize`; call it unjitted
    want = np.asarray(jpl.decode_grid.__wrapped__(*args, ls, normalize=normalize,
                                                  interpret=True, **tiles))
    before = setconv_cuda.launch_counts()["decode_grid"]
    got = setconv_cuda.decode_grid(*_t(*args), ls, normalize=normalize).numpy()
    assert setconv_cuda.launch_counts()["decode_grid"] == before
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        setconv_cuda.encode_offgrid(x, x, x, x, x, 0.1)


# -- (c) the gridded decode at a list of target cells ---------------------------------


def _cell_list(kind, Ht, Wt, rng):
    """Flat target-cell indices: a random fifth, every cell, one cell in
    each corner and in the ragged last row and column tiles, or none."""
    if kind == "random":
        return np.sort(rng.choice(Ht * Wt, Ht * Wt // 5, replace=False))
    if kind == "all":
        return np.arange(Ht * Wt)
    if kind == "corners":
        r, c = Ht - 1, Wt - 1
        return np.unique([0, c, r * Wt, r * Wt + c, (Ht // 2) * Wt + c, r * Wt + Wt // 2])
    return np.zeros(0, np.int64)


@pytest.mark.parametrize("row_sums", [False, True], ids=["whole", "row-sums"])
@pytest.mark.parametrize("kind", ["random", "all", "corners", "empty"])
def test_decode_grid_at_cells_is_the_whole_decodes_rows(rng, kind, row_sums):
    """On the CPU the wrapper with ``cells`` (the plain version) gives, bit
    for bit, the whole decode's rows at those cells, as (B, L, C); with a
    block's row sums too. A ragged grid: 150 target rows (3 row tiles, the
    last of 22) and 300 columns (4 column blocks of 80)."""
    x1g, x2g, f, xt1, xt2 = _t(*_grid(rng, 2, 32, 24, 3, 150, 300))
    sums = tsc.rbf(xt1[:, None], x1g[None, :], 0.07).sum(-1) * 1.5 if row_sums else None
    idx = _cell_list(kind, 150, 300, rng)
    cells = setconv_cuda.target_cells(idx, 150, 300)
    whole = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.07, row_sums=sums)
    got = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.07, row_sums=sums, cells=cells)
    assert got.shape == (2, len(idx), 3)
    torch.testing.assert_close(got, whole.reshape(2, -1, 3)[:, idx], rtol=0, atol=0)
    plain = tsc.setconv_decode_grid(x1g, x2g, f, xt1, xt2, 0.07, row_sums=sums,
                                    cells=cells.index)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


@pytest.mark.parametrize("Ht,Wt", [(150, 300), (64, 88), (278, 260), (1, 1), (70, 1300)])
def test_decode_live_tiles_are_the_block_tiles_holding_a_cell(rng, Ht, Wt):
    """``decode_live_tiles`` lists, ascending as ``ut · nTT + tt``, exactly
    the block tiles (64 rows × ``tiles_per_ut`` column tiles of 8) that
    hold a listed cell, counted here cell by cell."""
    t = setconv_cuda.decode_tiling(Ht, 32, Wt)
    wb = t["tiles_per_ut"] * 8
    for kind in ("random", "all", "corners", "empty"):
        idx = _cell_list(kind, Ht, Wt, rng)
        want = sorted({c // wb * t["nTT"] + r // setconv_cuda.DECODE_BLOCK
                       for r, c in (divmod(int(i), Wt) for i in idx)})
        got = setconv_cuda.decode_live_tiles(idx, Ht, Wt)
        assert got.dtype == np.int32 and got.tolist() == want, kind
        if kind == "all":
            assert len(got) == t["nTT"] * t["nUT"]


def test_decode_grid_counts_its_tiles_while_recording(rng):
    """A decode at a list of cells counts, while spans record and on either
    device, the whole grid's block tiles × planes and the live ones; a
    decode without a list counts neither."""
    from deepsensornz_tpu_torch.perf import spans

    x1g, x2g, f, xt1, xt2 = _t(*_grid(rng, 2, 32, 24, 3, 150, 300))
    idx = _cell_list("corners", 150, 300, rng)
    cells = setconv_cuda.target_cells(idx, 150, 300)
    spans.reset("decode_grid.")
    setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.07, cells=cells)
    assert spans.counters("decode_grid.") == {}
    with spans.recording():
        setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.07)
        assert spans.counters("decode_grid.") == {}
        setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.07, cells=cells)
    n_live = len(setconv_cuda.decode_live_tiles(idx, 150, 300))
    assert 0 < n_live < 3 * 4
    assert spans.counters("decode_grid.") == {"decode_grid.tiles": 3 * 4 * 2 * 3,
                                              "decode_grid.tiles_live": n_live * 2 * 3}
    spans.reset("decode_grid.")
