"""SetConv CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; without a GPU every test skips. Imports no
JAX, so it runs on a machine without it (skip the repo's JAX conftest):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

pytestmark = pytest.mark.cuda

# f32, different summation order: |got - ref| <= 1e-4·|ref| + 1e-5·max|ref|
RTOL, ATOL_FRAC = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref):
    torch.cuda.synchronize()
    atol = ATOL_FRAC * float(ref.abs().max()) + 1e-30
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=atol)


def _points(rng, B, N, C, H, W, p_mask, dev):
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    x = rng.random((B, N, 2)).astype(np.float32)
    y = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = (rng.random((B, N)) > p_mask).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x1g, x2g, x, y, mask)]


@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask", [
    (2, 16, 2, 32, 48, 0.12, 0.25),   # partial mask
    (1, 7, 1, 24, 40, 0.2, 0.0),      # tiles larger than the grid
    (2, 300, 2, 24, 24, 0.15, 0.1),   # several point chunks, ragged last one
    (1, 64, 7, 70, 130, 0.05, 0.0),   # widest channel count, ragged grid tiles
    (3, 512, 1, 200, 136, 0.005, 0.0),  # serving length-scale, sparse weights
    (2, 70, 8, 40, 72, 0.1, 0.2),     # 8 value channels: more than one channel group
    (1, 150, 12, 66, 64, 0.08, 0.1),  # 12 value channels, ragged last group
])
def test_encode_offgrid_kernel(cuda, B, N, C, H, W, ls, p_mask):
    args = _points(np.random.default_rng(0), B, N, C, H, W, p_mask, cuda) + [ls]
    before = setconv_cuda.encode_offgrid.launches
    with torch.no_grad():
        got = setconv_cuda.encode_offgrid(*args)
    assert setconv_cuda.encode_offgrid.launches == before + 1
    _close(got, setconv.setconv_encode_offgrid(*args))


def test_encode_offgrid_empty_point_set(cuda):
    args = _points(np.random.default_rng(0), 2, 0, 1, 16, 16, 0.0, cuda) + [0.1]
    got = setconv_cuda.encode_offgrid(*args)
    assert got.shape == (2, 16, 16, 2) and not bool(got.any())


def _grid(B, H, W, C, Ht, Wt, dtype, dev):
    rng = np.random.default_rng(1)
    x1g = np.linspace(0, 1, H).astype(np.float32)
    x2g = np.linspace(0, 1, W).astype(np.float32)
    f = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xt1 = np.linspace(0.1, 0.9, Ht).astype(np.float32)
    xt2 = np.linspace(0.2, 0.8, Wt).astype(np.float32)
    x1g, x2g, f, xt1, xt2 = [torch.from_numpy(a).to(dev) for a in (x1g, x2g, f, xt1, xt2)]
    return x1g, x2g, f.to(dtype), xt1, xt2


# ℓ 0.005 is the serving length-scale (banded weights, zero blocks skipped);
# ℓ 0.3 makes every weight nonzero (nothing skipped)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Ht,Wt,ls,normalize", [
    (2, 32, 24, 4, 20, 12, 0.07, True),
    (2, 32, 24, 4, 20, 12, 0.07, False),
    (1, 64, 16, 2, 8, 8, 0.3, True),       # wide kernel: every source row counts
    (1, 40, 70, 9, 17, 400, 0.05, True),   # odd channel count, two target-column blocks
    (2, 64, 64, 64, 30, 26, 0.03, True),   # serving channel count
    (1, 100, 70, 9, 70, 260, 0.005, True),   # ragged H/W (W % 8 != 0), serving Wt
    (1, 130, 136, 3, 40, 260, 0.3, False),   # wide ℓ, unnormalised
    (1, 90, 200, 5, 81, 400, 0.3, True),     # wide ℓ, three target-column blocks
    (1, 608, 608, 2, 64, 1040, 0.005, True),  # Wt >= 1024 at the serving source grid
    (1, 608, 96, 3, 278, 260, 0.005, False),  # serving target rows, unnormalised
])
def test_decode_grid_kernel(cuda, B, H, W, C, Ht, Wt, ls, normalize, dtype):
    args = list(_grid(B, H, W, C, Ht, Wt, dtype, cuda)) + [ls]
    before = setconv_cuda.decode_grid.launches
    got = setconv_cuda.decode_grid(*args, normalize=normalize)
    assert setconv_cuda.decode_grid.launches == before + 1
    assert got.dtype == torch.float32
    _close(got, setconv.setconv_decode_grid(*args, normalize=normalize))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_grid_reads_channel_first_in_place(cuda, dtype):
    """A channel-first tensor seen as NHWC gives the contiguous NHWC result."""
    x1g, x2g, f, xt1, xt2 = _grid(2, 64, 48, 6, 30, 26, dtype, cuda)
    f_cf = f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got = setconv_cuda.decode_grid(x1g, x2g, f_cf, xt1, xt2, 0.02)
    want = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.02)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernels_reject_what_they_do_not_take(cuda):
    x1g, x2g, x, y, mask = _points(np.random.default_rng(0), 1, 8, 1, 16, 16, 0.0, cuda)
    ls = torch.tensor(0.1, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        setconv_cuda.encode_offgrid(x1g, x2g, x, y, mask, ls)
    with pytest.raises(TypeError):
        setconv_cuda.encode_offgrid(x1g, x2g, x.double(), y, mask, 0.1)
    with pytest.raises(ValueError):
        setconv_cuda.encode_offgrid(x1g, x2g, x, y.expand(1, 8, 8), mask, 0.1)
    f = torch.randn(1, 16, 16, 4, device=cuda)
    with pytest.raises(ValueError):
        setconv_cuda.decode_grid(x1g, x2g, f.transpose(1, 2), x1g, x2g, 0.1)
    with pytest.raises(TypeError):
        setconv_cuda.decode_grid(x1g, x2g, f.double(), x1g, x2g, 0.1)
