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
    before = setconv_cuda.launch_counts()["encode_offgrid"]
    with torch.no_grad():
        got = setconv_cuda.encode_offgrid(*args)
    assert setconv_cuda.launch_counts()["encode_offgrid"] == before + 1
    _close(got, setconv.setconv_encode_offgrid(*args))


def test_encode_offgrid_with_ar_feedback_slots(cuda):
    """The AR chain's station set: real points, then feedback slots at
    x = -1e3 with mask 0, the first of them filled as a chain block does."""
    from deepsensornz_tpu_torch.infer.ar import _extend_point_context
    from deepsensornz_tpu_torch.task.task import PointContext

    x1g, x2g, x, y, mask = _points(np.random.default_rng(1), 3, 40, 1, 96, 80, 0.1, cuda)
    pc = _extend_point_context(PointContext(x, y, mask), 48)
    pc.x[:, 40:56] = torch.rand((3, 16, 2), device=cuda)
    pc.y[:, 40:56] = torch.randn((3, 16, 1), device=cuda)
    pc.mask[:, 40:56] = 1.0
    args = [x1g, x2g, pc.x, pc.y, pc.mask, 0.03]
    with torch.no_grad():
        got = setconv_cuda.encode_offgrid(*args)
    _close(got, setconv.setconv_encode_offgrid(*args))
    # the empty slots add exactly nothing
    with torch.no_grad():
        filled = setconv_cuda.encode_offgrid(x1g, x2g, pc.x[:, :56].contiguous(),
                                             pc.y[:, :56].contiguous(),
                                             pc.mask[:, :56].contiguous(), 0.03)
    _close(got, filled)


def test_sampling_and_ar_run_on_the_card(cuda):
    """A small model on the card: sampled, chunked and AR requests launch
    the kernels (B1 once per AR block) and give finite samples."""
    import chip_smoke as cs
    from deepsensornz_tpu_torch.infer.ar import ar_sample
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig

    cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=40, rank=4, decoder_channels=8,
                       mlp_hidden=8, compute_dtype="float32")
    dp = cs.make_processor("t")
    dem, aux = cs.target_fields(dp, (30, 28), seed=0)
    task = cs.train_task(0, 3, cfg.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                         n_stations=40, n_targets=20)
    model = cs.build_model(cfg, task, seed=0, device=cuda)
    setconv_cuda.reset_launch_counts()
    out = Predictor(model, dp, "t", batch_chunk=2).predict_grid(task, dem, aux_at_targets=aux,
                                                                n_samples=3, seed=1)
    assert setconv_cuda.launch_counts()["decode_grid"] == 2  # two chunks
    land = ~np.isnan(dem.data)
    assert np.isfinite(out["samples"].data[..., land]).all()
    before = setconv_cuda.launch_counts()["encode_offgrid"]
    s = ar_sample(model, task, n_samples=2, n_blocks=4,
                  generator=torch.Generator(device=cuda).manual_seed(0))
    assert setconv_cuda.launch_counts()["encode_offgrid"] - before == 2 * 4
    assert s.shape == (2, 3, 20, 1) and np.isfinite(s).all()


def test_encode_offgrid_empty_point_set(cuda):
    args = _points(np.random.default_rng(0), 2, 0, 1, 16, 16, 0.0, cuda) + [0.1]
    got = setconv_cuda.encode_offgrid(*args)
    assert got.shape == (2, 16, 16, 2) and not bool(got.any())


# B1's backward against its plain version in float64: dL/dℓ is one sum over
# every cell whose summands cancel, so its error is judged against both the
# value and the summands, a few f32 roundings each:
# |got - ref| <= 1e-5·|ref| + 1e-7·Σ|summands|
@pytest.mark.parametrize("B,N,C,H,W,ls,p_mask,layout", [
    (2, 16, 2, 32, 48, 0.12, 0.25, "uniform"),   # partial mask
    (1, 7, 1, 24, 40, 0.2, 0.0, "uniform"),      # tiles larger than the grid
    (2, 300, 2, 24, 24, 0.15, 0.1, "uniform"),   # several point chunks, ragged last one
    (1, 64, 7, 70, 130, 0.05, 0.0, "uniform"),   # many channels, ragged grid tiles
    (3, 512, 1, 200, 136, 0.005, 0.0, "uniform"),  # serving length-scale, sparse weights
    (2, 512, 1, 200, 136, 0.005, 0.0, "corner"),   # stations in one corner: empty tiles
    (2, 600, 1, 130, 200, 0.02, 0.95, "uniform"),  # 95 % masked slots
    (2, 64, 1, 200, 136, 0.01, 0.0, "boundary"),   # points at the reach from a tile edge
    (2, 100, 7, 70, 130, 0.05, 0.1, "uniform"),  # C1 = 8: seven passes
    (2, 700, 1, 130, 140, 0.3, 0.0, "uniform"),  # every point reaches every tile
    (2, 300, 1, 150, 100, 0.02, 0.1, "decreasing"),  # grid running down
])
@pytest.mark.parametrize("upstream", ["random", "density", "positive"])
def test_encode_offgrid_grad_kernel(cuda, B, N, C, H, W, ls, p_mask, layout, upstream):
    x1g, x2g, x, y, mask = _points(np.random.default_rng(0), B, N, C, H, W, p_mask, cuda)
    if layout == "corner":
        x = 0.2 * x
    elif layout == "decreasing":
        x1g, x2g = x1g.flip(0), x2g.flip(0)
    elif layout == "boundary":  # at GRAD_REACH·ℓ from row tile 0's upper edge, ±1 step
        r = torch.tensor(setconv_cuda.GRAD_REACH, device=cuda) * ls
        at = x1g[setconv_cuda.GRAD_TILE - 1] + r
        x[:, 0::3, 0] = at
        x[:, 1::3, 0] = torch.nextafter(at, at + 1)
        x[:, 2::3, 0] = torch.nextafter(at, at - 1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(B, H, W, C + 1, generator=gen, device=cuda)
    if upstream == "density":  # one sign, nothing cancels
        g = torch.zeros_like(g)
        g[..., 0] = 0.5 + torch.rand(B, H, W, generator=gen, device=cuda)
    elif upstream == "positive":  # the value channels without the random sign
        g = 0.5 + torch.rand(B, H, W, C + 1, generator=gen, device=cuda)
    args = (x1g, x2g, x, y, mask)
    with torch.no_grad():
        fwd = setconv_cuda.encode_offgrid(*args, ls)
    before = setconv_cuda.launch_counts()["encode_offgrid_grad"]
    got = setconv_cuda.encode_offgrid_grad(*args, ls, g, fwd)
    again = setconv_cuda.encode_offgrid_grad(*args, ls, g, fwd)
    assert setconv_cuda.launch_counts()["encode_offgrid_grad"] == before + 2
    assert got.shape == () and torch.equal(got, again)  # the same from run to run
    terms = setconv.encode_offgrid_grad_ls_terms(*args, torch.tensor(ls, dtype=torch.float64),
                                                 g.double())
    ref = float(sum(t.sum() for t in terms))
    bound = 1e-5 * abs(ref) + 1e-7 * float(sum(t.abs().sum() for t in terms))
    assert abs(float(got) - ref) <= bound, (float(got), ref, bound)


def test_encode_offgrid_grad_reads_a_strided_upstream(cuda):
    """A grad_out that is a channel slice of a wider NHWC tensor is read in
    place: bitwise the result of the same gradient made contiguous; a
    layout whose cells are not evenly strided raises."""
    x1g, x2g, x, y, mask = _points(np.random.default_rng(2), 3, 400, 1, 150, 130, 0.1, cuda)
    with torch.no_grad():
        fwd = setconv_cuda.encode_offgrid(x1g, x2g, x, y, mask, 0.01)
    wide = torch.randn(3, 150, 130, 11, device=cuda)
    g = wide[..., 9:]
    assert not g.is_contiguous()
    got = setconv_cuda.encode_offgrid_grad(x1g, x2g, x, y, mask, 0.01, g, fwd)
    want = setconv_cuda.encode_offgrid_grad(x1g, x2g, x, y, mask, 0.01, g.contiguous(), fwd)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="evenly strided"):
        setconv_cuda.encode_offgrid_grad(x1g, x2g, x, y, mask, 0.01,
                                         wide.transpose(1, 2).contiguous().transpose(1, 2)
                                         [..., 9:], fwd)


def test_encode_offgrid_grad_through_autograd(cuda):
    """The autograd function: the forward kernel, then the backward kernel
    for ℓ, against autograd of the plain forward (f32) on the same inputs.
    The encode is concatenated after another encode, as in the model, so
    its gradient arrives as a channel slice of the concatenation's."""
    x1g, x2g, x, y, mask = _points(np.random.default_rng(0), 2, 300, 2, 70, 130, 0.1, cuda)
    other = torch.randn(2, 70, 130, 4, device=cuda)
    g = torch.randn(2, 70, 130, 7, device=cuda)
    grads = []
    for fn in (setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid):
        ls = torch.tensor(0.05, device=cuda, requires_grad=True)
        enc = torch.cat([other, fn(x1g, x2g, x, y, mask, ls)], dim=-1)
        grads.append(torch.autograd.grad((enc * g).sum(), ls)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=0)


@pytest.mark.parametrize("loss", ["sum", "channel-first"])
def test_encode_offgrid_grad_of_an_upstream_it_cannot_read_in_place(cuda, loss):
    """Upstreams whose cells are not evenly strided reach the backward too:
    the expanded gradient of ``enc.sum()`` (every stride 0) and the
    channel-first one of a loss taken over ``enc.permute(0, 3, 1, 2)``.
    The backward copies them and still launches the kernel, and the result
    matches autograd of the plain forward (f32)."""
    x1g, x2g, x, y, mask = _points(np.random.default_rng(3), 2, 300, 2, 70, 130, 0.1, cuda)
    g = torch.randn(2, 3, 70, 130, device=cuda)
    grads = []
    for fn in (setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid):
        ls = torch.tensor(0.05, device=cuda, requires_grad=True)
        enc = fn(x1g, x2g, x, y, mask, ls)
        total = enc.sum() if loss == "sum" else (enc.permute(0, 3, 1, 2) * g).sum()
        before = setconv_cuda.launch_counts()["encode_offgrid_grad"]
        grads.append(torch.autograd.grad(total, ls)[0])
        launched = setconv_cuda.launch_counts()["encode_offgrid_grad"] - before
        assert launched == (fn is setconv_cuda.encode_offgrid)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=0)


def test_encode_offgrid_grad_empty_point_set(cuda):
    args = _points(np.random.default_rng(0), 2, 0, 1, 16, 16, 0.0, cuda)
    before = setconv_cuda.launch_counts()["encode_offgrid_grad"]
    fwd = setconv_cuda.encode_offgrid(*args, 0.1)
    g = torch.randn(2, 16, 16, 2, device=cuda)
    got = setconv_cuda.encode_offgrid_grad(*args, 0.1, g, fwd)
    assert float(got) == 0.0 and setconv_cuda.launch_counts()["encode_offgrid_grad"] == before


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
    (1, 608, 608, 64, 1390, 1300, 0.005, True),  # the 0.01° WRF grid, a task
    (24, 608, 608, 64, 1390, 1300, 0.005, True),  # its 24-task chunk: past 2^31 output elements
])
def test_decode_grid_kernel(cuda, B, H, W, C, Ht, Wt, ls, normalize, dtype):
    x1g, x2g, f, xt1, xt2 = _grid(B, H, W, C, Ht, Wt, dtype, cuda)
    before = setconv_cuda.launch_counts()["decode_grid"]
    got = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, ls, normalize=normalize)
    assert setconv_cuda.launch_counts()["decode_grid"] == before + 1
    assert got.dtype == torch.float32
    for b in range(B):  # a task at a time: the last ones' offsets pass 2^31
        _close(got[b], setconv.setconv_decode_grid(x1g, x2g, f[b:b + 1], xt1, xt2, ls,
                                                   normalize=normalize)[0])


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
    out = setconv_cuda.encode_offgrid(x1g, x2g, x, y, mask, ls)  # ℓ is differentiable
    assert out.requires_grad
    for which in (x, y):
        which.requires_grad_(True)
        with pytest.raises(RuntimeError, match="length-scale only"):
            setconv_cuda.encode_offgrid(x1g, x2g, x, y, mask, ls)
        which.requires_grad_(False)
    with pytest.raises(RuntimeError, match="forward only"):
        setconv_cuda.decode_grid(x1g, x2g, torch.randn(1, 16, 16, 4, device=cuda), x1g, x2g, ls)
    with pytest.raises(TypeError):
        setconv_cuda.encode_offgrid(x1g, x2g, x.double(), y, mask, 0.1)
    with pytest.raises(ValueError):
        setconv_cuda.encode_offgrid(x1g, x2g, x, y.expand(1, 8, 8), mask, 0.1)
    f = torch.randn(1, 16, 16, 4, device=cuda)
    with pytest.raises(ValueError):
        setconv_cuda.decode_grid(x1g, x2g, f.transpose(1, 2), x1g, x2g, 0.1)
    with pytest.raises(TypeError):
        setconv_cuda.decode_grid(x1g, x2g, f.double(), x1g, x2g, 0.1)


def test_encode_matches_plain_on_a_loader_task(cuda):
    """B1 against its plain version on a task the port's TaskLoader packed
    (its point capacity, per-time padding and missing rows), as the chip
    script's service phase checks it at the flagship size."""
    import chip_smoke as cs
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.task.loader import TaskLoader

    times, base, aux, highres, stations = cs.service_data(
        0, n_times=6, base_hw=(9, 8), aux_hw=(20, 18), highres_hw=(24, 22), n_stations=40)
    tl = TaskLoader([base, aux, stations], stations, aux_at_targets=highres, internal_density=30)
    cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                       mlp_hidden=8, compute_dtype="float32")
    task = tl(list(times[:4]))
    model = cs.build_model(cfg, task, seed=0, device=cuda)
    assert task.points[0].x.shape[1] == tl.point_capacity
    assert cs.encode_check(model, task.to(cuda)) >= 0.0


def test_pipeline_trains_on_the_card_as_on_the_cpu(cuda, tmp_path, monkeypatch):
    """A small ``Train.train_model`` from synthetic data on the card (B1 and
    its l-gradient) and on the CPU (plain versions), from the same seeded
    weights: two epochs' losses within rtol 1e-4 (f32 with cuDNN's and
    oneDNN's summation orders); then the card's run served by
    ``PredictService`` through B1 and B2."""
    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
    from deepsensornz_tpu_torch.infer.server import PredictService
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.pipeline.train import Train

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    base, dem, stations = synthetic_bundle(n_times=10, base_hw=(24, 24), dem_hw=(96, 96),
                                           n_stations=20)
    bundle = PreprocessForDownscaling("temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4,
        include_time_of_year=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tr = Train(bundle, seed=3, device=dev)
        tr.setup_task_loader(internal_density=24)
        tr.initialise_model(unet_channels=(8, 8), likelihood="gnp", rank=4,
                            compute_dtype="float32", decoder_channels=8, mlp_hidden=8)
        setconv_cuda.reset_launch_counts()
        out[dev.type] = tr.train_model(n_epochs=2, batch_size=4, lr=1e-3, verbose=False,
                                       model_dir=str(tmp_path / dev.type))
        out[dev.type + " launches"] = setconv_cuda.launch_counts()
    assert out["cuda launches"]["encode_offgrid"] > 0
    assert out["cuda launches"]["encode_offgrid_grad"] > 0
    assert out["cpu launches"] == dict.fromkeys(out["cpu launches"], 0)
    for key in ("train_losses", "val_losses"):
        np.testing.assert_allclose(out["cuda"][key], out["cpu"][key], rtol=1e-4)
    svc = PredictService(str(tmp_path / "cuda"), dem, highres_factor=2)
    setconv_cuda.reset_launch_counts()
    resp = svc.predict([str(t) for t in base.coords["time"][:2]])
    assert setconv_cuda.launch_counts()["decode_grid"] == 1
    assert setconv_cuda.launch_counts()["encode_offgrid"] == 1
    assert np.asarray(resp["mean"]).shape == (2, 48, 48)


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """{likelihood: (run directory, raw base, DEM, raw stations)}: a small
    cnp and gnp run trained on the CPU for one epoch."""
    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.pipeline.train import Train

    base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    bundle = PreprocessForDownscaling("temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4,
        include_time_of_year=True)
    out = {}
    for likelihood in ("cnp", "gnp"):
        tr = Train(bundle, seed=1, device="cpu")
        tr.setup_task_loader(internal_density=24)
        tr.initialise_model(unet_channels=(8, 8), likelihood=likelihood, rank=4,
                            compute_dtype="float32", decoder_channels=8, mlp_hidden=8)
        run_dir = str(tmp_path_factory.mktemp(likelihood))
        tr.train_model(n_epochs=1, batch_size=4, lr=1e-3, verbose=False, model_dir=run_dir)
        out[likelihood] = (run_dir, base, dem, stations)
    return out


@pytest.mark.parametrize("likelihood", ["cnp", "gnp"])
def test_validate_on_the_card_as_on_the_cpu(cuda, small_runs, likelihood, monkeypatch):
    """``Validate`` loaded on the card (B1 for every prediction) against the
    same run on the CPU: losses and z moments to rtol 1e-4, coverages to
    1/n, CRPS to rtol 1e-4; no plain SetConv on the card."""
    from deepsensornz_tpu_torch.pipeline.validate import Validate

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    run_dir, base, _, stations = small_runs[likelihood]
    times = list(base.coords["time"][:4])
    held = [str(i) for i in np.unique(stations["station_id"])[:3]]
    got = {}
    for dev in ("card", "cpu"):
        v = Validate(run_dir) if dev == "card" else Validate(run_dir, device="cpu")
        setconv_cuda.reset_launch_counts()
        got[dev] = (v.calculate_loss(times, held), v.calibration_stats(times, held),
                    v.pit_stats(times, held), v.crps(times, held))
        got[dev + " launches"] = setconv_cuda.launch_counts()
    assert got["card launches"]["encode_offgrid"] == 4  # one per prediction
    assert got["cpu launches"]["encode_offgrid"] == 0
    (la, ca, pa, ra), (lb, cb, pb, rb) = got["card"], got["cpu"]
    np.testing.assert_allclose([la["rmse"], la["mae"]], [lb["rmse"], lb["mae"]], rtol=1e-4)
    for a, b in ((ca, cb), (pa, pb)):
        assert a["n"] == b["n"] > 0
        np.testing.assert_allclose([a["z_mean"], a["z_std"]], [b["z_mean"], b["z_std"]],
                                   rtol=1e-4, atol=1e-4)
        assert abs(a["coverage_95"] - b["coverage_95"]) <= 1.0 / b["n"] + 1e-12
    np.testing.assert_allclose(ra["crps"], rb["crps"], rtol=1e-4)


def test_int16_predict_grid_on_the_card(cuda, small_runs, monkeypatch):
    """``ValidateERA`` on the card: int16 within half a step (plus four
    float32 roundings of the map's largest magnitude) of float32; 8
    download threads bitwise equal to one on a chunked request; B2 once per
    chunk."""
    from deepsensornz_tpu_torch.pipeline.validate import ValidateERA

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    run_dir, base, dem, stations = small_runs["gnp"]
    times = base.coords["time"][1:7]
    sel = stations[np.isin(stations["time"], np.asarray(times, stations["time"].dtype))]
    fields = {"temperature": base}
    f32 = ValidateERA(run_dir, dem, highres_factor=2)
    want = f32.predict(times, fields, station_df=sel)
    maps = []
    for threads in (1, 8):
        era = ValidateERA(run=f32.run, pred_grid=f32.pred_grid, transfer_dtype="int16",
                          batch_chunk=4, download_threads=threads)
        setconv_cuda.reset_launch_counts()
        maps.append(era.predict(times, fields, station_df=sel))
        assert setconv_cuda.launch_counts()["decode_grid"] == 2
    eps = float(np.finfo(np.float32).eps)
    for key in ("mean", "std"):
        assert maps[0][key].data.tobytes() == maps[1][key].data.tobytes()
        ref = want[key].data
        land = ~np.isnan(ref)
        span = np.nanmax(ref, axis=(1, 2), keepdims=True) - np.nanmin(ref, axis=(1, 2),
                                                                      keepdims=True)
        bound = span / 65535 / 2 + 4 * eps * np.nanmax(np.abs(ref), axis=(1, 2), keepdims=True)
        err = np.abs(maps[1][key].data.astype(np.float64) - ref)
        assert np.array_equal(np.isnan(maps[1][key].data), ~land)
        assert (err[land] <= np.broadcast_to(bound, ref.shape)[land]).all(), key


def _host_leaf(kind, n):
    """A host leaf of about ``n`` elements and the dtype it is sent in."""
    g = torch.Generator().manual_seed(len(kind) + n)
    if kind == "f32":
        return torch.randn(n, generator=g), torch.float32
    if kind == "int64":
        return torch.randint(-2 ** 40, 2 ** 40, (n,), generator=g), torch.int64
    if kind == "int32":
        return torch.randint(-2 ** 30, 2 ** 30, (n,), generator=g, dtype=torch.int32), torch.int32
    if kind in ("bf16", "f16"):
        return torch.randn(n, generator=g) * 100, (torch.bfloat16 if kind == "bf16"
                                                   else torch.float16)
    if kind == "transposed":
        return torch.randn(n // 64 + 1, 64, generator=g).t(), torch.float32
    return torch.randn(1, 64, generator=g).expand(n // 64 + 1, 64), torch.float32  # stride 0


@pytest.mark.parametrize("kind", ["f32", "int64", "int32", "bf16", "f16", "transposed",
                                  "expanded"])
def test_staged_upload_is_bitwise_to_device(cuda, kind):
    """Through a ring of 2 slabs of 4 KiB (slabs refilled within the upload)
    and through the default ring (a leaf of 3.5 slabs), with small leaves
    packed around it: each device tensor is contiguous and bit for bit
    ``t.to(dtype).to(device)``."""
    from deepsensornz_tpu_torch.infer import staging

    big = 7 * staging.SLAB_BYTES // 8  # 3.5 slabs of 4-byte elements
    for ring, sizes in ((staging.StagingRing(slab_bytes=4096, n_slabs=2), (3, 5000, 17)),
                        (staging.StagingRing(), (3, big, 17))):
        leaves = [_host_leaf(kind, n) for n in sizes]
        got = ring.upload(leaves, cuda)
        torch.cuda.synchronize()
        for g, (t, dt) in zip(got, leaves):
            want = t.to(dt).to(cuda)
            assert g.is_contiguous() and g.dtype == dt and g.shape == t.shape
            assert torch.equal(g.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


def test_back_to_back_staged_uploads_read_no_stale_slab(cuda):
    """Two uploads queued back to back, each over more slabs than the ring
    has, the first's sources overwritten as soon as it returned: each
    device result holds its own values."""
    from deepsensornz_tpu_torch.infer import staging

    ring = staging.StagingRing(slab_bytes=1 << 20, n_slabs=2)
    a = [torch.randn(5 << 18), torch.arange(7 << 16, dtype=torch.int64)]
    b = [torch.randn(5 << 18), torch.arange(7 << 16, dtype=torch.int64) + 3]
    want = [t.clone() for t in a]
    got_a = ring.upload([(t, t.dtype) for t in a], cuda)
    for t in a:
        t.fill_(-7)
    got_b = ring.upload([(t, t.dtype) for t in b], cuda)
    torch.cuda.synchronize()
    for got, w in zip(got_a + got_b, want + b):
        assert torch.equal(got.cpu(), w)


def test_staged_predict_grid_is_bitwise_the_to_device_upload(cuda, small_runs, monkeypatch):
    """``ValidateERA``'s ``predict_grid`` on the card, whole and in chunks:
    the mean and std maps with the inputs sent through the staging ring
    equal, bit for bit, those sent by ``.to(device)``; the ring stages
    exactly the bytes the direct upload counts; it holds its constant
    pinned slabs (at most 256 MiB), whatever the request's size."""
    from deepsensornz_tpu_torch.infer import predict as tpredict
    from deepsensornz_tpu_torch.infer import staging
    from deepsensornz_tpu_torch.perf import spans
    from deepsensornz_tpu_torch.pipeline.validate import ValidateERA

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    run_dir, base, dem, stations = small_runs["gnp"]
    fields = {"temperature": base}
    staged_upload = tpredict._upload
    ring_bytes = staging.SLAB_BYTES * staging.N_SLABS
    assert ring_bytes <= 256 << 20
    for chunk, times in ((None, base.coords["time"][1:3]), (2, base.coords["time"][1:7])):
        sel = stations[np.isin(stations["time"], np.asarray(times, stations["time"].dtype))]
        era = ValidateERA(run_dir, dem, highres_factor=2, batch_chunk=chunk)
        got = {}
        for way in ("direct", "staged"):
            monkeypatch.setattr(tpredict, "_upload", staged_upload if way == "staged"
                                else lambda task, target, dev, dt, _: staged_upload(
                                    task, target, dev, dt, None))
            before = spans.counters("predict_grid.upload")
            got[way] = era.predict(times, fields, station_df=sel)
            after = spans.counters("predict_grid.upload")
            got[way + " bytes"] = {k: after[k] - before.get(k, 0) for k in after
                                   if after[k] != before.get(k, 0)}
        sent = got["direct bytes"]["predict_grid.upload_direct_bytes"]
        assert got["direct bytes"] == {"predict_grid.upload_direct_bytes": sent}
        assert got["staged bytes"].pop("predict_grid.upload_staged_bytes") == sent
        assert set(got["staged bytes"]) <= {"predict_grid.upload_slab_waits"}
        for key in ("mean", "std"):
            assert got["staged"][key].data.tobytes() == got["direct"][key].data.tobytes(), key
        assert era.predictor._ring.nbytes == ring_bytes


def test_encode_offgrid_at_the_al_exhaustive_shape(cuda):
    """B1 as greedy placement's exhaustive forward feeds it: 64 hypothetical
    tasks, each the 512 stations, 4 masked placement slots and one
    candidate, onto the flagship's 608x608 grid."""
    import dataclasses

    import chip_smoke as cs
    from deepsensornz_tpu_torch.al import GreedyAlgorithm
    from deepsensornz_tpu_torch.infer.ar import _extend_point_context

    task = cs.train_task(0, 1, 500).to(cuda)
    ext = dataclasses.replace(task, points=(_extend_point_context(task.points[0], 4),))
    rng = np.random.default_rng(3)
    cand = torch.from_numpy(rng.random((64, 2)).astype(np.float32)).to(cuda)
    feed = torch.from_numpy(rng.normal(size=(64, 1)).astype(np.float32)).to(cuda)
    tiled = GreedyAlgorithm.hypothetical_tasks(ext, cand, feed, 0)
    p = tiled.points[0]
    assert p.x.shape == (64, 517, 2) and float(p.mask.sum()) == 64 * 513
    args = [tiled.x1g, tiled.x2g, p.x, p.y, p.mask, 0.004]
    before = setconv_cuda.launch_counts()["encode_offgrid"]
    with torch.no_grad():
        got = setconv_cuda.encode_offgrid(*args)
    assert setconv_cuda.launch_counts()["encode_offgrid"] == before + 1
    _close(got, setconv.setconv_encode_offgrid(*args))


def test_greedy_placement_on_the_card_as_on_the_cpu(cuda, monkeypatch):
    """A small ConvNP's ``GreedyAlgorithm.run`` in both modes on the card
    and on the CPU: the chip script's [al-reference] (each round's
    candidate scores within rtol 1e-4, decisive, the same placements,
    histories and final context within rtol 1e-4), with cuDNN's TF32 off
    as the chip script runs it."""
    import chip_smoke as cs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    setconv_cuda.reset_launch_counts()
    cs.al_reference(cuda)
    assert setconv_cuda.launch_counts()["encode_offgrid"] > 0


def test_two_rank_gloo_step_equals_the_summed_shards(cuda, tmp_path, monkeypatch):
    """A 2-rank data-parallel step on the card (gloo on CUDA tensors, both
    ranks on card 0, the chip script's [ddp] worker at its small model):
    each rank's summed gradient, its l-gradients among them, and its
    updated parameters, Adam state and loss are bitwise those of one
    process summing the two shards' gradients (computed with the whole
    batch's denominators), with cuDNN's deterministic algorithms on both
    sides; B1 and its l-gradient launched on each rank."""
    import chip_smoke as cs
    from deepsensornz_tpu_torch.train.trainer import apply_gradients, init_state

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfgs, task = cs.ddp_setting("small")
    ranks = cs.ddp_group(tmp_path, "small")
    with cs.deterministic_cudnn():
        model = cs.build_model(cfgs["float32"], task, seed=0, device=cuda)
        state0 = init_state(model)
        loss, grads = cs.summed_shards(model, task, cuda)
        want, want_loss = apply_gradients(state0, grads, loss, cs.TRAIN_LR)
    for out in ranks:
        got = out["float32"]
        for k, g in grads.items():
            assert torch.equal(got["grads"][k], g.cpu()), k
        assert torch.equal(got["state1"]["loss"], want_loss.cpu())
        for k, p in want.params.items():
            assert torch.equal(got["state1"]["params"][k], p.cpu()), k
            assert torch.equal(got["state1"]["mu"][k], want.opt_state["mu"][k].cpu()), k
        assert got["ranks_equal"]
        assert out["counts"]["encode_offgrid"] > 0 and out["counts"]["encode_offgrid_grad"] > 0
        assert not any(out["plain"].values())


def test_two_rank_gloo_grid_request_equals_the_two_shard_process(cuda, tmp_path, monkeypatch):
    """Data-parallel serving on the card (gloo on CUDA tensors, both ranks
    on card 0, the chip script's [dp-serve] worker at its small model):
    each rank's grid request, padded batch, samples, int16 chunks and
    points are bitwise those of one process running the ranks' rows with
    cuDNN's deterministic algorithms; B1 launched by every request, no
    plain SetConv on the card."""
    import chip_smoke as cs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfgs, dp, dem, aux, tasks = cs.dp_serve_setting("small")
    ranks = cs.dp_serve_group(tmp_path, "small")
    with cs.deterministic_cudnn():
        model = cs.build_model(cfgs["float32"], tasks["cycle"][0], seed=0, device=cuda)
        ref = cs.two_shard_reference(model, dp, dem, aux, tasks, cuda)
    for out in ranks:
        for k, want in ref.items():
            assert cs.same_arrays(out["float32"][k], want), k
        assert cs.same_arrays(out["float32"]["ar"], ranks[0]["float32"]["ar"])
        assert all(q["counts"]["encode_offgrid"] > 0 for q in out["requests"])
        assert not any(out["plain"].values())


# -- the spatial partition: the kernels on row blocks of the internal grid -------------


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_encode_and_its_l_gradient_on_row_blocks(cuda, n_blocks):
    """B1 on a block of grid rows (x1g[a:b]) gives the whole grid's rows of
    the plain encode; its l-gradient on the block is the plain gradient of
    the block's share, and the blocks' shares sum to the whole grid's."""
    from deepsensornz_tpu_torch.parallel.mesh import row_blocks

    B, N, C, H, W, ls = 3, 512, 1, 608, 136, 0.005
    x1g, x2g, x, y, mask = _points(np.random.default_rng(4), B, N, C, H, W, 0.1, cuda)
    g = torch.randn(B, H, W, C + 1, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    whole = setconv.setconv_encode_offgrid(x1g, x2g, x, y, mask, ls)
    total, scale = 0.0, 0.0
    for a, b in row_blocks(H, n_blocks, 16):
        args = (x1g[a:b], x2g, x, y, mask)
        before = setconv_cuda.launch_counts()
        with torch.no_grad():
            fwd = setconv_cuda.encode_offgrid(*args, ls)
        _close(fwd, whole[:, a:b])
        got = setconv_cuda.encode_offgrid_grad(*args, ls, g[:, a:b].contiguous(), fwd)
        after = setconv_cuda.launch_counts()
        assert after["encode_offgrid"] == before["encode_offgrid"] + 1
        assert after["encode_offgrid_grad"] == before["encode_offgrid_grad"] + 1
        terms = setconv.encode_offgrid_grad_ls_terms(*args, torch.tensor(ls, dtype=torch.float64),
                                                     g[:, a:b].double())
        ref = float(sum(t.sum() for t in terms))
        mag = float(sum(t.abs().sum() for t in terms))
        assert abs(float(got) - ref) <= 1e-5 * abs(ref) + 1e-7 * mag, (a, b, float(got), ref)
        total += float(got)
        scale += mag
    terms = setconv.encode_offgrid_grad_ls_terms(x1g, x2g, x, y, mask,
                                                 torch.tensor(ls, dtype=torch.float64), g.double())
    ref = float(sum(t.sum() for t in terms))
    assert abs(total - ref) <= 1e-5 * abs(ref) + 1e-7 * scale, (total, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_blocks", [2, 4])
def test_decode_grid_row_blocks_sum_to_the_whole(cuda, n_blocks, dtype):
    """B2 on each block's rows of f with the block's A and the whole grid's
    row sums, summed over the blocks: the whole decode, within B2's
    tolerance."""
    from deepsensornz_tpu_torch.parallel.mesh import row_blocks

    x1g, x2g, f, xt1, xt2 = _grid(2, 608, 96, 8, 278, 260, dtype, cuda)
    ls = 0.005
    row_sums = setconv.rbf(xt1[:, None], x1g[None, :], ls).sum(-1)
    want = setconv.setconv_decode_grid(x1g, x2g, f, xt1, xt2, ls)
    got = sum(setconv_cuda.decode_grid(x1g[a:b], x2g, f[:, a:b].contiguous(), xt1, xt2, ls,
                                       row_sums=row_sums)
              for a, b in row_blocks(608, n_blocks, 16))
    _close(got, want)
    # the plain version takes the same argument
    plain = sum(setconv.setconv_decode_grid(x1g[a:b], x2g, f[:, a:b], xt1, xt2, ls,
                                            row_sums=row_sums)
                for a, b in row_blocks(608, n_blocks, 16))
    _close(plain, want)


def test_decode_grid_block_reaching_no_target_tile_gives_zeros(cuda):
    """A block whose rows reach none of the target rows (every weight an
    exact 0, so every k-range empty) comes out exactly 0, whatever the
    memory the output was allocated from held."""
    x1g, x2g, f, _, xt2 = _grid(2, 608, 96, 8, 278, 260, torch.float32, cuda)
    xt1 = torch.linspace(0.0, 0.3, 278, device=cuda)  # targets in the grid's first third
    ls = 0.005
    row_sums = setconv.rbf(xt1[:, None], x1g[None, :], ls).sum(-1)
    a, b = 456, 608  # rows at x1 >= 0.75: exp(-(0.45/0.005)^2/2) is 0 in f32
    assert not bool((setconv.rbf(xt1[:, None], x1g[None, a:b], ls) != 0).any())
    garbage = torch.full((2 * 278 * 260 * 8 * 3,), float("nan"), device=cuda)
    del garbage  # the caching allocator hands its NaN-filled memory out again
    got = setconv_cuda.decode_grid(x1g[a:b], x2g, f[:, a:b].contiguous(), xt1, xt2, ls,
                                   row_sums=row_sums)
    torch.cuda.synchronize()
    assert bool((got == 0).all())


def _benchmark_domain(traffic: str):
    """The benchmark's domain of a traffic mix: its x-space target grid, the
    608² internal grid at density 500 and its land mask (cells near a
    registry site, 15.8 %)."""
    import json
    from pathlib import Path

    from benchmark import inputs

    path = Path(__file__).resolve().parents[1] / "benchmark" / "traffic" / f"{traffic}.json"
    return inputs.domain(json.loads(path.read_text()), {"internal_density": 500}, 0)


@pytest.mark.parametrize("traffic,live", [("wrf-cycle24", (112, 330)), ("cycle24", (10, 15))])
def test_decode_grid_on_the_live_tiles_is_the_full_launch_at_the_land(cuda, traffic, live):
    """B2 launched on the block tiles that hold the benchmark's land, with
    its gather: bit for bit the full launch at every land cell, 24 tasks of
    64 bf16 channels on the 608² grid at the serving ℓ, at 1390×1300 and at
    278×260, in one launch."""
    dom = _benchmark_domain(traffic)
    Ht, Wt = dom.land.shape
    land = np.flatnonzero(dom.land.ravel())
    t = setconv_cuda.decode_tiling(Ht, 608, Wt)
    assert (len(setconv_cuda.decode_live_tiles(land, Ht, Wt)), t["nTT"] * t["nUT"]) == live
    x1g, x2g, xt1, xt2 = (torch.from_numpy(a).to(cuda) for a in (dom.x1g, dom.x2g, dom.xt1,
                                                                  dom.xt2))
    g = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn(24, 608, 608, 64, device=cuda, generator=g).to(torch.bfloat16)
    full = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.005)
    cells = setconv_cuda.target_cells(land, Ht, Wt, cuda)
    before = setconv_cuda.launch_counts()["decode_grid"]
    got = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.005, cells=cells)
    assert setconv_cuda.launch_counts()["decode_grid"] == before + 1
    assert got.shape == (24, len(land), 64)
    for b in range(24):
        assert torch.equal(got[b], full[b].reshape(-1, 64).index_select(0, cells.index)), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["all", "corners", "random", "empty"])
def test_decode_grid_on_live_tiles_at_the_edges(cuda, kind, dtype):
    """Every cell listed (every tile live), one cell in each corner and in
    the ragged last row and column tiles, a random fifth of the cells with
    a block's row sums, and no cell (no launch, (B, 0, C)): bit for bit
    the full launch at the listed cells. 150 target rows (the last row
    tile 22), 300 columns (4 blocks of 80), 9 channels, ℓ 0.05."""
    x1g, x2g, f, xt1, xt2 = _grid(2, 100, 70, 9, 150, 300, dtype, cuda)
    n = 150 * 300
    rng = np.random.default_rng(2)
    idx = {"all": np.arange(n), "empty": np.zeros(0, np.int64),
           "random": np.sort(rng.choice(n, n // 5, replace=False)),
           "corners": np.array([0, 299, 75 * 300 + 299, 149 * 300, 149 * 300 + 150, n - 1])}[kind]
    row_sums = (setconv.rbf(xt1[:, None], x1g[None, :], 0.05).sum(-1) * 1.5
                if kind == "random" else None)
    cells = setconv_cuda.target_cells(idx, 150, 300, cuda)
    full = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.05, row_sums=row_sums)
    before = setconv_cuda.launch_counts()["decode_grid"]
    got = setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.05, row_sums=row_sums, cells=cells)
    assert setconv_cuda.launch_counts()["decode_grid"] == before + int(kind != "empty")
    assert got.shape == (2, len(idx), 9)
    torch.testing.assert_close(got, full.reshape(2, -1, 9)[:, cells.index], rtol=0, atol=0)
    with pytest.raises(ValueError, match="cells.index"):
        setconv_cuda.decode_grid(x1g, x2g, f, xt1, xt2, 0.05, cells=setconv_cuda.TargetCells(
            cells.index.int(), cells.tiles))


def test_a_wrf_land_forward_does_not_synchronise(cuda, monkeypatch):
    """One gridded forward of the flagship-width cnp model at the WRF shapes
    (24 tasks; base, aux and targets 1390×1300; the benchmark's land),
    ``Predictor._device_forward`` from the uploaded inputs to the moments,
    runs under ``torch.cuda.set_sync_debug_mode("error")``: the decode's
    live tiles come from the host. While recording it counts the 330 block
    tiles × 1536 planes, the 112 live ones and 24 × 285 506 decoded cells;
    its moments equal the whole-grid forward's at the land within f32."""
    import dataclasses

    import chip_smoke as cs
    from deepsensornz_tpu_torch.infer import predict as tpredict
    from deepsensornz_tpu_torch.perf import spans

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    dom = _benchmark_domain("wrf-cycle24")
    Ht, Wt = dom.land.shape
    land = np.flatnonzero(dom.land.ravel())
    cfg = dataclasses.replace(cs.flagship_config(), likelihood="cnp")
    task = cs.cycle_task(0, 24, cfg.internal_density, base_hw=(Ht, Wt), aux_hw=(Ht, Wt))
    model = cs.build_model(cfg, task, seed=0, device=cuda)
    pred = tpredict.Predictor(model, cs.make_processor("t"), "t")
    aux = np.random.default_rng(0).normal(size=(Ht, Wt, 1)).astype(np.float32)
    cells = setconv_cuda.target_cells(land, Ht, Wt)
    up, target = tpredict._upload(task, (dom.xt1, dom.xt2, aux, cells), cuda, None, pred._ring)
    torch.cuda.synchronize()
    outputs = ("mean", "std")
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pred._device_forward(up, target, 0, 0, outputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        spans.reset("decode_grid.")
        spans.reset("model.decode_grid_cells")
        with spans.recording():
            again = pred._device_forward(up, target, 0, 0, outputs)
        spans.clear()
        whole = pred._device_forward(up, target[:3] + (target[3].index,), 0, 0, outputs)
    assert spans.counters("decode_grid.") == {"decode_grid.tiles": 330 * 24 * 64,
                                              "decode_grid.tiles_live": 112 * 24 * 64}
    assert spans.counters("model.decode_grid_cells") == {"model.decode_grid_cells": 24 * 285506}
    for key in outputs:
        assert got[key].shape == (24, 285506, 1)
        assert torch.equal(got[key], again[key])
        _close(got[key], whole[key])


def test_two_rank_gloo_spatial_partition_on_the_card(cuda, monkeypatch):
    """The chip script's [spatial] phase at its small model: 2 ranks on card
    0 (gloo on CUDA tensors), each with its block of the grid's rows; the
    loss, gradients and request against one process on the whole grid
    within JAX's bounds, B1, its l-gradient and B2 launched on each rank,
    no plain SetConv on the card."""
    import chip_smoke as cs
    from deepsensornz_tpu_torch.ops import _build

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _build.load_library()
    counts = cs.spatial_phase(cuda, setconv_cuda, size="small")
    assert all(counts[k] > 0 for k in ("encode_offgrid", "encode_offgrid_grad", "decode_grid"))


def test_a_month_request_queues_its_chunks_without_a_sync_in_one_chunks_memory(cuda,
                                                                              monkeypatch):
    """A month as ``cli.infer`` sends it, at small widths: 744 hourly tasks
    of the benchmark's ``month744`` inputs (base 139×130×3, aux 278×260×4,
    aux at targets 556×520, the registry sites, the 278×260 land) to a
    ``cnp-spikes-beta`` model with U-Net (8, 8) at density 500, in 31
    chunks of 24, f16 upload, int16 mean only, humidity's post_transform.
    The request runs under ``torch.cuda.set_sync_debug_mode("error")``
    save the waits it means (``Event.synchronize``: each chunk's copies
    and the staging ring's slabs), so every chunk is queued before the
    host reads one. Its peak device memory is at most a one-chunk
    request's plus the month's inputs on the card (the f16 upload and its
    f32 upcast) and the chunks' int16 outputs, not 31 chunks' working
    sets; the first and last chunks' maps are bit for bit those of
    one-chunk requests of their tasks."""
    import copy

    from benchmark import manifest
    from benchmark.entries import common, serve_month
    from deepsensornz_tpu_torch.data.grid import Field
    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.perf import spans
    from deepsensornz_tpu_torch.pipeline.validate import post_transform_for
    from deepsensornz_tpu_torch.task.batching import take

    cell = copy.deepcopy(manifest.resolve("serve-month.spikesbeta-d500", manifest.load_manifest()))
    cell.config["model"].update(unet_channels=[8, 8], decoder_channels=8, mlp_hidden=8)
    cell.traffic["pool"] = 1
    tr, pr = cell.traffic, cell.traffic["predictor"]
    dom, pool, weights = serve_month.serve_inputs(cell, 2**31 + 5, cuda)
    model = common.port_model(cell, weights, cuda).eval()
    e = tr["extent"]
    dp = DataProcessor(x1_map=(e["minlat"], e["maxlat"]), x2_map=(e["minlon"], e["maxlon"]),
                       config={"humidity": cell.config["normalisation"]})
    dem = Field(np.where(dom.land, 100.0, np.nan), ("latitude", "longitude"),
                {"latitude": dom.lat, "longitude": dom.lon}, "elevation")
    highres = Field(dom.highres, ("x1", "x2"), {"x1": dom.highres_x[0].astype(np.float64),
                                                "x2": dom.highres_x[1].astype(np.float64)},
                    "elevation")
    p = Predictor(model, dp, "humidity", std_scale=pr["std_scale"],
                  transfer_dtype=pr["transfer_dtype"], batch_chunk=pr["batch_chunk"],
                  download_threads=pr["download_threads"], upload_dtype=pr["upload_dtype"])
    month = common.task_batch(pool[0], dom, with_targets=False)
    B, C = month.batch_size, pr["batch_chunk"]
    assert (B, C) == (744, 24)

    def request(task):
        return p.predict_grid(task, dem, aux_at_targets=highres, post_transform=post_transform_for(
            "humidity"), outputs=("mean",))

    def peak(task):
        request(task)  # warm: shapes, the ring
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        spans.reset("predict_grid.upload_staged_bytes")
        out = request(task)
        staged = spans.counters("predict_grid.upload_staged_bytes")
        return out, torch.cuda.max_memory_allocated(cuda) - base, sum(staged.values())

    firsts, last = take(month, np.arange(C)), take(month, np.arange(B - C, B))
    one, one_peak, _ = peak(firsts)
    waits = []
    real_sync = torch.cuda.Event.synchronize

    def allowed_wait(event):
        waits.append(event)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_sync(event)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(torch.cuda.Event, "synchronize", allowed_wait)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, month_peak, staged = peak(month)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.undo()
    assert len(waits) >= 2 * B // C  # two requests' chunks, at least
    L = int(dom.land.sum())
    outputs = B * L * 2 + B * 8
    # f16 values cross and are upcast: at most 3× what went through the ring
    bound = one_peak + 3 * staged + outputs + (16 << 20)
    print(f"one chunk {one_peak / 2**30:.3f} GiB, month {month_peak / 2**30:.3f} GiB, "
          f"staged {staged / 2**30:.3f} GiB, bound {bound / 2**30:.3f} GiB, waits {len(waits)}")
    assert month_peak <= bound
    for rows, ref_pred in ((slice(0, C), one), (slice(B - C, B), request(last))):
        a, b = got["mean"].data[rows], ref_pred["mean"].data
        assert a.tobytes() == b.tobytes()
    assert np.isnan(got["mean"].data[:, ~dom.land]).all()
    assert np.isfinite(got["mean"].data[:, dom.land]).all()
