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
    before = setconv_cuda.encode_offgrid.launches
    s = ar_sample(model, task, n_samples=2, n_blocks=4,
                  generator=torch.Generator(device=cuda).manual_seed(0))
    assert setconv_cuda.encode_offgrid.launches - before == 2 * 4
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
    before = setconv_cuda.encode_offgrid_grad.launches
    got = setconv_cuda.encode_offgrid_grad(*args, ls, g, fwd)
    again = setconv_cuda.encode_offgrid_grad(*args, ls, g, fwd)
    assert setconv_cuda.encode_offgrid_grad.launches == before + 2
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
        before = setconv_cuda.encode_offgrid_grad.launches
        grads.append(torch.autograd.grad(total, ls)[0])
        launched = setconv_cuda.encode_offgrid_grad.launches - before
        assert launched == (fn is setconv_cuda.encode_offgrid)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=0)


def test_encode_offgrid_grad_empty_point_set(cuda):
    args = _points(np.random.default_rng(0), 2, 0, 1, 16, 16, 0.0, cuda)
    before = setconv_cuda.encode_offgrid_grad.launches
    fwd = setconv_cuda.encode_offgrid(*args, 0.1)
    g = torch.randn(2, 16, 16, 2, device=cuda)
    got = setconv_cuda.encode_offgrid_grad(*args, 0.1, g, fwd)
    assert float(got) == 0.0 and setconv_cuda.encode_offgrid_grad.launches == before


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
    before = setconv_cuda.encode_offgrid.launches
    with torch.no_grad():
        got = setconv_cuda.encode_offgrid(*args)
    assert setconv_cuda.encode_offgrid.launches == before + 1
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
