"""PyTorch ``Predictor.predict_grid`` against the JAX ``Predictor`` (CPU).

The setting is tests/test_predict.py's: synthetic NZ-like data through the
JAX ``TaskLoader``, a small gnp ConvNP at float32, and a DEM with NaN sea
cells. The port gets the same parameters (``params_from_jax``), the same
task (``TaskBatch.from_numpy``) and the processor through its JSON file.
Also covers the host-side copies the slice carries (grids, fields,
processor, task padding) against their JAX originals.

Tolerance: physical-unit fields agree to rtol 1e-5 with an atol of 1e-5
times the field's largest magnitude (f32 forward, different summation
order; unnormalisation multiplies by the target's std).

Samples: JAX and torch draw different numbers from one seed, so the
sampled paths are held to their own contract here (shapes, sea cells, the
seed, ``post_transform`` and ``std_scale`` on the samples, per-chunk
seeds) and to JAX through the mean: ``ar_sample_grid`` with both heads'
``sample`` patched to return the mean must give JAX's field to the same
tolerance, loosened to rtol 1e-4 (eight blocks feed their outputs back).
The heads' own sampling is held against JAX in tests/test_torch_sampling.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data import grid as jgrid
from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer import ar as jar
from deepsensornz_tpu.infer import predict as jpredict
from deepsensornz_tpu.infer.predict import Predictor as JPredictor
from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.ops import grids as jgrids
from deepsensornz_tpu.task import batching as jbatching
from deepsensornz_tpu.task import task as jtaskmod
from deepsensornz_tpu.task.loader import TaskLoader, interp_grid_at_points
from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.data.grid import interp_grid_at_points as t_interp_grid_at_points
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.infer import predict as tpredict
from deepsensornz_tpu_torch.infer import staging
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.task.batching import take
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.perf import spans
from deepsensornz_tpu_torch.ops import grids as tgrids
from deepsensornz_tpu_torch.task import task as ttaskmod
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax


def _field(f) -> Field:
    return Field(f.data, f.dims, f.coords, f.name, dict(f.attrs))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.nanmax(np.abs(want))))


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    base, dem, stations = synthetic_bundle(n_times=6, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    jdp = JProcessor()
    jdp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    dem_n = jdp(dem.fillna(0.0).rename("elevation"), method="min_max")
    st_col = [c for c in stations.columns if c.endswith("_station")][0]
    tl = TaskLoader(context=[jdp(base, method="mean_std"), jdp(stations, method="mean_std")],
                    target=jdp(stations), aux_at_targets=dem_n,
                    internal_density=32, grid_multiple=16)
    jcfg = JConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=32,
                   decoder_channels=8, mlp_hidden=8, rank=4, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    jtask = tl(list(base.coords["time"][:2]))
    params = jmodel.init(jax.random.key(0), jtask)

    path = tmp_path_factory.mktemp("dp") / "data_processor.json"
    jdp.save(str(path))
    dp = DataProcessor.load(str(path))
    task = TaskBatch.from_numpy(jtask)
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), task)
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return dict(jpred=JPredictor(jmodel, params, jdp, st_col), pred=Predictor(model, dp, st_col),
                jtask=jtask, task=task, jdem=dem, dem=_field(dem), jaux=dem_n,
                aux=_field(dem_n), st_col=st_col, model=model, dp=dp, jdp=jdp, jcfg=jcfg)


def _predictors(s, likelihood, dim_yt=1, **kw):
    """A JAX ``Predictor`` and the port's over one freshly initialised
    model with the given head, the same parameters on both sides."""
    jcfg = dataclasses.replace(s["jcfg"], likelihood=likelihood, dim_yt=dim_yt)
    jmodel = JConvNP(jcfg)
    params = jmodel.init(jax.random.key(1), s["jtask"])
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), s["task"])
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    target = s["st_col"] if dim_yt == 1 else [s["st_col"]] * dim_yt
    return (JPredictor(jmodel, params, s["jdp"], target, **kw),
            Predictor(model, s["dp"], target, **kw))


def _both(s, **kw):
    a = s["jpred"].predict_grid(s["jtask"], s["jdem"], aux_at_targets=s["jaux"], **kw)
    b = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], **kw)
    return a, b


@pytest.mark.parametrize("kw", [
    dict(),
    dict(unnormalise=False),
    dict(resolution_factor=0.5),
    dict(resolution_factor=1.5),
    dict(sea_mask=False),
    dict(outputs=("mean",)),
])
def test_predict_grid_matches_jax(setting, kw):
    a, b = _both(setting, **kw)
    assert set(b) == set(a)
    for key in a:
        fa, fb = a[key], b[key]
        assert fb.dims == fa.dims == ("time", "latitude", "longitude")
        assert fb.shape == fa.shape
        for d in fa.dims:
            np.testing.assert_array_equal(fb.coords[d], fa.coords[d])
        np.testing.assert_array_equal(np.isnan(fb.data), np.isnan(fa.data))
        _close(fb.data, fa.data)


def test_predict_grid_fields_and_sea_mask(setting):
    out = setting["pred"].predict_grid(setting["task"], setting["dem"],
                                       aux_at_targets=setting["aux"], times=[10, 11])
    sea = np.isnan(setting["dem"].data)
    assert out["mean"].shape == (2, 48, 48)
    np.testing.assert_array_equal(out["mean"].coords["time"], [10, 11])
    assert np.isnan(out["mean"].data[:, sea]).all()
    assert np.isfinite(out["mean"].data[:, ~sea]).all()
    assert (out["std"].data[:, ~sea] > 0).all()


def test_std_scale_matches_jax(setting):
    s = setting
    jp = JPredictor(s["jpred"].model, s["jpred"].params, s["jpred"].dp, s["st_col"],
                    std_scale=2.0)
    tp = Predictor(s["model"], s["dp"], s["st_col"], std_scale=2.0)
    a = jp.predict_grid(s["jtask"], s["jdem"], aux_at_targets=s["jaux"])
    b = tp.predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"])
    base = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"])
    for key in ("mean", "std"):
        _close(b[key].data, a[key].data)
    land = ~np.isnan(s["dem"].data)
    np.testing.assert_allclose(b["std"].data[:, land], 2.0 * base["std"].data[:, land],
                               rtol=1e-5)


def test_unnormalisation_is_the_target_affine(setting):
    s = setting
    phys = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"])
    norm = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"],
                                  unnormalise=False)
    p = s["dp"].config[s["st_col"]]["params"]
    land = ~np.isnan(s["dem"].data)
    np.testing.assert_allclose(phys["mean"].data[:, land],
                               norm["mean"].data[:, land] * p["std"] + p["mean"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,call_kw", [
    (dict(transfer_dtype="float16"), {}), (dict(download_threads=2), {}),
    (dict(upload_dtype="float16"), {}), (dict(transfer_dtype="int8"), {}),
])
def test_transfer_options_match_jax(setting, kw, call_kw):
    """The compressed transfer modes and threaded downloads match the JAX
    ``Predictor``'s same mode, in
    normalised units: float16 to one unit in its last place (2^-10 of the
    value), int8 to one step of each (task, channel) map (its range / 255),
    each on top of the float32 tolerance (the two sides' float32 maps may
    round to neighbouring values); the rest to the float32 tolerance.
    Unknown modes raise ``ValueError``."""
    s = setting
    jp = JPredictor(s["jpred"].model, s["jpred"].params, s["jpred"].dp, s["st_col"], **kw)
    tp = Predictor(s["model"], s["dp"], s["st_col"], **kw)
    a = jp.predict_grid(s["jtask"], s["jdem"], aux_at_targets=s["jaux"], unnormalise=False,
                        **call_kw)
    b = tp.predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], unnormalise=False,
                        **call_kw)
    for key in ("mean", "std"):
        want, got = a[key].data, b[key].data
        land = ~np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), ~land)
        tol = 1e-5 * np.abs(want) + 1e-5 * float(np.nanmax(np.abs(want)))
        if kw.get("transfer_dtype") == "float16":
            tol = tol + 2.0 ** -10 * np.abs(want)
        elif kw.get("transfer_dtype") == "int8":
            span = np.nanmax(want, axis=(1, 2), keepdims=True) - np.nanmin(want, axis=(1, 2),
                                                                           keepdims=True)
            tol = tol + span / 255.0
        assert (np.abs(got - want)[land] <= tol[land]).all(), key
    with pytest.raises(ValueError):
        Predictor(s["model"], s["dp"], s["st_col"],
                  **{k: ("int4" if isinstance(v, str) else 0) for k, v in kw.items()})


@pytest.mark.parametrize("likelihood,dim_yt", [("gnp", 1), ("cnp", 2), ("bernoulli-gamma", 1),
                                               ("cnp-spikes-beta", 1)])
def test_predict_points_matches_jax(setting, likelihood, dim_yt):
    """Mean/std (and p_wet for bernoulli-gamma) at the station targets, with
    a spread rescale: (B, M) arrays for one channel, (B, M, dy) for two, NaN
    where the target mask is 0."""
    jp, tp = _predictors(setting, likelihood, dim_yt, std_scale=1.3)
    a = jp.predict_points(setting["jtask"])
    b = tp.predict_points(setting["task"])
    assert set(b) == set(a)
    assert ("p_wet" in b) == (likelihood == "bernoulli-gamma")
    np.testing.assert_array_equal(b["mask"], a["mask"])
    B, M = setting["task"].yt_mask.shape
    for key in set(a) - {"mask"}:
        assert b[key].shape == a[key].shape == ((B, M, dim_yt) if dim_yt > 1 and key != "p_wet"
                                                else (B, M))
        assert b[key].dtype == np.float64
        np.testing.assert_array_equal(np.isnan(b[key]), np.isnan(a[key]))
        _close(b[key], a[key])
    assert np.isnan(b["mean"][~b["mask"]]).all() and np.isfinite(b["mean"][b["mask"]]).all()


def test_sampled_predict_grid_fields(setting):
    s = setting
    plain = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"])
    out = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=3,
                                 times=[4, 5], seed=11)
    f = out["samples"]
    assert f.dims == ("sample", "time", "latitude", "longitude")
    assert f.shape == (3, 2, 48, 48) and f.data.dtype == np.float32
    np.testing.assert_array_equal(f.coords["sample"], np.arange(3))
    np.testing.assert_array_equal(f.coords["time"], [4, 5])
    sea = np.isnan(s["dem"].data)
    assert np.isnan(f.data[:, :, sea]).all() and np.isfinite(f.data[:, :, ~sea]).all()
    for key in ("mean", "std"):  # sampling leaves the moments as they were
        np.testing.assert_allclose(out[key].data, plain[key].data, rtol=1e-6)
    # the samples vary from draw to draw and from cell to cell
    assert not np.allclose(f.data[0][:, ~sea], f.data[1][:, ~sea])


def test_sampled_predict_grid_seeds(setting):
    s = setting

    def draw(seed):
        return s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"],
                                      n_samples=2, seed=seed)["samples"].data

    a, b, c = draw(3), draw(3), draw(4)
    np.testing.assert_array_equal(a, b)
    land = ~np.isnan(s["dem"].data)
    assert not np.allclose(a[..., land], c[..., land])


def test_samples_take_post_transform_and_std_scale(setting):
    """``post_transform(samples, None)`` maps the normalised samples (a
    shift by 1 moves the physical samples by the target's std); with
    ``std_scale=2`` the same seed gives deviations from the mean twice as
    large (the spread is rescaled before sampling)."""
    s = setting
    kw = dict(aux_at_targets=s["aux"], n_samples=4, seed=7)
    seen = []

    def shift(mean, std):
        seen.append(std is None)
        return mean + 1.0, std

    base = s["pred"].predict_grid(s["task"], s["dem"], **kw)
    shifted = s["pred"].predict_grid(s["task"], s["dem"], post_transform=shift, **kw)
    assert seen == [False, True]
    land = ~np.isnan(s["dem"].data)
    scale = s["dp"].config[s["st_col"]]["params"]["std"]
    np.testing.assert_allclose(shifted["samples"].data[..., land] - base["samples"].data[..., land],
                               scale, rtol=1e-4)
    scaled = Predictor(s["model"], s["dp"], s["st_col"], std_scale=2.0).predict_grid(
        s["task"], s["dem"], **kw)
    da = base["samples"].data[..., land] - base["mean"].data[None][..., land]
    db = scaled["samples"].data[..., land] - scaled["mean"].data[None][..., land]
    np.testing.assert_allclose(db, 2.0 * da, rtol=1e-4, atol=1e-5 * float(np.abs(da).max()))


def test_joint_samples_scatter_around_the_mean(setting):
    """As tests/test_predict.py holds the JAX sampler: 64 joint samples'
    z-scores against the mean/std maps are centred with unit spread."""
    s = setting
    out = s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=64)
    land = ~np.isnan(s["dem"].data)
    z = ((out["samples"].data[:, :, land] - out["mean"].data[None, :, land])
         / out["std"].data[None, :, land])
    assert np.isfinite(z).all()
    assert abs(float(z.mean())) < 0.35
    assert 0.6 < float(z.std()) < 1.5


def test_chunked_predict_matches_unchunked(setting):
    """Five tasks in chunks of 2 (the tail chunk padded with its last task):
    mean/std equal the one-batch request and JAX's chunked request; chunk
    k's samples are those of a one-chunk request seeded ``seed + offset``."""
    s = setting
    idx = [0, 1, 0, 1, 0]
    big, jbig = take(s["task"], idx), jbatching.take(s["jtask"], idx)
    chunked = Predictor(s["model"], s["dp"], s["st_col"], batch_chunk=2)
    kw = dict(aux_at_targets=s["aux"], n_samples=2, seed=3)
    a = s["pred"].predict_grid(big, s["dem"], **kw)
    b = chunked.predict_grid(big, s["dem"], **kw)
    j = JPredictor(s["jpred"].model, s["jpred"].params, s["jpred"].dp, s["st_col"],
                   batch_chunk=2).predict_grid(jbig, s["jdem"], aux_at_targets=s["jaux"])
    for key in ("mean", "std"):
        assert b[key].shape == (5, 48, 48)
        np.testing.assert_allclose(b[key].data, a[key].data, rtol=1e-5,
                                   atol=1e-5 * float(np.nanmax(np.abs(a[key].data))))
        _close(b[key].data, j[key].data)
    assert b["samples"].shape == (2, 5, 48, 48)
    for off, tasks in ((0, [0, 1]), (2, [0, 1]), (4, [0, 0])):
        one = s["pred"].predict_grid(take(s["task"], tasks), s["dem"], aux_at_targets=s["aux"],
                                     n_samples=2, seed=3 + off)
        n = min(2, 5 - off)
        np.testing.assert_allclose(b["samples"].data[:, off:off + n], one["samples"].data[:, :n],
                                   rtol=1e-5, atol=1e-5 * float(np.nanmax(np.abs(one["mean"].data))))
    with pytest.raises(ValueError):
        Predictor(s["model"], s["dp"], s["st_col"], batch_chunk=0)


@pytest.mark.parametrize("chunk", [None, 5, 8])
def test_a_batch_of_at_most_batch_chunk_is_one_chunk(setting, monkeypatch, chunk):
    """Five tasks with ``batch_chunk`` None, 5 or 8 are one chunk: one
    forward (one ``predict_grid.launch`` span), no ``take`` of the uploaded
    batch, and int16 maps and samples bit for bit those of the request
    without ``batch_chunk``, on two download threads."""
    s = setting
    task = take(s["task"], [0, 1, 0, 1, 0])
    kw = dict(aux_at_targets=s["aux"], n_samples=2, seed=3)
    want = Predictor(s["model"], s["dp"], s["st_col"], transfer_dtype="int16",
                     download_threads=2).predict_grid(task, s["dem"], **kw)
    takes = []
    monkeypatch.setattr(tpredict, "take", lambda *a: takes.append(a) or take(*a))
    pred = Predictor(s["model"], s["dp"], s["st_col"], transfer_dtype="int16",
                     batch_chunk=chunk, download_threads=2)
    spans.clear()
    try:
        with spans.recording():
            got = pred.predict_grid(task, s["dem"], **kw)
        launches = [r for r in spans.records() if r.name == "predict_grid.launch"]
    finally:
        spans.clear()
    assert len(launches) == 1 and takes == []
    assert list(got) == list(want)
    for key in want:
        assert got[key].data.tobytes() == want[key].data.tobytes(), key


@pytest.fixture(scope="module")
def two_channel_model(setting):
    cfg = dataclasses.replace(setting["jcfg"], likelihood="cnp", dim_yt=2)
    return ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(cfg)), setting["task"],
                            generator=torch.Generator().manual_seed(2))


def _shift(mean, std):
    return mean + 0.5, None if std is None else std * 1.5


def _dequantize_as_before(d):
    if not isinstance(d, dict):
        return d.float().numpy()
    q = d["q"].numpy()
    half = float(2 ** (q.dtype.itemsize * 8 - 1))
    return (q.astype(np.float32) + half) * d["scale"].numpy() + d["lo"].numpy()


def _maps_as_before(pred, hosts, land, B, Ht, Wt, chunk, unnormalise, post_transform):
    """The host pipeline the gridded maps had before they were computed on
    the land values: each downloaded chunk dequantised, its rows scattered
    into NaN-filled whole-grid maps, ``post_transform``, the float64 affine
    on the whole grid, then a float32 copy per channel."""
    rows = {}
    for i, host in enumerate(hosts):
        n = min(B - i * chunk, chunk)
        for k, v in host.items():
            a = _dequantize_as_before(v)
            rows.setdefault(k, []).append(a[:, :n] if k == "samples" else a[:n])
    full = {}
    for k, parts in rows.items():
        a = np.concatenate(parts, axis=int(k == "samples"))
        lead, dy = a.shape[:-2], a.shape[-1]
        if land is not None:
            grid = np.full(lead + (Ht * Wt, dy), np.nan, np.float32)
            grid[..., land, :] = a
            a = grid
        full[k] = a.reshape(lead + (Ht, Wt, dy))
    mean, std, samples = full["mean"], full.get("std"), full.get("samples")
    if post_transform is not None:
        mean, std = post_transform(mean, std)
        if samples is not None:
            samples, _ = post_transform(samples, None)
    if unnormalise:
        scale, offset = pred._affines()
        mean = mean * scale + offset
        std = None if std is None else std * np.abs(scale)
        samples = None if samples is None else samples * scale + offset
    out = {}
    for c, var in enumerate(pred.target_vars):
        suffix = "" if len(pred.target_vars) == 1 else f"_{var}"
        for key, a in (("mean", mean), ("std", std), ("samples", samples)):
            if a is not None:
                out[key + suffix] = a[..., c].astype(np.float32)
    return out


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunk2"])
@pytest.mark.parametrize("post", [False, True], ids=["plain", "shift"])
@pytest.mark.parametrize("unnormalise", [True, False], ids=["phys", "norm"])
@pytest.mark.parametrize("n_samples", [0, 2], ids=["moments", "samples2"])
@pytest.mark.parametrize("dy", [1, 2], ids=["dy1", "dy2"])
@pytest.mark.parametrize("sea_mask", [True, False], ids=["land", "grid"])
@pytest.mark.parametrize("transfer", [None, "float16", "int16", "int8"])
def test_maps_are_bitwise_the_whole_grid_pipeline(setting, two_channel_model, monkeypatch,
                                                  transfer, sea_mask, dy, n_samples,
                                                  unnormalise, post, chunk):
    """The maps computed on the land values and gathered once equal, bit for
    bit and NaN for NaN, the whole-grid pipeline fed the same downloads:
    five tasks, so chunks of 2 pad the tail."""
    s = setting
    hosts = []

    def recorded(out, device):
        got = download(out, device)
        hosts.append(got[0])
        return got

    download = tpredict._download
    monkeypatch.setattr(tpredict, "_download", recorded)
    model = s["model"] if dy == 1 else two_channel_model
    target = s["st_col"] if dy == 1 else [s["st_col"]] * 2
    pred = Predictor(model, s["dp"], target, transfer_dtype=transfer, batch_chunk=chunk,
                     download_threads=2)
    task = take(s["task"], [0, 1, 0, 1, 0])
    post_transform = _shift if post else None
    out = pred.predict_grid(task, s["dem"], aux_at_targets=s["aux"], n_samples=n_samples,
                            seed=5, sea_mask=sea_mask, unnormalise=unnormalise,
                            post_transform=post_transform)
    Ht, Wt = s["dem"].shape
    land = np.flatnonzero(~np.isnan(s["dem"].data.ravel())) if sea_mask else None
    want = _maps_as_before(pred, hosts, land, 5, Ht, Wt, chunk or 5, unnormalise,
                           post_transform)
    assert len(hosts) == (1 if chunk is None else 3)
    assert list(out) == list(want)
    for key, w in want.items():
        g = out[key].data
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, key
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=key)
        np.testing.assert_array_equal(g.view(np.uint32)[~nan], w.view(np.uint32)[~nan],
                                      err_msg=key)
    mean = out["mean" if dy == 1 else f"mean_{s['st_col']}"].data
    assert sea_mask == bool(np.isnan(mean).any())


@pytest.mark.parametrize("sea_mask", [True, False], ids=["land", "grid"])
def test_maps_count_the_land_values_and_the_cells(setting, sea_mask):
    """``predict_grid.maps_values`` over ``predict_grid.maps_cells`` is the
    share of the grid the host computed on: the DEM's land share with the
    sea mask, 1 without it; a request with 2 samples writes (2 + 2) maps."""
    s = setting
    names = ("predict_grid.maps_values", "predict_grid.maps_cells")
    before = spans.counters("predict_grid.")
    try:
        with spans.recording():
            s["pred"].predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=2,
                                   sea_mask=sea_mask)
    finally:
        spans.clear()
    after = spans.counters("predict_grid.")
    values, cells = (after.get(k, 0) - before.get(k, 0) for k in names)
    B, (Ht, Wt) = s["task"].batch_size, s["dem"].shape
    land = int((~np.isnan(s["dem"].data)).sum()) if sea_mask else Ht * Wt
    assert cells == (2 + 2) * B * Ht * Wt
    assert values == (2 + 2) * B * land
    assert values / cells == (land / (Ht * Wt) if sea_mask else 1.0)
    assert sea_mask == (land < Ht * Wt)


def _spy_cells(monkeypatch) -> list:
    """Record the ``cells`` each ``ConvNP`` forward is given."""
    seen = []
    forward = ConvNP.forward

    def spy(self, task, target_grid=None, mesh=None, cells=None):
        seen.append(cells)
        return forward(self, task, target_grid, mesh, cells)

    monkeypatch.setattr(ConvNP, "forward", spy)
    return seen


_STEPS = {None: None, "float16": 2.0 ** -10, "bfloat16": 2.0 ** -7, "int16": 16, "int8": 8}


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunk2"])
@pytest.mark.parametrize("dy", [1, 2], ids=["dy1", "dy2"])
@pytest.mark.parametrize("transfer", list(_STEPS))
def test_the_land_path_gives_the_whole_grid_paths_maps(setting, two_channel_model, monkeypatch,
                                                      transfer, dy, chunk):
    """Without samples the forward is given the land cells and computes
    them alone; the maps equal those of the whole-grid path (every cell
    decoded, the land gathered after the moments) with the same NaN sea:
    within f32 rounding (the head's GEMM has another M), or where the
    transfer rounds, within its step: half an ulp of the cast each side, or
    one quantisation step of the map's land range. Five tasks, so chunks of
    2 pad the tail."""
    s = setting
    model = s["model"] if dy == 1 else two_channel_model
    target = s["st_col"] if dy == 1 else [s["st_col"]] * 2
    pred = Predictor(model, s["dp"], target, transfer_dtype=transfer, batch_chunk=chunk)
    task = take(s["task"], [0, 1, 0, 1, 0])
    seen = _spy_cells(monkeypatch)
    got = pred.predict_grid(task, s["dem"], aux_at_targets=s["aux"])
    land = np.flatnonzero(~np.isnan(s["dem"].data.ravel()))
    assert len(seen) == (1 if chunk is None else 3)
    assert all(c is not None and c.index.tolist() == land.tolist() for c in seen)
    monkeypatch.setattr(setconv_cuda, "target_cells", lambda land, *a: land)  # whole grid
    want = pred.predict_grid(task, s["dem"], aux_at_targets=s["aux"])
    assert all(c is None for c in seen[len(seen) // 2:])
    assert list(got) == list(want)
    step = _STEPS[transfer]
    for key, w in want.items():
        g, w = got[key].data, w.data
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=key)
        assert nan.any() and not nan.all()
        top = float(np.abs(w[~nan]).max())
        if step is None:
            tol = 0.0
        elif step < 1:
            tol = step * top
        else:  # one step of the map's range over its land cells
            tol = 1.01 * float(np.ptp(w[~nan])) / (2 ** step - 1)
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=1e-5, atol=tol + 1e-5 * top,
                                   err_msg=key)


@pytest.mark.parametrize("likelihood", ["gnp", "bernoulli-gamma"])
def test_sampled_requests_decode_and_draw_over_the_whole_grid(setting, monkeypatch,
                                                             likelihood):
    """With samples the forward is given no cell list: the head's draws are
    made over every cell of the grid from the request's generator, then
    the land kept, so the samples are bit for bit those of a forward on
    the whole grid drawn from the same seed."""
    s = setting
    cfg = dataclasses.replace(s["jcfg"], likelihood=likelihood)
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(cfg)), s["task"],
                             generator=torch.Generator().manual_seed(3)).eval()
    pred = Predictor(model, s["dp"], s["st_col"], std_scale=0.8)
    seen = _spy_cells(monkeypatch)
    out = pred.predict_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=3, seed=7,
                            unnormalise=False)
    assert seen == [None]
    lat, lon, xt1, xt2, aux, land, _ = pred._prepare(s["task"], s["dem"], s["aux"], True, 1.0)
    B = s["task"].batch_size
    with torch.inference_mode():
        raw = model(s["task"], target_grid=(torch.from_numpy(xt1), torch.from_numpy(xt2),
                                            torch.from_numpy(aux).expand(B, *aux.shape)))
        raw = pred.likelihood.rescale_raw(raw, 0.8).flatten(1, -2)
        draws = pred.likelihood.sample(raw, torch.Generator().manual_seed(7), 3)
    want = draws[:, :, land, 0].numpy()
    got = out["samples"].data.reshape(3, B, -1)
    assert got[:, :, land].tobytes() == want.tobytes()
    assert np.isnan(np.delete(got, land, axis=2)).all()


SLAB = 1024


@pytest.mark.parametrize("sizes", [
    [100],                    # smaller than a slab
    [SLAB],                   # exactly one slab
    [SLAB * 7 // 2],          # 3.5 slabs
    [0],                      # nothing to send
    [37] * 16,                # many small leaves packed into one slab
    [0, 100, 0, SLAB, 3],     # empty leaves between, a full slab after a partial one
    [SLAB - 1, 2, SLAB + 3, 700, 5 * SLAB],  # leaves straddling slab boundaries
], ids=["small", "one-slab", "3.5-slabs", "zero", "packed", "mixed", "straddling"])
def test_the_slab_plan_covers_every_byte_once_in_order(sizes):
    """Each leaf's pieces run in order over its bytes, each byte once; each
    leaf starts at an aligned offset of the stream; a slab's pieces do not
    overlap and stay inside it; no slab is empty."""
    slabs = staging.plan(sizes, SLAB, align=64)
    seen = {i: [] for i in range(len(sizes))}
    for j, pieces in enumerate(slabs):
        assert pieces
        ends = 0
        for leaf, start, off, n in pieces:
            assert 0 < n and ends <= off and off + n <= SLAB
            ends = off + n
            seen[leaf].append((start, j * SLAB + off, n))
    for leaf, n in enumerate(sizes):
        pieces = seen[leaf]
        assert sum(p[2] for p in pieces) == n
        if n:
            assert pieces[0][0] == 0 and pieces[0][1] % 64 == 0
        for (s0, p0, n0), (s1, p1, _) in zip(pieces, pieces[1:]):
            assert s1 == s0 + n0 and p1 == p0 + n0  # in order, no gap in the stream
    if sizes == [37] * 16:
        assert len(slabs) == 1 and len(slabs[0]) == 16
    if sizes == [SLAB * 7 // 2]:
        assert [sum(p[3] for p in s) for s in slabs] == [SLAB] * 3 + [SLAB // 2]
    with pytest.raises(ValueError, match="multiple of align"):
        staging.plan(sizes, SLAB + 1, align=64)


def _leaf(kind):
    g = torch.Generator().manual_seed(3)
    if kind == "f32":
        return torch.randn(3 * SLAB // 4 + 5, generator=g), torch.float32
    if kind == "int64":
        return torch.randint(-2 ** 40, 2 ** 40, (400,), generator=g), torch.int64
    if kind == "int32":
        t = torch.randint(-2 ** 30, 2 ** 30, (5, 97), generator=g, dtype=torch.int32)
        return t, torch.int32
    if kind in ("bf16", "f16"):
        return (torch.randn(2, 600, generator=g) * 100,
                torch.bfloat16 if kind == "bf16" else torch.float16)
    if kind == "transposed":
        return torch.randn(40, 30, generator=g).t(), torch.float32
    if kind == "expanded":
        return torch.randn(1, 7, generator=g).expand(90, 7), torch.float32
    if kind == "bf16-leaf":  # no numpy dtype: its bytes are copied
        return torch.randn(700, generator=g).to(torch.bfloat16), torch.bfloat16
    if kind == "bool":
        return torch.rand(333, generator=g) > 0.5, torch.bool
    if kind == "empty":
        return torch.zeros(0, 4), torch.float32
    return torch.tensor(2.5), torch.float32  # a 0-d leaf


LEAF_KINDS = ["f32", "int64", "int32", "bf16", "f16", "bf16-leaf", "bool", "transposed",
              "expanded", "empty", "0-d"]


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_the_ring_gives_each_leaf_as_to_does(kind):
    """Through a ring of 3 small slabs (on the CPU: plain host slabs), each
    leaf, alone and among others, comes out contiguous, of its dtype and
    shape, bit for bit what ``t.to(dtype)`` gives; the bytes sent are
    counted as staged."""
    ring = staging.StagingRing(slab_bytes=SLAB, n_slabs=3)
    t, dt = _leaf(kind)
    others = [_leaf(k) for k in LEAF_KINDS]
    before = spans.counters("predict_grid.")
    alone, *mixed = ring.upload([(t, dt)], torch.device("cpu")) + ring.upload(
        others + [(t, dt)], torch.device("cpu"))
    after = spans.counters("predict_grid.")
    for got, (src, d) in [(alone, (t, dt))] + list(zip(mixed, others + [(t, dt)])):
        want = src.to(d)
        assert got.is_contiguous() and got.dtype == d and got.shape == src.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8) if got.numel() else got,
                           want.reshape(-1).view(torch.uint8) if want.numel() else want)
    sent = sum(o.numel() * o.element_size() for o in [alone] + mixed)
    assert (after.get("predict_grid.upload_staged_bytes", 0)
            - before.get("predict_grid.upload_staged_bytes", 0)) == sent
    assert ring.nbytes == 3 * SLAB
    assert after.get("predict_grid.upload_slab_waits", 0) == before.get(
        "predict_grid.upload_slab_waits", 0)  # no copy to wait for on the CPU


def test_back_to_back_uploads_through_the_ring_get_their_own_values():
    """Two uploads of different values, each over more slabs than the ring
    has, and the first's sources overwritten after it returned: each gets
    its own values, so no slab is read stale."""
    ring = staging.StagingRing(slab_bytes=SLAB, n_slabs=2)
    a = [torch.randn(5 * SLAB // 4 + 3), torch.arange(300.0)]
    b = [torch.randn(5 * SLAB // 4 + 3), torch.arange(300.0) + 1]
    want = [t.clone() for t in a]
    got_a = ring.upload([(t, t.dtype) for t in a], torch.device("cpu"))
    for t in a:
        t.fill_(-7.0)
    got_b = ring.upload([(t, t.dtype) for t in b], torch.device("cpu"))
    for got, w in zip(got_a + got_b, want + b):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="at least 2 slabs"):
        staging.StagingRing(n_slabs=1)


def _upload_bytes(task, dem, aux_channels, land, upload_dtype=None) -> int:
    """The bytes of a gridded request's upload without samples: the task's
    leaves (targets cut to one slot, value leaves in ``upload_dtype``) and
    the target grid's coordinates, aux, land index ``land`` and the
    decode's live tiles for it."""
    value = {None: 4, "bfloat16": 2, "float16": 2}[upload_dtype]
    n = sum(4 * (g.x1.numel() + g.x2.numel()) + value * (g.y.numel() + (
        0 if g.mask is None else g.mask.numel())) for g in task.grids)
    n += sum(4 * p.x.numel() + value * (p.y.numel() + p.mask.numel()) for p in task.points)
    B, (Ht, Wt) = task.batch_size, dem.shape
    n += 4 * (B * 2 + B + task.x1g.numel() + task.x2g.numel() + Ht + Wt + Ht * Wt * aux_channels)
    return n + 8 * len(land) + 4 * len(setconv_cuda.decode_live_tiles(land, Ht, Wt))


def test_the_cpu_upload_is_as_before(setting):
    """On the CPU ``predict_grid`` uploads by ``.to(device)``: the uploaded
    leaves are the inputs' own storage, every byte is counted as direct,
    none staged, and the ring holds no memory."""
    s = setting
    pred = Predictor(s["model"], s["dp"], s["st_col"])
    task = s["task"]
    target = (np.zeros(3, np.float32), np.zeros(4, np.float32), None, np.arange(5))
    up, (xt1, _, aux, land) = tpredict._upload(task, target, torch.device("cpu"), None, None)
    assert up.grids[0].y.data_ptr() == task.grids[0].y.data_ptr()
    assert up.points[0].mask.data_ptr() == task.points[0].mask.data_ptr()
    assert xt1.data_ptr() == target[0].ctypes.data and aux is None
    assert land.data_ptr() == target[3].ctypes.data
    before = spans.counters("predict_grid.upload")
    pred.predict_grid(task, s["dem"], aux_at_targets=s["aux"])
    after = spans.counters("predict_grid.upload")
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    land = np.flatnonzero(~np.isnan(s["dem"].data))
    assert moved == {"predict_grid.upload_direct_bytes": _upload_bytes(
        task, s["dem"], task.yt_aux.shape[-1], land)}
    assert pred._ring.nbytes == 0


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunk2"])
@pytest.mark.parametrize("upload_dtype", [None, "bfloat16", "float16"])
def test_predict_grid_through_the_ring_is_bitwise_the_direct_upload(setting, monkeypatch,
                                                                   chunk, upload_dtype):
    """``predict_grid`` with its inputs sent through a ring of small slabs
    (forced on the CPU) gives the maps of the direct upload bit for bit,
    and stages exactly the bytes the direct upload counts."""
    s = setting
    task = take(s["task"], [0, 1, 0, 1, 0])
    direct = tpredict._upload

    def run(ring):
        monkeypatch.setattr(tpredict, "_upload",
                            lambda t, tg, dev, dt, _: direct(t, tg, dev, dt, ring))
        pred = Predictor(s["model"], s["dp"], s["st_col"], batch_chunk=chunk,
                         upload_dtype=upload_dtype)
        before = spans.counters("predict_grid.upload")
        out = pred.predict_grid(task, s["dem"], aux_at_targets=s["aux"])
        after = spans.counters("predict_grid.upload")
        return out, {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}

    want, direct_count = run(None)
    got, staged_count = run(staging.StagingRing(slab_bytes=SLAB, n_slabs=3))
    land = np.flatnonzero(~np.isnan(s["dem"].data))
    sent = _upload_bytes(task, s["dem"], task.yt_aux.shape[-1], land, upload_dtype)
    assert direct_count == {"predict_grid.upload_direct_bytes": sent}
    assert staged_count == {"predict_grid.upload_staged_bytes": sent}
    for key in want:
        assert got[key].data.tobytes() == want[key].data.tobytes(), key


def test_ar_sample_grid_fields(setting):
    s = setting
    out = s["pred"].ar_sample_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=2,
                                   subsample_factor=8, n_blocks=3)
    assert out.shape == (2, 2, 48, 48)
    sea = np.isnan(s["dem"].data)
    assert np.isnan(out[:, :, sea]).all() and np.isfinite(out[:, :, ~sea]).all()
    assert not np.allclose(out[0][:, ~sea], out[1][:, ~sea])
    again = s["pred"].ar_sample_grid(s["task"], s["dem"], aux_at_targets=s["aux"], n_samples=2,
                                     subsample_factor=8, n_blocks=3)
    np.testing.assert_array_equal(again, out)


@pytest.mark.parametrize("kw", [dict(subsample_factor=8, n_blocks=3),
                                dict(subsample_factor=5, n_blocks=4, unnormalise=False)])
def test_ar_sample_grid_mean_feedback_matches_jax(setting, monkeypatch, kw):
    """With both gnp heads' ``sample`` returning the mean and both visit
    orders the identity, the AR chain is deterministic: the port's field
    (coarse-grid aux, chain, upsampling, unnormalisation, sea mask) equals
    JAX's."""
    s = setting
    monkeypatch.setattr(jlik.LowRankGaussian, "sample",
                        lambda self, raw, rng, n: self.mean_std(raw)[0][None])
    monkeypatch.setattr(tlik.LowRankGaussian, "sample",
                        lambda self, raw, gen, n: self.mean_std(raw)[0][None])
    monkeypatch.setattr(jax.random, "permutation", lambda key, m: jax.numpy.arange(m))
    monkeypatch.setattr(torch, "randperm",
                        lambda m, generator=None, device=None: torch.arange(m, device=device))
    jar._chain_fn.cache_clear()  # no chain traced with the real sampler
    try:
        jp = JPredictor(s["jpred"].model, s["jpred"].params, s["jpred"].dp, s["st_col"],
                        std_scale=1.4)
        tp = Predictor(s["model"], s["dp"], s["st_col"], std_scale=1.4)
        a = jp.ar_sample_grid(s["jtask"], s["jdem"], aux_at_targets=s["jaux"], **kw)
        b = tp.ar_sample_grid(s["task"], s["dem"], aux_at_targets=s["aux"], **kw)
    finally:
        jar._chain_fn.cache_clear()
    assert b.shape == a.shape == (1, 2, 48, 48)
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * float(np.nanmax(np.abs(a))))


def test_interpolation_helpers_match_jax(rng, setting):
    old = np.sort(rng.uniform(-1, 1, 9))[::-1]
    new = np.concatenate([rng.uniform(-1.2, 1.2, 15), old[:3]])
    np.testing.assert_array_equal(tpredict._linear_interp_weights(old, new),
                                  jpredict._linear_interp_weights(old, new))
    f = setting["aux"]
    x1, x2 = rng.uniform(-0.1, 1.1, 40), rng.uniform(-0.1, 1.1, 40)
    np.testing.assert_array_equal(t_interp_grid_at_points(f, x1, x2),
                                  interp_grid_at_points(setting["jaux"], x1, x2))


# -- host-side copies against their JAX originals ------------------------------------


@pytest.mark.parametrize("density,margin,multiple", [(500, 0.1, 16), (40, 0.05, 8), (33.3, 0.0, 16)])
def test_internal_grid_matches_jax(density, margin, multiple):
    a = jgrids.internal_grid((0.0, 1.0), (-0.2, 0.7), density, margin, multiple)
    b = tgrids.internal_grid((0.0, 1.0), (-0.2, 0.7), density, margin, multiple)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert jgrids.default_lengthscale(density) == tgrids.default_lengthscale(density)


def test_field_ops_match_jax(rng):
    data = rng.normal(size=(3, 10, 9))
    data[:, 2:4, 5] = np.nan
    coords = {"time": np.arange(3), "latitude": np.linspace(-40, -35, 10)[::-1],
              "longitude": np.linspace(170, 175, 9)}
    jf = jgrid.Field(data, ("time", "latitude", "longitude"), coords, "t")
    tf = Field(data, ("time", "latitude", "longitude"), coords, "t")
    new = np.linspace(-41, -34, 13)
    pairs = [
        (jf.coarsen(2), tf.coarsen(2)),
        (jf.fillna(0.5), tf.fillna(0.5)),
        (jf.rename("u"), tf.rename("u")),
        (jf._interp_one("latitude", new, "linear"), tf._interp_one("latitude", new, "linear")),
        (jf._interp_one("longitude", new + 210, "nearest"),
         tf._interp_one("longitude", new + 210, "nearest")),
    ]
    for a, b in pairs:
        assert (b.name, b.dims, b.shape) == (a.name, a.dims, a.shape)
        np.testing.assert_array_equal(b.data, a.data)
        for d in a.coords:
            np.testing.assert_array_equal(b.coords[d], a.coords[d])
    ds = Dataset([tf, tf.rename("v")])
    assert list(ds) == ["t", "v"] and ds["v"].name == "v"


def test_processor_json_roundtrip_matches_jax(tmp_path, rng):
    jdp = JProcessor()
    jdp.set_coord_maps_from_extent(-47.95, -34.05, 165.75, 178.7)
    jdp.config = {"t": {"method": "mean_std", "params": {"mean": 11.0, "std": 4.0}},
                  "h": {"method": "min_max", "params": {"min": 0.0, "max": 100.0}},
                  "p": {"method": "positive_semidefinite", "params": {"std": 2.5}}}
    jdp.save(str(tmp_path / "dp.json"))
    dp = DataProcessor.load(str(tmp_path / "dp.json"))
    lat = rng.uniform(-48, -34, 20)
    np.testing.assert_array_equal(dp.map_x1(lat), jdp.map_x1(lat))
    np.testing.assert_array_equal(dp.map_x2(lat + 210), jdp.map_x2(lat + 210))
    np.testing.assert_array_equal(dp.unmap_x1(lat), jdp.unmap_x1(lat))
    v = rng.normal(size=7)
    for name in jdp.config:
        for inverse in (False, True):
            np.testing.assert_array_equal(dp._apply_values(name, v, inverse),
                                          jdp._apply_values(name, v, inverse))
    dp.save(str(tmp_path / "again.json"))
    assert JProcessor.load(str(tmp_path / "again.json")).to_dict() == jdp.to_dict()


def test_pad_points_and_task_conversion_match_jax(rng, setting):
    x = rng.random((5, 2)).astype(np.float32)
    y = rng.normal(size=(5, 1)).astype(np.float32)
    y[2] = np.nan
    for a, b in zip(jtaskmod.pad_points(x, y, 8), ttaskmod.pad_points(x, y, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ttaskmod.pad_points(x, y, 4)
    jt, t = setting["jtask"], setting["task"]
    assert t.batch_size == jt.batch_size and t.num_targets == jt.num_targets
    np.testing.assert_array_equal(t.points[0].x.numpy(), np.asarray(jt.points[0].x))
    np.testing.assert_array_equal(t.grids[0].y.numpy(), np.asarray(jt.grids[0].y))
    moved = t.to("cpu")
    assert moved.grids[0].mask is None or moved.grids[0].mask.dtype == torch.float32
