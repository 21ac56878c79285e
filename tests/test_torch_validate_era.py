"""The port's ``ValidateERA``/``ValidateWRF`` and the ``Predictor`` transfer
modes against the JAX package's, on one run directory the JAX package
trained (synthetic data with time-of-year channels, cnp head, stations as
context, one epoch).

Tolerances (fields on the prediction grid):
- float32 transfer: rtol 1e-4 with an atol of 1e-5 times the field's
  largest magnitude (float32 forwards in other summation orders);
- ``transfer_dtype="float16"``/``"bfloat16"``: each side rounds its float32
  map, which may land one step apart: one unit in the last place (2^-10 or
  2^-7 of the value) plus the float32 tolerance, in normalised units
  (``unnormalise=False``);
- ``"int16"``/``"int8"``: one quantum (the per-(task, channel) step,
  range/(2^b - 1)) plus the float32 tolerance, for the same reason;
- ``upload_dtype="float16"``: both sides round the same inputs the same
  way, so the float32 tolerance;
- ``download_threads=8`` against 1: bitwise.
"""

import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer.predict import Predictor as JPredictor
from deepsensornz_tpu.pipeline import validate as jvalidate
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.perf import spans
from deepsensornz_tpu_torch.pipeline import validate as tvalidate

pd = pytest.importorskip("pandas")

ULP = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}
LEVELS = {"int16": 2 ** 16 - 1, "int8": 2 ** 8 - 1}


def _port(f) -> Field:
    return Field(f.data, f.dims, f.coords, f.name, dict(f.attrs))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    out = PreprocessForDownscaling(variable="temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4,
        include_time_of_year=True)
    tr = Train(out)
    tr.setup_task_loader(station_as_context="all", internal_density=24)
    tr.initialise_model(unet_channels=(8, 8), likelihood="cnp", compute_dtype="float32",
                        decoder_channels=8, mlp_hidden=8)
    model_dir = str(tmp_path_factory.mktemp("run") / "model")
    tr.train_model(n_epochs=1, batch_size=4, lr=1e-3, model_dir=model_dir, verbose=False)
    jera = jvalidate.ValidateERA(model_dir, dem, highres_factor=2)
    era = tvalidate.ValidateERA(model_dir, _port(dem), highres_factor=2, device="cpu")
    times = base.coords["time"][2:7]
    return {"jera": jera, "era": era, "times": times, "base": base, "dem": dem,
            "stations": stations, "model_dir": model_dir}


def _assert_fields_close(got, want, tol=None):
    """Equal keys, coordinates and NaN cells; values within
    ``tol(want_data)`` (default: the float32 tolerance)."""
    assert set(got) == set(want)
    for key in want:
        a, b = got[key], want[key]
        assert a.dims == b.dims and a.shape == b.shape, key
        for d in b.dims:
            np.testing.assert_array_equal(a.coords[d], b.coords[d])
        np.testing.assert_array_equal(np.isnan(a.data), np.isnan(b.data))
        land = ~np.isnan(b.data)
        err = np.abs(a.data[land].astype(np.float64) - b.data[land])
        f32 = 1e-4 * np.abs(b.data[land]) + 1e-5 * float(np.abs(b.data[land]).max())
        bound = f32 if tol is None else f32 + tol(b.data)[land]
        assert (err <= bound).all(), (key, float((err - bound).max()))


def _raw_inputs(run, with_stations: bool):
    t = run["times"]
    st = run["stations"]
    return t, {"temperature": run["base"].sel(time=t)}, st[st["time"].isin(t)] if with_stations \
        else None


@pytest.mark.parametrize("stations,holdout", [(True, False), (False, False), (True, True)])
def test_predict_matches_jax(run, stations, holdout):
    times, fields, sdf = _raw_inputs(run, stations)
    held = [str(i) for i in sorted(run["stations"]["station_id"].unique())[:4]] if holdout else ()
    want = run["jera"].predict(times, fields, station_df=sdf, remove_stations=held)
    port_fields = {k: _port(f) for k, f in fields.items()}
    got = run["era"].predict(times, port_fields, station_df=sdf, remove_stations=held)
    _assert_fields_close(got, want)
    assert got["mean"].shape == (len(times), 24, 24)
    if sdf is not None:  # a StationFrame gives the same
        again = run["era"].predict(times, port_fields, station_df=StationFrame.from_pandas(sdf),
                                   remove_stations=held)
        np.testing.assert_array_equal(again["mean"].data, got["mean"].data)


def test_swapped_task_is_the_loaders_and_is_restored(run):
    """The empty station context and the swapped data leave the loader as
    it was; the time-of-year channels follow the requested times."""
    era = run["era"]
    tl = era.run["task_loader"]
    before = (tl.context, tl.target, tl.point_capacity, len(tl.x1g))
    times, fields, _ = _raw_inputs(run, False)
    task = era._swapped_task(times, {k: _port(f) for k, f in fields.items()})
    assert (tl.context, tl.target, tl.point_capacity, len(tl.x1g)) == before
    assert float(task.points[0].mask.sum()) == 0.0
    names = list(tl.context[0].keys())
    cos_d = task.grids[0].y[..., names.index("cos_D")]
    doy = (np.asarray(times, "datetime64[D]") - np.asarray(times, "datetime64[Y]")).astype(float)
    np.testing.assert_allclose(cos_d[:, 0, 0].numpy(), np.cos(2 * np.pi * doy / 366.0), atol=1e-6)


class _Source:
    """A forecast source as ``ValidateWRF`` uses one: ``load`` gives the
    base field in kelvin, ``regrid_to`` resamples it (nearest)."""

    def __init__(self, base, field_cls):
        self.base, self.field_cls = base, field_cls

    def load(self, filepaths, variables):
        assert list(filepaths) == ["cycle_00.nc"] and variables == ["temperature"]
        b = self.base
        return {"temperature": self.field_cls(b.data + 273.15, b.dims, b.coords, b.name,
                                              dict(b.attrs))}

    def regrid_to(self, field, lat, lon):
        return field._interp_one("latitude", lat, "nearest")._interp_one("longitude", lon,
                                                                          "nearest")


def test_validate_wrf_matches_jax(run):
    from deepsensornz_tpu.data.grid import Field as JField

    base = run["base"].sel(time=run["times"])
    jw = jvalidate.ValidateWRF(run["model_dir"], run["dem"], coarsen_factor=2)
    w = tvalidate.ValidateWRF(run["model_dir"], _port(run["dem"]), coarsen_factor=2, device="cpu")
    assert w.predictor is w._era.predictor
    want = jw.predict(["cycle_00.nc"], _Source(base, JField))
    got = w.predict(["cycle_00.nc"], _Source(base, Field))
    _assert_fields_close(got, want)
    np.testing.assert_array_equal(got["mean"].coords["time"], base.coords["time"])
    land = ~np.isnan(got["mean"].data)
    assert got["mean"].data[land].max() < 60  # converted from kelvin


def _predictors(run, **kw):
    jr, r = run["jera"].run, run["era"].run
    jp = JPredictor(jr["model"], jr["params"], jr["data_processor"],
                    jr["task_loader"].target_var_IDs, std_scale=jr["std_scale"], **kw)
    p = Predictor(r["model"], r["data_processor"], r["task_loader"].target_var_IDs,
                  std_scale=r["std_scale"], **kw)
    return jp, p


class _TaskOnly:
    """A predictor stand-in: ``ValidateERA.predict`` hands it the swapped task."""

    def predict_grid(self, task, *args, **kwargs):
        return task


def _grid_call(run, predictor, jax_side: bool, **kw):
    """``predictor.predict_grid`` on the task ``ValidateERA.predict`` builds
    from the raw inputs (with stations) on that side."""
    times, fields, sdf = _raw_inputs(run, True)
    era = run["jera"] if jax_side else run["era"]
    if not jax_side:
        fields = {k: _port(f) for k, f in fields.items()}
    saved, era.predictor = era.predictor, _TaskOnly()
    try:
        task = era.predict(times, fields, station_df=sdf)
    finally:
        era.predictor = saved
    return predictor.predict_grid(task, era.pred_grid,
                                  aux_at_targets=era.run["task_loader"].aux_at_targets,
                                  times=np.asarray(times), **kw)


def _quantum(levels):
    """One quantisation step of each (task, channel) map: its range over
    the land cells over ``levels``."""
    def tol(data):
        span = np.nanmax(data, axis=(1, 2), keepdims=True) - np.nanmin(data, axis=(1, 2),
                                                                         keepdims=True)
        return np.broadcast_to(span / levels, data.shape)
    return tol


def _recorded(fn):
    """``fn()`` with the perf recorder on, and the spans' count by name."""
    spans.clear()
    with spans.recording():
        out = fn()
    counts = {k: v["count"] for k, v in spans.snapshot().items()}
    spans.clear()
    return out, counts


@pytest.mark.parametrize("mode", [dict(), dict(transfer_dtype="float16"),
                                  dict(transfer_dtype="bfloat16"), dict(transfer_dtype="int16"),
                                  dict(transfer_dtype="int8"), dict(upload_dtype="float16"),
                                  dict(transfer_dtype="int16", batch_chunk=2,
                                       download_threads=3)],
                         ids=["f32", "f16", "bf16", "int16", "int8", "upload-f16", "chunked"])
def test_transfer_modes_match_jax(run, mode):
    jp, p = _predictors(run, **mode)
    want = _grid_call(run, jp, True, unnormalise=False)
    got, counts = _recorded(lambda: _grid_call(run, p, False, unnormalise=False))
    t = mode.get("transfer_dtype")
    tol = None
    if t in ULP:
        tol = lambda d: ULP[t] * np.abs(d)  # noqa: E731
    elif t in LEVELS:
        tol = _quantum(LEVELS[t])
    _assert_fields_close(got, want, tol)
    chunks = -(-got["mean"].data.shape[0] // mode.get("batch_chunk", 10**9))
    assert counts["predict_grid"] == counts["predict_grid.upload"] == 1
    assert counts["predict_grid.launch"] == counts["predict_grid.download"] == chunks
    if "batch_chunk" in mode:
        assert chunks > 1 and counts["predict_grid.maps"] == chunks + 1
        assert set(jp.last_timings) == {"upload_s", "overlap_s"}


@pytest.mark.parametrize("t", ["int16", "int8"])
def test_quantised_error_is_half_a_step(run, t):
    """Against the port's own float32 maps, in physical units: at most half
    a step (range/(2^b - 1)/2) per (task, channel) map, plus four float32
    roundings of the map's largest magnitude (the quantisation's and the
    dequantisation's arithmetic)."""
    _, p32 = _predictors(run)
    _, pq = _predictors(run, transfer_dtype=t)
    ref = _grid_call(run, p32, False)
    got = _grid_call(run, pq, False)
    eps = float(np.finfo(np.float32).eps)
    for key in ("mean", "std"):
        land = ~np.isnan(ref[key].data)
        bound = (_quantum(LEVELS[t])(ref[key].data) / 2
                 + 4 * eps * np.nanmax(np.abs(ref[key].data), axis=(1, 2), keepdims=True))
        err = np.abs(got[key].data.astype(np.float64) - ref[key].data)[land]
        assert (err <= bound[land]).all()
        assert err.max() > 0


@pytest.mark.parametrize("t", [None, "int16", "float16"])
def test_download_threads_are_bitwise_one_thread(run, t):
    """A chunked request (5 times in chunks of 2, the tail padded) with 8
    download threads against 1: the same bytes, samples included."""
    maps = []
    for threads in (1, 8):
        _, p = _predictors(run, transfer_dtype=t, batch_chunk=2, download_threads=threads)
        got, counts = _recorded(lambda: _grid_call(run, p, False, n_samples=2, seed=3))
        maps.append(got)
        chunks = -(-got["mean"].data.shape[0] // 2)
        assert counts["predict_grid.launch"] == counts["predict_grid.sample"] == chunks > 1
        assert counts["predict_grid.maps"] == chunks + 1
    for key in ("mean", "std", "samples"):
        assert maps[0][key].data.tobytes() == maps[1][key].data.tobytes(), key
    _, whole = _predictors(run, transfer_dtype=t)
    one, counts = _recorded(lambda: _grid_call(run, whole, False))
    assert counts["predict_grid.launch"] == 1
    _assert_fields_close({k: maps[1][k] for k in ("mean", "std")}, one,
                         _quantum(LEVELS["int16"]) if t == "int16" else
                         (lambda d: ULP["float16"] * np.abs(d)) if t else None)


def test_bad_modes_and_missing_grid_raise(run):
    r = run["era"].run
    for kw in (dict(transfer_dtype="int4"), dict(upload_dtype="int8"),
               dict(download_threads=0), dict(batch_chunk=0)):
        with pytest.raises(ValueError):
            Predictor(r["model"], r["data_processor"], "dry_bulb_station", **kw)
    with pytest.raises(ValueError, match="prediction grid"):
        tvalidate.ValidateERA(run=r)


def test_validate_era_defaults_to_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvalidate.ValidateERA(run["model_dir"], _port(run["dem"]), highres_factor=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvalidate.ValidateWRF(run["model_dir"], _port(run["dem"]))
