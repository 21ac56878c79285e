"""The port's ``Validate`` against the JAX package's, on one run directory.

The run (as ``tests/test_pipeline.py`` makes it, smaller): synthetic data →
``PreprocessForDownscaling`` (time of year) → ``Train`` (cnp head, float32,
stations as context, one epoch) → ``train_model(model_dir=...)``, which
fits ``std_scale`` and writes the directory the JAX ``Validate`` and the
port's ``Validate(model_dir, device="cpu")`` both read. Each metric runs on
the same dates with the same holdout on both sides.

Tolerances: tasks and every metric built from host arithmetic alone (the
base-field baselines, the region and date-range station lists) are equal;
metrics of the model's float32 forward (summed in other orders) agree to
rtol 1e-4 (absolute 1e-4 for values near 0, such as a bias or z_mean);
coverages, shares of |z| under a threshold, to 1/n, since one z near 1.96
can cross it on a float32 difference; the closed-form CRPS to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from deepsensornz_tpu.config import station_registry as jstation_registry
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.pipeline import validate as jvalidate
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.pipeline import validate as tvalidate

pd = pytest.importorskip("pandas")

RTOL, ATOL = 1e-4, 1e-4


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
    jv = jvalidate.Validate(model_dir)
    v = tvalidate.Validate(model_dir, device="cpu")
    times = list(base.coords["time"][:4])
    ids = sorted(stations["station_id"].unique())
    return {"jv": jv, "v": v, "times": times, "held": [str(i) for i in ids[:4]],
            "base": base, "port_base": Field(base.data, base.dims, base.coords, base.name),
            "dem": dem, "stations": stations, "model_dir": model_dir}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, equal_nan=True)


def _same_summary(got: dict, want: dict, rtol=RTOL):
    """z-summaries: moments to ``rtol``, coverages to 1/n, n equal."""
    assert got["n"] == want["n"] > 0
    _close([got["z_mean"], got["z_std"]], [want["z_mean"], want["z_std"]], rtol=rtol, atol=rtol)
    for key in ("coverage_95", "coverage_68"):
        assert abs(got[key] - want[key]) <= 1.0 / want["n"] + 1e-12, key


@pytest.mark.parametrize("holdout", [False, True])
def test_calculate_loss_matches_jax(run, holdout):
    held = run["held"] if holdout else ()
    a = run["jv"].calculate_loss(run["times"], remove_stations=held)
    b = run["v"].calculate_loss(run["times"], remove_stations=held)
    assert set(b) == set(a)
    for key in ("rmse", "mae", "bias"):
        _close(b[key], a[key])
    assert set(b["per_channel"]) == set(a["per_channel"]) == {"dry_bulb_station"}
    for key in ("rmse", "mae", "bias"):
        _close(b["per_channel"]["dry_bulb_station"][key], a["per_channel"]["dry_bulb_station"][key])
    np.testing.assert_array_equal(b["xt"], np.asarray(a["xt"]))
    np.testing.assert_array_equal(np.isnan(b["errors"]), np.isnan(a["errors"]))
    for key in ("errors", "pred_mean", "obs"):
        assert b[key].shape == a[key].shape
        _close(b[key], a[key], atol=RTOL * float(np.nanmax(np.abs(a["obs"]))))


def test_holdout_stations_removed_from_context(run):
    """The held-out stations are absent from the station context points and
    still among the targets; the loader's own context comes back intact and
    the tasks are the JAX package's, leaf for leaf."""
    v, held, times = run["v"], run["held"], run["times"]
    tl = v.task_loader
    before = tl.context
    task = v._make_tasks(times, held)
    assert tl.context == before and all(a is b for a, b in zip(tl.context, before))
    jtask = run["jv"]._make_tasks(times, held)
    np.testing.assert_array_equal(task.points[0].x.numpy(), np.asarray(jtask.points[0].x))
    np.testing.assert_array_equal(task.points[0].mask.numpy(), np.asarray(jtask.points[0].mask))
    np.testing.assert_array_equal(task.xt.numpy(), np.asarray(jtask.xt))
    frame = tl.target
    ids = frame["station_id"].astype(str)
    coords = np.stack([frame["x1"], frame["x2"]], -1).astype(np.float32)
    held_xy = {tuple(c) for c in coords[np.isin(ids, held)]}
    kept_xy = {tuple(c) for c in coords[~np.isin(ids, held)]}
    assert held_xy and not held_xy & kept_xy
    full = v._make_tasks(times)
    for t in range(len(times)):
        ctx = {tuple(x) for x in task.points[0].x[t][task.points[0].mask[t] > 0].numpy()}
        tgt = {tuple(x) for x in task.xt[t][task.yt_mask[t] > 0].numpy()}
        all_ctx = {tuple(x) for x in full.points[0].x[t][full.points[0].mask[t] > 0].numpy()}
        assert not ctx & held_xy
        assert tgt & held_xy == all_ctx & held_xy != set()
        assert ctx == all_ctx - held_xy
    assert torch.equal(task.xt, full.xt) and torch.equal(task.yt_mask, full.yt_mask)


def test_holdout_changes_the_predictions(run):
    """Held-out stations leave the context, so the predictions at them move."""
    a = run["v"].get_predictions(run["times"])
    b = run["v"].get_predictions(run["times"], remove_stations=run["held"])
    assert not np.allclose(a["mean"][a["mask"]], b["mean"][b["mask"]])


def test_elevation_band_errors_matches_jax(run):
    dem = run["dem"]

    def lookup(lat, lon):
        return float(dem.sel(latitude=lat, longitude=lon, method="nearest").data)

    a = run["jv"].elevation_band_errors(run["times"], elevation_lookup=lookup)
    b = run["v"].elevation_band_errors(run["times"], elevation_lookup=lookup)
    assert list(b["bands"]) == list(a["bands"])
    assert set(b["stations"]) == set(a["stations"]) and b["stations"]
    for label in a["bands"]:
        _close(b["bands"][label], a["bands"][label])
    for k, s in a["stations"].items():
        assert b["stations"][k]["band"] == s["band"]
        assert b["stations"][k]["elevation"] == s["elevation"]
    # a precomputed error set, passed in, is banded as it is
    loss = run["v"].calculate_loss(run["times"])
    c = run["v"].elevation_band_errors(None, elevation_lookup=lookup, errors=loss["errors"],
                                       xt=loss["xt"])
    assert c == b


def test_registry_lookup_is_the_default_band_source(run):
    """The synthetic stations are not in the registry: the default lookup
    bands none of them, on both sides."""
    a = run["jv"].elevation_band_errors(run["times"])
    b = run["v"].elevation_band_errors(run["times"])
    assert b == a == {"bands": {k: [] for k in a["bands"]}, "stations": {}}


@pytest.mark.parametrize("as_frame", [False, True])
def test_base_baselines_match_jax(run, as_frame):
    """The base field at the stations, host arithmetic only: equal to the
    JAX values, from a DataFrame or a StationFrame, dates as datetime64 of
    any unit."""
    st = run["stations"]
    sel = st[st["time"].isin(run["times"])]
    port_sel = StationFrame.from_pandas(sel) if as_frame else sel
    port_st = StationFrame.from_pandas(st) if as_frame else st
    a = run["jv"].calculate_loss_base(run["base"], sel)
    b = run["v"].calculate_loss_base(run["port_base"], port_sel)
    assert b == a and a["n"] > 0
    dates = [np.datetime64(t, "D") for t in run["times"]]
    a = run["jv"].per_station_loss_base(run["base"], st, dates=dates)
    b = run["v"].per_station_loss_base(run["port_base"], port_st, dates=dates)
    assert b == a and a["n_stations"] > 0
    assert run["v"].per_station_loss_base(run["port_base"], port_st) == \
        run["jv"].per_station_loss_base(run["base"], st)
    assert list(run["v"]._base_errors_at_stations(run["port_base"], port_sel)) == \
        list(run["jv"]._base_errors_at_stations(run["base"], sel))


def test_calibration_stats_matches_jax(run):
    for held in ((), run["held"]):
        _same_summary(run["v"].calibration_stats(run["times"], held),
                      run["jv"].calibration_stats(run["times"], held))


def test_pit_stats_matches_jax(run):
    """The same u from ``np.random.default_rng(seed)`` on both sides; the
    cnp head's CDF is float32 ndtr on both."""
    for held in ((), run["held"]):
        a = run["jv"].pit_stats(run["times"], held, seed=3, return_samples=True)
        b = run["v"].pit_stats(run["times"], held, seed=3, return_samples=True)
        _same_summary(b, a)
        assert b["z"].shape == a["z"].shape
        _close(b["z"], a["z"], atol=1e-3)


def test_crps_matches_jax(run):
    for held in ((), run["held"]):
        a = run["jv"].crps(run["times"], held)
        b = run["v"].crps(run["times"], held)
        assert b["n"] == a["n"] > 0 and "per_channel" not in b
        _close(b["crps"], a["crps"], rtol=1e-5, atol=0.0)


def test_extrapolation_loss_matches_jax(run):
    st = run["stations"]
    lats = st["latitude"].unique()
    lat_range = (float(lats.min()) - 1e-6, float(np.median(lats)))
    held = run["v"].stations_in_region(lat_range=lat_range)
    assert held == run["jv"].stations_in_region(lat_range=lat_range)
    assert 0 < len(held) < st["station_id"].nunique()
    assert run["v"]._target_station_coords() == run["jv"]._target_station_coords()
    a = run["jv"].extrapolation_loss(run["times"], lat_range=lat_range)
    b = run["v"].extrapolation_loss(run["times"], lat_range=lat_range)
    assert b["held_out_stations"] == a["held_out_stations"] == held
    np.testing.assert_array_equal(b["holdout_mask"], a["holdout_mask"])
    for part in ("extrapolation", "interpolation"):
        assert b[part]["n"] == a[part]["n"] > 0
        for key in ("rmse", "mae", "bias"):
            _close(b[part][key], a[part][key])
    with pytest.raises(ValueError, match="no target stations"):
        run["v"].extrapolation_loss(run["times"], lat_range=(10.0, 11.0))


def test_extrapolation_by_elevation_band_matches_jax(run):
    def lookup(lat, lon):
        return 1000.0 * (np.sin(lat * 37.0) * 0.5 + 0.5)

    kw = dict(elevation_range=(500.0, None), elevation_lookup=lookup)
    held = run["v"].stations_in_region(**kw)
    assert held == run["jv"].stations_in_region(**kw)
    assert 0 < len(held) < len(run["v"]._target_station_coords())
    a = run["jv"].extrapolation_loss(run["times"][:2], **kw)
    b = run["v"].extrapolation_loss(run["times"][:2], **kw)
    for part in ("extrapolation", "interpolation"):
        assert b[part]["n"] == a[part]["n"]
        _close(b[part]["rmse"], a[part]["rmse"])


@pytest.mark.parametrize("stats", [
    {"z_std": 1.0, "coverage_95": 0.95}, {"z_std": 0.12, "coverage_95": 1.0},
    {"z_std": 1.0, "coverage_95": 1.0}, {"z_std": np.nan, "coverage_95": 0.95}, {}])
def test_calibration_gate_matches_jax(stats):
    assert tvalidate.Validate.calibration_gate(stats) == jvalidate.Validate.calibration_gate(stats)


def test_stations_in_date_range_matches_jax(run):
    st = run["stations"]
    t = sorted(st["time"].unique())
    # drop one station's first row so it does not cover the whole range
    first = st["station_id"].iloc[0]
    st = st[~((st["station_id"] == first) & (st["time"] == t[0]))]
    for rng_ in ([t[0], t[-1]], [t[1], t[3]], [str(t[2])[:10]]):
        want = run["jv"].stations_in_date_range(st, rng_)
        for frame in (st, StationFrame.from_pandas(st)):
            assert run["v"].stations_in_date_range(frame, rng_) == want
    whole = run["v"].stations_in_date_range(st, [t[0], t[-1]])
    assert first not in whole and 0 < len(whole) < st["station_id"].nunique()


def test_helpers_match_jax(rng):
    m = rng.random((3, 4))
    s = rng.random((3, 4))
    for got, want in zip(tvalidate.humidity_post_transform(m, s),
                         jvalidate.humidity_post_transform(m, s)):
        np.testing.assert_array_equal(got, want)
    assert tvalidate.humidity_post_transform(m, None)[1] is None
    assert tvalidate.post_transform_for("humidity") is tvalidate.humidity_post_transform
    assert tvalidate.post_transform_for("temperature") is None
    for coord in (np.sort(rng.random(9)), np.sort(rng.random(9))[::-1], np.array([0.3])):
        q = rng.random(40) * 1.4 - 0.2
        np.testing.assert_array_equal(tvalidate._nearest_index(coord, q),
                                      jvalidate._nearest_index(coord, q))
    lookup, jlookup = tvalidate.registry_elevation_lookup(), jvalidate.registry_elevation_lookup()
    reg = list(jstation_registry().values())
    pts = [(e["latitude"], e["longitude"]) for e in reg[:20]]
    pts += [(la + 0.01, lo - 0.01) for la, lo in pts[:5]] + [(-44.0, 160.0), (-41.0, 174.0)]
    assert [lookup(*p) for p in pts] == [jlookup(*p) for p in pts]
    assert lookup(-44.0, 160.0) is None and lookup(*pts[0]) is not None


@pytest.mark.parametrize("key", ["station_name", "station_id", "neither"])
def test_remove_stations_from_frame_matches_jax(rng, key):
    ids = rng.integers(0, 6, 30)
    df = pd.DataFrame({"time": np.datetime64("2020-01-01", "s") + ids.astype("timedelta64[h]"),
                       "v_station": rng.normal(size=30)})
    if key == "station_name":
        df[key] = [f"st{i}" for i in ids]
    elif key == "station_id":
        df[key] = ids
    for names in ([], ["st1", "st4"], [1, "4"], ["nope"]):
        want = jvalidate.remove_stations_from_frame(df, names)
        for frame in (df, StationFrame.from_pandas(df)):
            got = tvalidate.remove_stations_from_frame(frame, names)
            assert isinstance(got, StationFrame) and got.columns == list(want.columns)
            for c in want.columns:
                np.testing.assert_array_equal(got[c], want[c].to_numpy())


def test_validate_defaults_to_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvalidate.Validate(run["model_dir"])
    v = tvalidate.Validate(run=run["v"].run)  # a loaded run keeps its device
    assert v.predictor.device.type == "cpu"
