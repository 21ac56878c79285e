"""The port's ``Validate`` against the JAX package's for the other heads and
for two target channels, on run dicts built in memory (no training).

Heads: ``gnp`` on temperature, ``bernoulli-gamma`` on precipitation (with
``wet_dry_skill`` and its base-field baseline) and ``cnp-spikes-beta`` on
humidity (its post-transform included): synthetic winter data (wet enough
for the Gamma body) → the JAX ``PreprocessForDownscaling`` → the JAX
``Train`` loader (stations as context) and its initial parameters, which
the port gets through ``params_from_jax``, with the loader pickled and read
by ``load_task_loader`` and the processor through its JSON file. Two
channels: tests/test_validate_multichannel.py's joint u+v wind run.

Tolerances: metrics of the float32 forward to rtol 1e-4 (absolute 1e-4
near 0); coverages to 1/n; the closed-form CRPS to rtol 1e-5. The PIT of
the mixed heads: ``cnp-spikes-beta`` to 5e-3, since the JAX package's
float32 ``betainc`` under jit is off the float64 value by up to ~6e-5,
which moves z near the tails by ~1e-3 (as ``fit_std_scale`` in
tests/test_torch_pipeline.py); ``bernoulli-gamma`` to 1e-3 (float32
``gammainc`` against ``lax.igamma``, ~1e-5 apart). The sampled CRPS of the
mixed heads, on the same fixed samples on both sides (threefry and Philox
differ), to rtol 1e-4.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.grid import Dataset as JDataset
from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_base_grid, synthetic_dem, synthetic_stations
from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.pipeline import validate as jvalidate
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train
from deepsensornz_tpu.task.loader import TaskLoader as JTaskLoader
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.pipeline import validate as tvalidate
from deepsensornz_tpu_torch.pipeline.validate import load_task_loader
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

pd = pytest.importorskip("pandas")

MODEL = dict(unet_channels=(8, 8), compute_dtype="float32", decoder_channels=8, mlp_hidden=8)
HEADS = {"gnp": "temperature", "bernoulli-gamma": "precipitation",
         "cnp-spikes-beta": "humidity"}
PIT_RTOL = {"gnp": 1e-4, "bernoulli-gamma": 1e-3, "cnp-spikes-beta": 5e-3}
STD_SCALE = 0.8


def _port_run(jrun: dict, tmp_path) -> dict:
    """The port's run dict of a JAX one: the loader through its pickle, the
    processor through its JSON file, the parameters through
    ``params_from_jax``."""
    with open(tmp_path / "task_loader.pkl", "wb") as f:
        pickle.dump(jrun["task_loader"], f)
    jrun["data_processor"].save(str(tmp_path / "data_processor.json"))
    tl = load_task_loader(str(tmp_path / "task_loader.pkl"))
    jcfg = jrun["model"].cfg
    example = TaskBatch.from_numpy(jrun["example"])
    model = ConvNP.from_task(ConvNPConfig.from_dict(dataclasses.asdict(jcfg)), example)
    model.load_state_dict(params_from_jax(jax.device_get(jrun["params"]), model.cfg.upsample),
                          strict=True)
    return {"model": model.eval(), "params": model.state_dict(), "task_loader": tl,
            "data_processor": DataProcessor.load(str(tmp_path / "data_processor.json")),
            "metadata": {}, "variable": jrun["variable"], "std_scale": jrun["std_scale"]}


@pytest.fixture(scope="module")
def head_runs(tmp_path_factory):
    """{likelihood: (JAX Validate, port Validate, times, raw base, raw stations)}."""
    out = {}
    for likelihood, variable in HEADS.items():
        dem = synthetic_dem(48, 48, seed=0)
        base = synthetic_base_grid(variable, n_times=6, n_lat=16, n_lon=16, start="2000-07-01",
                                   seed=1)
        stations = synthetic_stations(base, dem, variable, 16, seed=2)
        bundle = PreprocessForDownscaling(variable).run_processing_sequence(
            dem, {variable: base}, stations, highres_factor=2, lowres_factor=4)
        tr = Train(bundle)
        tl = tr.setup_task_loader(station_as_context="all", internal_density=24)
        tr.initialise_model(likelihood=likelihood, rank=4, **MODEL)
        times = list(tr.task_times())
        jrun = {"model": tr.model, "params": tr.params, "task_loader": tl,
                "data_processor": bundle["data_processor"], "metadata": {},
                "variable": variable, "std_scale": STD_SCALE,
                "example": tl(times[:1], seed_override=0)}
        run = _port_run(jrun, tmp_path_factory.mktemp(likelihood))
        out[likelihood] = (jvalidate.Validate(run=jrun), tvalidate.Validate(run=run), times,
                           base, stations)
    return out


@pytest.fixture(scope="module")
def wind(tmp_path_factory):
    """A dim_yt=2 (joint u+v) run, as tests/test_validate_multichannel.py
    builds it."""
    rng = np.random.default_rng(0)
    n_times, n_st = 6, 24
    dem = synthetic_dem(48, 48, seed=0)
    u_base = synthetic_base_grid("10m_u_component_of_wind", n_times, 16, 16, seed=1)
    v_base = synthetic_base_grid("10m_v_component_of_wind", n_times, 16, 16, seed=5)
    land = np.argwhere(~np.isnan(dem.data))
    pick = land[rng.choice(len(land), size=n_st, replace=False)]
    lats = dem.coords["latitude"][pick[:, 0]]
    lons = dem.coords["longitude"][pick[:, 1]]
    li = np.abs(u_base.coords["latitude"][None] - lats[:, None]).argmin(1)
    lo = np.abs(u_base.coords["longitude"][None] - lons[:, None]).argmin(1)
    u = u_base.data[:, li, lo]
    v = v_base.data[:, li, lo]
    stations = pd.DataFrame({
        "time": np.repeat(u_base.coords["time"], n_st),
        "latitude": np.tile(lats, n_times), "longitude": np.tile(lons, n_times),
        "station_id": np.tile(np.arange(n_st), n_times),
        # distinct scales per component: a stats mix-up between channels is loud
        "u_station": (u + rng.normal(0, 0.2, u.shape)).ravel(),
        "v_station": (5.0 * v + rng.normal(0, 1.0, v.shape)).ravel()})
    jdp = JProcessor()
    jdp.set_coord_maps_from_extent(dem.coords["latitude"].min(), dem.coords["latitude"].max(),
                                   dem.coords["longitude"].min(), dem.coords["longitude"].max())
    st_n = jdp(stations, method="mean_std")
    tl = JTaskLoader(
        context=[JDataset({"u10": jdp(u_base, method="mean_std"),
                           "v10": jdp(v_base, method="mean_std")}), st_n],
        target=st_n, aux_at_targets=jdp(dem.fillna(0.0).rename("elevation"), method="min_max"),
        context_sampling=["all", "split"], target_sampling="split", links=[(1, 0)],
        internal_density=24, grid_multiple=8)
    model = JConvNP(JConfig(likelihood="cnp", internal_density=24, dim_yt=2, **MODEL))
    times = list(u_base.coords["time"])
    example = tl(times[:2], seed_override=0)
    jrun = {"model": model, "params": model.init(jax.random.key(0), example), "task_loader": tl,
            "data_processor": jdp, "metadata": {}, "variable": "wind", "std_scale": 1.3,
            "example": example}
    run = _port_run(jrun, tmp_path_factory.mktemp("wind"))
    return jvalidate.Validate(run=jrun), tvalidate.Validate(run=run), times


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, equal_nan=True)


def _same_summary(got: dict, want: dict, rtol=1e-4):
    assert got["n"] == want["n"] > 0
    _close([got["z_mean"], got["z_std"]], [want["z_mean"], want["z_std"]], rtol=rtol, atol=rtol)
    for key in ("coverage_95", "coverage_68"):
        assert abs(got[key] - want[key]) <= 1.0 / want["n"] + 1e-12, key


@pytest.mark.parametrize("likelihood", list(HEADS))
def test_loss_and_calibration_match_jax(head_runs, likelihood):
    jv, v, times, _, stations = head_runs[likelihood]
    held = [str(i) for i in sorted(stations["station_id"].unique())[:3]]
    a = jv.calculate_loss(times, held)
    b = v.calculate_loss(times, held)
    for key in ("rmse", "mae", "bias"):
        _close(b[key], a[key])
    np.testing.assert_array_equal(np.isnan(b["pred_mean"]), np.isnan(a["pred_mean"]))
    _close(b["pred_mean"], a["pred_mean"], atol=1e-4 * float(np.nanmax(np.abs(a["obs"]))))
    _close(b["obs"], a["obs"], rtol=1e-12, atol=0.0)
    _same_summary(v.calibration_stats(times, held), jv.calibration_stats(times, held))


@pytest.mark.parametrize("likelihood", list(HEADS))
def test_pit_stats_match_jax(head_runs, likelihood):
    jv, v, times, _, _ = head_runs[likelihood]
    a = jv.pit_stats(times, seed=4, return_samples=True)
    b = v.pit_stats(times, seed=4, return_samples=True)
    _same_summary(b, a, rtol=PIT_RTOL[likelihood])
    assert b["z"].shape == a["z"].shape


@pytest.mark.parametrize("likelihood", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_sampled_crps_matches_jax_on_fixed_samples(head_runs, monkeypatch, likelihood):
    """Both heads' ``sample`` return the same fixed samples (point masses
    included), so both energy forms see one sample set."""
    jv, v, times, _, _ = head_runs[likelihood]
    B, M, n = len(times), v.task_loader.target_capacity, 17
    r = np.random.default_rng(5).random((n, B, M, 1))
    xs = np.where(r < 0.3, 0.0, np.where(r > 0.9, 1.0, 3.0 * r)).astype(np.float32)
    jhead, thead = type(jlik.get_likelihood(likelihood)), type(tlik.get_likelihood(likelihood))
    monkeypatch.setattr(jhead, "sample", lambda self, raw, key, m: jnp.asarray(xs[:m]))
    monkeypatch.setattr(thead, "sample", lambda self, raw, gen, m: torch.from_numpy(xs[:m]))
    a = jv.crps(times, n_samples=n)
    b = v.crps(times, n_samples=n)
    assert b["n"] == a["n"] > 0
    _close(b["crps"], a["crps"], atol=0.0)


def test_gnp_crps_matches_jax(head_runs):
    jv, v, times, _, _ = head_runs["gnp"]
    a, b = jv.crps(times), v.crps(times)
    assert b["n"] == a["n"] > 0
    _close(b["crps"], a["crps"], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("likelihood", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_sampled_crps_is_seeded(head_runs, likelihood):
    """Unpatched, the port's mixed heads draw from a generator seeded with
    ``seed``: equal for one seed, different for another, positive."""
    _, v, times, _, _ = head_runs[likelihood]
    a, b, c = (v.crps(times[:2], n_samples=16, seed=s)["crps"] for s in (1, 1, 2))
    assert a == b != c and a > 0


def test_wet_dry_skill_matches_jax(head_runs):
    jv, v, times, base, stations = head_runs["bernoulli-gamma"]
    port_base = Field(base.data, base.dims, base.coords, base.name)
    a = jv.wet_dry_skill(times, base_field=base, station_df=stations)
    b = v.wet_dry_skill(times, base_field=port_base, station_df=stations)
    assert set(b) == set(a) >= {"baseline_brier", "baseline_hit_rate"}
    assert b["n"] == a["n"] > 0 and 0 < a["wet_frac_obs"] < 1
    assert (b["baseline_brier"], b["baseline_hit_rate"]) == (a["baseline_brier"],
                                                             a["baseline_hit_rate"])
    _close([b["brier"], b["hit_rate"], b["wet_frac_obs"]],
           [a["brier"], a["hit_rate"], a["wet_frac_obs"]], atol=1.0 / a["n"])
    no_base = v.wet_dry_skill(times, wet_threshold=0.5)
    assert no_base == pytest.approx(jv.wet_dry_skill(times, wet_threshold=0.5), rel=1e-4,
                                    abs=1.0 / a["n"])


def test_wet_dry_skill_needs_the_bernoulli_gamma_head(head_runs):
    _, v, times, _, _ = head_runs["gnp"]
    with pytest.raises(ValueError, match="bernoulli-gamma"):
        v.wet_dry_skill(times)


def test_two_channels_match_jax(wind):
    jv, v, times = wind
    a, b = jv.calculate_loss(times), v.calculate_loss(times)
    assert b["errors"].shape == a["errors"].shape and a["errors"].shape[-1] == 2
    assert set(b["per_channel"]) == set(a["per_channel"]) == {"u_station", "v_station"}
    for vid in a["per_channel"]:
        for key in ("rmse", "mae", "bias"):
            _close(b["per_channel"][vid][key], a["per_channel"][vid][key])
    _close(b["obs"], a["obs"], rtol=1e-12, atol=0.0)
    ca, cb = jv.calibration_stats(times), v.calibration_stats(times)
    _same_summary(cb, ca)
    for vid in ca["per_channel"]:
        _same_summary(cb["per_channel"][vid], ca["per_channel"][vid])
    pa, pb = jv.pit_stats(times), v.pit_stats(times)
    for vid in pa["per_channel"]:
        _same_summary(pb["per_channel"][vid], pa["per_channel"][vid])
    ra, rb = jv.crps(times), v.crps(times)
    for vid in ra["per_channel"]:
        _close(rb["per_channel"][vid], ra["per_channel"][vid], rtol=1e-5, atol=0.0)
    assert rb["per_channel"]["v_station"] > rb["per_channel"]["u_station"] > 0

    def lookup(lat, lon):
        return 250.0

    ea = jv.elevation_band_errors(times, elevation_lookup=lookup, errors=a["errors"], xt=a["xt"])
    eb = v.elevation_band_errors(times, elevation_lookup=lookup, errors=b["errors"], xt=b["xt"])
    assert set(eb["stations"]) == set(ea["stations"]) and eb["stations"]
    _close(eb["bands"]["Low (<500m)"], ea["bands"]["Low (<500m)"])
