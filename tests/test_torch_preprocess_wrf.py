"""The WRF base of the port's preprocessing and the processed-bundle cache
against the JAX package's, on the CPU.

A forecast run on a curvilinear grid (2-D latitude/longitude, sheared and
perturbed) over a synthetic DEM's extent: 30 hourly temperatures in
kelvin, as ``WRFSource.load`` returns them, the same arrays on both sides.
``PreprocessForDownscaling(base="wrf").run_processing_sequence`` with each
package's ``WRFSource`` as the regridder gives the same bundle bit for bit
(tests/test_torch_preprocess.py's comparison: every Field, the processor,
the station frame). ``save_processed_bundle`` / ``load_processed_bundle``:
a bundle written by either package loads in the other equal to the
writer's own reload; without pandas the port writes and reads its own
station-frame layout and refuses a pandas pickle with a reason.
"""

import os
import sys

import numpy as np
import pytest

from deepsensornz_tpu.data import grid as jgrid
from deepsensornz_tpu.data import synthetic as jsyn
from deepsensornz_tpu.data.sources import wrf as jwrf
from deepsensornz_tpu.pipeline import preprocess as jpre
from deepsensornz_tpu_torch.data import synthetic as syn
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.sources import wrf as twrf
from deepsensornz_tpu_torch.pipeline import preprocess as pre

from test_torch_preprocess import (assert_same_bundle, assert_same_dataset, assert_same_field,
                                   assert_same_frame)

N_TIMES = 30
SEQ = dict(highres_factor=2, lowres_factor=4)


def _wrf_arrays(dem, n_times=N_TIMES, ny=20, nx=18, seed=4):
    """(times, lat2d, lon2d, data in K) of a curvilinear run over the DEM."""
    lat, lon = dem.coords["latitude"], dem.coords["longitude"]
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx), indexing="ij")
    lat2d = lat.min() - 0.3 + (lat.max() - lat.min() + 0.6) * u + 0.4 * v \
        + 0.02 * rng.standard_normal((ny, nx))
    lon2d = lon.min() - 0.4 + (lon.max() - lon.min() + 0.6) * v + 0.3 * u \
        + 0.02 * rng.standard_normal((ny, nx))
    times = np.datetime64("2000-01-01T06", "s") + np.arange(n_times) * np.timedelta64(1, "h")
    data = (285 + 3 * np.sin(6 * u + 2 * v)[None] + rng.standard_normal((n_times, ny, nx))
            ).astype(np.float32)
    return times, lat2d, lon2d, data


def _wrf_field(mod, times, lat2d, lon2d, data):
    fld = mod.Field(data.copy(), ("time", "y", "x"), {"time": times.copy()}, "T2",
                    {"curvilinear": 1})
    fld.attrs["lat2d"], fld.attrs["lon2d"] = lat2d, lon2d
    return fld


@pytest.fixture(scope="module")
def inputs():
    jd, d = jsyn.synthetic_dem(96, 96, seed=0), syn.synthetic_dem(96, 96, seed=0)
    times, lat2d, lon2d, data = _wrf_arrays(d)
    base_kw = dict(n_times=N_TIMES, n_lat=24, n_lon=24, freq_hours=1, seed=1,
                   start="2000-01-01T06")
    js = jsyn.synthetic_stations(jsyn.synthetic_base_grid(**base_kw), jd, n_stations=20)
    s = syn.synthetic_stations(syn.synthetic_base_grid(**base_kw), d, n_stations=20)
    assert_same_frame(s, js)
    return dict(jd=jd, d=d, js=js, s=s, arrays=(times, lat2d, lon2d, data))


def _run(inputs, weights="", **seq):
    jsrc = jwrf.WRFSource("", weights_dir=weights)
    tsrc = twrf.WRFSource("", weights_dir=weights)
    jout = jpre.PreprocessForDownscaling("temperature", base="wrf").run_processing_sequence(
        inputs["jd"], {"temperature": _wrf_field(jgrid, *inputs["arrays"])}, inputs["js"],
        wrf_source=jsrc, **SEQ, **seq)
    out = pre.PreprocessForDownscaling("temperature", base="wrf").run_processing_sequence(
        inputs["d"], {"temperature": _wrf_field(pre, *inputs["arrays"])}, inputs["s"],
        wrf_source=tsrc, **SEQ, **seq)
    return out, jout


@pytest.mark.parametrize("seq", [dict(coarsen_factor=5),
                                 dict(coarsen_factor=2, include_time_of_year=True,
                                      time_of_year_freq="H", include_landmask=True,
                                      include_coordinates=True, test_norm=True)],
                         ids=["coarsen5", "coarsen2-all-options"])
def test_wrf_base_matches_jax(inputs, seq):
    out, jout = _run(inputs, **seq)
    assert_same_bundle(out, jout)
    t2m = out["raw"]["base"]["t2m"]
    assert t2m.dims == ("time", "latitude", "longitude") and len(t2m.coords["time"]) == N_TIMES
    land = np.isfinite(t2m.data)
    assert land.mean() > 0.9 and float(np.nanmean(t2m.data)) < 50.0  # K -> degC
    assert out["data_settings"]["base"] == "wrf"


def test_preprocess_wrf_alone_matches_jax(inputs, tmp_path):
    """``preprocess_wrf`` on its own, a Celsius field left as it is, and the
    regrid weights persisted by the port reused by the JAX regridder."""
    times, lat2d, lon2d, data = inputs["arrays"]
    for values in (data, data - np.float32(273.15)):
        jp = jpre.PreprocessForDownscaling("temperature", base="wrf")
        p = pre.PreprocessForDownscaling("temperature", base="wrf")
        jp.load_topography(inputs["jd"])
        p.load_topography(inputs["d"])
        wdir = str(tmp_path / "w")
        p.preprocess_wrf({"temperature": _wrf_field(pre, times, lat2d, lon2d, values)},
                         twrf.WRFSource("", weights_dir=wdir), coarsen_factor=3)
        jp.preprocess_wrf({"temperature": _wrf_field(jgrid, times, lat2d, lon2d, values)},
                          jwrf.WRFSource("", weights_dir=wdir), coarsen_factor=3)
        assert len(os.listdir(wdir)) == 1
        assert_same_dataset(p.base_ds, jp.base_ds, "base")
        assert_same_dataset(p._raw["base"], jp._raw["base"], "raw base")


def _same_loaded(got: dict, want: dict):
    """A bundle loaded by the port against the same files loaded by JAX."""
    assert set(got) == set(want)
    for key in ("base_ds", "aux_ds", "highres_aux_ds"):
        assert_same_dataset(got[key], want[key], key)
    if want["landmask_ds"] is None:
        assert got["landmask_ds"] is None
    else:
        assert_same_field(got["landmask_ds"], want["landmask_ds"], "landmask")
    assert got["data_processor"].to_dict() == want["data_processor"].to_dict()
    assert_same_frame(got["station_df"], want["station_df"])
    assert (got["data_settings"], got["date_info"], got["raw"]) == (
        want["data_settings"], want["date_info"], want["raw"])


@pytest.mark.parametrize("landmask", [True, False], ids=["landmask", "no-landmask"])
def test_bundle_cache_round_trips_both_ways(inputs, tmp_path, landmask):
    out, jout = _run(inputs, coarsen_factor=5, include_time_of_year=True,
                     include_landmask=landmask)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    pre.save_processed_bundle(out, pdir)
    jpre.save_processed_bundle(jout, jdir)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for d in (pdir, jdir):
        _same_loaded(pre.load_processed_bundle(d), jpre.load_processed_bundle(d))
    # each side's reload of the other's files equals its reload of its own
    _same_loaded(pre.load_processed_bundle(jdir), jpre.load_processed_bundle(pdir))
    again = pre.load_processed_bundle(pdir)
    assert isinstance(again["station_df"], StationFrame)
    for k in jout["base_ds"]:  # a file lists its variables by name
        assert_same_field(again["base_ds"][k], jout["base_ds"][k], ("reloaded base", k))


def test_bundle_cache_without_pandas(inputs, tmp_path, monkeypatch):
    out, jout = _run(inputs, coarsen_factor=5)
    jdir = str(tmp_path / "jax")
    jpre.save_processed_bundle(jout, jdir)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(RuntimeError, match="holds a pandas DataFrame"):
        pre.load_processed_bundle(jdir)
    pdir = str(tmp_path / "port")
    pre.save_processed_bundle(out, pdir)
    back = pre.load_processed_bundle(pdir)
    assert isinstance(back["station_df"], StationFrame)
    assert back["station_df"].columns == out["station_df"].columns
    for c in out["station_df"].columns:
        np.testing.assert_array_equal(back["station_df"][c], out["station_df"][c])
