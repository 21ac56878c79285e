"""The port's archive readers (``data/sources``: ERA5, stations, DEM, WRF)
against the JAX package's on the same on-disk archives, on the CPU.

The fixtures and cases are tests/test_sources.py's: ERA5 year files, a
legacy-layout station archive with a corrupt file, a reference-schema
archive (per-variable subfolders, ``site name``/``agent_number``
attributes, scalar coordinate variables, a station without a height, wind
as speed and direction), DEMs and a WRF forecast cycle on a curvilinear
grid, all written in the test with the JAX writers. Every reader's output
equals the JAX reader's: Fields bitwise (data, dims, coordinates, name);
station frames through ``StationFrame.to_pandas`` with pandas'
``assert_frame_equal`` (dtypes and values exact); the skip counters,
registries, the index and the regrid weights equal, and the registry,
index and weight files written by either side read by the other.
"""

import json
import os
import warnings
from datetime import datetime

import numpy as np
import pandas as pd
import pytest

from deepsensornz_tpu.data.grid import Dataset, Field, open_dataset, save_dataset
from deepsensornz_tpu.data.sources import era5 as jera5
from deepsensornz_tpu.data.sources import stations as jst
from deepsensornz_tpu.data.sources import topography as jtopo
from deepsensornz_tpu.data.sources import wrf as jwrf
from deepsensornz_tpu_torch.data import grid as tgrid
from deepsensornz_tpu_torch.data.sources import era5 as tera5
from deepsensornz_tpu_torch.data.sources import stations as tst
from deepsensornz_tpu_torch.data.sources import topography as ttopo
from deepsensornz_tpu_torch.data.sources import wrf as twrf


def _same_field(got, want):
    assert got.dims == want.dims and got.name == want.name
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    assert set(got.coords) == set(want.coords)
    for d, c in want.coords.items():
        np.testing.assert_array_equal(got.coords[d], c)


def _same_frame(got, want):
    want = want.reset_index(drop=True)
    if len(want) == 0:
        assert len(got) == 0 and got.columns == list(want.columns)
        return
    pd.testing.assert_frame_equal(got.to_pandas(), want, check_exact=True)


def _port_field(f):
    return tgrid.Field(f.data, f.dims, f.coords, f.name, dict(f.attrs))


# -- ERA5 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def era5_archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("era5")
    os.makedirs(root / "temperature")
    lat = np.linspace(-34, -47, 6)
    lon = np.linspace(166, 178, 7)
    for year in (2000, 2001):
        t = np.datetime64(f"{year}-01-01", "s") + np.arange(48) * np.timedelta64(1, "h")
        data = np.random.default_rng(year).random((48, 6, 7))
        f = Field(data, ("time", "latitude", "longitude"),
                  {"time": t, "latitude": lat, "longitude": lon}, "t2m")
        save_dataset(Dataset([f]), str(root / "temperature" / f"t2m_{year}.nc"), float32=False)
    # a flat-layout file of the second year, overlapping the first's times
    f = Field(np.random.default_rng(5).random((24, 6, 7)), ("time", "latitude", "longitude"),
              {"time": np.datetime64("2001-01-01T12", "s") + np.arange(24)
               * np.timedelta64(1, "h"), "latitude": lat, "longitude": lon}, "t2m")
    save_dataset(Dataset([f]), str(root / "extra_t2m_2001.nc"), float32=False)
    return str(root)


def test_era5_load_years(era5_archive):
    src, jsrc = tera5.ERA5Source(era5_archive), jera5.ERA5Source(era5_archive)
    assert src.candidate_files("temperature", [2000, 2001]) == jsrc.candidate_files(
        "temperature", [2000, 2001])
    f = src.load("temperature", [2000, 2001])
    _same_field(f, jsrc.load("temperature", [2000, 2001]))
    t = f.coords["time"].astype("datetime64[s]")
    assert (np.diff(t) > np.timedelta64(0, "s")).all()  # sorted, deduplicated


def test_era5_load_time(era5_archive):
    want = np.datetime64("2000-01-01T05:00:00", "s") + np.arange(3) * np.timedelta64(1, "h")
    f = tera5.ERA5Source(era5_archive).load_time("temperature", want)
    _same_field(f, jera5.ERA5Source(era5_archive).load_time("temperature", want))
    np.testing.assert_array_equal(f.coords["time"].astype("datetime64[s]"), want)


def test_era5_windowed_load_reads_only_window(era5_archive):
    src = tera5.ERA5Source(era5_archive)
    want = np.datetime64("2001-01-01T10:00:00", "s") + np.arange(5) * np.timedelta64(1, "h")
    lazy = src.load_time("temperature", want)
    eager = src.load("temperature", [2000, 2001]).sel(time=want, method="nearest")
    np.testing.assert_array_equal(lazy.data, eager.data)
    _same_field(src.load("temperature", [2001], time_window=(want[0], want[-1])),
                jera5.ERA5Source(era5_archive).load("temperature", [2001],
                                                    time_window=(want[0], want[-1])))
    with pytest.raises(FileNotFoundError, match="none overlap"):
        src.load("temperature", [2001], time_window=("1990-01-01", "1990-02-01"))


def test_era5_transforms_match_jax(era5_archive):
    src, jsrc = tera5.ERA5Source(era5_archive), jera5.ERA5Source(era5_archive)
    f, jf = src.load("temperature", [2000]), jsrc.load("temperature", [2000])
    for var in ("temperature", "precipitation"):
        _same_field(src.hourly_to_daily(f, var), jsrc.hourly_to_daily(jf, var))
    got = src.kelvin_to_celsius(f)
    _same_field(got, jsrc.kelvin_to_celsius(jf))
    assert got.attrs["units"] == "°C"
    tgt = Field(np.zeros((9, 10)), ("latitude", "longitude"),
                {"latitude": np.linspace(-35, -46, 9), "longitude": np.linspace(167, 177, 10)},
                "elevation")
    _same_field(src.interpolate_to(f, _port_field(tgt)), jsrc.interpolate_to(jf, tgt))
    parts = [f.isel(time=np.arange(30, 48)), f.isel(time=np.arange(0, 36))]
    _same_field(tera5.concat_time(parts), jera5.concat_time([_port_field(p) for p in parts]))


def test_daily_resample_mean_and_sum():
    t = np.datetime64("2000-01-01", "s") + np.arange(48) * np.timedelta64(1, "h")
    data = np.random.default_rng(2).random((48, 2, 2))
    data[3, 0, 0] = np.nan
    f = Field(data, ("time", "latitude", "longitude"),
              {"time": t, "latitude": np.arange(2.0), "longitude": np.arange(2.0)}, "tp")
    for how in ("mean", "sum"):
        _same_field(tera5.daily_resample(_port_field(f), how), jera5.daily_resample(f, how))


def test_era5_missing_raises(era5_archive):
    with pytest.raises(FileNotFoundError):
        tera5.ERA5Source(era5_archive).load("humidity", [2000])


# -- stations -----------------------------------------------------------------


@pytest.fixture(scope="module")
def station_archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("stations")
    t = np.datetime64("2000-01-01", "s") + np.arange(96) * np.timedelta64(1, "h")
    rng = np.random.default_rng(0)
    for name, lat, lon, elev in [("alpha", -36.8, 174.7, 30.0), ("bravo", -41.3, 174.8, 10.0),
                                 ("charlie", -43.5, 172.6, 50.0)]:
        vals = 15 + rng.standard_normal(96)
        vals[5:9] = np.nan
        jst.save_station_file(str(root / f"{name}.nc"), name, lat, lon, elev, t,
                              {"dry_bulb": vals,
                               "precipitation": np.abs(rng.standard_normal(96))})
    with open(root / "corrupt.nc", "wb") as f:
        f.write(b"not an hdf5 file")
    return str(root)


def test_station_metadata_scan(station_archive):
    src, jsrc = tst.StationSource(station_archive), jst.StationSource(station_archive)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta, jmeta = src.get_metadata(), jsrc.get_metadata()
    _same_frame(meta, jmeta)
    assert len(meta) == 3 and src.skipped == jsrc.skipped and len(src.skipped) == 1
    assert (meta["start_year"] == 2000).all()


def test_station_registry_build(station_archive, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reg = tst.StationSource(station_archive).build_registry(str(tmp_path / "port.json"))
        jreg = jst.StationSource(station_archive).build_registry(str(tmp_path / "jax.json"))
    assert reg == jreg
    assert reg["alpha"]["latitude"] == pytest.approx(-36.8)
    # the same file, byte for byte
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("variable,daily", [("temperature", False), ("temperature", True),
                                            ("precipitation", True)])
def test_load_stations_time_with_holdout(station_archive, variable, daily):
    src, jsrc = tst.StationSource(station_archive), jst.StationSource(station_archive)
    times = np.datetime64("2000-01-02", "s") + np.arange(4) * np.timedelta64(1, "h")
    for kw in (dict(remove_stations=["bravo"]), dict(keep_stations=["alpha"]),
               dict(use_index=False), dict(keep_stations=["nobody"])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = src.load_stations_time(variable, times, daily=daily, **kw)
            want = jsrc.load_stations_time(variable, times, daily=daily, **kw)
        _same_frame(got, want)
        assert src.skipped == jsrc.skipped
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = src.load_stations_time("temperature", times, remove_stations=["bravo"])
    assert set(df["station_name"]) == {"alpha", "charlie"} and len(df) == 8
    assert "dry_bulb_station" in df.columns


def test_station_index_load_identical_and_persisted(station_archive, tmp_path):
    """The index path and the index-free path give the same frame; the port
    writes the JAX package's index file, and each side reads the other's
    index without rescanning a file."""
    src = tst.StationSource(station_archive, index_path=str(tmp_path / "port_index.json"))
    jsrc = jst.StationSource(station_archive, index_path=str(tmp_path / "jax_index.json"))
    times = np.datetime64("2000-01-02", "s") + np.arange(30) * np.timedelta64(1, "h")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = src.load_stations_time("temperature", times, use_index=False,
                                   remove_stations=["bravo"])
        b = src.load_stations_time("temperature", times, remove_stations=["bravo"])
        jb = jsrc.load_stations_time("temperature", times, remove_stations=["bravo"])
    _same_frame(b, jb)
    pa = a.to_pandas().sort_values(["station_name", "time"]).reset_index(drop=True)
    pb = b.to_pandas().sort_values(["station_name", "time"]).reset_index(drop=True)
    assert pa.equals(pb)
    with open(src.index_path) as f:
        idx = json.load(f)
    with open(jsrc.index_path) as f:
        assert idx == json.load(f)
    assert len(idx) == 3 and next(iter(idx.values()))["t_min"].startswith("2000-01-01")

    def no_rescan(self, path):
        # the corrupt file has no entry, so every build scans it again
        if path in idx:
            raise AssertionError(f"rescanned {path}")
        return None

    for cls, path in ((jst.StationSource, src.index_path), (tst.StationSource, jsrc.index_path)):
        other = cls(station_archive, index_path=path)
        saved = cls._scan_index_entry
        cls._scan_index_entry = no_rescan
        try:
            assert other.build_index() == idx
        finally:
            cls._scan_index_entry = saved

    # a stale entry (mtime changed) is rescanned
    victim = [p for p in src.station_files() if "alpha" in p][0]
    st = os.stat(victim)
    os.utime(victim, (1, 1))
    try:
        assert tst.StationSource(station_archive, index_path=src.index_path).build_index()[
            victim]["mtime"] == 1
    finally:
        os.utime(victim, (st.st_atime, st.st_mtime))


@pytest.mark.parametrize("variable", ["temperature", "precipitation"])
def test_load_station_daily_resample(station_archive, variable):
    """pandas' ``resample("1D")``: the days' means (NaN-skipping) or sums,
    summed with pandas' compensation, bitwise."""
    src, jsrc = tst.StationSource(station_archive), jst.StationSource(station_archive)
    path = [f for f in src.station_files() if "alpha" in f][0]
    for daily in (False, True):
        _same_frame(src.load_station(path, variable, daily=daily),
                    jsrc.load_station(path, variable, daily=daily))
    assert len(src.load_station(path, variable, daily=True)) == 4  # 96 hourly -> 4 days


def test_daily_series_fills_empty_days_as_pandas():
    """A gap of whole days: NaN for the mean, 0 for the sum; and a long
    day of values whose plain sum rounds differently from pandas'."""
    rng = np.random.default_rng(4)
    t = np.concatenate([np.datetime64("2000-01-01", "s") + np.arange(30) * np.timedelta64(1, "h"),
                        np.datetime64("2000-01-05", "s") + np.arange(24) * np.timedelta64(1, "h")])
    v = rng.standard_normal(len(t)) * 10 ** rng.uniform(-3, 6, len(t))
    v[[2, 40]] = np.nan
    df = pd.DataFrame({"time": t, "x": v}).set_index("time")
    for how in ("mean", "sum"):
        want = df.resample("1D").agg(how).reset_index()
        days, got = tst.daily_station_series(t, v, how)
        np.testing.assert_array_equal(days, want["time"].to_numpy())
        np.testing.assert_array_equal(got, want["x"].to_numpy())


def test_topography_source(tmp_path):
    lat = np.linspace(-34, -47, 20)
    lon = np.linspace(166, 178, 24)
    dem = Field(np.random.default_rng(0).random((20, 24)) * 1000, ("latitude", "longitude"),
                {"latitude": lat, "longitude": lon}, "elevation")
    path = str(tmp_path / "dem.nc")
    save_dataset(Dataset([dem]), path, float32=False)
    src, jsrc = ttopo.TopographySource(path), jtopo.TopographySource(path)
    for kw in (dict(), dict(area="christchurch"), dict(coarsen=2),
               dict(area="all", coarsen=3)):
        _same_field(src.load(**kw), jsrc.load(**kw))
    assert src.load(area="christchurch").sizes()["latitude"] < 20
    assert ttopo.topography_from_paths({"topography": {"file": path}}).path == path
    with pytest.raises(KeyError):
        ttopo.topography_from_paths({})


# -- WRF ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wrf_archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("wrf")
    src = jwrf.WRFSource(str(root), weights_dir="")
    init = datetime(2021, 6, 1)
    ny, nx = 12, 14
    base_lat = np.linspace(-47, -34, ny)[:, None] + np.linspace(0, 0.5, nx)[None, :]
    base_lon = np.linspace(166, 178, nx)[None, :] + np.linspace(0, 0.3, ny)[:, None]
    rng = np.random.default_rng(1)
    for valid in src.cycle_hours(init):
        path = src.filename_for(init, valid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fields = {"T2": Field(280 + rng.standard_normal((ny, nx)), ("y", "x"), {}, "T2"),
                  "XLAT": Field(base_lat, ("y", "x"), {}, "XLAT"),
                  "XLONG": Field(base_lon, ("y", "x"), {}, "XLONG")}
        save_dataset(Dataset(fields), path, float32=False)
    return str(root), init


def test_wrf_cycle_discovery(wrf_archive):
    root, init = wrf_archive
    src, jsrc = twrf.WRFSource(root, weights_dir=""), jwrf.WRFSource(root, weights_dir="")
    paths = src.get_filepaths(init)
    assert paths == jsrc.get_filepaths(init) and len(paths) == 24
    assert src.get_filepaths(init, datetime(2021, 6, 3)) == paths  # one cycle on disk
    assert src.cycle_hours(init) == jsrc.cycle_hours(init)
    assert src.filename_for(init, init) == jsrc.filename_for(init, init)
    for p in paths[:3]:
        assert src.parse_valid_time(p) == jsrc.parse_valid_time(p)
    assert src.parse_valid_time(paths[0]) == np.datetime64("2021-06-01T06:00:00")


def test_wrf_load_and_regrid(wrf_archive):
    root, init = wrf_archive
    src, jsrc = twrf.WRFSource(root, weights_dir=""), jwrf.WRFSource(root, weights_dir="")
    paths = src.get_filepaths(init)[:4]
    fld, jfld = src.load(paths, ["temperature"])["temperature"], jsrc.load(
        paths, ["temperature"])["temperature"]
    _same_field(fld, jfld)
    for k in ("lat2d", "lon2d"):
        np.testing.assert_array_equal(fld.attrs[k], jfld.attrs[k])
    target_lat = np.linspace(-46, -35, 10)
    target_lon = np.linspace(167, 177, 11)
    g = src.regrid_to(fld, target_lat, target_lon)
    _same_field(g, jsrc.regrid_to(jfld, target_lat, target_lon))
    assert g.shape == (4, 10, 11) and np.isfinite(g.data).mean() > 0.5
    assert len(src._regrid_cache) == 1
    src.regrid_to(fld, target_lat, target_lon)
    assert len(src._regrid_cache) == 1


def test_wrf_corrupt_member_identified(wrf_archive, tmp_path):
    root, init = wrf_archive
    src = twrf.WRFSource(root, weights_dir="")
    paths = src.get_filepaths(init)[:3]
    bad = str(tmp_path / "member.corrupt.nc")
    with open(bad, "wb") as f:
        f.write(b"junk")
    with pytest.raises(IOError) as e:
        src.load([paths[0], bad, paths[2]], ["temperature"])
    assert "corrupt" in str(e.value)
    with pytest.raises(KeyError, match="RAINNC"):
        src.load(paths[:1], ["precipitation"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wrf_regrid_weights_interchangeable(wrf_archive, tmp_path, writer, reader):
    """Weights persisted by either side load in the other without a new
    triangulation, and the regrid from them is bitwise the writer's."""
    import scipy.spatial as sps

    root, init = wrf_archive
    mods = {"jax": jwrf, "port": twrf}
    wdir = str(tmp_path / "weights")
    src = mods[writer].WRFSource(root, weights_dir=wdir)
    fld = src.load(src.get_filepaths(init)[:2], ["temperature"])["temperature"]
    lat, lon = np.linspace(-46, -35, 10), np.linspace(167, 177, 11)
    g1 = src.regrid_to(fld, lat, lon)
    files = os.listdir(wdir)
    assert len(files) == 1 and files[0].endswith(".npz")

    class Boom:
        def __init__(self, *a, **k):
            raise AssertionError("Delaunay recomputed despite the weight file")

    other = mods[reader].WRFSource(root, weights_dir=wdir)
    orig = sps.Delaunay
    sps.Delaunay = Boom
    try:
        g2 = other.regrid_to(fld, lat, lon)
    finally:
        sps.Delaunay = orig
    np.testing.assert_array_equal(g1.data, g2.data)
    assert os.listdir(wdir) == files  # no temporary file left behind


# -- the reference archive schema -----------------------------------------------


@pytest.fixture(scope="module")
def reference_archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_stations")
    t = np.datetime64("2001-01-01", "s") + np.arange(48) * np.timedelta64(1, "h")
    rng = np.random.default_rng(3)
    screen, wind = root / "ScreenObs", root / "Surface_Wind"
    screen.mkdir()
    wind.mkdir()
    jst.save_station_file_reference(
        str(screen / "12345.nc"), "Alpha Ews", 12345, -36.8, 174.7, 30.0, t,
        {"dry_bulb": 15 + rng.standard_normal(48),
         "relative_humidity": rng.uniform(20, 100, 48)})
    jst.save_station_file_reference(
        str(screen / "23456.nc"), "Bravo Aws", 23456, -41.3, 174.8, None, t,
        {"dry_bulb": 10 + rng.standard_normal(48)})
    jst.save_station_file_reference(
        str(wind / "34567.nc"), "Charlie Aero", 34567, -43.5, 172.6, 5.0, t,
        {"speed": np.abs(rng.standard_normal(48)) * 10, "direction": rng.uniform(0, 360, 48)})
    with open(screen / "corrupt.nc", "wb") as f:
        f.write(b"definitely not hdf5")
    return str(root)


def test_reference_schema_metadata(reference_archive):
    src, jsrc = tst.StationSource(reference_archive), jst.StationSource(reference_archive)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta, jmeta = src.get_metadata("temperature"), jsrc.get_metadata("temperature")
    _same_frame(meta, jmeta)
    assert set(meta["station_id"]) == {12345, 23456}
    assert np.isnan(meta["elevation"][meta["station_name"] == "Bravo Aws"]).all()
    assert src.skipped == jsrc.skipped and "corrupt" in src.skipped[0]


def test_reference_schema_skip_warns(reference_archive):
    with pytest.warns(UserWarning, match="skipped 1 unreadable"):
        tst.StationSource(reference_archive).get_metadata("temperature")


def test_reference_schema_load_time(reference_archive):
    times = np.datetime64("2001-01-01T06", "s") + np.arange(3) * np.timedelta64(1, "h")
    for var in ("temperature", "humidity"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = tst.StationSource(reference_archive).load_stations_time(var, times)
            want = jst.StationSource(reference_archive).load_stations_time(var, times)
        _same_frame(got, want)
    assert set(got["station_name"]) == {"Alpha Ews"}


def test_reference_schema_wind_uv(reference_archive):
    times = np.datetime64("2001-01-01T00", "s") + np.arange(4) * np.timedelta64(1, "h")
    for var in ("10m_u_component_of_wind", "10m_v_component_of_wind"):
        got = tst.StationSource(reference_archive).load_stations_time(var, times)
        _same_frame(got, jst.StationSource(reference_archive).load_stations_time(var, times))
        assert set(got["station_name"]) == {"Charlie Aero"}


def test_reference_schema_registry(reference_archive, tmp_path):
    variables = ["temperature", "10m_u_component_of_wind"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reg = tst.StationSource(reference_archive).build_registry(
            str(tmp_path / "p.json"), variables=variables)
        jreg = jst.StationSource(reference_archive).build_registry(
            str(tmp_path / "j.json"), variables=variables)
        assert json.dumps(tst.StationSource(reference_archive).build_registry()) == \
            json.dumps(jst.StationSource(reference_archive).build_registry())
    # (NaN elevations: compared as JSON, NaN != NaN in a dict comparison)
    assert json.dumps(reg) == json.dumps(jreg) and reg["Charlie Aero"]["station_id"] == 34567
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_port_station_writers_match_jax(tmp_path):
    """Files of the port's two station writers read as the JAX writers'."""
    t = np.datetime64("2001-01-01", "s") + np.arange(24) * np.timedelta64(1, "h")
    vals = {"dry_bulb": np.linspace(5, 20, 24)}
    for name, writer in (("ref", "save_station_file_reference"), ("legacy", "save_station_file")):
        args = (("Delta", 45678, -40.0, 175.0, None) if name == "ref"
                else ("Delta", -40.0, 175.0, 12.0))
        for mod, tag in ((tst, "p"), (jst, "j")):
            getattr(mod, writer)(str(tmp_path / f"{name}_{tag}.nc"), *args, t, vals)
        got = open_dataset(str(tmp_path / f"{name}_p.nc"))
        want = open_dataset(str(tmp_path / f"{name}_j.nc"))
        assert got.attrs == want.attrs and list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].data, want[k].data)


def test_topography_discovery(tmp_path):
    lat = np.linspace(-34, -47, 10)
    lon = np.linspace(166, 178, 12)
    rng = np.random.default_rng(1)
    for res in ("800m", "25m", "coarse"):
        dem = Field(rng.random((10, 12)) * 1000, ("latitude", "longitude"),
                    {"latitude": lat, "longitude": lon}, "elevation", {"res": res})
        save_dataset(Dataset([dem]), str(tmp_path / f"nz_elevation_{res}.nc"), float32=False)
    src = ttopo.TopographySource.discover(str(tmp_path))
    assert src.path == jtopo.TopographySource.discover(str(tmp_path)).path
    assert src.path.endswith("nz_elevation_25m.nc")
    assert ttopo.topography_from_paths({"topography": {"parent": str(tmp_path)}}).path == src.path
    _same_field(src.load(), jtopo.TopographySource(src.path).load())
    with pytest.raises(FileNotFoundError):
        ttopo.TopographySource.discover(str(tmp_path / "nope"))
