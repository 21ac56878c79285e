"""The port's data preparation against the JAX package's, on the CPU.

Covered: ``synthetic_bundle`` (every array, coordinate and station column
with its dtype), ``PreprocessForDownscaling.run_processing_sequence`` for
temperature, precipitation, humidity and surface pressure (every ``Field``
of the bundle, the fitted ``DataProcessor``, the station columns in their
order), the hourly path (``freq_hours=1``, daily and not, which fits the
stats on ``random_hour_subset``), ``adjust_duplicates`` and
``fill_missing_station_values``, the features, ``daily_resample``,
``infer_internal_density``, the ``config`` tables, ``StationFrame``'s
pandas-like operations and the ``Field``/``Dataset`` selection and
interpolation edge cases. Sizes are ``tests/test_pipeline.py``'s: 10 times,
24² base, 96² DEM, 20 stations, highres 2, lowres 4.

Tolerance: none. The same numpy/scipy operations run in the same order on
both sides, so every array must be equal bit for bit (NaN where NaN), with
the same dtype, and every fitted statistic equal as a float.
"""

import numpy as np
import pandas as pd
import pytest

from deepsensornz_tpu import config as jcfg
from deepsensornz_tpu.data import features as jfeat
from deepsensornz_tpu.data import grid as jgrid
from deepsensornz_tpu.data import synthetic as jsyn
from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.sources.era5 import daily_resample as jdaily
from deepsensornz_tpu.ops.grids import infer_internal_density as jinfer
from deepsensornz_tpu.pipeline import preprocess as jpre
from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data import features as feat
from deepsensornz_tpu_torch.data import synthetic as syn
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.data.sources.era5 import daily_resample
from deepsensornz_tpu_torch.ops.grids import infer_internal_density
from deepsensornz_tpu_torch.pipeline import preprocess as pre

VARIABLES = ["temperature", "precipitation", "humidity", "surface_pressure"]
SIZE = dict(n_times=10, base_hw=(24, 24), dem_hw=(96, 96), n_stations=20)
SEQ = dict(highres_factor=2, lowres_factor=4)


def to_port(f):
    if isinstance(f, jgrid.Dataset):
        return Dataset({k: to_port(v) for k, v in f.items()}, dict(f.attrs))
    return Field(f.data.copy(), f.dims, {k: v.copy() for k, v in f.coords.items()}, f.name,
                 dict(f.attrs))


def assert_same_field(got: Field, want, what=""):
    assert isinstance(got, Field), what
    assert (got.name, got.dims, got.attrs) == (want.name, want.dims, want.attrs), what
    assert got.data.dtype == want.data.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.data, want.data, err_msg=str(what))
    assert list(got.coords) == list(want.coords), what
    for k, c in want.coords.items():
        assert got.coords[k].dtype == c.dtype, (what, k)
        np.testing.assert_array_equal(got.coords[k], c, err_msg=f"{what} coord {k}")


def assert_same_dataset(got: Dataset, want, what=""):
    assert isinstance(got, Dataset) and list(got.keys()) == list(want.keys()), what
    for k in want.keys():
        assert_same_field(got[k], want[k], (what, k))


def assert_same_frame(got: StationFrame, want: pd.DataFrame):
    assert isinstance(got, StationFrame)
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        a = want[c].to_numpy()
        assert got[c].dtype == a.dtype, c
        np.testing.assert_array_equal(got[c], a, err_msg=c)


def to_frame(df: pd.DataFrame) -> StationFrame:
    return StationFrame.from_pandas(df)


# -- synthetic data -----------------------------------------------------------------------


@pytest.mark.parametrize("variable", VARIABLES + ["10m_u_component_of_wind"])
def test_synthetic_bundle_matches_jax(variable):
    jb, jd, js = jsyn.synthetic_bundle(variable, seed=3, **SIZE)
    b, d, s = syn.synthetic_bundle(variable, seed=3, **SIZE)
    assert_same_field(b, jb, "base")
    assert_same_field(d, jd, "dem")
    assert_same_frame(s, js)
    assert s["time"].dtype == np.dtype("datetime64[s]") and s["station_id"].dtype == np.int64
    assert all(s[c].dtype == np.float64 for c in s.columns if c not in ("time", "station_id"))


def test_synthetic_world_knobs_match_jax():
    world = {"terrain_scale": 400.0, "base_noise": 1.0, "lapse_rate": 0.01, "obs_noise": 0.2,
             "n_stations": 9}
    jb, jd, js = jsyn.synthetic_bundle(n_times=4, base_hw=(12, 12), dem_hw=(40, 40),
                                       world=dict(world))
    b, d, s = syn.synthetic_bundle(n_times=4, base_hw=(12, 12), dem_hw=(40, 40),
                                   world=dict(world))
    assert_same_field(b, jb)
    assert_same_field(d, jd)
    assert_same_frame(s, js)
    with pytest.raises(ValueError, match="unknown world knobs"):
        syn.synthetic_bundle(world={"nope": 1})


# -- the preprocessing sequence --------------------------------------------------------------


def _run_both(variable, base_kw=None, **seq):
    jd = jsyn.synthetic_dem(*SIZE["dem_hw"], seed=0)
    d = syn.synthetic_dem(*SIZE["dem_hw"], seed=0)
    base_kw = {"n_times": SIZE["n_times"], "n_lat": 24, "n_lon": 24, "seed": 1, **(base_kw or {})}
    jb = jsyn.synthetic_base_grid(variable, **base_kw)
    b = syn.synthetic_base_grid(variable, **base_kw)
    js = jsyn.synthetic_stations(jb, jd, variable, SIZE["n_stations"], seed=2)
    s = syn.synthetic_stations(b, d, variable, SIZE["n_stations"], seed=2)
    assert_same_frame(s, js)
    jout = jpre.PreprocessForDownscaling(variable).run_processing_sequence(
        jd, {variable: jb}, js, **SEQ, **seq)
    out = pre.PreprocessForDownscaling(variable).run_processing_sequence(
        d, {variable: b}, s, **SEQ, **seq)
    return out, jout


def assert_same_bundle(out, jout):
    assert set(out) == set(jout)
    for key in ("base_ds", "aux_ds", "highres_aux_ds"):
        assert_same_dataset(out[key], jout[key], key)
    if jout["landmask_ds"] is None:
        assert out["landmask_ds"] is None
    else:
        assert_same_field(out["landmask_ds"], jout["landmask_ds"], "landmask")
    assert out["data_processor"].to_dict() == jout["data_processor"].to_dict()
    assert_same_frame(out["station_df"], jout["station_df"])
    assert (out["data_settings"], out["date_info"]) == (jout["data_settings"], jout["date_info"])
    assert set(out["raw"]) == set(jout["raw"])
    assert_same_dataset(out["raw"]["base"], jout["raw"]["base"], "raw base")
    for key in ("dem_highres", "dem_lowres"):
        assert_same_field(out["raw"][key], jout["raw"][key], key)
    assert_same_frame(out["raw"]["stations"], jout["raw"]["stations"])


@pytest.mark.parametrize("variable", VARIABLES)
@pytest.mark.parametrize("options", [
    {},
    {"include_landmask": True, "include_time_of_year": True, "include_coordinates": True,
     "test_norm": True},
], ids=["plain", "all-options"])
def test_processing_sequence_matches_jax(variable, options):
    out, jout = _run_both(variable, **options)
    assert_same_bundle(out, jout)
    # x1/x2 are popped and set again: they are the frame's last columns
    assert out["station_df"].columns[-2:] == ["x1", "x2"]


@pytest.mark.parametrize("daily", [True, False], ids=["daily", "hourly"])
@pytest.mark.parametrize("variable", ["temperature", "precipitation"])
def test_hourly_base_matches_jax(variable, daily):
    """30 hourly times: ``daily=True`` resamples the base to days (mean, sum
    for precipitation); ``daily=False`` keeps the hours and fits the stats
    on one random hour per day."""
    out, jout = _run_both(variable, base_kw={"n_times": 30, "freq_hours": 1}, daily=daily,
                          include_time_of_year=True, time_of_year_freq="H", test_norm=True)
    assert_same_bundle(out, jout)
    short = cfg.VAR_ERA5[variable]["var_name"]
    assert len(out["base_ds"][short].coords["time"]) == (2 if daily else 30)


def test_area_crop_and_reused_processor_match_jax():
    jb, jd, js = jsyn.synthetic_bundle(**SIZE)
    b, d, s = syn.synthetic_bundle(**SIZE)
    jp = jpre.PreprocessForDownscaling("temperature", area="south_island")
    p = pre.PreprocessForDownscaling("temperature", area="south_island")
    jout = jp.run_processing_sequence(jd, {"temperature": jb}, js, **SEQ)
    out = p.run_processing_sequence(d, {"temperature": b}, s, **SEQ)
    assert_same_bundle(out, jout)
    # apply-only with the fitted processor: nothing is refitted
    dp = DataProcessor.from_dict(out["data_processor"].to_dict())
    again = pre.PreprocessForDownscaling("temperature", area="south_island") \
        .run_processing_sequence(d, {"temperature": b}, s, data_processor=dp, **SEQ)
    assert again["data_processor"].to_dict() == out["data_processor"].to_dict()
    assert_same_frame(again["station_df"], jout["station_df"])


def test_wrf_base_is_not_ported_and_empty_stations_raise():
    """The WRF base needs the WRF source to regrid with (the JAX package
    asserts it; tests/test_torch_preprocess_wrf.py holds the WRF base
    against JAX), and an empty station frame raises."""
    b, d, s = syn.synthetic_bundle(**SIZE)
    with pytest.raises(ValueError, match="wrf_source"):
        pre.PreprocessForDownscaling("temperature", base="wrf").run_processing_sequence(
            d, {"temperature": b}, s, **SEQ)
    far = s.copy()
    far["latitude"] = far["latitude"] + 90.0
    with pytest.raises(ValueError, match="station frame is empty"):
        pre.PreprocessForDownscaling("temperature").run_processing_sequence(
            d, {"temperature": b}, far, **SEQ)


# -- station helpers --------------------------------------------------------------------------


def _ragged_frame(seed: int, named: bool) -> pd.DataFrame:
    """40 stations (some sharing coordinates, under different names) at 5
    times, 8 NaN values per time."""
    rng = np.random.default_rng(seed)
    n_st, n_t = 40, 5
    lats = rng.uniform(-47, -34, n_st)
    lons = rng.uniform(166, 179, n_st)
    lats[10:14], lons[10:14] = lats[3], lons[3]  # four more at station 3's place
    lats[20], lons[20] = lats[21], lons[21]
    rows = []
    for t in range(n_t):
        vals = rng.normal(size=n_st)
        vals[rng.choice(n_st, size=8, replace=False)] = np.nan
        for i in range(n_st):
            row = {"time": np.datetime64("2020-01-01") + t, "latitude": lats[i],
                   "longitude": lons[i], "t2m_station": vals[i]}
            if named:
                row["station_name"] = f"st{i % 37}"
            rows.append(row)
    return pd.DataFrame(rows).sample(frac=1.0, random_state=seed).reset_index(drop=True)


@pytest.mark.parametrize("named", [True, False], ids=["station_name", "no-names"])
def test_adjust_duplicates_matches_jax(named):
    df = _ragged_frame(3, named)
    got = pre.adjust_duplicates(to_frame(df))
    want = jpre.adjust_duplicates(df)
    assert_same_frame(got, want)
    moved = got["latitude"] != df["latitude"].to_numpy()
    assert moved.any() == named


def test_fill_missing_station_values_matches_jax():
    df = _ragged_frame(4, named=False)
    df.loc[df["time"] == df["time"].iloc[0], "t2m_station"] = np.nan  # one all-NaN time
    df.loc[5, "time"] = pd.NaT  # a NaT row is in no group
    got = pre.fill_missing_station_values(to_frame(df))
    want = jpre.fill_missing_station_values(df)
    assert_same_frame(got, want)
    assert np.isnan(got["t2m_station"]).sum() == np.isnan(want["t2m_station"]).sum() > 0


def test_fill_missing_keeps_the_first_minimum():
    """Two reporting stations at one distance from the gap: argmin's first."""
    frame = StationFrame({"time": np.full(3, np.datetime64("2020-01-01", "s")),
                          "latitude": np.array([0.0, 1.0, -1.0]),
                          "longitude": np.zeros(3),
                          "x_station": np.array([np.nan, 5.0, 7.0])})
    assert pre.fill_missing_station_values(frame)["x_station"].tolist() == [5.0, 5.0, 7.0]


# -- StationFrame ---------------------------------------------------------------------------


def test_station_frame_operations_match_pandas():
    df = _ragged_frame(5, named=True)
    frame = to_frame(df)
    mask = (df["latitude"] > -40).to_numpy()
    assert_same_frame(frame[mask], df[mask].reset_index(drop=True))
    copy = frame.copy()
    copy["latitude"] = copy["latitude"] + 1.0
    assert not np.array_equal(copy["latitude"], frame["latitude"])
    # popped and set again: to the end, as in pandas
    pdf = df.copy()
    pdf["lat2"] = pdf.pop("latitude")
    copy = frame.copy()
    copy["lat2"] = copy.pop("latitude")
    assert_same_frame(copy, pdf)
    groups = [(t, rows) for t, rows in frame.groupby_time()]
    want = [(np.datetime64(t, "s"), g.index.to_numpy()) for t, g in df.groupby("time")]
    assert [t for t, _ in groups] == [t for t, _ in want]
    for (_, a), (_, b) in zip(groups, want):
        np.testing.assert_array_equal(a, b)
    assert_same_frame(to_frame(frame.to_pandas()), frame.to_pandas())
    pd.testing.assert_frame_equal(frame.to_pandas(), df)
    with pytest.raises(ValueError, match="shape"):
        frame["bad"] = np.zeros(3)
    with pytest.raises(TypeError, match="boolean row mask"):
        frame[np.arange(len(frame))]


# -- the processor -----------------------------------------------------------------------------


def test_processor_fits_and_inverts_like_jax():
    jb, jd, js = jsyn.synthetic_bundle(**SIZE)
    jdp, dp = JProcessor(), DataProcessor()
    for p in (jdp, dp):
        p.set_coord_maps_from_extent(-48.0, -34.0, 166.0, 179.0)
    ds = jgrid.Dataset({"t2m": jb, "elevation": jd})
    jn = jdp(ds, method="min_max")
    n = dp(to_port(ds), method="min_max")
    assert_same_dataset(n, jn)
    assert_same_frame(dp(to_frame(js), method="positive_semidefinite"),
                      jdp(js, method="positive_semidefinite"))
    assert dp.config == jdp.config
    assert_same_dataset(dp.unnormalise(n), jdp.unnormalise(jn))
    back = dp.unnormalise(dp(to_frame(js)))
    assert_same_frame(back, jdp.unnormalise(jdp(js)))
    # lists, apply-only and unknown types
    both = dp([to_port(jb), to_frame(js)])
    assert isinstance(both[0], Field) and isinstance(both[1], StationFrame)
    with pytest.raises(KeyError, match="assert_computed"):
        DataProcessor(x1_map=(0, 1), x2_map=(0, 1))(to_port(jb), assert_computed=True)
    with pytest.raises(TypeError):
        dp(np.zeros(3))


# -- features, sources, grids, config ----------------------------------------------------------


def test_features_match_jax():
    jd = jsyn.synthetic_dem(96, 90, seed=1)
    d = to_port(jd)
    assert_same_dataset(feat.compute_tpi(d), jfeat.compute_tpi(jd))
    assert_same_dataset(feat.compute_tpi(d, (0.2, 0.3)), jfeat.compute_tpi(jd, (0.2, 0.3)))
    lo_j, lo = jd.coarsen(4), d.coarsen(4)
    assert_same_field(feat.elevation_difference(d, lo), jfeat.elevation_difference(jd, lo_j))
    assert_same_field(feat.landmask_from_elevation(d), jfeat.landmask_from_elevation(jd))
    assert_same_dataset(feat.x1x2_channels(d), jfeat.x1x2_channels(jd))
    rng = np.random.default_rng(0)
    speed, direction = rng.random(50) * 20, rng.random(50) * 360
    for a, b in zip(feat.wind_components(speed, direction),
                    jfeat.wind_components(speed, direction)):
        np.testing.assert_array_equal(a, b)
    v = rng.normal(size=30)
    np.testing.assert_array_equal(feat.shift_humidity_to_unit_interval(v),
                                  jfeat.shift_humidity_to_unit_interval(v))
    np.testing.assert_array_equal(feat.shift_humidity_from_unit_interval(v),
                                  jfeat.shift_humidity_from_unit_interval(v))
    w = v + rng.normal(size=30)
    w[3] = np.nan
    assert feat.rmse(v, w) == jfeat.rmse(v, w)


@pytest.mark.parametrize("freq", ["D", "H"])
def test_circ_time_encoding_matches_jax(freq):
    # a leap year, an hour past midnight, the turn of a year
    times = (np.datetime64("2019-12-30T00", "s")
             + np.arange(0, 400 * 24, 7) * np.timedelta64(1, "h"))
    got, want = feat.circ_time_encoding(times, freq), jfeat.circ_time_encoding(times, freq)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_random_hour_subset_and_daily_resample_match_jax():
    jb = jsyn.synthetic_base_grid(n_times=50, n_lat=6, n_lon=5, freq_hours=1)
    jb.data[3, 2, 2] = np.nan
    b = to_port(jb)
    for seed in (0, 5):
        assert_same_field(feat.random_hour_subset(b, seed), jfeat.random_hour_subset(jb, seed))
    for how in ("mean", "sum"):
        assert_same_field(daily_resample(b, how), jdaily(jb, how))


def test_infer_internal_density_matches_jax():
    for res, mult in (([0.01, 0.02, 0.0], 1.0), ([0.003], 2.5), ([1.0, 0.9], 1.0)):
        assert infer_internal_density(res, mult) == jinfer(res, mult)


def test_config_tables_match_jax():
    assert cfg.station_registry() == jcfg.station_registry()
    for name in ("VARIABLE_OPTIONS", "VAR_ERA5", "VAR_WRF", "VAR_STATIONS", "VAR_TO_STD",
                 "LIKELIHOODS", "NORMALISATION", "EXTENTS", "CONVNP_KWARGS_DEFAULT",
                 "TRAIN_DEFAULTS"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for v in cfg.VARIABLE_OPTIONS:
        assert cfg.likelihood_for(v) == jcfg.likelihood_for(v)
        assert cfg.normalisation_for(v) == jcfg.normalisation_for(v)


# -- Field and Dataset edge cases ---------------------------------------------------------------


@pytest.fixture(scope="module")
def fields():
    jb = jsyn.synthetic_base_grid(n_times=6, n_lat=9, n_lon=7)  # latitude descending
    jb.data[1, 2, 3] = np.nan
    return jb, to_port(jb)


SEL_CASES = {
    "lat slice high→low": dict(latitude=slice(-36.0, -44.0)),
    "lat slice low→high (empty on a descending coord)": dict(latitude=slice(-44.0, -36.0)),
    "open slices": dict(latitude=slice(None, -40.0), longitude=slice(170.0, None)),
    "time slice of strings": dict(time=slice("2000-01-02", "2000-01-04")),
    "nearest scalar": dict(latitude=-40.01, longitude=170.3, method="nearest"),
    "nearest array": dict(latitude=np.array([-47.9, -34.0, -41.0]), method="nearest"),
    "nearest time": dict(time=np.datetime64("2000-01-03T13:00"), method="nearest"),
    "nearest beyond the ends": dict(longitude=np.array([100.0, 200.0]), method="nearest"),
    "exact time string": dict(time="2000-01-02"),
    "exact array": dict(time=np.array(["2000-01-01", "2000-01-05"], dtype="datetime64[s]")),
}


@pytest.mark.parametrize("case", list(SEL_CASES))
def test_field_sel_matches_jax(fields, case):
    jb, b = fields
    kw = SEL_CASES[case]
    assert_same_field(b.sel(**kw), jb.sel(**kw))


def test_field_isel_reduce_and_arithmetic_match_jax(fields):
    jb, b = fields
    for kw in (dict(time=2), dict(time=np.int64(1), latitude=slice(2, 5)),
               dict(longitude=np.array([4, 0, 6])), dict(time=[0, 3]),
               dict(latitude=np.asarray(3))):
        assert_same_field(b.isel(**kw), jb.isel(**kw))
    with pytest.raises(ValueError, match="at most one dim"):
        b.isel(time=[0, 1], latitude=[0, 1])
    with pytest.raises(KeyError, match="not found"):
        b.sel(time="1999-01-01")
    for dims in ("time", ("latitude", "longitude")):
        for skipna in (True, False):
            assert_same_field(b.mean(dims, skipna), jb.mean(dims, skipna))
            assert_same_field(b.sum(dims, skipna), jb.sum(dims, skipna))
    mask = b.data > 10
    assert_same_field(b.where(mask), jb.where(mask))
    assert_same_field(b.where(mask, -1.0), jb.where(mask, -1.0))
    for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
        assert_same_field(getattr(b, op)(2.5), getattr(jb, op)(2.5))
        assert_same_field(getattr(b, op)(b), getattr(jb, op)(jb))
    assert b.resolution("latitude") == jb.resolution("latitude")
    assert_same_field(b.astype(np.float64), jb.astype(np.float64))
    ren = {"latitude": "lat", "time": "t"}
    assert_same_field(b.rename_dims(ren), jb.rename_dims(ren))
    assert b.values is b.data and b.dtype == jb.dtype
    assert_same_field(b.coarsen(2, how="max"), jb.coarsen(2, how="max"))
    assert_same_field(b.coarsen(3, ("time",)), jb.coarsen(3, ("time",)))


@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_field_interp_like_matches_jax(fields, method):
    jb, b = fields
    # a target grid ascending where the source descends, reaching past both ends
    lat = np.linspace(-49.0, -33.0, 23)
    lon = np.linspace(165.0, 180.0, 4)
    jt = jgrid.Field(np.zeros((23, 4)), ("latitude", "longitude"),
                     {"latitude": lat, "longitude": lon})
    t = to_port(jt)
    assert_same_field(b.interp_like(t, method=method), jb.interp_like(jt, method=method))
    assert_same_field(b.interp_like(t, method=method, dims=("longitude",)),
                      jb.interp_like(jt, method=method, dims=("longitude",)))
    with pytest.raises(ValueError, match="unknown interp method"):
        b.interp_like(t, method="cubic")


def test_dataset_operations_match_jax(fields):
    jb, b = fields
    jds = jgrid.Dataset({"a": jb, "b": jb * 2.0}, {"k": 1})
    ds = to_port(jds)
    ds["c"] = b + 1.0
    jds["c"] = jb + 1.0
    assert ds["c"].name == "c" and list(ds.data_vars) == ["a", "b", "c"]
    assert_same_dataset(ds, jds)
    assert_same_dataset(ds.sel(latitude=slice(-36.0, -40.0)),
                        jds.sel(latitude=slice(-36.0, -40.0)))
    assert_same_dataset(ds.isel(time=1), jds.isel(time=1))
    assert_same_dataset(ds.map(lambda f: f.fillna(0.0)), jds.map(lambda f: f.fillna(0.0)))
    cp = ds.copy()
    cp["a"].data[0, 0, 0] = -1.0
    assert ds["a"].data[0, 0, 0] != -1.0 and cp.attrs == {"k": 1}
