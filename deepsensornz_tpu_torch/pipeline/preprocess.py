"""Feature-engineering pipeline: raw fields and stations → normalised
model inputs.

Copy of ``deepsensornz_tpu/pipeline/preprocess.py`` on the port's
``Field``/``Dataset`` and :class:`StationFrame`, bit for bit its bundle on
the same inputs:

- topography: highres elevation (coarsen ×highres_factor, NaN→0), TPI at
  0.1/0.05/0.025°, lowres elevation, the elevation_diff channel, an
  optional landmask;
- the base: ERA5 hourly→daily, coarsen, trim to the topography extent; or
  WRF regridded onto the topography coarsened ×``coarsen_factor`` through
  the WRF source's regridder, renamed to the ERA5 names, temperature in
  °C;
- stations: area filter, duplicate-coordinate jitter, optional
  nearest-station NaN filling;
- normalisation: a ``DataProcessor`` fitted (or reused) on the highres
  topography's extent with each variable's method; hourly records are
  fitted on one random hour per day; an optional round-trip check;
- aux channels: circular time of year and x1/x2 positions;
- the output bundle the ``Train`` layer reads, and its cache on disk
  (:func:`save_processed_bundle`/:func:`load_processed_bundle`: netCDF
  through h5py, the processor and settings as JSON, the station frame
  pickled).

The fields and stations come in memory (the readers are in
``data/sources``), so the JAX class's ``training_fpaths``,
``validation_fpaths`` and ``validation`` arguments, which it stores and
never reads, are not taken.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.features import (
    circ_time_encoding,
    compute_tpi,
    elevation_difference,
    landmask_from_elevation,
    random_hour_subset,
    shift_humidity_from_unit_interval,
    shift_humidity_to_unit_interval,
    x1x2_channels,
)
from deepsensornz_tpu_torch.data.frame import FrameUnpickler, StationFrame, is_pandas_frame
from deepsensornz_tpu_torch.data.grid import Dataset, Field, open_dataset, save_dataset
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.data.sources.era5 import daily_resample


class PreprocessForDownscaling:
    """Orchestrates feature engineering for one target variable."""

    def __init__(
        self,
        variable: str,
        base: str = "era5",
        training_years: Sequence[int] = (),
        validation_years: Sequence[int] = (),
        area: Optional[str] = None,
        context_variables: Sequence[str] = (),
    ):
        self.variable = variable
        self.base = base
        self.training_years = list(training_years)
        self.validation_years = list(validation_years)
        self.area = area
        self.context_variables = list(context_variables) or [variable]

        self.dem: Optional[Field] = None
        self.highres_aux_ds: Optional[Dataset] = None
        self.aux_ds: Optional[Dataset] = None
        self.landmask_ds: Optional[Field] = None
        self.base_ds: Optional[Dataset] = None
        self.station_df: Optional[StationFrame] = None
        self.data_processor: Optional[DataProcessor] = None
        self._raw: dict = {}

    # ------------------------------------------------------------------ topo --

    def load_topography(self, dem: Field) -> None:
        """Attach the raw DEM, cropped to ``area`` when one is set."""
        if self.area is not None:
            e = cfg.EXTENTS[self.area]
            lat = dem.coords["latitude"]
            asc = lat[0] < lat[-1]
            dem = dem.sel(
                latitude=slice(e["minlat"], e["maxlat"]) if asc else slice(e["maxlat"], e["minlat"]),
                longitude=slice(e["minlon"], e["maxlon"]),
            )
        self.dem = dem

    def preprocess_topography(self, highres_factor: int = 10, lowres_factor: int = 50,
                              include_landmask: bool = False) -> None:
        """Highres elevation + TPI, and the lowres elevation + elevation_diff
        aux stacks."""
        assert self.dem is not None, "load_topography first"
        highres = self.dem.coarsen(highres_factor).rename("elevation")
        lowres = self.dem.coarsen(lowres_factor).rename("elevation_lowres")
        tpi = compute_tpi(highres)
        ediff = elevation_difference(highres, lowres)
        hr_fields = {"elevation": highres.fillna(0.0)}
        hr_fields.update({k: v for k, v in tpi.items()})
        self.highres_aux_ds = Dataset(hr_fields)
        self.aux_ds = Dataset({
            "elevation_lowres": lowres.fillna(0.0),
            "elevation_diff": ediff.interp_like(lowres, method="nearest"),
        })
        if include_landmask:
            self.landmask_ds = landmask_from_elevation(highres)
        self._raw["dem_highres"] = highres
        self._raw["dem_lowres"] = lowres

    # ------------------------------------------------------------------ base --

    def preprocess_era5(self, base_fields: dict[str, Field], coarsen_factor: int = 1,
                        daily: bool = True) -> None:
        """Daily-resample (mean; sum for precipitation), coarsen and trim
        each base field to the topography extent."""
        assert self.highres_aux_ds is not None, "preprocess_topography first"
        out = {}
        for var, fld in base_fields.items():
            short = cfg.VAR_ERA5[var]["var_name"]
            f = fld
            if daily and _is_hourly(f):
                how = "sum" if var == "precipitation" else "mean"
                f = daily_resample(f, how)
            if coarsen_factor > 1:
                f = f.coarsen(coarsen_factor)
            f = self._trim_to_topo(f)
            out[short] = f.rename(short)
        self.base_ds = Dataset(out)
        self._raw["base"] = Dataset({k: v.copy() for k, v in out.items()})

    def preprocess_wrf(self, wrf_fields: dict[str, Field], wrf_source,
                       coarsen_factor: int = 5) -> None:
        """Regrid each WRF field onto the topography coarsened
        ×``coarsen_factor`` with ``wrf_source.regrid_to``, name it by the
        ERA5 convention, and turn a temperature in kelvin (a mean above
        100) into °C."""
        assert self.dem is not None, "load_topography first"
        target = self.dem.coarsen(coarsen_factor)
        lat = target.coords["latitude"]
        lon = target.coords["longitude"]
        out = {}
        for var, fld in wrf_fields.items():
            short = cfg.VAR_ERA5[var]["var_name"]
            g = wrf_source.regrid_to(fld, lat, lon)
            if var == "temperature" and g.data[np.isfinite(g.data)].mean() > 100:
                g = g.copy(g.data - 273.15)
            out[short] = g.rename(short)
        self.base_ds = Dataset(out)
        self._raw["base"] = Dataset({k: v.copy() for k, v in out.items()})

    def _trim_to_topo(self, f: Field) -> Field:
        """Crop the base grid to the highres topography's extent."""
        hr = self.highres_aux_ds["elevation"]
        lat = hr.coords["latitude"]
        lon = hr.coords["longitude"]
        la = f.coords["latitude"]
        asc = la[0] < la[-1]
        lat_lo, lat_hi = float(lat.min()), float(lat.max())
        return f.sel(
            latitude=slice(lat_lo, lat_hi) if asc else slice(lat_hi, lat_lo),
            longitude=slice(float(lon.min()), float(lon.max())),
        )

    # -------------------------------------------------------------- stations --

    def preprocess_stations(self, station_df: StationFrame, fill_missing: bool = False) -> None:
        """Keep the rows inside the DEM's extent, jitter duplicate
        coordinates, optionally fill NaNs from the nearest station."""
        assert self.dem is not None
        df = station_df.copy()
        lat = self.dem.coords["latitude"]
        lon = self.dem.coords["longitude"]
        keep = ((df["latitude"] >= lat.min()) & (df["latitude"] <= lat.max())
                & (df["longitude"] >= lon.min()) & (df["longitude"] <= lon.max()))
        df = df[keep]
        if len(df) == 0:
            # stations are the targets: an empty frame would otherwise fail
            # opaquely deep in task construction
            raise ValueError(
                "station frame is empty after loading/area filtering — "
                f"no usable station rows for variable {self.variable!r} "
                "over the requested times (check the archive layout, the "
                "time range, and any remove_stations/keep_stations "
                "filters)")
        df = adjust_duplicates(df)
        if fill_missing:
            df = fill_missing_station_values(df)
        self.station_df = df
        self._raw["stations"] = self.station_df.copy()

    # --------------------------------------------------------- normalisation --

    def calculate_data_processor(self, data_processor: Optional[DataProcessor] = None,
                                 test_norm: bool = False) -> DataProcessor:
        """Fit (or reuse, apply-only) the normalisation over base, aux and
        stations; optionally check the round trip."""
        hr = self.highres_aux_ds["elevation"]
        if data_processor is None:
            dp = DataProcessor()
            dp.set_coord_maps_from_extent(
                hr.coords["latitude"].min(), hr.coords["latitude"].max(),
                hr.coords["longitude"].min(), hr.coords["longitude"].max(),
            )
        else:
            dp = data_processor
        apply_only = data_processor is not None

        method = cfg.NORMALISATION[self.variable]

        def method_for(short_name: str) -> str:
            # each base/context variable normalises by its own method
            std = cfg.VAR_TO_STD.get(short_name)
            return cfg.NORMALISATION.get(std, method)

        # hourly records: fit stats on one random hour per day, then apply
        # to the full record
        if not apply_only:
            for k, v in self.base_ds.items():
                if "time" in v.dims and _is_hourly(v) and k not in dp.config:
                    dp._fit(k, random_hour_subset(v).data, method_for(k))
        base_n = Dataset({k: dp(v, method=method_for(k), assert_computed=apply_only)
                          for k, v in self.base_ds.items()})
        hr_n = Dataset({k: dp(v, method="min_max", assert_computed=apply_only)
                        for k, v in self.highres_aux_ds.items()})
        aux_n = Dataset({k: dp(v, method="min_max", assert_computed=apply_only)
                         for k, v in self.aux_ds.items()})
        lm_n = None
        if self.landmask_ds is not None:
            lm = self.landmask_ds
            lm_n = Field(lm.data, ("x1", "x2"),
                         {"x1": dp.map_x1(lm.coords["latitude"]),
                          "x2": dp.map_x2(lm.coords["longitude"])},
                         "landmask", dict(lm.attrs))
        st_n = (dp(self.station_df, method=method, assert_computed=apply_only)
                if self.station_df is not None else None)

        # humidity: shift the min_max output [-1, 1] → [0, 1] so the
        # spikes-beta head sees a unit-interval variable
        if self.variable == "humidity":
            short = cfg.VAR_ERA5[self.variable]["var_name"]
            if short in base_n:
                f = base_n[short]
                base_n[short] = f.copy(shift_humidity_to_unit_interval(f.data))
            if st_n is not None:
                for col in st_n.columns:
                    if col.endswith("_station"):
                        st_n[col] = shift_humidity_to_unit_interval(st_n[col])

        if test_norm:
            self.test_normalisation(dp, base_n, st_n)

        self.data_processor = dp
        self.base_ds_n = base_n
        self.highres_aux_ds_n = hr_n
        self.aux_ds_n = aux_n
        self.landmask_ds_n = lm_n
        self.station_df_n = st_n
        return dp

    def test_normalisation(self, dp, base_n, st_n) -> None:
        """raw == unnormalise(normalise(raw)) within 1e-3."""
        shifted = (cfg.VAR_ERA5[self.variable]["var_name"]
                   if self.variable == "humidity" else None)
        for k, f in base_n.items():
            if k == shifted:
                f = f.copy(shift_humidity_from_unit_interval(f.data))
            back = dp.unnormalise(f)
            raw = self._raw["base"][k]
            if not np.allclose(back.data, raw.data, atol=1e-3, equal_nan=True):
                raise AssertionError(f"normalisation round-trip failed for {k}")
        if st_n is not None:
            if self.variable == "humidity":
                st_n = st_n.copy()
                for col in st_n.columns:
                    if col.endswith("_station"):
                        st_n[col] = shift_humidity_from_unit_interval(st_n[col])
            back = dp.unnormalise(st_n)
            for col in back.columns:
                if col.endswith("_station") and not np.allclose(
                        back[col], self._raw["stations"][col], atol=1e-3, equal_nan=True):
                    raise AssertionError("station normalisation round-trip failed")

    # ------------------------------------------------------------ aux extras --

    def add_time_of_year(self, freq: str = "D") -> None:
        """Append cos/sin day-of-year (and hour-of-day for ``freq="H"``)
        channels, constant over the grid at each time, to the base."""
        base_n = self.base_ds_n
        out = dict(base_n.items())
        any_field = next(iter(base_n.values()))
        times = any_field.coords["time"]
        enc = circ_time_encoding(times, freq)
        h, w = any_field.shape[-2:]
        for name, vals in enc.items():
            arr = np.broadcast_to(vals[:, None, None].astype(np.float32),
                                  (len(times), h, w)).copy()
            out[name] = Field(arr, any_field.dims, dict(any_field.coords), name, {})
        self.base_ds_n = Dataset(out)

    def add_coordinate_channels(self) -> None:
        """Append x1/x2 positional channels to the aux grid."""
        ch = x1x2_channels(next(iter(self.aux_ds_n.values())))
        out = dict(self.aux_ds_n.items())
        out.update(dict(ch.items()))
        self.aux_ds_n = Dataset(out)

    # ------------------------------------------------------------- sequence --

    def run_processing_sequence(
        self,
        dem: Field,
        base_fields: dict[str, Field],
        station_df: StationFrame,
        highres_factor: int = 10,
        lowres_factor: int = 50,
        coarsen_factor: int = 1,
        include_landmask: bool = False,
        include_time_of_year: bool = False,
        time_of_year_freq: str = "D",
        include_coordinates: bool = False,
        data_processor: Optional[DataProcessor] = None,
        wrf_source=None,
        daily: bool = True,
        fill_missing_stations: bool = False,
        test_norm: bool = False,
    ) -> dict:
        """The whole sequence; returns the processed-output bundle."""
        self.load_topography(dem)
        self.preprocess_topography(highres_factor, lowres_factor, include_landmask)
        if self.base == "wrf":
            if wrf_source is None:
                raise ValueError("base='wrf' needs wrf_source (a WRFSource) for the regrid")
            self.preprocess_wrf(base_fields, wrf_source, coarsen_factor)
        else:
            self.preprocess_era5(base_fields, coarsen_factor, daily=daily)
        self.preprocess_stations(station_df, fill_missing=fill_missing_stations)
        self.calculate_data_processor(data_processor, test_norm=test_norm)
        if include_time_of_year:
            self.add_time_of_year(time_of_year_freq)
        if include_coordinates:
            self.add_coordinate_channels()
        return self.get_processed_output_dict()

    def get_processed_output_dict(self) -> dict:
        """The bundle the ``Train`` layer reads, plus raw variants."""
        return {
            "data_processor": self.data_processor,
            "base_ds": self.base_ds_n,
            "aux_ds": self.aux_ds_n,
            "highres_aux_ds": self.highres_aux_ds_n,
            "landmask_ds": self.landmask_ds_n,
            "station_df": self.station_df_n,
            "raw": dict(self._raw),
            "data_settings": {
                "variable": self.variable,
                "base": self.base,
                "area": self.area,
                "context_variables": self.context_variables,
            },
            "date_info": {
                "training_years": self.training_years,
                "validation_years": self.validation_years,
            },
        }

    def print_resolutions(self) -> None:
        hr = self.highres_aux_ds["elevation"]
        base = next(iter(self.base_ds.values()))
        print(f"highres aux resolution: {hr.resolution('latitude'):.4f}°")
        print(f"base resolution:        {base.resolution('latitude'):.4f}°")


# -- station helpers ----------------------------------------------------------


def adjust_duplicates(df: StationFrame, jitter: float = 1e-4) -> StationFrame:
    """Jitter stations that share identical coordinates: the second and
    later station names at one (lat, lon), keyed on coordinates rounded to
    8 decimals, move by ``uniform(-jitter, jitter, 2)·k·10`` (k its rank
    there), one draw per station in row order, the same at all its rows.
    Without a ``station_name`` column the key is the name, so nothing
    moves."""
    df = df.copy()
    lat, lon = df["latitude"], df["longitude"]
    key = list(zip(np.round(lat, 8).tolist(), np.round(lon, 8).tolist()))
    names = df["station_name"].tolist() if "station_name" in df.columns else key
    uniq: dict = {}
    for name, k in zip(names, key):
        seen = uniq.setdefault(k, [])
        if name not in seen:
            seen.append(name)
    lat_off = np.zeros(len(df))
    lon_off = np.zeros(len(df))
    rng = np.random.default_rng(0)
    offsets = {}
    for i, (name, k) in enumerate(zip(names, key)):
        idx = uniq[k].index(name)
        if idx > 0:
            if (k, name) not in offsets:
                offsets[(k, name)] = rng.uniform(-jitter, jitter, 2) * idx * 10
            lat_off[i], lon_off[i] = offsets[(k, name)]
    df["latitude"] = lat + lat_off
    df["longitude"] = lon + lon_off
    return df


def fill_missing_station_values(df: StationFrame) -> StationFrame:
    """Fill each NaN of a ``*_station`` column with the value of the
    nearest station (squared lat/lon distance, the first on a tie) that
    reports at the same time."""
    value_cols = [c for c in df.columns if c.endswith("_station")]
    out = df.copy()
    lat_all, lon_all = df["latitude"], df["longitude"]
    for _, rows in df.groupby_time():
        lat = lat_all[rows]
        lon = lon_all[rows]
        for col in value_cols:
            vals = df[col][rows]
            bad = ~np.isfinite(vals)
            if not bad.any() or bad.all():
                continue
            good_idx = np.nonzero(~bad)[0]
            bad_idx = np.nonzero(bad)[0]
            d2 = ((lat[bad_idx, None] - lat[good_idx][None, :]) ** 2
                  + (lon[bad_idx, None] - lon[good_idx][None, :]) ** 2)
            nearest = good_idx[np.argmin(d2, axis=1)]
            out[col][rows[bad_idx]] = vals[nearest]
    return out


def save_processed_bundle(bundle: dict, out_dir: str) -> None:
    """Write a processed-output bundle to ``out_dir`` in the JAX package's
    layout: ``data_processor.json``; ``base_ds.nc``, ``aux_ds.nc``,
    ``highres_aux_ds.nc`` and ``landmask_ds.nc`` (netCDF, float64 kept);
    ``station_df.pkl``; ``settings.json`` (data settings and dates). The
    station frame is pickled as a pandas DataFrame where pandas is
    installed, which both packages read, and as the port's
    :class:`StationFrame` elsewhere."""
    os.makedirs(out_dir, exist_ok=True)
    bundle["data_processor"].save(os.path.join(out_dir, "data_processor.json"))
    for key in ("base_ds", "aux_ds", "highres_aux_ds"):
        ds = bundle.get(key)
        if ds is not None:
            save_dataset(ds, os.path.join(out_dir, f"{key}.nc"), float32=False)
    lm = bundle.get("landmask_ds")
    if lm is not None:
        save_dataset(Dataset([lm]), os.path.join(out_dir, "landmask_ds.nc"), float32=False)
    st = bundle.get("station_df")
    if st is not None:
        try:
            st = st.to_pandas()
        except ImportError:
            pass  # the port's layout
        with open(os.path.join(out_dir, "station_df.pkl"), "wb") as f:
            pickle.dump(st, f)
    with open(os.path.join(out_dir, "settings.json"), "w") as f:
        json.dump({"data_settings": bundle.get("data_settings", {}),
                   "date_info": bundle.get("date_info", {})}, f, indent=2)


def load_processed_bundle(out_dir: str) -> dict:
    """The bundle :func:`save_processed_bundle` (of either package) wrote,
    without the raw variants; the station frame as a
    :class:`StationFrame`."""
    bundle: dict = {"raw": {}}
    bundle["data_processor"] = DataProcessor.load(os.path.join(out_dir, "data_processor.json"))
    for key in ("base_ds", "aux_ds", "highres_aux_ds"):
        path = os.path.join(out_dir, f"{key}.nc")
        bundle[key] = open_dataset(path) if os.path.exists(path) else None
    lm_path = os.path.join(out_dir, "landmask_ds.nc")
    bundle["landmask_ds"] = open_dataset(lm_path)["landmask"] if os.path.exists(lm_path) else None
    st_path = os.path.join(out_dir, "station_df.pkl")
    bundle["station_df"] = None
    if os.path.exists(st_path):
        with open(st_path, "rb") as f:
            st = FrameUnpickler(
                f, "this station_df.pkl holds a pandas DataFrame (a bundle written where "
                   "pandas is installed) and pandas is not installed; load the bundle once "
                   "where pandas is installed and save it again").load()
        bundle["station_df"] = StationFrame.from_pandas(st) if is_pandas_frame(st) else st
    with open(os.path.join(out_dir, "settings.json")) as f:
        bundle.update(json.load(f))
    return bundle


def _is_hourly(f: Field) -> bool:
    t = f.coords.get("time")
    if t is None or len(t) < 2:
        return False
    dt = np.diff(t.astype("datetime64[s]")).astype("timedelta64[h]").astype(int)
    return int(np.median(dt)) < 24
