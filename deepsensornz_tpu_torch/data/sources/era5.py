"""ERA5(-Land) reanalysis reader and transforms.

Counterpart of ``deepsensornz_tpu/data/sources/era5.py``:

- ``ERA5Source``: year files of a variable found across the archive's
  layouts (``<parent>/<name>/*<year>*.nc``, ``<parent>/<name>/<year>/*.nc``
  and flat ``<parent>/*<name>*<year>*.nc``, for the canonical and the
  short name), concatenated along time; ``load_time`` reads only the rows
  around the requested times (an h5py hyperslab) and snaps to them;
- hourly→daily resampling (mean, or sum for precipitation), Kelvin→Celsius
  and bilinear regridding onto another Field's lat/lon grid;
- ``concat_time``: sorted, duplicate-free concatenation along time.

Reading needs h5py (``data.grid.open_dataset``); the transforms are numpy.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.grid import Field, open_dataset


class ERA5Source:
    """Load ERA5 variables from a directory of netCDF files."""

    def __init__(self, parent: str):
        self.parent = parent

    def candidate_files(self, variable: str, years: Sequence[int]) -> list[str]:
        """The files of a canonical variable for ``years``, across the known
        layouts, each once, in the order the layouts are tried."""
        short = cfg.VAR_ERA5[variable]["var_name"]
        pats = []
        for name in (variable, short):
            for y in years:
                pats += [
                    os.path.join(self.parent, name, f"*{y}*.nc"),
                    os.path.join(self.parent, name, str(y), "*.nc"),
                    os.path.join(self.parent, f"*{name}*{y}*.nc"),
                ]
        seen, out = set(), []
        for p in pats:
            for f in sorted(glob.glob(p)):
                if f not in seen:
                    seen.add(f)
                    out.append(f)
        return out

    def load(self, variable: str, years: Sequence[int],
             time_window: tuple | None = None) -> Field:
        """The variable's year files concatenated along time (named by its
        short name). ``time_window=(t0, t1)`` reads only each file's rows
        inside the window; files without an overlap contribute nothing."""
        files = self.candidate_files(variable, years)
        if not files:
            raise FileNotFoundError(
                f"no ERA5 files for {variable!r} years {list(years)} under {self.parent}")
        short = cfg.VAR_ERA5[variable]["var_name"]
        pieces = []
        for f in files:
            ds = open_dataset(f, time_window=time_window)
            name = short if short in ds else next(iter(ds.keys()))
            fld = ds[name]
            if "time" in fld.dims and fld.data.shape[fld.axis("time")] == 0:
                continue  # the file lies outside the window
            if "expver" in fld.dims:  # ERA5T's experiment axis
                fld = fld.isel(expver=0)
            pieces.append(fld)
        if not pieces:
            raise FileNotFoundError(
                f"ERA5 files for {variable!r} exist but none overlap time_window={time_window}")
        return concat_time(pieces).rename(short)

    def load_time(self, variable: str, times: np.ndarray,
                  window_pad: np.timedelta64 = np.timedelta64(1, "h")) -> Field:
        """Exactly the requested times, nearest in time: only the rows in
        [min(times) - pad, max(times) + pad] are read."""
        times = np.asarray(times, dtype="datetime64[s]")
        years = sorted({int(str(t.astype("datetime64[Y]"))) for t in times})
        fld = self.load(variable, years,
                        time_window=(times.min() - window_pad, times.max() + window_pad))
        return fld.sel(time=times, method="nearest")

    @staticmethod
    def hourly_to_daily(fld: Field, variable: str) -> Field:
        """Daily mean (sum for precipitation)."""
        return daily_resample(fld, "sum" if variable == "precipitation" else "mean")

    @staticmethod
    def kelvin_to_celsius(fld: Field) -> Field:
        out = fld.copy(fld.data - 273.15)
        out.attrs["units"] = "°C"
        return out

    @staticmethod
    def interpolate_to(fld: Field, target: Field) -> Field:
        """Bilinear regrid onto another Field's lat/lon grid."""
        return fld.interp_like(target, method="linear")


def daily_resample(fld: Field, how: str = "mean") -> Field:
    """Group a time-dimensioned Field by calendar day and reduce (``mean``
    or ``sum``; NaN counts as 0, the mean divides by the day's count)."""
    t = fld.coords["time"].astype("datetime64[s]")
    days = t.astype("datetime64[D]")
    uniq, inv = np.unique(days, return_inverse=True)
    ax = fld.axis("time")
    counts = np.zeros(len(uniq))
    data = np.moveaxis(fld.data, ax, 0)
    acc = np.zeros((len(uniq),) + data.shape[1:], dtype=np.float64)
    np.add.at(acc, inv, np.nan_to_num(data))
    np.add.at(counts, inv, 1)
    if how == "mean":
        acc = acc / np.maximum(counts.reshape((-1,) + (1,) * (acc.ndim - 1)), 1)
    out = np.moveaxis(acc, 0, ax)
    coords = dict(fld.coords)
    coords["time"] = uniq.astype("datetime64[s]")
    return Field(out.astype(fld.data.dtype), fld.dims, coords, fld.name, dict(fld.attrs))


def concat_time(fields: list[Field]) -> Field:
    """Concatenate Fields along time, sorted and deduplicated (the first
    of equal times kept, in a stable sort)."""
    if len(fields) == 1:
        f = fields[0]
    else:
        ax = fields[0].axis("time")
        data = np.concatenate([x.data for x in fields], axis=ax)
        t = np.concatenate([x.coords["time"] for x in fields]).astype("datetime64[s]")
        coords = dict(fields[0].coords)
        coords["time"] = t
        f = Field(data, fields[0].dims, coords, fields[0].name, dict(fields[0].attrs))
    order = np.argsort(f.coords["time"].astype("datetime64[s]"))
    t_sorted = f.coords["time"][order]
    keep = np.ones(len(order), bool)
    keep[1:] = t_sorted[1:] != t_sorted[:-1]
    return f.isel(time=order[keep])
