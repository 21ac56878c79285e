"""ERA5(-Land) transforms.

Only ``daily_resample`` of ``deepsensornz_tpu/data/sources/era5.py`` is
ported: preprocessing turns an hourly base field into a daily one with it.
The archive readers (``ERA5Source``) need netCDF and wait.
"""

from __future__ import annotations

import numpy as np

from deepsensornz_tpu_torch.data.grid import Field


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
