"""Feature engineering for the downscaling pipeline (numpy/scipy).

Copy of ``deepsensornz_tpu/data/features.py`` on the port's ``Field`` and
``Dataset``:

- :func:`compute_tpi` — topographic position index at several window
  scales, through ``scipy.ndimage.gaussian_filter``;
- :func:`elevation_difference` — highres minus nearest-upsampled lowres
  elevation;
- :func:`landmask_from_elevation` — land/sea mask from DEM NaNs;
- :func:`circ_time_encoding` — circular day-of-year / hour-of-day encodings;
- :func:`x1x2_channels` — positional-coordinate aux channels;
- :func:`wind_components` — u/v from speed and direction;
- the humidity interval shifts, :func:`random_hour_subset` and :func:`rmse`.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from deepsensornz_tpu_torch.data.grid import Dataset, Field


def compute_tpi(elevation: Field, window_degrees: tuple[float, ...] = (0.1, 0.05, 0.025)) -> Dataset:
    """Topographic position index at several smoothing scales.

    TPI(scale) = elevation − gaussian_filter(elevation, sigma=scale), where
    sigma is the window size converted from degrees to grid cells. NaNs (sea)
    are treated as elevation 0 for the filter (fill, then filter).
    """
    res = elevation.resolution("latitude")
    elev = elevation.fillna(0.0).data.astype(np.float64)
    out = {}
    for w in window_degrees:
        sigma = max(w / res, 1e-6)
        smoothed = gaussian_filter(elev, sigma=sigma, mode="nearest")
        name = f"TPI_{w}"
        out[name] = Field(
            (elev - smoothed).astype(np.float32),
            elevation.dims,
            dict(elevation.coords),
            name,
            {"window_degrees": w},
        )
    return Dataset(out)


def elevation_difference(highres: Field, lowres: Field) -> Field:
    """highres − nearest-neighbour-upsampled lowres elevation.

    Captures sub-grid orography the coarse field cannot see.
    """
    up = lowres.fillna(0.0).interp_like(highres, method="nearest")
    diff = highres.fillna(0.0).data - up.data
    return Field(diff.astype(np.float32), highres.dims, dict(highres.coords),
                 "elevation_diff", {})


def landmask_from_elevation(elevation: Field) -> Field:
    """1.0 over land, 0.0 over sea, from DEM NaNs."""
    mask = (~np.isnan(elevation.data)).astype(np.float32)
    return Field(mask, elevation.dims, dict(elevation.coords), "landmask", {})


def circ_time_encoding(times: np.ndarray, freq: str = "D") -> dict[str, np.ndarray]:
    """Circular encodings of time.

    ``freq='D'`` → ``cos_D``/``sin_D`` over day-of-year; ``freq='H'`` →
    additionally ``cos_H``/``sin_H`` over hour-of-day.
    """
    t = np.asarray(times, dtype="datetime64[s]")
    years = t.astype("datetime64[Y]")
    doy = (t - years).astype("timedelta64[D]").astype(np.float64)
    year_len = ((years + 1).astype("datetime64[D]") - years.astype("datetime64[D]")).astype(np.float64)
    phase_d = 2.0 * np.pi * doy / year_len
    out = {"cos_D": np.cos(phase_d), "sin_D": np.sin(phase_d)}
    if freq.upper().startswith("H"):
        days = t.astype("datetime64[D]")
        hours = (t - days).astype("timedelta64[h]").astype(np.float64)
        phase_h = 2.0 * np.pi * hours / 24.0
        out["cos_H"] = np.cos(phase_h)
        out["sin_H"] = np.sin(phase_h)
    return out


def x1x2_channels(template: Field) -> Dataset:
    """Broadcast x1/x2 coordinate arrays as aux channels; they break the
    CNN's translation equivariance so the model can learn location-specific
    behaviour."""
    x1 = template.coords[template.dims[-2]].astype(np.float32)
    x2 = template.coords[template.dims[-1]].astype(np.float32)
    h, w = len(x1), len(x2)
    x1_arr = np.broadcast_to(x1[:, None], (h, w)).copy()
    x2_arr = np.broadcast_to(x2[None, :], (h, w)).copy()
    dims = template.dims[-2:]
    coords = {dims[0]: template.coords[dims[0]], dims[1]: template.coords[dims[1]]}
    return Dataset({
        "x1_arr": Field(x1_arr, dims, coords, "x1_arr", {}),
        "x2_arr": Field(x2_arr, dims, coords, "x2_arr", {}),
    })


def wind_components(speed: np.ndarray, direction_deg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Meteorological u/v from speed + direction."""
    theta = np.deg2rad(np.asarray(direction_deg, dtype=np.float64))
    u = -np.asarray(speed, dtype=np.float64) * np.sin(theta)
    v = -np.asarray(speed, dtype=np.float64) * np.cos(theta)
    return u, v


def shift_humidity_to_unit_interval(values: np.ndarray) -> np.ndarray:
    """[-1, 1] (min_max output) → [0, 1]."""
    return (np.asarray(values) + 1.0) / 2.0


def shift_humidity_from_unit_interval(values: np.ndarray) -> np.ndarray:
    """[0, 1] → [-1, 1] before unnormalisation."""
    return np.asarray(values) * 2.0 - 1.0


def random_hour_subset(field: Field, seed: int = 0) -> Field:
    """One random hour per day: the subsample normalisation stats are
    fitted on for hourly data (every hour of a long hourly record is
    wasteful and biases toward high-frequency structure)."""
    t = field.coords["time"].astype("datetime64[s]")
    days = t.astype("datetime64[D]")
    uniq = np.unique(days)
    rng = np.random.default_rng(seed)
    picks = []
    for d in uniq:
        idx = np.nonzero(days == d)[0]
        picks.append(idx[rng.integers(len(idx))])
    return field.isel(time=np.asarray(picks))


def rmse(pred: np.ndarray, truth: np.ndarray) -> float:
    """Root-mean-square error over finite pairs."""
    p = np.asarray(pred, dtype=np.float64).ravel()
    t = np.asarray(truth, dtype=np.float64).ravel()
    ok = np.isfinite(p) & np.isfinite(t)
    return float(np.sqrt(np.mean((p[ok] - t[ok]) ** 2)))
