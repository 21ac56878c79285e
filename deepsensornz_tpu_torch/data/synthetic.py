"""Synthetic NZ-like data for tests, smoke runs and benchmarks.

Copy of ``deepsensornz_tpu/data/synthetic.py``: a DEM with sea NaNs, a
coarse gridded base field and a ragged station table, drawn from the same
seeded generators in the same order, so each array equals the JAX
package's bit for bit. The station table is a :class:`StationFrame` with
the dtypes pandas infers from the JAX package's row dicts: ``time``
datetime64[s], ``station_id`` int64, every other column float64.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Field, _lookup


def _smooth_noise(rng, shape, octaves=4, scale=1.0):
    """Cheap multi-octave value noise via repeated upsample+blur."""
    out = np.zeros(shape, dtype=np.float64)
    for o in range(octaves):
        k = 2 ** (octaves - o - 1)
        small = rng.standard_normal((max(shape[0] // (4 * k), 2), max(shape[1] // (4 * k), 2)))
        ups = np.kron(small, np.ones((shape[0] // small.shape[0] + 1,
                                      shape[1] // small.shape[1] + 1)))
        ups = ups[: shape[0], : shape[1]]
        out += gaussian_filter(ups, sigma=2.0) * (scale / (o + 1))
    return out


def synthetic_dem(n_lat: int = 128, n_lon: int = 128, extent: str = "all", seed: int = 0,
                  terrain_scale: float = 800.0) -> Field:
    """Synthetic DEM: smooth mountains over an island, NaN over sea;
    ``terrain_scale`` sets mountain amplitude/roughness."""
    rng = np.random.default_rng(seed)
    e = cfg.EXTENTS[extent]
    lat = np.linspace(e["maxlat"], e["minlat"], n_lat)
    lon = np.linspace(e["minlon"], e["maxlon"], n_lon)
    terrain = _smooth_noise(rng, (n_lat, n_lon), octaves=4, scale=terrain_scale)
    terrain = np.abs(terrain) + 5.0
    # island mask: an ellipse-ish blob with noisy coastline
    yy, xx = np.meshgrid(np.linspace(-1, 1, n_lat), np.linspace(-1, 1, n_lon), indexing="ij")
    coast = _smooth_noise(rng, (n_lat, n_lon), octaves=3, scale=0.25)
    land = (yy**2 + xx**2 + coast) < 0.75
    dem = np.where(land, terrain, np.nan).astype(np.float32)
    return Field(dem, ("latitude", "longitude"), {"latitude": lat, "longitude": lon},
                 "elevation", {"units": "m", "synthetic": 1})


def synthetic_base_grid(variable: str = "temperature", n_times: int = 16, n_lat: int = 32,
                        n_lon: int = 32, extent: str = "all", start: str = "2000-01-01",
                        freq_hours: int = 24, seed: int = 1, base_noise: float = 2.0) -> Field:
    """Synthetic coarse base field (ERA5-like): seasonal cycle + smooth
    noise; ``base_noise`` scales the synoptic (smooth-noise) component."""
    rng = np.random.default_rng(seed)
    e = cfg.EXTENTS[extent]
    lat = np.linspace(e["maxlat"], e["minlat"], n_lat)
    lon = np.linspace(e["minlon"], e["maxlon"], n_lon)
    times = np.datetime64(start, "s") + np.arange(n_times) * np.timedelta64(freq_hours, "h")
    doy = (times - times.astype("datetime64[Y]")).astype("timedelta64[D]").astype(float)
    season = np.cos(2 * np.pi * (doy - 15) / 365.25)  # southern-hemisphere phase
    base = 12.0 - 8.0 * season[:, None, None]
    lat_grad = (lat - lat.mean())[None, :, None] * 0.6
    noise = np.stack([_smooth_noise(rng, (n_lat, n_lon), 3, base_noise)
                      for _ in range(n_times)])
    data = base + lat_grad + noise
    if variable == "precipitation":
        amount = np.maximum(np.exp(0.35 * (data - 8.0)) - 1.0, 0.0)
        # wet/dry from a smooth, spatially coherent potential (fronts), not
        # i.i.d. per-cell speckle
        rng2 = np.random.default_rng(seed + 7)
        wet_pot = np.stack([_smooth_noise(rng2, (n_lat, n_lon), 3, 1.0)
                            for _ in range(n_times)])
        wet_pot = wet_pot - np.quantile(wet_pot, 0.35)  # ~65 % wet
        data = amount * (wet_pot > 0.0)
    elif variable == "humidity":
        data = 1.0 / (1.0 + np.exp(-(data - 10.0) / 6.0))
    elif variable == "surface_pressure":
        data = 101325.0 + data * 50.0
    name = cfg.VAR_ERA5[variable]["var_name"]
    return Field(data.astype(np.float32), ("time", "latitude", "longitude"),
                 {"time": times, "latitude": lat, "longitude": lon},
                 name, {"synthetic": 1, "variable": variable})


def synthetic_stations(base: Field, dem: Field, variable: str = "temperature",
                       n_stations: int = 64, missing_frac: float = 0.1, seed: int = 2,
                       lapse_rate: float = 0.0065, obs_noise: float = 0.5) -> StationFrame:
    """Synthetic station table: the base field at random land points
    (nearest cell) + elevation lapse + local noise; ~``missing_frac`` of
    the observations dropped to mimic ragged availability. ``lapse_rate``
    (temperature °C/m) and ``obs_noise`` (temperature σ, °C) are the
    sub-grid-signal / noise-floor knobs; the other variables keep their
    fixed processes. The draws come in the JAX package's row order."""
    rng = np.random.default_rng(seed)
    land_idx = np.argwhere(~np.isnan(dem.data))
    pick = land_idx[rng.choice(len(land_idx), size=n_stations,
                               replace=len(land_idx) < n_stations)]
    lats = dem.coords["latitude"][pick[:, 0]]
    lons = dem.coords["longitude"][pick[:, 1]]
    elevs = dem.data[pick[:, 0], pick[:, 1]]
    # jitter off-grid so stations are genuinely irregular
    res = dem.resolution("latitude")
    lats = lats + rng.uniform(-0.4, 0.4, n_stations) * res
    lons = lons + rng.uniform(-0.4, 0.4, n_stations) * res

    # each station's nearest base cell (the same at every time)
    ilat = _lookup(base.coords["latitude"], lats.astype(np.float64), method="nearest")
    ilon = _lookup(base.coords["longitude"], lons.astype(np.float64), method="nearest")
    b = np.moveaxis(base.data, [base.axis(d) for d in ("time", "latitude", "longitude")],
                    [0, 1, 2])[:, ilat, ilon]  # (time, station)
    times = base.coords["time"]
    t_i, s_i, ys = [], [], []
    for ti in range(len(times)):
        for si in range(n_stations):
            if rng.random() < missing_frac:
                continue
            y = float(b[ti, si])
            elev = float(elevs[si])
            if variable == "temperature":
                y = y - lapse_rate * elev + rng.normal(0, obs_noise)
            elif variable == "precipitation":
                # orographic enhancement of the amount; occurrence dries in
                # sheltered low stations inside a wet cell; a wet draw is
                # floored at a trace amount, dry cells stay exactly dry
                if y > 0.0:
                    p_wet = 1.0 / (1.0 + np.exp(-(elev - 500.0) / 250.0))
                    if rng.random() < p_wet:
                        y = max(y * (1 + 0.002 * elev) + rng.normal(0, 0.05), 0.01)
                    else:
                        y = 0.0
            elif variable == "humidity":
                # elevation-dependent drying + small noise (bounded [0, 1])
                y = float(np.clip(y * (1 - 0.0004 * elev) + rng.normal(0, 0.02), 0.0, 1.0))
            elif variable == "surface_pressure":
                # barometric elevation reduction (scale height ~8434 m), ~20 Pa noise
                y = y * float(np.exp(-elev / 8434.0)) + rng.normal(0, 20.0)
            else:
                y = y + rng.normal(0, 0.05 * (abs(y) + 1.0))
            t_i.append(ti)
            s_i.append(si)
            ys.append(y)
    t_i = np.asarray(t_i, np.intp)
    s_i = np.asarray(s_i, np.int64)
    col = cfg.VAR_STATIONS[variable]["var_name"] + "_station"
    return StationFrame({
        "time": times[t_i],
        "latitude": lats[s_i].astype(np.float64),
        "longitude": lons[s_i].astype(np.float64),
        "station_id": s_i,
        "elevation": elevs[s_i].astype(np.float64),
        col: np.asarray(ys, np.float64),
    })


def synthetic_bundle(variable: str = "temperature", n_times: int = 16,
                     base_hw: tuple[int, int] = (32, 32), dem_hw: tuple[int, int] = (128, 128),
                     n_stations: int = 64, seed: int = 0, world: dict | None = None):
    """(base Field, DEM Field, station StationFrame) in one call. ``world``
    bundles the generator knobs: ``terrain_scale``, ``base_noise``,
    ``lapse_rate``, ``obs_noise`` and ``n_stations``; the defaults give the
    JAX package's default world."""
    world = dict(world or {})
    n_stations = world.pop("n_stations", n_stations)
    dem = synthetic_dem(*dem_hw, seed=seed, terrain_scale=world.pop("terrain_scale", 800.0))
    base = synthetic_base_grid(variable, n_times, *base_hw, seed=seed + 1,
                               base_noise=world.pop("base_noise", 2.0))
    stations = synthetic_stations(
        base, dem, variable, n_stations, seed=seed + 2,
        lapse_rate=world.pop("lapse_rate", 0.0065),
        obs_noise=world.pop("obs_noise", 0.5),
    )
    if world:
        raise ValueError(f"unknown world knobs: {sorted(world)}")
    return base, dem, stations
