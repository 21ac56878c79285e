"""Static configuration the port reads (numpy/json only).

Counterpart of ``deepsensornz_tpu/config.py``: the station registry, the
canonical variable names and their per-source short names, the
per-variable likelihoods and normalisation methods, the geographic
extents, the named locations the plots zoom to, the ConvNP defaults, the default training recipe, and the
``profile`` tables with ``apply_profile``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

_STATION_REGISTRY: Optional[dict] = None


def station_registry() -> dict:
    """name → {station_id, latitude, longitude, elevation} for the ~619 NZ
    stations, read on first use from the package's
    ``data/station_registry.json`` (``elevation`` may be None)."""
    global _STATION_REGISTRY
    if _STATION_REGISTRY is None:
        path = os.path.join(os.path.dirname(__file__), "data", "station_registry.json")
        with open(path) as f:
            _STATION_REGISTRY = json.load(f)
    return _STATION_REGISTRY


# Canonical variable names.
VARIABLE_OPTIONS = (
    "temperature",
    "precipitation",
    "surface_pressure",
    "10m_u_component_of_wind",
    "10m_v_component_of_wind",
    "humidity",
)

# Canonical name -> ERA5(-Land) short name.
VAR_ERA5 = {
    "temperature": {"var_name": "t2m", "units": "°C", "long_name": "2 m temperature"},
    "precipitation": {"var_name": "tp", "units": "mm", "long_name": "Total precipitation"},
    "surface_pressure": {"var_name": "sp", "units": "Pa", "long_name": "Surface pressure"},
    "10m_u_component_of_wind": {"var_name": "u10", "units": "m s-1", "long_name": "10 m U wind"},
    "10m_v_component_of_wind": {"var_name": "v10", "units": "m s-1", "long_name": "10 m V wind"},
    "humidity": {"var_name": "rh", "units": "1", "long_name": "Relative humidity"},
}

# Canonical name -> WRF output field.
VAR_WRF = {
    "temperature": {"var_name": "T2", "units": "K"},
    "precipitation": {"var_name": "RAINNC", "units": "mm"},
    "surface_pressure": {"var_name": "PSFC", "units": "Pa"},
    "10m_u_component_of_wind": {"var_name": "U10", "units": "m s-1"},
    "10m_v_component_of_wind": {"var_name": "V10", "units": "m s-1"},
    "humidity": {"var_name": "RH2", "units": "1"},
}

# Canonical name -> station archive variable and its archive subfolder.
VAR_STATIONS = {
    "temperature": {"var_name": "dry_bulb", "units": "°C", "subdir": "ScreenObs"},
    "precipitation": {"var_name": "precipitation", "units": "mm", "subdir": "Precipitation"},
    "surface_pressure": {"var_name": "stn_lev_pres", "units": "hPa", "subdir": "Pressure"},
    "10m_u_component_of_wind": {"var_name": "u", "units": "m s-1", "subdir": "Surface_Wind"},
    "10m_v_component_of_wind": {"var_name": "v", "units": "m s-1", "subdir": "Surface_Wind"},
    "humidity": {"var_name": "relative_humidity", "units": "1", "subdir": "ScreenObs"},
}

# Any per-source short name -> canonical name.
VAR_TO_STD = {}
for _std, _m in list(VAR_ERA5.items()) + list(VAR_WRF.items()) + list(VAR_STATIONS.items()):
    VAR_TO_STD[_m["var_name"]] = _std

# Per-variable output likelihood.
LIKELIHOODS = {
    "temperature": "cnp",
    "precipitation": "bernoulli-gamma",
    "surface_pressure": "cnp",
    "10m_u_component_of_wind": "cnp",
    "10m_v_component_of_wind": "cnp",
    "humidity": "cnp-spikes-beta",
}

# Per-variable normalisation method.
NORMALISATION = {
    "temperature": "mean_std",
    "precipitation": "positive_semidefinite",
    "surface_pressure": "mean_std",
    "10m_u_component_of_wind": "mean_std",
    "10m_v_component_of_wind": "mean_std",
    "humidity": "min_max",
}

# Geographic extents (lat/lon degrees) of the NZ domains.
EXTENTS = {
    "all": {"minlat": -47.95, "maxlat": -34.05, "minlon": 165.75, "maxlon": 178.70},
    "north_island": {"minlat": -41.7, "maxlat": -34.05, "minlon": 172.5, "maxlon": 178.70},
    "south_island": {"minlat": -47.95, "maxlat": -40.3, "minlon": 165.75, "maxlon": 174.5},
    "christchurch": {"minlat": -44.2, "maxlat": -43.0, "minlon": 171.0, "maxlon": 173.2},
}

# Named locations (lat, lon) the plots zoom to and mark.
LOCATION_LATLON = {
    "auckland": (-36.8485, 174.7633),
    "wellington": (-41.2866, 174.7756),
    "christchurch": (-43.5321, 172.6362),
    "dunedin": (-45.8788, 170.5028),
    "queenstown": (-45.0312, 168.6626),
    "hamilton": (-37.7870, 175.2793),
    "tauranga": (-37.6878, 176.1651),
    "napier": (-39.4928, 176.9120),
    "nelson": (-41.2706, 173.2840),
    "invercargill": (-46.4132, 168.3538),
    "taupo": (-38.6857, 176.0702),
    "hokitika": (-42.7166, 170.9632),
    "milford_sound": (-44.6717, 167.9256),
    "mt_cook": (-43.7340, 170.0966),
}

# ConvNP model defaults.
CONVNP_KWARGS_DEFAULT = {
    "unet_channels": (64, 64, 64, 64),
    "likelihood": "gnp",
    "internal_density": 500,
}

# Default training recipe.
TRAIN_DEFAULTS = {
    "lr": 5e-5,
    "weight_decay": 0.0,
    "batch_size": 8,
    "n_epochs": 30,
    "plateau_factor": 0.1,
    "plateau_patience": 5,
    "early_stop_patience": 10,
}


# Per-variable operating points of the training CLI's ``profile:`` key,
# the JAX package's (``deepsensornz_tpu/config.py``, where the studies
# behind them are described; they were measured with the JAX package and
# are not re-measured for the port). 'tuned': density 350 with
# per-variable smoothing; 'throughput': density 120 with the smoothing
# scale pinned.
TUNED_PROFILE = {
    "temperature": {"internal_density": 350},
    "precipitation": {"internal_density": 350, "init_lengthscale": 0.005},
    "surface_pressure": {"internal_density": 350, "init_lengthscale": 0.005},
    "10m_u_component_of_wind": {"internal_density": 350,
                                "lengthscale_lr_mult": 30.0},
    "10m_v_component_of_wind": {"internal_density": 350,
                                "lengthscale_lr_mult": 30.0},
    "humidity": {"internal_density": 350},
}

THROUGHPUT_PROFILE = {
    "temperature": {"internal_density": 120, "init_lengthscale": 0.00714},
    "precipitation": {"internal_density": 120, "init_lengthscale": 0.005},
    "surface_pressure": {"internal_density": 120, "init_lengthscale": 0.005},
    "10m_u_component_of_wind": {"internal_density": 120,
                                "init_lengthscale": 0.00714,
                                "lengthscale_lr_mult": 30.0},
    "10m_v_component_of_wind": {"internal_density": 120,
                                "init_lengthscale": 0.00714,
                                "lengthscale_lr_mult": 30.0},
    "humidity": {"internal_density": 120, "init_lengthscale": 0.00714},
}

PROFILES = {"tuned": TUNED_PROFILE, "throughput": THROUGHPUT_PROFILE}


def lengthscale_values(ls) -> list:
    """Numeric values of an ``init_lengthscale`` setting in any of its
    accepted forms — scalar, mapping, or (name, value) pair iterable (the
    same protocol ``utils.ARG_SCHEMA`` coerces from YAML and
    ``ConvNPConfig.__post_init__`` normalises; keep the three in sync)."""
    if isinstance(ls, (int, float)):
        return [float(ls)]
    pairs = ls.items() if hasattr(ls, "items") else ls
    return [float(v) for _, v in pairs]


def apply_profile(args: dict) -> dict:
    """Resolve ``profile: tuned`` / ``profile: throughput`` into
    per-variable measured-best settings.

    Explicit per-run values always win; the profile only fills keys the
    YAML left unset (or null). ``profile: parity`` / absent is a no-op.
    """
    profile = args.get("profile")
    if profile in (None, "parity"):
        return args
    if profile not in PROFILES:
        raise ValueError(
            f"unknown profile {profile!r}; use "
            f"{', '.join(map(repr, PROFILES))} or 'parity'")
    filled = set()
    for k, v in PROFILES[profile][args["variable"]].items():
        if args.get(k) is None:
            args[k] = v
            filled.add(k)
    # The profile's init_lengthscale values assume the profile's density.
    # If the combination ends up invalid (a length-scale at/below the
    # SetConv half-grid-spacing floor 0.5/density, which ConvNP refuses),
    # back off whichever side the PROFILE filled — never an explicit
    # per-run value (those always win). If BOTH are explicit, leave the
    # combo alone so the model raises its own loud error.
    ls, dens = args.get("init_lengthscale"), args.get("internal_density")
    if ls is not None and dens:
        vals = lengthscale_values(ls)
        # an empty per-scale mapping means "all scales default" (ConvNP
        # accepts it) — nothing to check against the floor
        if vals and min(vals) <= 0.5 / float(dens):
            if "init_lengthscale" in filled:
                warnings.warn(
                    f"profile {profile!r} init_lengthscale {ls} is "
                    f"at/below the grid floor 0.5/{dens}; dropping it for "
                    f"this run", stacklevel=2)
                args["init_lengthscale"] = None
            elif "internal_density" in filled:
                warnings.warn(
                    f"explicit init_lengthscale {ls} is at/below the grid "
                    f"floor at the profile's internal_density {dens}; "
                    f"dropping the profile's density for this run",
                    stacklevel=2)
                args["internal_density"] = None
    return args


def likelihood_for(variable: str) -> str:
    """Default likelihood for a canonical variable name."""
    return LIKELIHOODS[variable]


def normalisation_for(variable: str) -> str:
    """Default normalisation method for a canonical variable name."""
    return NORMALISATION[variable]
