"""Static configuration the port reads (numpy/json only).

Counterpart of ``deepsensornz_tpu/config.py``: the station registry, the
canonical variable names and their per-source short names, the
per-variable likelihoods and normalisation methods, the geographic
extents, the ConvNP defaults and the default training recipe. The
``profile`` tables and ``apply_profile`` are not carried over yet.
"""

from __future__ import annotations

import json
import os
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


def likelihood_for(variable: str) -> str:
    """Default likelihood for a canonical variable name."""
    return LIKELIHOODS[variable]


def normalisation_for(variable: str) -> str:
    """Default normalisation method for a canonical variable name."""
    return NORMALISATION[variable]
