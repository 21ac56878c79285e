"""Static configuration the port reads (numpy/json only).

Counterpart of ``deepsensornz_tpu/config.py``: the geographic extents, the
per-variable likelihoods and the ConvNP defaults that ``load_run`` falls
back on when a run's metadata has no ``model_config``.
"""

from __future__ import annotations

# Geographic extents (lat/lon degrees) of the NZ domains.
EXTENTS = {
    "all": {"minlat": -47.95, "maxlat": -34.05, "minlon": 165.75, "maxlon": 178.70},
    "north_island": {"minlat": -41.7, "maxlat": -34.05, "minlon": 172.5, "maxlon": 178.70},
    "south_island": {"minlat": -47.95, "maxlat": -40.3, "minlon": 165.75, "maxlon": 174.5},
    "christchurch": {"minlat": -44.2, "maxlat": -43.0, "minlon": 171.0, "maxlon": 173.2},
}

# Per-variable output likelihood.
LIKELIHOODS = {
    "temperature": "cnp",
    "precipitation": "bernoulli-gamma",
    "surface_pressure": "cnp",
    "10m_u_component_of_wind": "cnp",
    "10m_v_component_of_wind": "cnp",
    "humidity": "cnp-spikes-beta",
}

# ConvNP model defaults.
CONVNP_KWARGS_DEFAULT = {
    "unet_channels": (64, 64, 64, 64),
    "likelihood": "gnp",
    "internal_density": 500,
}
