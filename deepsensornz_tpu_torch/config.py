"""Static configuration the serving slice reads (numpy/json only).

Counterpart of ``deepsensornz_tpu/config.py``; only the geographic
extents are carried over so far.
"""

from __future__ import annotations

# Geographic extents (lat/lon degrees) of the NZ domains.
EXTENTS = {
    "all": {"minlat": -47.95, "maxlat": -34.05, "minlon": 165.75, "maxlon": 178.70},
    "north_island": {"minlat": -41.7, "maxlat": -34.05, "minlon": 172.5, "maxlon": 178.70},
    "south_island": {"minlat": -47.95, "maxlat": -40.3, "minlon": 165.75, "maxlon": 174.5},
    "christchurch": {"minlat": -44.2, "maxlat": -43.0, "minlon": 171.0, "maxlon": 173.2},
}
