"""Digital elevation model reader.

Counterpart of ``deepsensornz_tpu/data/sources/topography.py``: opens the
NZ DEM netCDF (the ``elevation`` variable, or the file's first) with an
optional crop to one of ``config.EXTENTS`` and block coarsening. Reading
needs h5py (``data.grid.open_dataset``).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.grid import Field, open_dataset


class TopographySource:
    def __init__(self, path: str):
        self.path = path

    @classmethod
    def discover(cls, parent: str, pattern: str = "nz_elevation_*.nc") -> "TopographySource":
        """The DEM under ``parent`` by the archive's naming,
        ``nz_elevation_<res>m.nc``: with several resolutions the finest
        (smallest ``<N>m``) wins; names without one sort last."""
        hits = sorted(glob.glob(os.path.join(parent, pattern)))
        if not hits:
            raise FileNotFoundError(
                f"no DEM matching {pattern!r} under {parent!r} "
                "(reference convention: nz_elevation_<res>m.nc)")

        def res_m(p: str) -> float:
            m = re.search(r"_(\d+)m", os.path.basename(p))
            return float(m.group(1)) if m else float("inf")

        return cls(min(hits, key=res_m))

    def load(self, area: Optional[str] = None, coarsen: int = 1) -> Field:
        ds = open_dataset(self.path)
        name = "elevation" if "elevation" in ds else next(iter(ds.keys()))
        dem = ds[name].rename("elevation")
        if area is not None:
            e = cfg.EXTENTS[area]
            lat = dem.coords["latitude"]
            asc = lat[0] < lat[-1]
            lat_slice = (slice(e["minlat"], e["maxlat"]) if asc
                         else slice(e["maxlat"], e["minlat"]))
            dem = dem.sel(latitude=lat_slice, longitude=slice(e["minlon"], e["maxlon"]))
        if coarsen > 1:
            dem = dem.coarsen(coarsen)
        return dem


def topography_from_paths(paths: dict) -> TopographySource:
    """The DEM of a data-paths dict: ``topography.file`` when set, else the
    ``nz_elevation_*.nc`` found under ``topography.parent``."""
    topo = paths.get("topography", {})
    if topo.get("file"):
        return TopographySource(topo["file"])
    if topo.get("parent"):
        return TopographySource.discover(topo["parent"])
    raise KeyError("DATA_PATHS['topography'] needs 'file' or 'parent' "
                   "(nz_elevation_*.nc discovery)")
