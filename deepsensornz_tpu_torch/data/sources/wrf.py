"""WRF NWP forecast reader and its regridder.

Counterpart of ``deepsensornz_tpu/data/sources/wrf.py``:

- forecast-cycle files: midnight inits, the first 6 spin-up hours skipped,
  hours 6–30 taken, named
  ``<parent>/<YYYYMMDD>/<model>/wrf_hourly_<model>_d02_<valid>.nc``;
- the threaded load of a cycle's hourly files, per-file variable
  selection, and a report naming every unreadable member;
- the curvilinear → regular regrid onto a lat/lon grid (the topography's):
  a scipy ``Delaunay`` triangulation of the WRF points and barycentric
  weights, built once per (source shape, target grid) and reused, kept in
  memory and, with ``weights_dir``, in ``.npz`` files (written under a
  per-writer temporary name, then ``os.replace``), interchangeable with
  the JAX package's.

The regrid is host numpy, the JAX one's arithmetic bit for bit. Reading
the files needs h5py (``data.grid.open_dataset``); the regrid does not.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta
from typing import Optional, Sequence

import numpy as np

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.grid import Field, open_dataset

SPINUP_HOURS = 6
CYCLE_HOURS = 24  # hours used per cycle after spin-up (6..30)


class WRFSource:
    """Load WRF forecast cycles from a directory tree of hourly files."""

    def __init__(self, parent: str, model: str = "nz4kmN-ECMWF-SIGMA",
                 weights_dir: Optional[str] = None):
        """``weights_dir``: where regrid weights persist; by default the
        data paths' ``regridder_weights.parent`` where one is configured,
        else weights are kept in memory only."""
        self.parent = parent
        self.model = model
        self._regrid_cache: dict[tuple, object] = {}
        if weights_dir is None:
            from deepsensornz_tpu_torch.paths import get_data_paths

            try:
                weights_dir = get_data_paths().get("regridder_weights", {}).get("parent")
            except (FileNotFoundError, AttributeError):
                weights_dir = None
        self.weights_dir = weights_dir

    # -- cycle discovery ---------------------------------------------------------

    @staticmethod
    def cycle_hours(init: datetime) -> list[datetime]:
        """Valid times used from one (midnight) init: hours 6..30."""
        return [init + timedelta(hours=h) for h in range(SPINUP_HOURS, SPINUP_HOURS + CYCLE_HOURS)]

    def filename_for(self, init: datetime, valid: datetime) -> str:
        return os.path.join(
            self.parent, init.strftime("%Y%m%d"), self.model,
            f"wrf_hourly_{self.model}_d02_{valid.strftime('%Y-%m-%d_%H:%M:%S')}.nc")

    def get_filepaths(self, init_start: datetime, init_end: Optional[datetime] = None,
                      step_days: int = 1) -> list[str]:
        """Every existing hourly file of the midnight cycles in
        [init_start, init_end], every ``step_days`` days."""
        init_end = init_end or init_start
        out = []
        init = init_start.replace(hour=0, minute=0, second=0, microsecond=0)
        while init <= init_end:
            for valid in self.cycle_hours(init):
                path = self.filename_for(init, valid)
                if os.path.exists(path):
                    out.append(path)
            init += timedelta(days=step_days)
        return out

    @staticmethod
    def parse_valid_time(path: str) -> np.datetime64:
        """The valid time of a ``d02_%Y-%m-%d_%H:%M:%S`` file name."""
        ts = os.path.basename(path).split("d02_")[-1].replace(".nc", "")
        return np.datetime64(datetime.strptime(ts, "%Y-%m-%d_%H:%M:%S"))

    # -- loading -----------------------------------------------------------------

    def load(self, filepaths: Sequence[str], variables: Sequence[str]) -> dict[str, Field]:
        """The hourly files stacked along time, canonical name → Field
        (``("time", "y", "x")`` float32, the 2-D ``lat2d``/``lon2d`` in its
        attributes). Raises ``IOError`` naming every file that did not open,
        ``KeyError`` for a missing variable or coordinates."""
        shorts = {v: cfg.VAR_WRF[v]["var_name"] for v in variables}

        def one(path):
            """(path, time, per-variable arrays, lat2d, lon2d), or the path
            and Nones where it does not open."""
            try:
                ds = open_dataset(path)
            except Exception:
                return path, None, None, None, None
            cols = {}
            for v, s in shorts.items():
                if s not in ds:
                    raise KeyError(f"variable {s} missing from {path}")
                cols[v] = np.squeeze(ds[s].data)
            la = lo = None
            for latname in ("XLAT", "latitude", "lat"):
                if latname in ds:
                    la = np.squeeze(ds[latname].data)
            for lonname in ("XLONG", "longitude", "lon"):
                if lonname in ds:
                    lo = np.squeeze(ds[lonname].data)
            return path, self.parse_valid_time(path), cols, la, lo

        with ThreadPoolExecutor(min(8, max(1, len(filepaths)))) as ex:
            loaded = list(ex.map(one, filepaths))

        per_var: dict[str, list] = {v: [] for v in variables}
        times, bad = [], []
        lat2d = lon2d = None
        for path, t_valid, cols, la, lo in loaded:
            if t_valid is None:
                bad.append(path)
                continue
            times.append(t_valid)
            for v in shorts:
                per_var[v].append(cols[v])
            lat2d = la if la is not None else lat2d
            lon2d = lo if lo is not None else lon2d
        if bad:
            raise IOError(f"unreadable WRF files: {bad}")
        if lat2d is None or lon2d is None:
            raise KeyError("WRF files missing XLAT/XLONG coordinates")
        t = np.asarray(times, dtype="datetime64[s]")
        out = {}
        for v in variables:
            fld = Field(np.stack(per_var[v]).astype(np.float32), ("time", "y", "x"),
                        {"time": t}, shorts[v], {"curvilinear": 1})
            fld.attrs["lat2d"] = lat2d
            fld.attrs["lon2d"] = lon2d
            out[v] = fld
        return out

    # -- regridding ----------------------------------------------------------------

    def _weights_path(self, key: tuple) -> Optional[str]:
        if not self.weights_dir:
            return None
        (sh, nlat, nlon, lat0, lon0) = key
        name = f"regrid_{sh[0]}x{sh[1]}_to_{nlat}x{nlon}_{lat0:.4f}_{lon0:.4f}.npz"
        return os.path.join(self.weights_dir, name)

    def _load_weights(self, key: tuple):
        """Persisted weights (verts, bary, valid), or None where there are
        none or the file is unreadable (then they are recomputed)."""
        path = self._weights_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return z["verts"], z["bary"], z["valid"]
        except (OSError, ValueError, KeyError):
            return None

    def _save_weights(self, key: tuple, verts, bary, valid) -> None:
        path = self._weights_path(key)
        if path is None:
            return
        os.makedirs(self.weights_dir, exist_ok=True)
        # a per-writer temporary name: two processes regridding one geometry
        # must not write into one file before the atomic replace
        tmp = f"{path}.{os.getpid()}.tmp"
        np.savez_compressed(tmp, verts=verts, bary=bary, valid=valid)
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)  # savez adds .npz

    def regrid_to(self, fld: Field, target_lat: np.ndarray, target_lon: np.ndarray) -> Field:
        """Curvilinear → regular bilinear regrid of every time of ``fld``
        (NaN read as 0, NaN outside the source hull), as float32
        ``("time", "latitude", "longitude")``. The weights of each target
        cell, its triangle's vertices and barycentric weights in a Delaunay
        triangulation of the source points, come from memory, from
        ``weights_dir`` or a new triangulation, keyed by the source shape
        and the target grid."""
        lat2d = fld.attrs["lat2d"]
        lon2d = fld.attrs["lon2d"]
        key = (lat2d.shape, len(target_lat), len(target_lon),
               float(target_lat[0]), float(target_lon[0]))
        if key not in self._regrid_cache:
            loaded = self._load_weights(key)
            if loaded is not None:
                self._regrid_cache[key] = loaded
        if key not in self._regrid_cache:
            from scipy.spatial import Delaunay

            tri = Delaunay(np.column_stack([lat2d.ravel(), lon2d.ravel()]))
            tg_lat, tg_lon = np.meshgrid(target_lat, target_lon, indexing="ij")
            query = np.column_stack([tg_lat.ravel(), tg_lon.ravel()])
            simplex = tri.find_simplex(query)
            valid = simplex >= 0
            verts = tri.simplices[np.maximum(simplex, 0)]
            T = tri.transform[np.maximum(simplex, 0)]
            bary2 = np.einsum("nij,nj->ni", T[:, :2], query - T[:, 2])
            bary = np.column_stack([bary2, 1.0 - bary2.sum(1)])
            self._regrid_cache[key] = (verts, bary, valid)
            self._save_weights(key, verts, bary, valid)
        verts, bary, valid = self._regrid_cache[key]

        data = fld.data.reshape(fld.data.shape[0], -1)
        vals = data[:, verts]  # (T, P, 3)
        out = np.einsum("tpv,pv->tp", np.nan_to_num(vals), bary)
        out[:, ~valid] = np.nan
        out = out.reshape(fld.data.shape[0], len(target_lat), len(target_lon))
        return Field(
            out.astype(np.float32), ("time", "latitude", "longitude"),
            {"time": fld.coords["time"], "latitude": np.asarray(target_lat),
             "longitude": np.asarray(target_lon)},
            fld.name, {"units": fld.attrs.get("units", "")})
