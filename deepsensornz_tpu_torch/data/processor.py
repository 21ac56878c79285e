"""DataProcessor: coordinate maps + per-variable value normalisation.

numpy copy of ``deepsensornz_tpu/data/processor.py``: the linear
latitude/longitude → x1/x2 maps; per-variable value normalisation
(``mean_std``, ``min_max`` to [-1, 1], ``positive_semidefinite``) whose
stats are fitted on first use and kept in the ``config`` dict; applied to
a :class:`Field`, a :class:`Dataset`, a :class:`StationFrame` or a list of
them, with exact inverses (``unnormalise``) and an apply-only mode
(``assert_computed=True``); and the JSON ``save``/``load`` format, so a
processor written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Dataset, Field


class DataProcessor:
    """Normalise coordinates and values into model space and back."""

    def __init__(
        self,
        x1_map: tuple[float, float] | None = None,
        x2_map: tuple[float, float] | None = None,
        x1_name: str = "latitude",
        x2_name: str = "longitude",
        config: dict[str, Any] | None = None,
    ):
        # (lo, hi) in raw coordinates; x = (raw - lo) / (hi - lo)
        self.x1_map = tuple(x1_map) if x1_map is not None else None
        self.x2_map = tuple(x2_map) if x2_map is not None else None
        self.x1_name = x1_name
        self.x2_name = x2_name
        # var name -> {"method": ..., "params": {...}}
        self.config: dict[str, Any] = dict(config or {})

    # -- coordinate maps ------------------------------------------------------

    def set_coord_maps_from_extent(self, minlat, maxlat, minlon, maxlon) -> None:
        self.x1_map = (float(minlat), float(maxlat))
        self.x2_map = (float(minlon), float(maxlon))

    def map_x1(self, lat) -> np.ndarray:
        lo, hi = self.x1_map
        return (np.asarray(lat, dtype=np.float64) - lo) / (hi - lo)

    def map_x2(self, lon) -> np.ndarray:
        lo, hi = self.x2_map
        return (np.asarray(lon, dtype=np.float64) - lo) / (hi - lo)

    def unmap_x1(self, x1) -> np.ndarray:
        lo, hi = self.x1_map
        return np.asarray(x1, dtype=np.float64) * (hi - lo) + lo

    def unmap_x2(self, x2) -> np.ndarray:
        lo, hi = self.x2_map
        return np.asarray(x2, dtype=np.float64) * (hi - lo) + lo

    # -- value normalisation ---------------------------------------------------

    def _fit(self, name: str, values: np.ndarray, method: str) -> dict:
        v = np.asarray(values, dtype=np.float64)
        v = v[np.isfinite(v)]
        if method == "mean_std":
            params = {"mean": float(v.mean()), "std": float(max(v.std(), 1e-12))}
        elif method == "min_max":
            params = {"min": float(v.min()), "max": float(v.max())}
        elif method == "positive_semidefinite":
            params = {"std": float(max(v.std(), 1e-12))}
        else:
            raise ValueError(f"unknown normalisation method {method!r}")
        self.config[name] = {"method": method, "params": params}
        return self.config[name]

    def _apply_values(self, name: str, values: np.ndarray, inverse: bool) -> np.ndarray:
        cfg = self.config[name]
        p = cfg["params"]
        m = cfg["method"]
        v = np.asarray(values, dtype=np.float64)
        if m == "mean_std":
            out = v * p["std"] + p["mean"] if inverse else (v - p["mean"]) / p["std"]
        elif m == "min_max":
            # maps [min, max] -> [-1, 1]
            span = max(p["max"] - p["min"], 1e-12)
            out = (v + 1.0) / 2.0 * span + p["min"] if inverse else 2.0 * (v - p["min"]) / span - 1.0
        elif m == "positive_semidefinite":
            out = v * p["std"] if inverse else v / p["std"]
        else:
            raise ValueError(f"unknown normalisation method {m!r}")
        return out.astype(values.dtype if np.issubdtype(np.asarray(values).dtype, np.floating) else np.float64)

    # -- public API ------------------------------------------------------------

    def __call__(self, data, method: str | None = None, assert_computed: bool = False):
        """Normalise a Field, Dataset or StationFrame (or a list of them)
        into model space; stats missing from ``config`` are fitted with
        ``method`` (default ``mean_std``) unless ``assert_computed``."""
        if isinstance(data, (list, tuple)):
            return [self(d, method=method, assert_computed=assert_computed) for d in data]
        if isinstance(data, Dataset):
            return Dataset({k: self(v, method=method, assert_computed=assert_computed)
                            for k, v in data.items()}, dict(data.attrs))
        if isinstance(data, Field):
            return self._process_field(data, method, inverse=False,
                                       assert_computed=assert_computed)
        if isinstance(data, StationFrame):
            return self._process_frame(data, method, inverse=False,
                                       assert_computed=assert_computed)
        raise TypeError(f"cannot process {type(data)}")

    def unnormalise(self, data):
        """Inverse transform back to physical units and geographic coords."""
        if isinstance(data, (list, tuple)):
            return [self.unnormalise(d) for d in data]
        if isinstance(data, Dataset):
            return Dataset({k: self.unnormalise(v) for k, v in data.items()}, dict(data.attrs))
        if isinstance(data, Field):
            return self._process_field(data, None, inverse=True, assert_computed=True)
        if isinstance(data, StationFrame):
            return self._process_frame(data, None, inverse=True, assert_computed=True)
        raise TypeError(f"cannot unnormalise {type(data)}")

    def _coord_maps(self, inverse: bool) -> tuple:
        """(old name, new name, map) for x1 then x2: raw → normalised, or
        back when ``inverse``."""
        if inverse:
            return (("x1", self.x1_name, self.unmap_x1), ("x2", self.x2_name, self.unmap_x2))
        return ((self.x1_name, "x1", self.map_x1), (self.x2_name, "x2", self.map_x2))

    def _process_field(self, f: Field, method, inverse: bool, assert_computed: bool) -> Field:
        name = f.name
        if inverse:
            if name not in self.config:
                raise KeyError(f"no normalisation stats for {name!r}")
        elif name not in self.config:
            if assert_computed:
                raise KeyError(f"stats for {name!r} not computed and assert_computed=True")
            self._fit(name, f.data, method or "mean_std")
        data = self._apply_values(name, f.data, inverse)
        coords = dict(f.coords)
        ren = {}
        for old, new, fn in self._coord_maps(inverse):
            if old in coords:
                coords[new] = fn(coords.pop(old))
                ren[old] = new
        dims = tuple(ren.get(d, d) for d in f.dims)
        return Field(data, dims, coords, name, dict(f.attrs))

    def _process_frame(self, frame: StationFrame, method, inverse: bool,
                       assert_computed: bool) -> StationFrame:
        """The JAX package's ``_process_df`` on a StationFrame: the
        coordinate columns are popped and set again, so ``x1``, ``x2`` (or
        the raw names, inverted) end up last, in that order; then every
        numeric column outside the coordinate set is normalised, in column
        order (and fitted first where its stats are missing)."""
        out = frame.copy()
        for old, new, fn in self._coord_maps(inverse):
            if old in out.columns:
                out[new] = fn(out.pop(old))
        coord_cols = {"time", "x1", "x2", self.x1_name, self.x2_name, "station_id",
                      "station_name", "elevation"}
        for col in out.columns:
            if col in coord_cols or not np.issubdtype(out[col].dtype, np.number):
                continue
            if inverse:
                if col not in self.config:
                    continue
            elif col not in self.config:
                if assert_computed:
                    raise KeyError(f"stats for {col!r} not computed and assert_computed=True")
                self._fit(col, out[col], method or "mean_std")
            out[col] = self._apply_values(col, out[col], inverse)
        return out

    # -- (de)serialisation -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "x1_map": self.x1_map,
            "x2_map": self.x2_map,
            "x1_name": self.x1_name,
            "x2_name": self.x2_name,
            "config": self.config,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DataProcessor":
        return cls(
            x1_map=d.get("x1_map"),
            x2_map=d.get("x2_map"),
            x1_name=d.get("x1_name", "latitude"),
            x2_name=d.get("x2_name", "longitude"),
            config=d.get("config"),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "DataProcessor":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self):
        return (
            f"<DataProcessor x1_map={self.x1_map} x2_map={self.x2_map} "
            f"vars={list(self.config)}>"
        )
