"""DataProcessor: coordinate maps + per-variable value normalisation.

numpy copy of the part of ``deepsensornz_tpu/data/processor.py`` that
serving needs: the linear latitude/longitude → x1/x2 maps, the ``config``
dict of per-variable stats with ``_apply_values``, and the JSON
``save``/``load`` format, so a processor written by the JAX package loads
unchanged. Fitting stats from data is not carried over yet.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np


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
