"""Labeled N-d grids (``Field``) and collections (``Dataset``).

numpy copy of the subset of ``deepsensornz_tpu/data/grid.py`` that
gridded prediction touches: construction, ``dims``/``coords``, ``rename``,
block-mean ``coarsen``, nearest/linear interpolation along one dim and
``fillna``; and ``interp_grid_at_points`` from
``deepsensornz_tpu/task/loader.py``, which AR sampling on a grid needs.
NetCDF I/O is not carried over (it needs h5py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Iterator, Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class Field:
    """A named, dimension-labeled numpy array with per-dim coordinates."""

    data: np.ndarray
    dims: tuple[str, ...]
    coords: dict[str, np.ndarray]
    name: str = "field"
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.dims = tuple(self.dims)
        if self.data.ndim != len(self.dims):
            raise ValueError(f"data has {self.data.ndim} dims, got names {self.dims}")
        self.coords = {k: np.asarray(v) for k, v in self.coords.items()}
        for d, n in zip(self.dims, self.data.shape):
            if d in self.coords and self.coords[d].shape != (n,):
                raise ValueError(
                    f"coord {d!r} has shape {self.coords[d].shape}, dim size is {n}"
                )

    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    def axis(self, dim: str) -> int:
        return self.dims.index(dim)

    def copy(self, data: np.ndarray | None = None) -> "Field":
        return Field(
            data=self.data.copy() if data is None else np.asarray(data),
            dims=self.dims,
            coords={k: v.copy() for k, v in self.coords.items()},
            name=self.name,
            attrs=dict(self.attrs),
        )

    def rename(self, name: str) -> "Field":
        out = self.copy(self.data)
        out.name = name
        return out

    def coarsen(self, factor: int, dims: Sequence[str] = ("latitude", "longitude"),
                boundary: str = "trim", how: str = "mean") -> "Field":
        """Block-aggregate coarsening; ``boundary="trim"`` drops the ragged
        tail, any other value requires divisible sizes."""
        if factor == 1:
            return self.copy(self.data)
        out = self
        for dim in dims:
            out = out._coarsen_one(dim, factor, boundary, how)
        return out

    def _coarsen_one(self, dim: str, factor: int, boundary: str, how: str) -> "Field":
        ax = self.axis(dim)
        n = self.data.shape[ax]
        keep = (n // factor) * factor
        if keep == 0:
            raise ValueError(f"dim {dim} (size {n}) smaller than coarsen factor {factor}")
        if keep != n and boundary != "trim":
            raise ValueError(f"dim {dim} size {n} not divisible by {factor}")
        data = np.take(self.data, np.arange(keep), axis=ax)
        data = data.reshape(data.shape[:ax] + (keep // factor, factor) + data.shape[ax + 1:])
        reducer = {"mean": np.nanmean, "sum": np.nansum, "max": np.nanmax}[how]
        with warnings.catch_warnings():
            # all-NaN blocks (sea) legitimately reduce to NaN
            warnings.simplefilter("ignore", category=RuntimeWarning)
            data = reducer(data, axis=ax + 1)
        coords = {k: v.copy() for k, v in self.coords.items()}
        if dim in coords:
            c = coords[dim][:keep].reshape(-1, factor)
            coords[dim] = (
                c.astype("int64").mean(axis=1).astype(c.dtype)
                if np.issubdtype(c.dtype, np.datetime64)
                else c.mean(axis=1)
            )
        return Field(data, self.dims, coords, self.name, dict(self.attrs))

    def _interp_one(self, dim: str, new_coord: np.ndarray, method: str) -> "Field":
        """Interpolate along one dim onto ``new_coord`` (``"nearest"`` or
        ``"linear"``; sorted ascending internally, clamped at the edges)."""
        ax = self.axis(dim)
        old = self.coords[dim].astype(np.float64)
        new = np.asarray(new_coord, dtype=np.float64)
        order = np.argsort(old)
        old_s = old[order]
        data = np.take(self.data, order, axis=ax)
        if method == "nearest":
            pos = np.clip(np.searchsorted(old_s, new), 1, len(old_s) - 1)
            left = old_s[pos - 1]
            right = old_s[pos]
            pick = np.where(np.abs(new - left) <= np.abs(right - new), pos - 1, pos)
            out = np.take(data, pick, axis=ax)
        elif method == "linear":
            pos = np.clip(np.searchsorted(old_s, new), 1, len(old_s) - 1)
            x0, x1 = old_s[pos - 1], old_s[pos]
            w = np.clip((new - x0) / np.maximum(x1 - x0, 1e-12), 0.0, 1.0)
            lo = np.take(data, pos - 1, axis=ax)
            hi = np.take(data, pos, axis=ax)
            shape = [1] * data.ndim
            shape[ax] = len(new)
            w = w.reshape(shape)
            out = lo * (1 - w) + hi * w
        else:
            raise ValueError(f"unknown interp method {method!r}")
        coords = {k: v.copy() for k, v in self.coords.items()}
        coords[dim] = np.asarray(new_coord)
        return Field(out, self.dims, coords, self.name, dict(self.attrs))

    def fillna(self, value: float) -> "Field":
        data = self.data.copy()
        data[np.isnan(data)] = value
        return self.copy(data)

    def __repr__(self):
        cs = ", ".join(f"{d}: {n}" for d, n in self.sizes().items())
        return f"<Field {self.name!r} ({cs}) dtype={self.data.dtype}>"


class Dataset:
    """An ordered mapping of name -> Field."""

    def __init__(self, fields: Mapping[str, Field] | Sequence[Field] = (),
                 attrs: dict | None = None):
        if isinstance(fields, Mapping):
            self._fields = dict(fields)
        else:
            self._fields = {f.name: f for f in fields}
        self.attrs = dict(attrs or {})

    def __getitem__(self, name: str) -> Field:
        return self._fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def items(self):
        return self._fields.items()

    def __repr__(self):
        inner = "\n  ".join(repr(f) for f in self._fields.values())
        return f"<Dataset\n  {inner}\n>"


def interp_grid_at_points(field: Field, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of a (x1, x2) Field at scattered points
    (edge-clamped, NaN read as 0)."""
    g1 = field.coords[field.dims[-2]].astype(np.float64)
    g2 = field.coords[field.dims[-1]].astype(np.float64)
    s1 = np.argsort(g1)
    s2 = np.argsort(g2)
    d = np.take(np.take(np.nan_to_num(field.data), s1, -2), s2, -1)
    g1s, g2s = g1[s1], g2[s2]

    def locate(g, p):
        i = np.clip(np.searchsorted(g, p), 1, len(g) - 1)
        w = np.clip((p - g[i - 1]) / np.maximum(g[i] - g[i - 1], 1e-12), 0, 1)
        return i - 1, w

    i1, w1 = locate(g1s, np.asarray(x1, np.float64))
    i2, w2 = locate(g2s, np.asarray(x2, np.float64))
    return (d[..., i1, i2] * (1 - w1) * (1 - w2) + d[..., i1, i2 + 1] * (1 - w1) * w2
            + d[..., i1 + 1, i2] * w1 * (1 - w2) + d[..., i1 + 1, i2 + 1] * w1 * w2)
