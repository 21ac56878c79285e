"""Labeled N-d grids (``Field``) and collections (``Dataset``), and their
netCDF-4 files.

numpy copy of ``deepsensornz_tpu/data/grid.py``: construction,
``dims``/``coords``, ``values``/``dtype``, ``rename``/``rename_dims``/
``astype``, label and position selection (``sel`` with slices,
``method="nearest"`` and ``tolerance``; ``isel``), block coarsening,
``mean``/``sum``, nearest/linear ``interp_like``, ``fillna``/``where``,
``resolution`` and arithmetic; ``interp_grid_at_points`` from
``deepsensornz_tpu/task/loader.py``, which the loader and AR sampling on a
grid need; and the netCDF-4 (HDF5) files, :func:`save_dataset` and
:func:`open_dataset` with the CF time codec, through h5py. h5py is imported
by those two functions only: without it they raise ``RuntimeError`` and the
rest of the module works. The files are the JAX package's, byte for byte
in their values, coordinates, attributes and dtypes, so either side reads
what the other wrote.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

_CF_EPOCH = np.datetime64("1970-01-01T00:00:00", "s")


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

    # -- basic properties ---------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    @property
    def values(self) -> np.ndarray:
        return self.data

    @property
    def dtype(self):
        return self.data.dtype

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

    def rename_dims(self, mapping: Mapping[str, str]) -> "Field":
        """Rename dimensions and their coordinates."""
        dims = tuple(mapping.get(d, d) for d in self.dims)
        coords = {mapping.get(k, k): v for k, v in self.coords.items()}
        return Field(self.data, dims, coords, self.name, dict(self.attrs))

    def astype(self, dtype) -> "Field":
        return self.copy(self.data.astype(dtype))

    # -- selection ----------------------------------------------------------------

    def isel(self, **indexers) -> "Field":
        """Integer/slice/array indexing by dim name; a scalar drops the dim.
        At most one dim may take an array indexer (numpy would broadcast
        several jointly, which is not label semantics)."""
        n_array = sum(1 for v in indexers.values()
                      if isinstance(v, (list, np.ndarray)) and np.ndim(v) > 0)
        if n_array > 1:
            raise ValueError("isel supports an array indexer on at most one dim; "
                             "chain .isel calls for multiple dims")
        idx = [slice(None)] * self.data.ndim
        for dim, sel in indexers.items():
            idx[self.axis(dim)] = sel
        data = self.data[tuple(idx)]
        dims, coords = [], {}
        for d in self.dims:
            sel = indexers.get(d, slice(None))
            if (np.isscalar(sel) or (isinstance(sel, np.ndarray) and sel.ndim == 0)
                    or isinstance(sel, (int, np.integer))):
                continue  # dim dropped
            dims.append(d)
            if d in self.coords:
                coords[d] = self.coords[d][sel]
        for d, c in self.coords.items():
            if d not in indexers and d in dims:
                coords[d] = c
        return Field(data, tuple(dims), coords, self.name, dict(self.attrs))

    def sel(self, method: str | None = None, tolerance=None, **indexers) -> "Field":
        """Label-based selection: scalars drop the dim, slices keep it;
        ``method="nearest"`` snaps to the closest coordinate value."""
        int_indexers = {}
        for dim, want in indexers.items():
            coord = self.coords[dim]
            if isinstance(want, slice):
                int_indexers[dim] = _slice_to_index(coord, want)
            else:
                want_arr = np.atleast_1d(np.asarray(want))
                if np.issubdtype(coord.dtype, np.datetime64):
                    want_arr = want_arr.astype(coord.dtype)
                pos = _lookup(coord, want_arr, method=method, tolerance=tolerance)
                scalar = np.isscalar(want) or (
                    isinstance(want, np.ndarray) and want.ndim == 0
                ) or isinstance(want, (np.datetime64, str))
                int_indexers[dim] = int(pos[0]) if scalar else pos
        return self.isel(**int_indexers)

    # -- transforms ---------------------------------------------------------------

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

    def mean(self, dim: str | Sequence[str], skipna: bool = True) -> "Field":
        return self._reduce(dim, np.nanmean if skipna else np.mean)

    def sum(self, dim: str | Sequence[str], skipna: bool = True) -> "Field":
        return self._reduce(dim, np.nansum if skipna else np.sum)

    def _reduce(self, dim, fn) -> "Field":
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self.axis(d) for d in dims)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            data = fn(self.data, axis=axes)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {k: v for k, v in self.coords.items() if k not in dims}
        return Field(data, new_dims, coords, self.name, dict(self.attrs))

    def interp_like(self, other: "Field", method: str = "nearest",
                    dims: Sequence[str] = ("latitude", "longitude")) -> "Field":
        """Interpolate onto another Field's grid along ``dims``."""
        out = self
        for dim in dims:
            out = out._interp_one(dim, other.coords[dim], method)
        return out

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

    def where(self, mask: np.ndarray, other: float = np.nan) -> "Field":
        return self.copy(np.where(mask, self.data, other))

    def resolution(self, dim: str) -> float:
        """Mean grid spacing along a dim."""
        c = self.coords[dim].astype(np.float64)
        return float(np.abs(np.diff(c).mean()))

    # -- arithmetic ---------------------------------------------------------------

    def _binop(self, other, fn) -> "Field":
        if isinstance(other, Field):
            other = other.data
        return self.copy(fn(self.data, other))

    def __add__(self, o):
        return self._binop(o, np.add)

    def __sub__(self, o):
        return self._binop(o, np.subtract)

    def __mul__(self, o):
        return self._binop(o, np.multiply)

    def __truediv__(self, o):
        return self._binop(o, np.divide)

    def __repr__(self):
        cs = ", ".join(f"{d}: {n}" for d, n in self.sizes().items())
        return f"<Field {self.name!r} ({cs}) dtype={self.data.dtype}>"


def _slice_to_index(coord: np.ndarray, sl: slice) -> slice:
    """A label slice as a positional slice on a monotonic coord; ``start``
    and ``stop`` follow the coordinate's own order (on a descending coord,
    ``slice(high, low)`` selects high→low)."""
    asc = len(coord) < 2 or coord[1] >= coord[0]
    start, stop = sl.start, sl.stop
    if np.issubdtype(coord.dtype, np.datetime64):
        start = None if start is None else np.datetime64(start)
        stop = None if stop is None else np.datetime64(stop)
    lo, hi = (start, stop) if asc else (stop, start)
    c = coord if asc else coord[::-1]
    i0 = 0 if lo is None else int(np.searchsorted(c, lo, side="left"))
    i1 = len(c) if hi is None else int(np.searchsorted(c, hi, side="right"))
    if asc:
        return slice(i0, i1)
    return slice(len(coord) - i1, len(coord) - i0)


def _lookup(coord: np.ndarray, want: np.ndarray, method=None, tolerance=None) -> np.ndarray:
    """Positions of ``want`` in ``coord``: the nearest value (ties to the
    lower sorted position) or an exact match (the first one; KeyError when
    absent). ``tolerance`` is accepted and not applied, as in the JAX
    package."""
    if method == "nearest":
        is_time = np.issubdtype(coord.dtype, np.datetime64)
        cf = coord.astype("int64") if is_time else coord.astype(np.float64)
        wf = (want.astype(coord.dtype).astype("int64") if is_time
              else np.asarray(want, np.float64))
        order = np.argsort(cf)
        pos = np.searchsorted(cf[order], wf)
        pos = np.clip(pos, 1, len(cf) - 1)
        left, right = cf[order][pos - 1], cf[order][pos]
        pick = np.where(np.abs(wf - left) <= np.abs(right - wf), pos - 1, pos)
        return order[pick]
    out = np.empty(len(want), dtype=np.int64)
    for i, w in enumerate(want):
        hits = np.nonzero(coord == w)[0]
        if len(hits) == 0:
            raise KeyError(f"value {w!r} not found in coordinate")
        out[i] = hits[0]
    return out


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

    def __setitem__(self, name: str, field: Field):
        field.name = name
        self._fields[name] = field

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

    @property
    def data_vars(self):
        return self._fields

    def map(self, fn) -> "Dataset":
        return Dataset({k: fn(v) for k, v in self._fields.items()}, self.attrs)

    def sel(self, **kw) -> "Dataset":
        return self.map(lambda f: f.sel(**kw))

    def isel(self, **kw) -> "Dataset":
        return self.map(lambda f: f.isel(**kw))

    def copy(self) -> "Dataset":
        return Dataset({k: v.copy() for k, v in self._fields.items()}, dict(self.attrs))

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


# ---------------------------------------------------------------------------
# netCDF-4 (HDF5) I/O
# ---------------------------------------------------------------------------


def _h5py(what: str):
    """The h5py module, imported here so that nothing else needs it."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(f"h5py unavailable; cannot {what} netCDF") from None
    return h5py


def _encode_time(values: np.ndarray) -> tuple[np.ndarray, str]:
    secs = (values.astype("datetime64[s]") - _CF_EPOCH).astype("int64")
    return secs.astype("float64"), "seconds since 1970-01-01 00:00:00"


def _decode_time(values: np.ndarray, units: str) -> np.ndarray:
    parts = units.split(" since ")
    scale = {"seconds": "s", "minutes": "m", "hours": "h", "days": "D"}[parts[0].strip().lower()]
    origin = np.datetime64(parts[1].strip().replace(" ", "T").rstrip("Z"), "s")
    mult = {"s": 1, "m": 60, "h": 3600, "D": 86400}[scale]
    return origin + (np.asarray(values, dtype="float64") * mult).astype("timedelta64[s]")


def save_dataset(ds: Dataset | Field, path: str, compress: bool = True,
                 float32: bool = True, packing: str | None = None) -> None:
    """Write a Dataset/Field as a netCDF-4-compatible HDF5 file: dimension
    scales for the coordinates (time CF-encoded as float64 seconds since
    1970), float data cast to float32 when ``float32``, gzip level 1 with
    shuffle on chunked variables of more than 1024 values when
    ``compress``, and scalar attributes of the fields and the Dataset.

    ``packing="int16"`` stores float data variables as CF-packed int16 with
    per-variable ``scale_factor``/``add_offset`` (float64) and
    ``_FillValue`` -32768 for NaN; coordinates stay full precision."""
    h5py = _h5py("write")
    if isinstance(ds, Field):
        ds = Dataset([ds])
    with h5py.File(path, "w") as f:
        written_dims: dict[str, Any] = {}
        for field in ds.values():
            for dim in field.dims:
                if dim in written_dims or dim not in field.coords:
                    continue
                coord = field.coords[dim]
                attrs = {}
                if np.issubdtype(coord.dtype, np.datetime64):
                    coord, units = _encode_time(coord)
                    attrs["units"] = units
                    attrs["calendar"] = "proleptic_gregorian"
                d = f.create_dataset(dim, data=coord)
                for k, v in attrs.items():
                    d.attrs[k] = v
                d.make_scale(dim)
                written_dims[dim] = d
        for name, field in ds.items():
            data = field.data
            pack_attrs = {}
            if packing == "int16" and np.issubdtype(data.dtype, np.floating):
                finite = np.isfinite(data)
                lo = float(data[finite].min()) if finite.any() else 0.0
                hi = float(data[finite].max()) if finite.any() else 0.0
                scale = max((hi - lo) / 65533.0, 1e-12)
                offset = lo + scale * 32766.0
                packed = np.where(finite, np.round((data - offset) / scale), -32768.0)
                data = packed.astype(np.int16)
                pack_attrs = {"scale_factor": np.float64(scale),
                              "add_offset": np.float64(offset),
                              "_FillValue": np.int16(-32768)}
            elif float32 and np.issubdtype(data.dtype, np.floating):
                data = data.astype(np.float32)
            kw = {}
            if compress and data.ndim >= 1 and data.size > 1024:
                kw = dict(compression="gzip", compression_opts=1, chunks=True, shuffle=True)
            v = f.create_dataset(name, data=data, **kw)
            for k, val in pack_attrs.items():
                v.attrs[k] = val
            for i, dim in enumerate(field.dims):
                if dim in written_dims:
                    v.dims[i].attach_scale(written_dims[dim])
            for k, val in field.attrs.items():
                if isinstance(val, (str, int, float, np.number)):
                    v.attrs[k] = val
        for k, val in ds.attrs.items():
            if isinstance(val, (str, int, float, np.number)):
                f.attrs[k] = val


_H5_BOOKKEEPING = ("DIMENSION_LIST", "CLASS", "NAME", "REFERENCE_LIST", "_Netcdf4Coordinates")


def open_dataset(path: str, variables: Sequence[str] | None = None,
                 time_window: tuple | None = None) -> Dataset:
    """Read a netCDF-4/HDF5 file into a Dataset: dimension scales become
    coordinates (decoded to ``datetime64[s]`` where their ``units`` say
    "<unit> since <origin>"), every other dataset a Field (only
    ``variables`` when given), a dim without a scale named ``dim_<i>``;
    CF-packed variables unpacked (``_FillValue`` → NaN).

    ``time_window=(t0, t1)`` (datetime64-coercible, inclusive) reads only
    the rows of time-dimensioned variables whose time falls in the window,
    a hyperslab read; variables without a time dimension load whole, and an
    empty overlap gives zero-length time axes."""
    h5py = _h5py("read")
    fields: dict[str, Field] = {}
    with h5py.File(path, "r") as f:
        scales, data_vars = {}, {}
        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            if obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                scales[name] = obj
            else:
                data_vars[name] = obj

        def read_coord(obj):
            vals = obj[()]
            units = obj.attrs.get("units", b"")
            if isinstance(units, bytes):
                units = units.decode()
            if " since " in str(units):
                vals = _decode_time(vals, str(units))
            return vals

        coords = {n: read_coord(o) for n, o in scales.items()}
        tsel = None  # (lo, hi) row slice of the time axis
        if time_window is not None and "time" in coords and np.issubdtype(
                np.asarray(coords["time"]).dtype, np.datetime64):
            t = np.asarray(coords["time"]).astype("datetime64[s]")
            t0 = np.datetime64(time_window[0], "s")
            t1 = np.datetime64(time_window[1], "s")
            inside = np.nonzero((t >= t0) & (t <= t1))[0]
            lo = int(inside[0]) if len(inside) else 0
            hi = int(inside[-1]) + 1 if len(inside) else 0
            tsel = (lo, hi)
            coords = dict(coords)
            coords["time"] = coords["time"][lo:hi]
        for name, obj in data_vars.items():
            if variables is not None and name not in variables:
                continue
            dims = []
            for i in range(obj.ndim):
                attached = [s.name.lstrip("/") for s in obj.dims[i].values()] if obj.dims[i] else []
                dims.append(attached[0] if attached else f"dim_{i}")
            fcoords = {d: coords[d] for d in dims if d in coords}
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in obj.attrs.items() if k not in _H5_BOOKKEEPING}
            if tsel is not None and "time" in dims:
                ax = dims.index("time")
                data = obj[tuple(slice(tsel[0], tsel[1]) if i == ax else slice(None)
                                 for i in range(obj.ndim))]
            else:
                data = obj[()]
            # CF packing: unpacked = packed*scale_factor + add_offset,
            # _FillValue -> NaN
            if "scale_factor" in attrs or "add_offset" in attrs:
                sf = float(attrs.pop("scale_factor", 1.0))
                ao = float(attrs.pop("add_offset", 0.0))
                fv = attrs.pop("_FillValue", None)
                bad = (data == fv) if fv is not None else None
                data = data.astype(np.float32) * sf + ao
                if bad is not None:
                    data = np.where(bad, np.nan, data)
            fields[name] = Field(data, tuple(dims), fcoords, name, attrs)
        file_attrs = {k: (v.decode() if isinstance(v, bytes) else v) for k, v in f.attrs.items()}
    return Dataset(fields, file_attrs)
