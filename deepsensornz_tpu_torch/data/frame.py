"""``StationFrame``: a station table without pandas.

The JAX package's ``TaskLoader`` reads its station sets as pandas
DataFrames; the port keeps them as an ordered mapping from column name to a
1-D numpy array, all of one length, with ``time`` stored as
``datetime64[s]``. It has exactly the operations the loader needs: the
column names, the length, a column by name, row selection by position
(``take``, pandas' ``iloc``), the largest number of rows at one time
(``groupby("time").size().max()``) and ``to_numpy`` of some columns.
:meth:`StationFrame.from_pandas` converts a DataFrame where pandas exists;
nothing here imports pandas.
"""

from __future__ import annotations

import pickle
from typing import Mapping, Sequence

import numpy as np


class StationFrame:
    """Columns of equal length; ``time`` as ``datetime64[s]``."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        cols = {str(k): np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        if any(v.ndim != 1 for v in cols.values()):
            raise ValueError("every column must be 1-D")
        if "time" in cols:
            cols["time"] = cols["time"].astype("datetime64[s]")
        self._cols = cols
        self._len = lengths.pop() if lengths else 0

    @classmethod
    def from_pandas(cls, df) -> "StationFrame":
        """The columns of a pandas DataFrame, in its order and dtypes (the
        index is dropped: the loader selects rows by position)."""
        return cls({c: df[c].to_numpy() for c in df.columns})

    def to_pandas(self):
        """A pandas DataFrame of these columns, in this order and with these
        dtypes, on a RangeIndex."""
        import pandas as pd

        return pd.DataFrame(dict(self._cols))

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, key):
        """A column by name, or the rows where a boolean mask is True."""
        if isinstance(key, str):
            return self._cols[key]
        mask = np.asarray(key)
        if mask.dtype != bool or mask.shape != (self._len,):
            raise TypeError("index a StationFrame by a column name or a boolean row mask")
        return self.take(np.nonzero(mask)[0])

    def __setitem__(self, name: str, values) -> None:
        """Set a column: in place where it exists, else at the end."""
        values = np.asarray(values)
        if values.shape != (self._len,) and self._cols:
            raise ValueError(f"column {name!r} has shape {values.shape}, frame length {self._len}")
        if name == "time":
            values = values.astype("datetime64[s]")
        if not self._cols:
            self._len = len(values)
        self._cols[str(name)] = values

    def pop(self, name: str) -> np.ndarray:
        return self._cols.pop(name)

    def copy(self) -> "StationFrame":
        return StationFrame({k: v.copy() for k, v in self._cols.items()})

    def take(self, idx) -> "StationFrame":
        """The rows at the integer positions ``idx``, in that order."""
        idx = np.asarray(idx, dtype=np.intp)
        return StationFrame({k: v[idx] for k, v in self._cols.items()})

    def groupby_time(self):
        """(time, row positions) for each distinct non-NaT time, in sorted
        time order; the positions in row order."""
        t = self._cols["time"]
        for u in np.unique(t[~np.isnat(t)]):
            yield u, np.nonzero(t == u)[0]

    def max_rows_per_time(self) -> int:
        """The most rows that share one (non-NaT) time; 0 when empty."""
        t = self._cols["time"]
        t = t[~np.isnat(t)]
        return int(np.unique(t, return_counts=True)[1].max()) if len(t) else 0

    def to_numpy(self, cols: Sequence[str], dtype=np.float32) -> np.ndarray:
        """(len, len(cols)) array of the named columns, each cast to ``dtype``."""
        if not cols:
            return np.empty((self._len, 0), dtype)
        return np.stack([self._cols[c].astype(dtype) for c in cols], -1)

    def __repr__(self):
        return f"<StationFrame {self._len} rows, columns {self.columns}>"


def frame_value_cols(frame: StationFrame) -> list[str]:
    """The numeric columns outside the coordinate/metadata set, in frame
    order (``bool`` is not numeric here)."""
    skip = {"time", "x1", "x2", "station_id", "station_name", "elevation",
            "latitude", "longitude"}
    return [c for c in frame.columns
            if c not in skip and np.issubdtype(frame[c].dtype, np.number)]


def is_pandas_frame(obj) -> bool:
    """True for a pandas DataFrame, found without importing pandas."""
    t = type(obj)
    return t.__name__ == "DataFrame" and t.__module__.split(".")[0] == "pandas"


class FrameUnpickler(pickle.Unpickler):
    """Unpickles, and refuses with ``reason`` (a ``RuntimeError``) a pickle
    that holds pandas objects where pandas is not installed."""

    def __init__(self, file, reason: str):
        super().__init__(file)
        self.reason = reason

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "pandas":
            try:
                import pandas  # noqa: F401
            except ImportError as e:
                raise RuntimeError(self.reason) from e
        return super().find_class(module, name)
