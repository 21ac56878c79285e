"""Weather-station archive reader (one netCDF per station).

Counterpart of ``deepsensornz_tpu/data/sources/stations.py``, returning the
port's :class:`~..frame.StationFrame` where the JAX reader returns a pandas
DataFrame (the same columns, in the same order, with the same values):

- the archive's layouts: a per-variable subfolder
  ``{parent}/{VAR_STATIONS[var]['subdir']}/*.nc``, or a flat
  ``{parent}/*.nc``;
- the reference schema (name in ``attrs['site name']``, id in
  ``attrs['agent_number']``, latitude/longitude/``station_height`` as
  scalar variables) and the legacy one (attributes), the file's stem as the
  last fallback;
- a metadata scan that counts unreadable files in ``skipped`` and warns;
- the station registry (name → id, coordinates, elevation), optionally
  written as JSON;
- a per-archive index of every file's identity, coordinates, time span and
  variables, persisted next to the archive, reused while a file's (mtime,
  size) are unchanged: time-targeted loads open only the files that can
  contribute;
- single-station frames, optionally resampled to days (mean, sum for
  precipitation, as pandas' ``resample("1D")`` computes them);
- multi-station loads at requested times with ``remove_stations`` /
  ``keep_stations``, the value column named ``{var}_station``;
- u/v wind derived from the archive's speed and direction.

The registry and index JSON files are the JAX reader's, so either side
reads the other's. Reading needs h5py (``data.grid.open_dataset``).
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.features import wind_components
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Dataset, Field, open_dataset, save_dataset

_EMPTY_COLUMNS = ("time", "latitude", "longitude", "station_name", "elevation")


class VariableAbsent(KeyError):
    """The file opened fine but does not carry the requested variable —
    benign (mixed archives), unlike a structurally broken file."""


def _scalar_var(ds, name: str) -> Optional[float]:
    """A 0-d (or length-1) dataset variable as float, else None."""
    if name in ds:
        v = np.asarray(ds[name].data).ravel()
        if v.size >= 1:
            return float(v[0])
    return None


def _column(values: list) -> np.ndarray:
    """A column of Python values: numpy's own dtype where the values share a
    type, an object array where they mix (as a pandas column holds them)."""
    if len({type(v) for v in values}) > 1:
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out
    return np.asarray(values)


def _frame_from_rows(rows: list[dict]) -> StationFrame:
    if not rows:
        return StationFrame({})
    return StationFrame({k: _column([r[k] for r in rows]) for k in rows[0]})


def _concat(frames: list[StationFrame]) -> StationFrame:
    cols = frames[0].columns
    return StationFrame({c: np.concatenate([f[c] for f in frames]) for c in cols})


def _kahan_group_sum(idx: np.ndarray, vals: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(sum, count) of the non-NaN ``vals`` in each of ``n`` groups, each
    group summed in row order with Kahan compensation, as pandas' grouped
    ``sum``/``mean`` add them."""
    ok = ~np.isnan(vals)
    idx, vals = idx[ok], vals[ok]
    count = np.bincount(idx, minlength=n)
    total = np.zeros(n)
    comp = np.zeros(n)
    order = np.argsort(idx, kind="stable")
    idx, vals = idx[order], vals[order]
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    rank = np.arange(len(idx)) - start[idx]  # each value's place in its group
    for k in range(int(count.max()) if len(idx) else 0):
        sel = rank == k
        g, v = idx[sel], vals[sel]
        y = v - comp[g]
        t = total[g] + y
        comp[g] = t - total[g] - y
        total[g] = t
    return total, count


def daily_station_series(t: np.ndarray, v: np.ndarray, how: str) -> tuple[np.ndarray, np.ndarray]:
    """pandas' ``resample("1D").agg(how)`` of one series: every day from
    the first to the last, the mean of its non-NaN values (NaN for none)
    or their sum (0 for none)."""
    days = t.astype("datetime64[D]")
    if len(days) == 0:
        return t[:0], v[:0].astype(np.float64)
    d0 = days.min()
    n = int((days.max() - d0).astype(np.int64)) + 1
    total, count = _kahan_group_sum((days - d0).astype(np.int64), v.astype(np.float64), n)
    if how == "mean":
        with np.errstate(invalid="ignore", divide="ignore"):
            total = np.where(count > 0, total / np.maximum(count, 1), np.nan)
    return (d0 + np.arange(n)).astype("datetime64[s]"), total


class StationSource:
    """Load station observations from a reference-layout archive; loads fan
    out over a thread pool (``n_workers``)."""

    INDEX_NAME = ".dsnz_station_index.json"

    def __init__(self, parent: str, index_path: Optional[str] = None, n_workers: int = 8):
        self.parent = parent
        # the unreadable files of the last scan: "empty archive" and "wrong
        # archive format" must not look alike
        self.skipped: list[str] = []
        self.index_path = index_path or os.path.join(parent, self.INDEX_NAME)
        self.n_workers = n_workers
        self._index: Optional[dict] = None

    def variable_dir(self, variable: Optional[str]) -> str:
        """A variable's folder: ``{parent}/{subdir}`` where the per-variable
        layout is present, else ``parent``."""
        if variable is not None:
            sub = cfg.VAR_STATIONS.get(variable, {}).get("subdir")
            if sub and os.path.isdir(os.path.join(self.parent, sub)):
                return os.path.join(self.parent, sub)
        return self.parent

    def station_files(self, variable: Optional[str] = None) -> list[str]:
        return sorted(glob.glob(os.path.join(self.variable_dir(variable), "*.nc")))

    # -- metadata --------------------------------------------------------------

    def get_metadata(self, variable: Optional[str] = None) -> StationFrame:
        """Per-station file, name, id, latitude, longitude, elevation, first
        and last year. Unreadable files are counted in ``skipped`` and
        reported with a warning."""
        def one(path):
            try:
                return path, self._meta_row(path, open_dataset(path))
            except Exception:
                return path, None

        with ThreadPoolExecutor(self.n_workers) as ex:
            results = list(ex.map(one, self.station_files(variable)))
        self.skipped = [p for p, r in results if r is None]
        self._warn_skipped("metadata scan")
        return _frame_from_rows([r for _, r in results if r is not None])

    def _warn_skipped(self, what: str) -> None:
        if self.skipped:
            warnings.warn(
                f"StationSource {what}: skipped {len(self.skipped)} "
                f"unreadable station file(s), e.g. {self.skipped[0]!r} "
                "(see .skipped for the full list)", stacklevel=3)

    @staticmethod
    def _meta_row(path: str, ds) -> dict:
        """One metadata row, the reference schema first: name =
        attrs['site name'], id = attrs['agent_number'] (the file's stem as
        the fallback), latitude/longitude/elevation as dataset variables."""
        attrs = ds.attrs
        stem = os.path.basename(path).replace(".nc", "")
        name = attrs.get("site name", attrs.get("station_name", stem))
        station_id = attrs.get("agent_number", attrs.get("station_id", stem))
        if isinstance(station_id, np.ndarray):
            station_id = station_id.ravel()[0]
        if isinstance(station_id, np.integer):
            station_id = int(station_id)
        lat = _scalar_var(ds, "latitude")
        if lat is None:
            lat = float(attrs.get("latitude", np.nan))
        lon = _scalar_var(ds, "longitude")
        if lon is None:
            lon = float(attrs.get("longitude", np.nan))
        elev = _scalar_var(ds, "station_height")
        if elev is None:
            elev = float(attrs.get("elevation", np.nan))
        t = None
        for f in ds.values():
            if "time" in f.dims:
                t = f.coords.get("time")
                break
        return {
            "file": path,
            "station_name": name,
            "station_id": station_id,
            "latitude": lat,
            "longitude": lon,
            "elevation": elev,
            "start_year": int(str(t.min().astype("datetime64[Y]"))) if t is not None else -1,
            "end_year": int(str(t.max().astype("datetime64[Y]"))) if t is not None else -1,
        }

    def build_registry(self, cache_path: Optional[str] = None,
                       variables: Optional[Sequence[str]] = None) -> dict:
        """name → {station_id, latitude, longitude, elevation}, the first
        occurrence of a name across the variables winning; written as JSON
        to ``cache_path`` when given. With ``variables=None`` every variable
        whose subfolder exists is scanned, and the flat parent where it
        holds station files."""
        if variables:
            variables = list(variables)
        else:
            variables = [v for v in cfg.VAR_STATIONS if self.variable_dir(v) != self.parent]
            if self.station_files(None):
                variables.append(None)  # flat single-folder archive
        reg: dict = {}
        for var in variables:
            meta = self.get_metadata(var)
            if not len(meta):
                continue
            for name, sid, lat, lon, elev in zip(*(meta[c].tolist() for c in (
                    "station_name", "station_id", "latitude", "longitude", "elevation"))):
                reg.setdefault(name, {"station_id": sid, "latitude": lat, "longitude": lon,
                                      "elevation": elev})
        if not reg:
            warnings.warn(
                f"StationSource.build_registry: no stations found under "
                f"{self.parent!r} (scanned {variables!r}) — wrong archive "
                "path or layout?", stacklevel=2)
        if cache_path:
            with open(cache_path, "w") as f:
                json.dump(reg, f, indent=1)
        return reg

    # -- metadata index --------------------------------------------------------

    def _scan_index_entry(self, path: str) -> Optional[dict]:
        """One file's index record (identity, coordinates, time span, the
        variables with a time axis); None for an unreadable file."""
        try:
            st = os.stat(path)
            ds = open_dataset(path)
            meta = self._meta_row(path, ds)
            t0 = t1 = None
            names = []
            for n, f in ds.items():
                if "time" in f.dims and len(f.coords.get("time", ())):
                    names.append(n)
                    tt = f.coords["time"].astype("datetime64[s]")
                    lo, hi = str(tt.min()), str(tt.max())
                    t0 = lo if t0 is None or lo < t0 else t0
                    t1 = hi if t1 is None or hi > t1 else t1
            return {
                "mtime": st.st_mtime, "size": st.st_size,
                "station_name": str(meta["station_name"]),
                "station_id": str(meta["station_id"]),
                "latitude": meta["latitude"], "longitude": meta["longitude"],
                "elevation": meta["elevation"],
                "t_min": t0, "t_max": t1, "variables": sorted(names),
            }
        except Exception:
            return None

    def build_index(self, variable: Optional[str] = None, persist: bool = True) -> dict:
        """(Re)build the index of one variable's folder: entries whose
        (mtime, size) match are reused, the rest scanned on the thread pool;
        persisted atomically next to the archive (silently not, where the
        archive is read-only)."""
        index = dict(self._load_index())
        todo = []
        for p in self.station_files(variable):
            ent = index.get(p)
            try:
                st = os.stat(p)
            except OSError:
                continue
            if not ent or ent.get("mtime") != st.st_mtime or ent.get("size") != st.st_size:
                todo.append(p)
        if todo:
            with ThreadPoolExecutor(self.n_workers) as ex:
                for p, ent in zip(todo, ex.map(self._scan_index_entry, todo)):
                    if ent is not None:
                        index[p] = ent
                    else:
                        index.pop(p, None)
            if persist:
                self._persist_index(index)
        self._index = index
        return index

    def _load_index(self) -> dict:
        if self._index is not None:
            return self._index
        try:
            with open(self.index_path) as f:
                self._index = json.load(f)
        except (OSError, ValueError):
            self._index = {}
        return self._index

    def _persist_index(self, index: dict) -> None:
        try:
            tmp = f"{self.index_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(index, f)
            os.replace(tmp, self.index_path)
        except OSError:
            pass  # read-only archive: the in-memory index still serves this run

    # -- loading ---------------------------------------------------------------

    def _values_and_time(self, ds, path: str, variable: str):
        """One file's value series and time coordinate; u/v wind from the
        archive's speed and direction."""
        short = cfg.VAR_STATIONS[variable]["var_name"]
        if short in ds:
            return ds[short].data, ds[short].coords["time"]
        if "wind" in variable:
            for sp, dr in (("speed", "direction"), ("wind_speed", "wind_direction")):
                if sp in ds and dr in ds:
                    u, v = wind_components(ds[sp].data, ds[dr].data)
                    vals = u if "u_component" in variable else v
                    return vals, ds[sp].coords["time"]
        raise VariableAbsent(f"{short} not in {path}")

    def load_station(self, path: str, variable: str, daily: bool = False,
                     time_window: tuple | None = None) -> StationFrame:
        """One station's frame: time, ``{short}_station``, latitude,
        longitude, station_name, elevation. ``daily`` resamples to days
        (sum for precipitation, else mean); ``time_window`` reads only the
        window's rows."""
        short = cfg.VAR_STATIONS[variable]["var_name"]
        ds = open_dataset(path, time_window=time_window)
        vals, t = self._values_and_time(ds, path, variable)
        t = np.asarray(t).astype("datetime64[s]")
        vals = np.asarray(vals, np.float64)
        if daily:
            t, vals = daily_station_series(t, vals, "sum" if variable == "precipitation"
                                           else "mean")
        meta = self._meta_row(path, ds)
        n = len(t)
        return StationFrame({
            "time": t, f"{short}_station": vals,
            "latitude": np.full(n, meta["latitude"], np.float64),
            "longitude": np.full(n, meta["longitude"], np.float64),
            "station_name": _column([meta["station_name"]] * n) if n else np.asarray([], str),
            "elevation": np.full(n, meta["elevation"], np.float64)})

    def load_stations_time(
        self,
        variable: str,
        times: np.ndarray,
        daily: bool = False,
        remove_stations: Sequence[str] = (),
        keep_stations: Sequence[str] = (),
        use_index: bool = True,
    ) -> StationFrame:
        """Every station covering the requested times, at those times, with
        the holdout filters. Unreadable files are counted in ``skipped``
        (with a warning). With ``use_index`` the persisted index drops the
        files the load would certainly drop (name filters, the variable
        absent, a span that cannot cover the query) and lets indexed files
        read only the query window; the frame is the same either way."""
        times = np.asarray(times, dtype="datetime64[s]")
        if daily:
            # daily series carry midnight stamps: floor the query to days
            times = np.unique(times.astype("datetime64[D]").astype("datetime64[s]"))
        t_lo, t_hi = times.min(), times.max()

        short = cfg.VAR_STATIONS[variable]["var_name"]
        index = self.build_index(variable) if use_index else {}
        candidates = []
        for path in self.station_files(variable):
            ent = index.get(path)
            if ent:
                name = ent["station_name"]
                if keep_stations and name not in keep_stations:
                    continue
                if name in remove_stations:
                    continue
                have = set(ent.get("variables", ()))
                if not (short in have
                        or ("wind" in variable
                            and ({"speed", "direction"} <= have
                                 or {"wind_speed", "wind_direction"} <= have))):
                    continue
                if ent.get("t_min") is None:
                    continue
                e0 = np.datetime64(ent["t_min"], "s")
                e1 = np.datetime64(ent["t_max"], "s")
                if daily:
                    e0 = e0.astype("datetime64[D]").astype("datetime64[s]")
                    e1 = e1.astype("datetime64[D]").astype("datetime64[s]")
                if e0 > t_lo or e1 < t_hi:
                    continue
            candidates.append(path)

        # indexed files passed the coverage check on their span, so they read
        # just the query window (whole days when daily); unindexed files read
        # whole and are checked on their frame
        hi_ext = (t_hi + np.timedelta64(86399, "s")) if daily else t_hi

        def one(path):
            windowed = path in index
            try:
                df = self.load_station(path, variable, daily=daily,
                                       time_window=(t_lo, hi_ext) if windowed else None)
                return "ok", path, df, windowed
            except VariableAbsent:
                return "absent", path, None, windowed
            except Exception:
                # a structurally broken file is counted, not read as absent
                return "bad", path, None, windowed

        with ThreadPoolExecutor(self.n_workers) as ex:
            results = list(ex.map(one, candidates))
        self.skipped = [p for s, p, _, _ in results if s == "bad"]
        frames = []
        for s, _, df, windowed in results:
            if s != "ok":
                continue
            name = df["station_name"][0] if len(df) else ""
            if keep_stations and name not in keep_stations:
                continue
            if name in remove_stations:
                continue
            tt = df["time"]
            if len(tt) == 0 or (not windowed and (tt.min() > t_lo or tt.max() < t_hi)):
                continue
            sel = df[np.isin(tt, times)]
            if len(sel):
                frames.append(sel)
        self._warn_skipped("load_stations_time")
        if not frames:
            return StationFrame({
                "time": np.asarray([], "datetime64[s]"), "latitude": np.asarray([], float),
                "longitude": np.asarray([], float), "station_name": np.asarray([], object),
                "elevation": np.asarray([], float)})
        return _concat(frames)


def save_station_file(path: str, name: str, lat: float, lon: float, elev: float,
                      times: np.ndarray, values_by_var: dict[str, np.ndarray]) -> None:
    """Write a per-station netCDF in the legacy layout (metadata as
    attributes; ``station_id`` from the name's hash, as in the JAX
    package). New archives use :func:`save_station_file_reference`."""
    fields = {
        short: Field(np.asarray(v, np.float64), ("time",),
                     {"time": np.asarray(times, "datetime64[s]")}, short)
        for short, v in values_by_var.items()
    }
    ds = Dataset(fields, attrs={
        "station_name": name, "latitude": lat, "longitude": lon,
        "elevation": elev, "station_id": abs(hash(name)) % 100000,
    })
    save_dataset(ds, path, float32=False)


def save_station_file_reference(
    path: str, name: str, agent_number: int, lat: float, lon: float,
    elev: Optional[float], times: np.ndarray, values_by_var: dict[str, np.ndarray],
) -> None:
    """Write a per-station netCDF in the reference archive's schema: name in
    ``attrs['site name']``, id in ``attrs['agent_number']``, lat/lon and
    ``station_height`` as scalar variables (``elev=None`` omits the
    height, as some archive stations do)."""
    t = np.asarray(times, "datetime64[s]")
    fields = {
        short: Field(np.asarray(v, np.float64), ("time",), {"time": t}, short)
        for short, v in values_by_var.items()
    }
    fields["latitude"] = Field(np.float64(lat), (), {}, "latitude")
    fields["longitude"] = Field(np.float64(lon), (), {}, "longitude")
    if elev is not None:
        fields["station_height"] = Field(np.float64(elev), (), {}, "station_height")
    ds = Dataset(fields, attrs={"site name": name, "agent_number": int(agent_number)})
    save_dataset(ds, path, float32=False)
