"""TaskLoader: assemble fixed-shape TaskBatches from normalised data.

Counterpart of ``deepsensornz_tpu/task/loader.py``, equal to it bit for bit
on the same data:

- N context sets (gridded ``Field``/``Dataset`` or station
  :class:`~..data.frame.StationFrame`) and a station target set, plus
  ``aux_at_targets`` (gridded aux sampled at the target points) and
  ``aux_at_contexts`` (appended to every station context's values);
- per-set ``context_sampling``: ``"all"``/``True``, a float fraction, an
  int count, ``"random"`` (a fresh fraction per task) and ``"split"`` (the
  sampled stations are context, the rest are targets; ``links``);
- ``delta_t`` day lags per context set, ``seed_override`` /
  ``datewise_deterministic`` seeding, rows with a non-finite value dropped;
- the native fast path (:mod:`..native.taskpack`) when every station set is
  sampled ``"all"``, with no links and no ``aux_at_contexts``;
- ``swap_data`` for operational inference, capacities that never shrink,
  and pickling without the fast path's cache.

Tasks come out as CPU tensors; ``Predictor`` moves them to its device.
Station sets are ``StationFrame`` objects; a pandas DataFrame is converted on
entry where pandas exists. The fraction and count sampling reproduce
``DataFrame.sample(frac=f | n=k, random_state=s)`` without pandas:
``np.random.RandomState(s).choice(len, size, replace=False)``, with
``size = round(f·len)`` (half to even) or ``min(k, len)``.
"""

from __future__ import annotations

import contextlib
import hashlib
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from deepsensornz_tpu_torch.data.frame import StationFrame, frame_value_cols, is_pandas_frame
from deepsensornz_tpu_torch.data.grid import Dataset, Field, interp_grid_at_points
from deepsensornz_tpu_torch.native import taskpack
from deepsensornz_tpu_torch.ops.grids import internal_grid
from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch, pad_points


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def _is_frame(obj) -> bool:
    return isinstance(obj, StationFrame)


def _as_set(entry):
    """A pandas DataFrame as a ``StationFrame``; anything else unchanged."""
    return StationFrame.from_pandas(entry) if is_pandas_frame(entry) else entry


def _grid_channels(entry) -> list[Field]:
    if isinstance(entry, Field):
        return [entry]
    if isinstance(entry, Dataset):
        return list(entry.values())
    raise TypeError(f"unsupported gridded context type {type(entry)}")


def _var_ids(entry) -> list[str]:
    return frame_value_cols(entry) if _is_frame(entry) else [f.name for f in _grid_channels(entry)]


def sample_rows(n_rows: int, seed: int, frac: Optional[float] = None,
                n: Optional[int] = None) -> np.ndarray:
    """The row positions ``DataFrame.sample(frac=frac | n=n,
    random_state=seed)`` selects from ``n_rows`` rows, in its order."""
    size = round(frac * n_rows) if n is None else n
    return np.random.RandomState(seed).choice(n_rows, size=size, replace=False)


def _nearest_time(f: Field, date) -> int:
    """Index of ``f``'s time coordinate nearest ``date`` (``Field.sel(time=…,
    method="nearest")`` of the JAX package)."""
    coord = f.coords["time"]
    want = np.atleast_1d(np.asarray(date)).astype(coord.dtype).astype("int64")
    cf = coord.astype("int64")
    order = np.argsort(cf)
    pos = np.clip(np.searchsorted(cf[order], want), 1, len(cf) - 1)
    left, right = cf[order][pos - 1], cf[order][pos]
    return int(order[np.where(np.abs(want - left) <= np.abs(right - want), pos - 1, pos)][0])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _stack_channels(chans: list[np.ndarray]) -> np.ndarray:
    """``np.stack(chans, -1)`` written into a C-contiguous float32 array:
    np.stack of broadcast views may lay its result out otherwise, and the
    tensor would then need a second copy."""
    out = np.empty(chans[0].shape + (len(chans),), np.float32)
    for c, a in enumerate(chans):
        out[..., c] = a
    return out


class TaskLoader:
    """Build TaskBatches of CPU tensors from normalised contexts/targets."""

    def __init__(
        self,
        context: Sequence,
        target,
        aux_at_targets: Optional[Dataset | Field] = None,
        aux_at_contexts: Optional[Dataset | Field] = None,
        context_sampling="all",
        target_sampling="all",
        links: Optional[Sequence[tuple[int, int]]] = None,
        delta_t: Optional[Sequence[int]] = None,
        internal_density: float = 500.0,
        grid_margin: float = 0.1,
        grid_multiple: int = 16,
        point_capacity: Optional[int] = None,
        target_capacity: Optional[int] = None,
        split_frac: float = 0.5,
    ):
        """``delta_t``: per-context-set time lag in days (context set i is
        sliced at ``date + delta_t[i]``). ``aux_at_contexts``: gridded aux
        channels gathered at every station context point and appended to
        its values."""
        self.context = [_as_set(c) for c in context]
        self.target = _as_set(target)
        self.aux_at_targets = aux_at_targets
        self.aux_at_contexts = aux_at_contexts
        self.delta_t = list(delta_t) if delta_t is not None else [0] * len(self.context)
        if len(self.delta_t) != len(self.context):
            raise ValueError("delta_t must have one entry per context set")
        if isinstance(context_sampling, (str, float, int)):
            context_sampling = [context_sampling] * len(self.context)
        self.context_sampling = list(context_sampling)
        self.target_sampling = target_sampling
        self.links = list(links or [])
        self.internal_density = float(internal_density)
        self.grid_margin = grid_margin
        self.grid_multiple = grid_multiple
        self.split_frac = split_frac
        self.context_var_IDs = [_var_ids(c) for c in self.context]
        self.target_var_IDs = _var_ids(self.target)

        self._rebuild_static()
        if point_capacity is not None:
            self.point_capacity = point_capacity
        if target_capacity is not None:
            self.target_capacity = target_capacity
        self._flat_cache: dict = {}

    # -- pickling --------------------------------------------------------------------

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state.pop("_flat_cache", None)
        return state

    def __setstate__(self, state: dict) -> None:
        """Also restores a JAX ``TaskLoader``'s state (through
        :func:`..pipeline.validate.load_task_loader`): its DataFrames
        become ``StationFrame`` objects and its fast-path cache is dropped."""
        state = dict(state)
        state.pop("_flat_cache", None)
        state["context"] = [_as_set(c) for c in state["context"]]
        state["target"] = _as_set(state["target"])
        self.__dict__.update(state)
        self._flat_cache = {}

    # -- static geometry -------------------------------------------------------------

    def _rebuild_static(self) -> None:
        """(Re)derive the internal grid and capacities from the current data;
        capacities never shrink, so shapes stay stable across data swaps."""
        x1_lo, x1_hi, x2_lo, x2_hi = np.inf, -np.inf, np.inf, -np.inf
        for entry in list(self.context) + [self.target]:
            if _is_frame(entry):
                if len(entry):
                    x1_lo = min(x1_lo, entry["x1"].min())
                    x1_hi = max(x1_hi, entry["x1"].max())
                    x2_lo = min(x2_lo, entry["x2"].min())
                    x2_hi = max(x2_hi, entry["x2"].max())
            else:
                for f in _grid_channels(entry):
                    c1 = f.coords[f.dims[-2]]
                    c2 = f.coords[f.dims[-1]]
                    x1_lo, x1_hi = min(x1_lo, c1.min()), max(x1_hi, c1.max())
                    x2_lo, x2_hi = min(x2_lo, c2.min()), max(x2_hi, c2.max())
        self.x1g, self.x2g = internal_grid(
            (x1_lo, x1_hi), (x2_lo, x2_hi),
            self.internal_density, self.grid_margin, self.grid_multiple,
        )
        caps = [entry.max_rows_per_time() for entry in list(self.context) + [self.target]
                if _is_frame(entry) and len(entry)]
        cap = _round_up(max(caps, default=8), 8)
        self.point_capacity = max(cap, getattr(self, "point_capacity", 0))
        self.target_capacity = max(cap, getattr(self, "target_capacity", 0))
        self._flat_cache = {}

    @contextlib.contextmanager
    def swap_data(self, context=None, target=None):
        """Temporarily swap the loader's context/target data in place: the
        internal grid is rederived (capacities never shrink), and the
        originals, variable-ID lists included, come back on exit, also on an
        exception. ``context`` must have as many sets as the loader."""
        if context is not None and len(context) != len(self.context):
            raise ValueError(f"swap_data context must have {len(self.context)} sets, "
                             f"got {len(context)}")
        saved = (self.context, self.target, self.context_var_IDs, self.target_var_IDs)
        try:
            if context is not None:
                self.context = [_as_set(c) for c in context]
                self.context_var_IDs = [_var_ids(c) for c in self.context]
            if target is not None:
                self.target = _as_set(target)
                self.target_var_IDs = _var_ids(self.target)
            self._rebuild_static()
            yield self
        finally:
            (self.context, self.target, self.context_var_IDs, self.target_var_IDs) = saved
            self._rebuild_static()

    # -- seeding ---------------------------------------------------------------------

    @staticmethod
    def _seed_for(date, seed_override, datewise_deterministic) -> Optional[int]:
        if seed_override is not None:
            return int(seed_override)
        if datewise_deterministic:
            # the date's string carries its unit: keep it as the JAX loader does
            h = hashlib.md5(str(np.datetime64(date)).encode()).hexdigest()
            return int(h[:8], 16)
        return None

    # -- task generation -------------------------------------------------------------

    def __call__(self, dates, context_sampling=None, target_sampling=None,
                 seed_override=None, datewise_deterministic: bool = False) -> TaskBatch:
        """A TaskBatch for one date or a list of dates."""
        single = not isinstance(dates, (list, tuple, np.ndarray))
        date_list = [dates] if single else list(dates)
        sampling = self.context_sampling if context_sampling is None else (
            [context_sampling] * len(self.context)
            if isinstance(context_sampling, (str, float, int)) else list(context_sampling)
        )
        tgt_sampling = self.target_sampling if target_sampling is None else target_sampling

        fast = self._fast_call(date_list, sampling, tgt_sampling)
        if fast is not None:
            return fast

        grids: list[list[np.ndarray]] = [[] for _ in self.context]
        grid_specs: list = [None] * len(self.context)
        pts_x: dict[int, list] = {}
        pts_y: dict[int, list] = {}
        pts_m: dict[int, list] = {}
        xt_l, yt_l, ytm_l, aux_l = [], [], [], []
        linked_ctx = {c for c, _ in self.links}

        for date in date_list:
            rng = np.random.default_rng(self._seed_for(date, seed_override,
                                                       datewise_deterministic))
            split_context_ids = None  # (x1, x2) of the stations chosen as context

            # --- station context sets first (a split decides the targets) ----
            for ci, entry in enumerate(self.context):
                if not _is_frame(entry):
                    continue
                date_eff = np.datetime64(date) + np.timedelta64(self.delta_t[ci], "D")
                rows = self._rows_at(entry, date_eff)
                # a NaN reading must never become a valid observation of 0
                finite = np.isfinite(rows.to_numpy(self.context_var_IDs[ci])).all(-1)
                if not finite.all():
                    rows = rows.take(np.nonzero(finite)[0])
                strat = sampling[ci]
                if ci in linked_ctx or strat == "split":
                    n_ctx = max(int(round(self.split_frac * len(rows))), 1)
                    rows = rows.take(rng.permutation(len(rows))[:n_ctx])
                    split_context_ids = set(zip(np.round(rows["x1"], 9),
                                                np.round(rows["x2"], 9)))
                elif strat == "all" or strat is True:
                    pass
                elif strat == "random":
                    frac = rng.random()  # a fresh fraction per task
                    rows = rows.take(sample_rows(len(rows), rng.integers(2**31), frac=frac))
                elif isinstance(strat, float) and not isinstance(strat, bool):
                    rows = rows.take(sample_rows(len(rows), rng.integers(2**31), frac=strat))
                elif isinstance(strat, (int, np.integer)) and not isinstance(strat, bool):
                    n = min(int(strat), len(rows))
                    rows = rows.take(sample_rows(len(rows), rng.integers(2**31), n=n))
                else:
                    raise ValueError(f"unknown context_sampling {strat!r}")
                x = rows.to_numpy(["x1", "x2"])
                y = rows.to_numpy(self.context_var_IDs[ci])
                if self.aux_at_contexts is not None:
                    aux_cols = [interp_grid_at_points(f, x[:, 0], x[:, 1])
                                for f in _grid_channels(self.aux_at_contexts)]
                    if aux_cols:
                        y = np.concatenate([y, np.stack(aux_cols, -1).astype(np.float32)],
                                           axis=-1)
                xp, yp, m = pad_points(x, y, self.point_capacity)
                pts_x.setdefault(ci, []).append(xp)
                pts_y.setdefault(ci, []).append(yp)
                pts_m.setdefault(ci, []).append(m)

            # --- gridded context sets -------------------------------------------
            for ci, entry in enumerate(self.context):
                if _is_frame(entry):
                    continue
                chans = []
                spec = None
                date_eff = np.datetime64(date) + np.timedelta64(self.delta_t[ci], "D")
                for f in _grid_channels(entry):
                    data, dims = f.data, f.dims
                    if "time" in f.dims:
                        data = np.take(f.data, _nearest_time(f, date_eff), axis=f.axis("time"))
                        dims = tuple(d for d in f.dims if d != "time")
                    chans.append(np.nan_to_num(data.astype(np.float32)))
                    spec = (f.coords[dims[-2]].astype(np.float32),
                            f.coords[dims[-1]].astype(np.float32))
                grids[ci].append(np.stack(chans, -1))
                grid_specs[ci] = spec

            # --- targets ----------------------------------------------------------
            t_rows = self._rows_at(self.target, date)
            if split_context_ids is not None or tgt_sampling == "split":
                if split_context_ids is None:
                    raise ValueError("target 'split' requires a linked station context")
                keys = zip(np.round(t_rows["x1"], 9), np.round(t_rows["x2"], 9))
                keep = [k not in split_context_ids for k in keys]
                t_rows = t_rows.take(np.nonzero(keep)[0])
            xt = t_rows.to_numpy(["x1", "x2"])
            yt = t_rows.to_numpy(self.target_var_IDs)
            ok = np.isfinite(yt).all(-1)
            xt, yt = xt[ok], yt[ok]
            xtp, ytp, mt = pad_points(xt, yt, self.target_capacity)
            xt_l.append(xtp)
            yt_l.append(ytp)
            ytm_l.append(mt)
            if self.aux_at_targets is not None:
                aux_ch = [interp_grid_at_points(f, xtp[:, 0], xtp[:, 1])
                          for f in _grid_channels(self.aux_at_targets)]
                aux_l.append(np.stack(aux_ch, -1).astype(np.float32))

        grid_ctx = tuple(
            GridContext(x1=_t(grid_specs[ci][0]), x2=_t(grid_specs[ci][1]),
                        y=_t(np.stack(grids[ci])))
            for ci in range(len(self.context)) if grids[ci])
        point_ctx = tuple(
            PointContext(x=_t(np.stack(pts_x[ci])), y=_t(np.stack(pts_y[ci])),
                         mask=_t(np.stack(pts_m[ci])))
            for ci in sorted(pts_x))
        return TaskBatch(
            grids=grid_ctx, points=point_ctx,
            xt=_t(np.stack(xt_l)), yt=_t(np.stack(yt_l)), yt_mask=_t(np.stack(ytm_l)),
            yt_aux=_t(np.stack(aux_l)) if aux_l else None,
            x1g=_t(self.x1g.copy()), x2g=_t(self.x2g.copy()))

    # -- native fast path -------------------------------------------------------------

    def _fast_call(self, date_list, sampling, tgt_sampling):
        """Pack every date in one native pass, when every station set is
        sampled "all", with no links and no ``aux_at_contexts``; None
        otherwise (or without the native library)."""
        if not taskpack.available() or len(date_list) == 0:
            return None
        if tgt_sampling != "all" or self.links or self.aux_at_contexts is not None:
            return None
        for ci, entry in enumerate(self.context):
            if _is_frame(entry) and sampling[ci] != "all" and sampling[ci] is not True:
                return None
        dates = np.asarray([np.datetime64(d, "s") for d in date_list], dtype="datetime64[s]")

        def flat(frame, key):
            # validated by identity against a strong reference to the frame:
            # a swapped-in frame is never served a stale entry, even if id()
            # is recycled; _rebuild_static also clears the cache
            cached = self._flat_cache.get(key)
            if cached is not None and cached[0] is frame:
                return cached[1]
            t = frame["time"]
            x1 = frame["x1"].astype(np.float32)
            x2 = frame["x2"].astype(np.float32)
            v = frame.to_numpy(frame_value_cols(frame))
            # rows with a non-finite value are dropped, contexts and targets alike
            ok = np.isfinite(v).all(-1)
            if not ok.all():
                t, x1, x2, v = t[ok], x1[ok], x2[ok], v[ok]
            self._flat_cache[key] = (frame, (t, x1, x2, v))
            return t, x1, x2, v

        points = []
        for ci, entry in enumerate(self.context):
            if not _is_frame(entry):
                continue
            t, x1, x2, v = flat(entry, f"ctx{ci}")
            dts = self._align_times(t, dates + np.timedelta64(self.delta_t[ci], "D"))
            px, py, pm, _ = taskpack.pack_station_batches(t, x1, x2, v, dts, self.point_capacity)
            points.append(PointContext(x=_t(px), y=_t(py), mask=_t(pm)))

        t, x1, x2, v = flat(self.target, "tgt")
        xt, yt, ytm, _ = taskpack.pack_station_batches(
            t, x1, x2, v, self._align_times(t, dates), self.target_capacity)

        yt_aux = None
        if self.aux_at_targets is not None:
            chans = []
            flat_x1 = xt[..., 0].ravel().astype(np.float64)
            flat_x2 = xt[..., 1].ravel().astype(np.float64)
            for f in _grid_channels(self.aux_at_targets):
                g1 = f.coords[f.dims[-2]].astype(np.float64)
                g2 = f.coords[f.dims[-1]].astype(np.float64)
                s1, s2 = np.argsort(g1), np.argsort(g2)
                grid = np.take(np.take(f.data, s1, -2), s2, -1).astype(np.float32)
                out = taskpack.interp_grid_points_native(grid, g1[s1], g2[s2], flat_x1, flat_x2)
                chans.append(out.reshape(xt.shape[:2]))
            yt_aux = _t(np.stack(chans, -1))

        grids = []
        for ci, entry in enumerate(self.context):
            if _is_frame(entry):
                continue
            dts = dates + np.timedelta64(self.delta_t[ci], "D")
            chans = []
            spec = None
            for f in _grid_channels(entry):
                if "time" in f.dims:  # vectorised nearest-time gather
                    ft = f.coords["time"].astype("datetime64[s]").astype(np.int64)
                    order = np.argsort(ft)
                    want = dts.astype(np.int64)
                    pos = np.clip(np.searchsorted(ft[order], want), 1, len(ft) - 1)
                    left, right = ft[order][pos - 1], ft[order][pos]
                    pick = order[np.where(np.abs(want - left) <= np.abs(right - want),
                                          pos - 1, pos)]
                    data = np.nan_to_num(
                        np.take(f.data, pick, axis=f.axis("time")).astype(np.float32))
                else:
                    data = np.broadcast_to(np.nan_to_num(f.data.astype(np.float32)),
                                           (len(dates),) + f.data.shape)
                chans.append(data)
                spec = (f.coords[f.dims[-2]].astype(np.float32),
                        f.coords[f.dims[-1]].astype(np.float32))
            grids.append(GridContext(x1=_t(spec[0]), x2=_t(spec[1]), y=_t(_stack_channels(chans))))

        return TaskBatch(
            grids=tuple(grids), points=tuple(points),
            xt=_t(xt), yt=_t(yt), yt_mask=_t(ytm), yt_aux=yt_aux,
            x1g=_t(self.x1g.copy()), x2g=_t(self.x2g.copy()))

    @staticmethod
    def _align_times(frame_times: np.ndarray, queries: np.ndarray) -> np.ndarray:
        """Map query timestamps onto a frame's time resolution: exact matches
        pass; a query whose calendar day is in the frame snaps (with a
        warning) to the frame's nearest timestamp within that day; a query
        whose whole day is absent stays as it is (an empty set)."""
        if len(frame_times) == 0 or len(queries) == 0:
            return queries
        uniq = np.unique(frame_times)
        exact = np.isin(queries, uniq)
        if exact.all():
            return queries
        # snapped values are frame timestamps: carry the frame's unit, or a
        # [s] value assigned into a [D] query array would truncate the snap
        out = queries.astype(uniq.dtype).copy()
        miss = np.nonzero(~exact)[0]
        q = queries[miss]
        uniq_days = uniq.astype("datetime64[D]")
        q_days = q.astype("datetime64[D]")
        lo = np.searchsorted(uniq_days, q_days, side="left")
        hi = np.searchsorted(uniq_days, q_days, side="right")
        same_day = hi > lo
        lo_c = np.minimum(lo, len(uniq) - 1)
        hi_c = np.maximum(hi - 1, 0)
        ins = np.searchsorted(uniq, q)
        li = np.clip(ins - 1, lo_c, hi_c)
        ri = np.clip(ins, lo_c, hi_c)
        nearest = np.where(np.abs(q - uniq[li]) <= np.abs(uniq[ri] - q), uniq[li], uniq[ri])
        if same_day.any():
            warnings.warn(
                "TaskLoader: query timestamps do not exactly match the "
                "station frame's time resolution; snapping to the frame's "
                "nearest same-day timestamps (daily/hourly mismatch).",
                stacklevel=3,
            )
            out[miss[same_day]] = nearest[same_day]
        return out

    @staticmethod
    def _rows_at(frame: StationFrame, date) -> StationFrame:
        t = np.datetime64(date, "s")
        times = frame["time"]
        idx = np.nonzero(times == t)[0]
        if len(idx) == 0 and len(times):
            t2 = TaskLoader._align_times(times, np.asarray([t]))[0]
            if t2 != t:
                idx = np.nonzero(times == t2)[0]
        return frame.take(idx)

    # -- dims used by ConvNP construction ---------------------------------------------

    def context_dims(self) -> list[int]:
        n_aux_c = (len(_grid_channels(self.aux_at_contexts))
                   if self.aux_at_contexts is not None else 0)
        return [len(ids) + (n_aux_c if _is_frame(self.context[i]) else 0)
                for i, ids in enumerate(self.context_var_IDs)]

    def target_dim(self) -> int:
        return len(self.target_var_IDs)

    def aux_dim(self) -> int:
        if self.aux_at_targets is None:
            return 0
        return len(_grid_channels(self.aux_at_targets))
