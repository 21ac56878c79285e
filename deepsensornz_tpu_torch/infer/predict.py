"""Prediction: ConvNP → physical-units mean/std (+ samples) fields.

Counterpart of ``Predictor`` in ``deepsensornz_tpu/infer/predict.py``:

- ``predict_grid`` takes a batch of tasks and a target DEM ``Field`` (raw
  latitude/longitude coordinates, NaN = sea), runs the forward on the
  model's device, rescales the predictive spread by ``std_scale``, takes
  the head's mean/std and, with ``n_samples > 0``, joint samples over the
  whole grid; only the land cells leave the device, and they return
  unnormalised as ``Field``s with NaN sea cells. Without samples the
  decode, the head and the moments run on the land cells alone (the
  decode kernel on the block tiles that hold land); with samples on the
  whole grid, the land cells gathered after the draws, so the draws are
  the whole grid's. A request is a list of chunks: the whole batch, or
  fixed-size chunks of ``batch_chunk`` tasks when the batch is longer.
  Every chunk is launched first; the host then waits for each chunk's
  copy and writes its rows of the maps, a map a job on
  ``download_threads`` workers, while the later chunks run. The host's
  maps are computed on the land values alone (dequantise,
  ``post_transform``, which must be elementwise, and unnormalise), and
  each ``Field``'s array is written once, by one gather that puts NaN on
  the sea cells.
- ``predict_points`` gives mean/std (and ``p_wet`` for bernoulli-gamma) at
  the task's off-grid targets.
- ``ar_sample_grid`` draws coherent AR samples on a subsampled grid and
  interpolates them back onto the full grid.

``predict_grid``, ``predict_points``, ``ar_sample_grid`` (and
``infer.ar.ar_sample``) take ``mesh=``, a data mesh of
``parallel.mesh.make_mesh``: every rank passes the same global batch, the
batch (each chunk of it, with ``batch_chunk``) is padded to a multiple of
the data axis and split over the ranks, each rank runs the forward on its
rows, the device outputs are gathered in rank order and the pad rows
dropped; the host steps then run as in one process, and every rank
returns the whole result. Sample draws are the whole batch's on every rank
(``infer.ar.sample_rows``), so they do not depend on the number of ranks.
On a mesh with a spatial axis, every rank of a spatial group runs the same
rows and draws the same samples, and a model with ``mesh_axes`` runs its
internal grid in row blocks over that axis (``models.convnp``).

Every request runs under ``torch.inference_mode()``. The transfer modes
shrink what crosses the host link: ``transfer_dtype`` casts the finished
maps on the device (``"float16"``/``"bfloat16"``) or quantises them there
(``"int16"``/``"int8"``: per-(task, channel) ``lo``/``scale`` over the
cells, dequantised on the host, at most ``scale/2`` off); ``upload_dtype``
casts the task's value leaves on the host and upcasts them on the device.
On a CUDA device a gridded request's host inputs (the task and the target
grid's coordinates, aux and land index) reach the card through the
``Predictor``'s pinned staging ring (``infer.staging``), before the
forward is queued.

While the perf recorder records (``perf.spans``), a gridded request is the
span ``predict_grid`` and its children: ``.prepare`` (the target
coordinates, the aux resampled onto the target grid, the sea mask),
``.upload`` (the inputs' fill of the staging ring and the copies it
issues), ``.launch`` (the host's enqueue of the forward),
``.download`` (issuing the copies to pinned memory), ``.wait`` (for a
chunk's copies), ``.maps`` (on the land values: dequantise,
``post_transform``, unnormalise; then each map written once, on the
request's workers; one per chunk, and one around the ``Field``s),
``.drain`` (from the return of the last chunk's ``.wait`` to the
request's return: the host's work that no queued device work hides, the
last chunk's ``.maps`` and the ``Field``s'); and the device spans
``.device`` (all of the forward's device work) with ``.sample`` (the
head's draws) inside it. Counters
``predict_grid.maps_values`` and ``predict_grid.maps_cells`` add, per map
written, the land values computed on and the grid cells written: their
ratio is the share of the grid the host computed on. Counters
``predict_grid.upload_staged_bytes`` and ``predict_grid.upload_direct_bytes``
add the bytes uploaded through the ring and by ``.to(device)`` (the CPU
path), ``predict_grid.upload_slab_waits`` the fills that waited for a
slab's copy to the card; ``predict_grid.chunks``, counted only while
recording, the chunks a request launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from deepsensornz_tpu_torch.data.grid import Dataset, Field, interp_grid_at_points
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.infer.ar import ar_sample, sample_rows
from deepsensornz_tpu_torch.infer.staging import StagingRing
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.parallel.mesh import gather_rows, rank_indices
from deepsensornz_tpu_torch.perf import spans
from deepsensornz_tpu_torch.task.batching import take
from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch


class Prediction(Dataset):
    """Dataset of mean/std (+ samples) fields for one target variable."""


def _affine_for(dp: DataProcessor, var: str) -> tuple[float, float]:
    """(scale, offset): physical = normalised·scale + offset, for each of the
    three (affine) normalisation methods."""
    cfg = dp.config[var]
    p = cfg["params"]
    m = cfg["method"]
    if m == "mean_std":
        return p["std"], p["mean"]
    if m == "min_max":
        span = p["max"] - p["min"]
        return span / 2.0, p["min"] + span / 2.0
    if m == "positive_semidefinite":
        return p["std"], 0.0
    raise ValueError(m)


def _linear_interp_weights(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Dense (len(new), len(old)) linear-interpolation weights with the
    semantics of ``Field._interp_one(dim, new, 'linear')`` (sorted,
    edge-clamped)."""
    old = np.asarray(old, np.float64)
    new = np.asarray(new, np.float64)
    order = np.argsort(old)
    old_s = old[order]
    pos = np.clip(np.searchsorted(old_s, new), 1, len(old_s) - 1)
    x0, x1 = old_s[pos - 1], old_s[pos]
    w = np.clip((new - x0) / np.maximum(x1 - x0, 1e-12), 0.0, 1.0)
    W = np.zeros((len(new), len(old)), np.float64)
    rows = np.arange(len(new))
    np.add.at(W, (rows, order[pos - 1]), 1.0 - w)
    np.add.at(W, (rows, order[pos]), w)
    return W


def _channels(aux) -> list:
    return list(aux.values()) if isinstance(aux, Dataset) else [aux]


_QUANT_BITS = {"int16": 16, "int8": 8}
_CASTS = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _quantize(v: torch.Tensor, bits: int) -> dict:
    """Affine quantisation of (..., cells, C) on the device, with one
    ``lo``/``scale`` per (leading index, channel) over the cell axis (the
    land cells, or every cell of the grid): ``q = round((v - lo)/scale) -
    2^(b-1)``, ``scale = (max - min)/(2^b - 1)``, so the host's
    :func:`_dequantize_host` is at most ``scale/2`` off."""
    lo = v.amin(dim=-2, keepdim=True)
    hi = v.amax(dim=-2, keepdim=True)
    scale = torch.clamp((hi - lo) / float(2 ** bits - 1), min=1e-12)
    q = torch.round((v - lo) / scale) - 2.0 ** (bits - 1)
    return {"q": q.to(torch.int8 if bits == 8 else torch.int16), "lo": lo, "scale": scale}


def _dequantize_host(d) -> np.ndarray:
    """float32 numpy of a downloaded map: ``(q + 2^(b-1))·scale + lo`` for
    a quantised one, the upcast value for a cast one."""
    if not isinstance(d, dict):
        return d.float().numpy()
    q = d["q"].numpy()
    a = q.astype(np.float32)
    a += float(2 ** (q.dtype.itemsize * 8 - 1))
    a *= d["scale"].numpy()
    a += d["lo"].numpy()
    return a


def _download(out: dict, device: torch.device) -> tuple[dict, Optional[torch.cuda.Event]]:
    """Start copying each tensor of ``out`` into pinned host memory; returns
    the host tree and an event that completes with the copies (on the CPU:
    the tensors themselves and None)."""
    if device.type != "cuda":
        return out, None

    def copy(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t, non_blocking=True)

    host = {k: ({kk: copy(vv) for kk, vv in v.items()} if isinstance(v, dict) else copy(v))
            for k, v in out.items()}
    event = torch.cuda.Event()
    event.record()
    return host, event


def _upload(task: TaskBatch, target: tuple, device: torch.device,
            upload_dtype: Optional[str], ring: Optional[StagingRing]) -> tuple:
    """(task, target) of the grid path on ``device``: the task with its
    target-side leaves, unused when predicting on a grid, cut to one
    placeholder slot, and the target grid's ``(xt1, xt2, aux, land)`` as
    tensors: numpy ``xt1``, ``xt2`` and ``aux`` (or None), and ``land`` None,
    the numpy land index or its host
    :class:`~deepsensornz_tpu_torch.ops.setconv_cuda.TargetCells`. With
    ``upload_dtype`` the value leaves (grid and point ``y`` and ``mask``)
    cross in that dtype and are upcast to float32 on the device; coordinates stay
    float32. With ``ring``, every host leaf goes through the pinned
    staging ring (:mod:`~deepsensornz_tpu_torch.infer.staging`); the rest,
    and every leaf without one, by ``.to(device)``, counted under
    ``predict_grid.upload_direct_bytes``."""
    dt = _CASTS[upload_dtype] if upload_dtype else None
    leaves = []  # (tensor, the dtype it crosses in, upcast on the device)

    def put(t, value=False):
        if t is None:
            return None
        leaves.append((t, dt if value and dt else t.dtype, value and dt is not None))
        return len(leaves) - 1

    grids = [(put(g.x1), put(g.x2), put(g.y, True), put(g.mask, True)) for g in task.grids]
    points = [(put(p.x), put(p.y, True), put(p.mask, True)) for p in task.points]
    rest = [put(t) for t in (task.xt[:, :1], task.yt_mask[:, :1], task.x1g, task.x2g)]
    xt1, xt2, aux, land = target
    cells = isinstance(land, setconv_cuda.TargetCells)
    grid = [put(None if a is None else torch.as_tensor(a))
            for a in (xt1, xt2, aux, *(land if cells else (land,)))]
    got = [None] * len(leaves)
    if ring is not None:
        host = [i for i, (t, _, _) in enumerate(leaves) if t.device.type == "cpu"]
        staged = ring.upload([leaves[i][:2] for i in host], device)
        for i, t in zip(host, staged):
            got[i] = t
    for i, (t, d, _) in enumerate(leaves):
        if got[i] is None:
            got[i] = t.to(d).to(device)
            spans.count("predict_grid.upload_direct_bytes",
                        got[i].numel() * got[i].element_size())

    def leaf(i):
        return None if i is None else got[i].float() if leaves[i][2] else got[i]

    xt, yt_mask, x1g, x2g = map(leaf, rest)
    xt1, xt2, aux, *land = map(leaf, grid)
    return (TaskBatch(grids=tuple(GridContext(*map(leaf, g)) for g in grids),
                      points=tuple(PointContext(*map(leaf, p)) for p in points),
                      xt=xt, yt=None, yt_mask=yt_mask, yt_aux=None, x1g=x1g, x2g=x2g),
            (xt1, xt2, aux, setconv_cuda.TargetCells(*land) if cells else land[0]))


def _chunk_index(chunks: list, device: torch.device) -> list:
    """Each chunk's rows of the uploaded batch as an index on ``device``,
    all from one copy out of pinned memory: a pageable ``.to(device)`` a
    chunk would make the host wait for every chunk queued before it."""
    host = torch.from_numpy(np.concatenate(chunks))
    if device.type == "cuda":
        host = host.pin_memory()
    return list(host.to(device, non_blocking=True).split([len(c) for c in chunks]))


def _gather_out(out: dict, mesh, batch: int) -> dict:
    """The ranks' transfer-format outputs gathered in rank order, the pad
    rows past ``batch`` dropped: mean/std (and their quantisation ``lo``/
    ``scale``) along dim 0, samples along dim 1."""
    def gather(t, dim):
        return gather_rows(t, mesh, dim).narrow(dim, 0, batch)

    return {k: ({kk: gather(vv, int(k == "samples")) for kk, vv in v.items()}
                if isinstance(v, dict) else gather(v, int(k == "samples")))
            for k, v in out.items()}


def _inverse_index(land: np.ndarray, cells: int) -> np.ndarray:
    """Each grid cell's position in the compact row of ``land`` values; a
    sea cell's is the NaN slot after the row (``len(land)``)."""
    inv = np.full(cells, len(land), np.intp)
    inv[land] = np.arange(len(land))
    return inv


def _gather_into(dst: np.ndarray, src: np.ndarray, inv: Optional[np.ndarray],
                 scale: Optional[float] = None, offset: Optional[float] = None) -> None:
    """Write the compact values ``src`` (m, L) into the C-contiguous float32
    map ``dst`` (m, Ht, Wt) in one pass: a gather through ``inv``
    (:func:`_inverse_index`) from each row extended by its NaN slot, or a
    plain copy where ``inv`` is None (every cell is in the row). With
    ``scale``, the values are first unnormalised in float64 (``src·scale``,
    plus ``offset`` when given) and rounded once to float32. Counts the
    values under ``predict_grid.maps_values`` and the cells written under
    ``predict_grid.maps_cells``."""
    flat = dst.reshape(len(dst), -1)
    if inv is None:
        row = flat
    else:
        ext = np.empty((len(src), src.shape[-1] + 1), np.float32)
        ext[:, -1] = np.nan
        row = ext[:, :-1]
    if scale is None:
        row[...] = src
    elif offset is None:
        np.multiply(src, scale, out=row, dtype=np.float64)
    else:
        np.add(np.multiply(src, scale, dtype=np.float64), offset, out=row)
    if inv is not None:
        # mode="raise" with out= would buffer a second copy of the map
        np.take(ext, inv, axis=1, out=flat, mode="clip")
    spans.count("predict_grid.maps_values", src.size)
    spans.count("predict_grid.maps_cells", flat.size)


class Predictor:
    """Bind (model, data_processor, target variable) into a predict callable.
    The model's parameters decide the device every request runs on.

    ``batch_chunk``: split gridded predictions into chunks of this many
    tasks (the tail padded by repeating its last task, the pad trimmed), so
    device memory is bounded by the chunk, not the batch; a batch of at
    most ``batch_chunk`` tasks is one chunk. The batch is uploaded once and
    every chunk launched before the first result is read; the host then
    waits for each chunk's copy in turn and writes its rows of the maps on
    ``download_threads`` workers, a map each, while the later chunks still
    run. Mean and std do not depend on the chunking or the number of
    threads; joint samples draw per-chunk seeds (``seed + chunk offset``)
    and depend on the chunking.

    ``transfer_dtype``: ``None`` (float32), ``"float16"``/``"bfloat16"``
    (cast on the device, upcast on the host) or ``"int16"``/``"int8"``
    (quantised on the device, see :func:`_quantize`). ``upload_dtype``:
    ``None`` or ``"float16"``/``"bfloat16"`` for the task's value leaves
    (see :func:`_upload`)."""

    def __init__(self, model, data_processor: DataProcessor, target_var,
                 std_scale: float = 1.0, transfer_dtype: Optional[str] = None,
                 batch_chunk: Optional[int] = None, download_threads: int = 1,
                 upload_dtype: Optional[str] = None):
        if transfer_dtype is not None and transfer_dtype not in {**_QUANT_BITS, **_CASTS}:
            raise ValueError(f"transfer_dtype must be None, 'float16', 'bfloat16', 'int16' or "
                             f"'int8'; got {transfer_dtype!r}")
        if upload_dtype is not None and upload_dtype not in _CASTS:
            raise ValueError(f"upload_dtype must be None, 'float16' or 'bfloat16'; "
                             f"got {upload_dtype!r}")
        if batch_chunk is not None and batch_chunk < 1:
            raise ValueError(f"batch_chunk must be >= 1, got {batch_chunk}")
        if download_threads < 1:
            raise ValueError(f"download_threads must be >= 1, got {download_threads}")
        self.model = model
        self.dp = data_processor
        self.target_vars = [target_var] if isinstance(target_var, str) else list(target_var)
        self.target_var = self.target_vars[0]
        dy = model.cfg.dim_yt
        if dy != 1 and len(self.target_vars) != dy:
            raise ValueError(f"model has dim_yt={dy}; pass {dy} target_var names "
                             f"(got {self.target_vars})")
        self.likelihood = model.cfg.make_likelihood()
        self.std_scale = float(std_scale)
        self.transfer_dtype = transfer_dtype
        self.upload_dtype = upload_dtype
        self.batch_chunk = batch_chunk
        self.download_threads = int(download_threads)
        self._ring = StagingRing()  # pinned at the first request on a CUDA device

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def predict_grid(
        self,
        task: TaskBatch,
        target_elev: Field,
        aux_at_targets=None,
        times: Optional[np.ndarray] = None,
        n_samples: int = 0,
        seed: int = 0,
        sea_mask: bool = True,
        unnormalise: bool = True,
        post_transform=None,
        resolution_factor: float = 1.0,
        outputs: tuple = ("mean", "std"),
        mesh=None,
    ) -> Prediction:
        """Predict on the grid of ``target_elev``.

        ``aux_at_targets`` is the normalised x-space aux Field/Dataset the
        model was trained with; its channels are resampled onto the
        prediction grid. ``n_samples > 0`` adds ``samples`` Fields
        (dims ``("sample", "time", "latitude", "longitude")``), joint over
        the grid, drawn from a generator seeded with ``seed``.
        ``post_transform(mean, std) -> (mean, std)`` maps the normalised
        moments before unnormalisation; it is applied to the samples as
        ``post_transform(samples, None)``. It must be elementwise: it sees
        the land values only, (…, land cells, dy) arrays (with a chunked
        batch, one chunk's tasks at a time). ``mesh``: split the batch over
        the data ranks (module docstring).

        The host's maps (the ``.maps`` spans) are computed on the land
        values that left the device: dequantised, post-transformed and
        unnormalised there, and each channel's map is then written once,
        straight into the array its ``Field`` holds, NaN on the sea.
        """
        if "mean" not in outputs or not set(outputs) <= {"mean", "std"}:
            raise ValueError(f"outputs must be ('mean','std') or ('mean',); got {outputs}")
        with spans.span("predict_grid"), contextlib.ExitStack() as drain:
            with spans.span("predict_grid.prepare"):
                lat, lon, xt1, xt2, aux, land, inv = self._prepare(
                    task, target_elev, aux_at_targets, sea_mask, resolution_factor)
                if land is not None and n_samples == 0:
                    # without draws over the whole grid, only the land is computed
                    land = setconv_cuda.target_cells(land, len(xt1), len(xt2))
            maps = self._forward_chunked(task, xt1, xt2, aux, n_samples, seed, outputs, land,
                                         inv, unnormalise, post_transform, mesh, drain)
            with spans.span("predict_grid.maps"):
                return self._fields(task, lat, lon, maps, times, n_samples)

    def _prepare(self, task, target_elev, aux_at_targets, sea_mask, resolution_factor):
        """(lat, lon, xt1, xt2, aux, land, inv) of a gridded request: the
        target grid's coordinates, raw and normalised, the aux channels
        resampled onto it (Ht, Wt, A) or None, and the land cells' flat
        indices and their inverse index (:func:`_inverse_index`), or None
        and None."""
        lat = target_elev.coords[target_elev.dims[-2]]
        lon = target_elev.coords[target_elev.dims[-1]]
        if resolution_factor != 1.0:
            # densify/thin the prediction grid relative to the DEM grid
            n_lat = max(int(round(len(lat) * resolution_factor)), 2)
            n_lon = max(int(round(len(lon) * resolution_factor)), 2)
            lat = np.linspace(float(lat[0]), float(lat[-1]), n_lat)
            lon = np.linspace(float(lon[0]), float(lon[-1]), n_lon)
            target_elev = target_elev._interp_one(
                target_elev.dims[-2], lat, "nearest"
            )._interp_one(target_elev.dims[-1], lon, "nearest")
        xt1 = self.dp.map_x1(lat).astype(np.float32)
        xt2 = self.dp.map_x2(lon).astype(np.float32)

        aux = None
        if task.yt_aux is not None:
            if aux_at_targets is None:
                raise ValueError("model was trained with aux_at_targets; pass the same "
                                 "normalised aux Dataset/Field to predict_grid")
            cols = []
            for f in _channels(aux_at_targets):
                g = f._interp_one(f.dims[-2], xt1, "linear")
                g = g._interp_one(g.dims[-1], xt2, "linear")
                cols.append(np.nan_to_num(g.data.astype(np.float32)))
            aux = np.stack(cols, -1)  # (Ht, Wt, A)
            if aux.shape[-1] != task.yt_aux.shape[-1]:
                raise ValueError(f"aux channel mismatch: task has {task.yt_aux.shape[-1]}, "
                                 f"grid aux has {aux.shape[-1]}")

        # sea cells come back NaN: only land cells leave the device
        land = inv = None
        if sea_mask:
            sea2d = np.isnan(target_elev.data)
            if sea2d.any():
                land = np.flatnonzero(~sea2d.ravel())
                inv = _inverse_index(land, sea2d.size)
        return lat, lon, xt1, xt2, aux, land, inv

    def _fields(self, task, lat, lon, maps, times, n_samples) -> Prediction:
        """The finished maps as ``Field``s (no copy)."""
        if times is None:
            times = np.arange(task.batch_size)
        dims = ("time", "latitude", "longitude")
        coords = {"time": np.asarray(times), "latitude": lat, "longitude": lon}
        fields = {}
        for c, var in enumerate(self.target_vars):
            suffix = "" if len(self.target_vars) == 1 else f"_{var}"
            fields[f"mean{suffix}"] = Field(maps["mean"][c], dims, coords, f"mean{suffix}",
                                            {"variable": var})
            if "std" in maps:
                fields[f"std{suffix}"] = Field(maps["std"][c], dims, coords, f"std{suffix}",
                                               {"variable": var})
            if "samples" in maps:
                fields[f"samples{suffix}"] = Field(
                    maps["samples"][c], ("sample",) + dims,
                    {"sample": np.arange(n_samples), **coords}, f"samples{suffix}", {})
        return Prediction(fields)

    def _write_maps(self, maps, host, off, n, inv, unnormalise, post_transform,
                    pool: ThreadPoolExecutor) -> None:
        """Rows ``off:off + n`` of every map in ``maps`` from the first ``n``
        tasks of a downloaded ``host`` tree, computed on its compact values:
        dequantised (float32), ``post_transform``-ed, then each channel
        unnormalised (float64, rounded once to float32) and gathered into
        its map (:func:`_gather_into`), one map (a key, channel and sample)
        a job on ``pool``'s workers."""
        vals = {}
        for k, v in host.items():
            a = _dequantize_host(v)
            vals[k] = a[:, :n] if k == "samples" else a[:n]
        if post_transform is not None:
            vals["mean"], std = post_transform(vals["mean"], vals.get("std"))
            if "std" in vals:
                vals["std"] = std
            if "samples" in vals:
                vals["samples"], _ = post_transform(vals["samples"], None)
        scale, offset = self._affines() if unnormalise else (None, None)
        jobs = []
        for k, a in vals.items():
            for c, dst in enumerate(maps[k]):
                if scale is None:
                    affine = (None, None)
                elif k == "std":
                    affine = (np.abs(scale[c]), None)
                else:
                    affine = (scale[c], offset[c])
                if k == "samples":
                    jobs += [(dst[i, off:off + n], a[i, ..., c], inv, *affine)
                             for i in range(len(a))]
                else:
                    jobs.append((dst[off:off + n], a[..., c], inv, *affine))
        list(pool.map(lambda job: _gather_into(*job), jobs))

    def _forward_chunked(self, task, xt1, xt2, aux, n_samples, seed, outputs, land, inv,
                         unnormalise, post_transform, mesh, drain: contextlib.ExitStack) -> dict:
        """The request's finished float32 maps, one list of ``dim_yt``
        channels a key: mean/std (B, Ht, Wt) and samples (n, B, Ht, Wt),
        NaN outside the land when ``land`` is given (:meth:`_write_maps`):
        the land index, or its ``TargetCells`` when the forward computes
        the land cells alone (:meth:`_device_forward`). The batch is
        one chunk, or chunks of ``batch_chunk`` when it is longer (the tail
        padded with the batch's last task). The inputs are uploaded once;
        every chunk is launched (with ``mesh``, on the data ranks' rows,
        gathered before the download) and its download started before the
        host waits for the first; the host then writes each chunk's rows
        while the later chunks run. After the last chunk's wait the span
        ``predict_grid.drain`` opens on ``drain``, which the caller closes
        when the request returns."""
        dev = self.device
        B = task.batch_size
        size = min(self.batch_chunk or B, B)
        Ht, Wt, dy = len(xt1), len(xt2), self.model.cfg.dim_yt
        maps = {k: [np.empty((B, Ht, Wt), np.float32) for _ in range(dy)] for k in outputs}
        if n_samples > 0:
            maps["samples"] = [np.empty((n_samples, B, Ht, Wt), np.float32) for _ in range(dy)]
        offsets = range(0, B, size)
        chunks = [np.minimum(np.arange(off, off + size), B - 1) for off in offsets]
        pending = []  # (offset, host tree, event) of each chunk
        with torch.inference_mode():
            with spans.span("predict_grid.upload"):
                if mesh is not None:
                    # this rank's rows of every chunk, uploaded once; each
                    # chunk then takes its rows of the upload
                    mine = [rank_indices(mesh, idx) for idx in chunks]
                    task = take(task, np.concatenate(mine))
                    chunks = [np.arange(i * len(m), (i + 1) * len(m)) for i, m in enumerate(mine)]
                ring = self._ring if dev.type == "cuda" else None
                task, target = _upload(task, (xt1, xt2, aux, land), dev, self.upload_dtype,
                                       ring)
                index = None if len(chunks) == 1 else _chunk_index(chunks, dev)
            if spans.active():
                spans.count("predict_grid.chunks", len(chunks))
            for k, off in enumerate(offsets):
                with spans.span("predict_grid.launch"):
                    rows = task if index is None else take(task, index[k])
                    out = self._device_forward(rows, target, n_samples, seed + off, outputs, mesh,
                                               size)
                with spans.span("predict_grid.download"):
                    pending.append((off, *_download(out, dev)))
        with ThreadPoolExecutor(self.download_threads) as pool:
            for k, (off, host, event) in enumerate(pending):
                with spans.span("predict_grid.wait"):
                    if event is not None:
                        event.synchronize()
                if k == len(pending) - 1:
                    drain.enter_context(spans.span("predict_grid.drain"))
                with spans.span("predict_grid.maps"):
                    self._write_maps(maps, host, off, min(size, B - off), inv, unnormalise,
                                     post_transform, pool)
        return maps

    def _device_forward(self, task, target, n_samples, seed, outputs, mesh=None,
                        batch: int = 0) -> dict:
        """Forward, moments and samples of a task on the device, in the
        transfer format: (B, cells, dy) mean/std and (n, B, cells, dy)
        samples, over the ``land`` cells when given, else every cell;
        each a tensor, or a quantised dict (:func:`_quantize`). With
        ``mesh``, ``task`` is this rank's rows of a ``batch``-task batch:
        the samples are drawn as for the batch (:func:`sample_rows`) and
        the result is the batch's, gathered from every rank. ``target``:
        the target grid's ``(xt1, xt2, aux, land)`` on the device
        (:func:`_upload`). Where ``land`` is a
        :class:`~deepsensornz_tpu_torch.ops.setconv_cuda.TargetCells` (no
        samples), the aux is taken at the land cells and the decode, the
        head and the moments run on them alone; else on the whole grid,
        then the land cells are gathered when ``land`` is an index."""
        dev = self.device
        xt1, xt2, aux, land = target
        with spans.span("predict_grid.device", device=dev):
            lik = self.likelihood
            B = task.batch_size
            cells = land if isinstance(land, setconv_cuda.TargetCells) else None
            if aux is not None and cells is not None:
                aux = aux.flatten(0, 1).index_select(0, cells.index)  # (L, A)
            aux_b = None if aux is None else aux.expand(B, *aux.shape)
            raw = self.model(task, target_grid=(xt1, xt2, aux_b), mesh=mesh, cells=cells)
            raw = lik.rescale_raw(raw, self.std_scale).flatten(1, -2)
            mean, std = lik.mean_std(raw)
            out = {k: v for k, v in (("mean", mean), ("std", std)) if k in outputs}
            if n_samples > 0:
                # over the flattened grid, so the gnp head samples jointly
                gen = torch.Generator(device=dev).manual_seed(int(seed))
                with spans.span("predict_grid.sample", device=dev):
                    out["samples"] = (lik.sample(raw, gen, n_samples) if mesh is None
                                      else sample_rows(lik, raw, gen, n_samples, mesh, batch))
            if land is not None and cells is None:
                out = {k: v.index_select(-2, land) for k, v in out.items()}
            out = {k: v.float() for k, v in out.items()}
            bits = _QUANT_BITS.get(self.transfer_dtype)
            if bits:
                out = {k: _quantize(v, bits) for k, v in out.items()}
            elif self.transfer_dtype:
                out = {k: v.to(_CASTS[self.transfer_dtype]) for k, v in out.items()}
            return out if mesh is None else _gather_out(out, mesh, batch)

    def predict_points(self, task: TaskBatch, unnormalise: bool = True,
                       post_transform=None, mesh=None) -> dict[str, np.ndarray]:
        """Mean/std at ``task.xt`` (the station-holdout path). Arrays of
        shape (B, M) for single-channel models, (B, M, dy) for dim_yt > 1,
        NaN where ``task.yt_mask`` is 0; with ``mask`` and, for
        bernoulli-gamma, the wet probability ``p_wet`` (B, M). ``mesh``:
        split the batch over the data ranks (module docstring)."""
        lik = self.likelihood
        with torch.inference_mode():
            rows = task if mesh is None else take(task, rank_indices(mesh, np.arange(
                task.batch_size)))
            raw = lik.rescale_raw(self.model(rows.to(self.device), mesh=mesh), self.std_scale)
            mean, std = lik.mean_std(raw)
            out = {"mean": mean, "std": std}
            if lik.name == "bernoulli-gamma":
                # occurrence probability, untouched by the spread rescale
                out["p_wet"] = torch.sigmoid(raw[..., 0])
            if mesh is not None:
                out = {k: gather_rows(v, mesh)[:task.batch_size] for k, v in out.items()}
            host = {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}
        mean, std = host["mean"], host["std"]
        if post_transform is not None:
            mean, std = post_transform(mean, std)
        if unnormalise:
            scale, offset = self._affines()
            mean = mean * scale + offset
            std = std * np.abs(scale)
        mask = task.yt_mask.cpu().numpy().astype(bool)
        mean = np.where(mask[..., None], mean, np.nan)
        std = np.where(mask[..., None], std, np.nan)
        if len(self.target_vars) == 1:
            mean, std = mean[..., 0], std[..., 0]
        result = {"mean": mean, "std": std, "mask": mask}
        if "p_wet" in host:
            result["p_wet"] = np.where(mask, host["p_wet"], np.nan)
        return result

    def ar_sample_grid(
        self,
        task: TaskBatch,
        target_elev: Field,
        aux_at_targets=None,
        n_samples: int = 1,
        subsample_factor: int = 4,
        n_blocks: int = 8,
        unnormalise: bool = True,
        sea_mask: bool = True,
        seed: int = 0,
        mesh=None,
    ) -> np.ndarray:
        """Coherent AR samples on the prediction grid: AR runs on every
        ``subsample_factor``-th cell, then each sampled field is linearly
        interpolated back onto the full grid. Returns (n_samples, B, Ht, Wt)
        in physical units ((…, dy) for dim_yt > 1), NaN on sea. ``mesh``:
        split the batch over the data ranks (``ar_sample``)."""
        lat = target_elev.coords[target_elev.dims[-2]]
        lon = target_elev.coords[target_elev.dims[-1]]
        lat_c = lat[::subsample_factor]
        lon_c = lon[::subsample_factor]
        x1c = self.dp.map_x1(lat_c).astype(np.float32)
        x2c = self.dp.map_x2(lon_c).astype(np.float32)
        pts = np.stack(np.meshgrid(x1c, x2c, indexing="ij"), -1).reshape(-1, 2)
        M = len(pts)
        B = task.batch_size
        dy = self.model.cfg.dim_yt
        aux = None
        if task.yt_aux is not None:
            A = task.yt_aux.shape[-1]
            if aux_at_targets is not None:
                # the aux channels at the coarse AR points, as in training
                a = np.stack([interp_grid_at_points(f, pts[:, 0], pts[:, 1])
                              for f in _channels(aux_at_targets)], -1).astype(np.float32)
                if a.shape[-1] != A:
                    raise ValueError(f"aux channel mismatch: task has {A}, grid aux has "
                                     f"{a.shape[-1]}")
                aux = torch.from_numpy(np.broadcast_to(a[None], (B, M, A)).copy())
            else:
                aux = torch.zeros((B, M, A), dtype=torch.float32)
        coarse = dataclasses.replace(
            task, xt=torch.from_numpy(np.broadcast_to(pts[None], (B, M, 2)).copy()),
            yt=None, yt_mask=torch.ones((B, M), dtype=torch.float32), yt_aux=aux)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        samples = ar_sample(self.model, coarse, n_samples=n_samples, n_blocks=n_blocks,
                            generator=gen, std_scale=self.std_scale, mesh=mesh)  # (S, B, M, dy)
        fields = samples.reshape(n_samples, B, len(lat_c), len(lon_c), dy)
        # one separable linear upsampling of every (sample, task, channel)
        w_lat = _linear_interp_weights(lat_c, lat)
        w_lon = _linear_interp_weights(lon_c, lon)
        out = np.einsum("hi,sbijc,wj->sbhwc", w_lat, fields, w_lon,
                        optimize=True).astype(np.float32)
        if unnormalise:
            scale, offset = self._affines()
            out = out * scale + offset
        if sea_mask:
            out = np.where(np.isnan(target_elev.data)[..., None], np.nan, out)
        return out[..., 0] if dy == 1 else out

    def _target_stat_name(self, var: Optional[str] = None) -> str:
        """Resolve the DataProcessor stats entry for a target variable."""
        var = self.target_var if var is None else var
        if var in self.dp.config:
            return var
        hits = [k for k in self.dp.config if k.startswith(var)]
        if len(hits) == 1:
            return hits[0]
        if hits:
            raise KeyError(f"target {var!r} matches multiple stats entries {hits}; "
                           "use the exact name")
        raise KeyError(f"no normalisation stats for target {var!r}; have {list(self.dp.config)}")

    def _affines(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel (scale, offset) vectors, shape (dim_yt,)."""
        pairs = [_affine_for(self.dp, self._target_stat_name(v)) for v in self.target_vars]
        return (np.asarray([p[0] for p in pairs], np.float64),
                np.asarray([p[1] for p in pairs], np.float64))
