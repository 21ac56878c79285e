"""Prebuilt task caches: TaskBatches in ``.npz`` shards on disk.

Counterpart of ``deepsensornz_tpu/task/cache.py``, in its format: each
shard is ``shard_NNNNN.npz`` (``np.savez_compressed`` of the batch's arrays
under the JAX package's names) beside ``shard_NNNNN.npz.json`` (the counts
of context sets, which optional leaves are present, and the shard's times).
Shards written by either package load in the other. Shards load as CPU
tensors.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flatten(task: TaskBatch) -> tuple[dict, dict]:
    arrays: dict[str, np.ndarray] = {}
    meta = {"n_grids": len(task.grids), "n_points": len(task.points),
            "has_yt": task.yt is not None, "has_aux": task.yt_aux is not None}
    for i, g in enumerate(task.grids):
        arrays[f"g{i}_x1"] = _np(g.x1)
        arrays[f"g{i}_x2"] = _np(g.x2)
        arrays[f"g{i}_y"] = _np(g.y)
        if g.mask is not None:
            arrays[f"g{i}_mask"] = _np(g.mask)
    for i, p in enumerate(task.points):
        arrays[f"p{i}_x"] = _np(p.x)
        arrays[f"p{i}_y"] = _np(p.y)
        arrays[f"p{i}_mask"] = _np(p.mask)
    arrays["xt"] = _np(task.xt)
    if task.yt is not None:
        arrays["yt"] = _np(task.yt)
    arrays["yt_mask"] = _np(task.yt_mask)
    if task.yt_aux is not None:
        arrays["yt_aux"] = _np(task.yt_aux)
    arrays["x1g"] = _np(task.x1g)
    arrays["x2g"] = _np(task.x2g)
    return arrays, meta


def _unflatten(arrays: dict, meta: dict) -> TaskBatch:
    def t(key):
        return torch.from_numpy(arrays[key]) if key in arrays else None

    return TaskBatch(
        grids=tuple(GridContext(t(f"g{i}_x1"), t(f"g{i}_x2"), t(f"g{i}_y"), t(f"g{i}_mask"))
                    for i in range(meta["n_grids"])),
        points=tuple(PointContext(t(f"p{i}_x"), t(f"p{i}_y"), t(f"p{i}_mask"))
                     for i in range(meta["n_points"])),
        xt=t("xt"), yt=t("yt") if meta["has_yt"] else None, yt_mask=t("yt_mask"),
        yt_aux=t("yt_aux") if meta["has_aux"] else None, x1g=t("x1g"), x2g=t("x2g"))


class TaskCache:
    """A directory of fixed-shape TaskBatch shards."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir

    def build(self, task_loader, times, shard_size: int = 32, **task_kwargs) -> int:
        """Materialise tasks for ``times`` into shards of ``shard_size``
        times; returns the number of shards."""
        os.makedirs(self.cache_dir, exist_ok=True)
        times = list(times)
        n_shards = 0
        for s in range(0, len(times), shard_size):
            chunk = times[s: s + shard_size]
            arrays, meta = _flatten(task_loader(chunk, **task_kwargs))
            path = os.path.join(self.cache_dir, f"shard_{n_shards:05d}.npz")
            np.savez_compressed(path, **arrays)
            with open(path + ".json", "w") as f:
                json.dump({**meta, "times": [str(t) for t in chunk]}, f)
            n_shards += 1
        return n_shards

    def shards(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.cache_dir, "shard_*.npz")))

    def load_shard(self, path: str) -> TaskBatch:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        with open(path + ".json") as f:
            meta = json.load(f)
        return _unflatten(arrays, meta)

    def __iter__(self) -> Iterator[TaskBatch]:
        for path in self.shards():
            yield self.load_shard(path)

    def iter_epochs(self, n_epochs: int, shuffle: bool = True, seed: int = 0,
                    prefetch: int = 2) -> Iterator[TaskBatch]:
        """The shards for ``n_epochs`` epochs, in a fresh order each epoch
        (the JAX package's order for the same seed); ``prefetch`` > 0 loads
        upcoming shards on a background thread."""
        rng = np.random.default_rng(seed)
        paths = self.shards()

        def gen():
            for _ in range(n_epochs):
                order = rng.permutation(len(paths)) if shuffle else np.arange(len(paths))
                for i in order:
                    yield self.load_shard(paths[i])

        return prefetch_iterator(gen(), depth=prefetch) if prefetch else gen()


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator on a background thread with a bounded queue; an
    error in it is raised on the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, raised there
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
