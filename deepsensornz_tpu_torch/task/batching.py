"""Batch-axis selection, concatenation and padding for TaskBatches.

Counterpart of ``take`` and ``concat`` in
``deepsensornz_tpu/task/batching.py`` and ``pad_batch_to_multiple`` in
``deepsensornz_tpu/parallel/mesh.py``. Only the batched fields are touched;
the grid coordinate vectors are shared by every task and pass through
unchanged (``concat`` keeps the first batch's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch


def _map_batched(task: TaskBatch, fn) -> TaskBatch:
    """Apply ``fn`` to every tensor with a batch axis."""
    def opt(t):
        return None if t is None else fn(t)

    return dataclasses.replace(
        task,
        grids=tuple(GridContext(g.x1, g.x2, fn(g.y), opt(g.mask)) for g in task.grids),
        points=tuple(PointContext(fn(p.x), fn(p.y), fn(p.mask)) for p in task.points),
        xt=fn(task.xt), yt=opt(task.yt), yt_mask=fn(task.yt_mask), yt_aux=opt(task.yt_aux))


def take(task: TaskBatch, idx) -> TaskBatch:
    """The sub-batch at the integer indices ``idx`` (array-like or tensor)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    return _map_batched(task, lambda t: t[idx.to(t.device)])


def concat(tasks: list[TaskBatch]) -> TaskBatch:
    """The batches one after another along the batch axis."""
    t0 = tasks[0]

    def cat(getter):
        vals = [getter(t) for t in tasks]
        return None if vals[0] is None else torch.cat(vals, dim=0)

    return TaskBatch(
        grids=tuple(GridContext(g.x1, g.x2, cat(lambda t: t.grids[i].y),
                                cat(lambda t: t.grids[i].mask))
                    for i, g in enumerate(t0.grids)),
        points=tuple(PointContext(cat(lambda t: t.points[i].x), cat(lambda t: t.points[i].y),
                                  cat(lambda t: t.points[i].mask))
                     for i in range(len(t0.points))),
        xt=cat(lambda t: t.xt), yt=cat(lambda t: t.yt), yt_mask=cat(lambda t: t.yt_mask),
        yt_aux=cat(lambda t: t.yt_aux), x1g=t0.x1g, x2g=t0.x2g)


def pad_batch_to_multiple(task: TaskBatch, multiple: int) -> tuple[TaskBatch, int]:
    """Pad the batch to a multiple of ``multiple``; returns (task, n_real).
    The padding repeats the last task with its target mask zeroed, so the
    loss ignores it entirely."""
    b = task.batch_size
    pad = (-b) % multiple
    if pad == 0:
        return task, b
    padded = _map_batched(task, lambda t: torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]))
    mask = padded.yt_mask.clone()
    mask[b:] = 0.0
    return dataclasses.replace(padded, yt_mask=mask), b
