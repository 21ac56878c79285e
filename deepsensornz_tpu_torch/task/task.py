"""Fixed-shape task batches of tensors.

Counterpart of ``deepsensornz_tpu/task/task.py``: the same field names and
shapes, as dataclasses of ``torch.Tensor``. Point sets are padded to a fixed
capacity with a validity mask; padding is inert because the mask folds
into the SetConv density channel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _to(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


def _tensor(a) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


@dataclasses.dataclass
class GridContext:
    """A gridded context set (base field / aux / landmask) in x-space."""

    x1: torch.Tensor  # (Hc,) grid x1 coordinates
    x2: torch.Tensor  # (Wc,) grid x2 coordinates
    y: torch.Tensor   # (B, Hc, Wc, C) channel values
    mask: Optional[torch.Tensor] = None  # (B, Hc, Wc); None = fully valid

    def to(self, device) -> "GridContext":
        return GridContext(self.x1.to(device), self.x2.to(device),
                           self.y.to(device), _to(self.mask, device))


@dataclasses.dataclass
class PointContext:
    """An off-grid (station) context set, padded to static capacity N."""

    x: torch.Tensor     # (B, N, 2) coords in x-space; pads arbitrary
    y: torch.Tensor     # (B, N, C) values; pads arbitrary
    mask: torch.Tensor  # (B, N) 1.0 = real observation

    def to(self, device) -> "PointContext":
        return PointContext(self.x.to(device), self.y.to(device), self.mask.to(device))


@dataclasses.dataclass
class TaskBatch:
    """One batch of downscaling tasks (one task = one timestamp)."""

    grids: tuple          # tuple[GridContext, ...]
    points: tuple         # tuple[PointContext, ...]
    xt: torch.Tensor      # (B, M, 2) target coords (padded)
    yt: Optional[torch.Tensor]      # (B, M, dy) target values (None at inference)
    yt_mask: torch.Tensor  # (B, M)
    yt_aux: Optional[torch.Tensor]  # (B, M, A) aux-at-targets (highres topo)
    x1g: torch.Tensor     # (H,) internal grid x1
    x2g: torch.Tensor     # (W,) internal grid x2

    @property
    def batch_size(self) -> int:
        return self.xt.shape[0]

    @property
    def num_targets(self) -> int:
        return self.xt.shape[1]

    def to(self, device) -> "TaskBatch":
        return TaskBatch(
            grids=tuple(g.to(device) for g in self.grids),
            points=tuple(p.to(device) for p in self.points),
            xt=self.xt.to(device), yt=_to(self.yt, device),
            yt_mask=self.yt_mask.to(device), yt_aux=_to(self.yt_aux, device),
            x1g=self.x1g.to(device), x2g=self.x2g.to(device),
        )

    @classmethod
    def from_numpy(cls, task) -> "TaskBatch":
        """Build from any object with a TaskBatch's attributes whose leaves
        ``np.asarray`` accepts (e.g. a JAX ``TaskBatch``). Leaves are copied
        into CPU tensors; move them with :meth:`to`."""
        return cls(
            grids=tuple(GridContext(_tensor(g.x1), _tensor(g.x2), _tensor(g.y),
                                    _tensor(g.mask)) for g in task.grids),
            points=tuple(PointContext(_tensor(p.x), _tensor(p.y), _tensor(p.mask))
                         for p in task.points),
            xt=_tensor(task.xt), yt=_tensor(task.yt), yt_mask=_tensor(task.yt_mask),
            yt_aux=_tensor(task.yt_aux), x1g=_tensor(task.x1g), x2g=_tensor(task.x2g),
        )


def pad_points(
    x: np.ndarray, y: np.ndarray, capacity: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (N,2)/(N,C) point arrays to ``capacity`` rows; returns mask too.

    Pad coordinates are placed far outside the unit domain so their RBF
    weight underflows to exactly 0 even before masking.
    """
    n = x.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    xp = np.full((capacity, 2), -1e3, dtype=np.float32)
    yp = np.zeros((capacity,) + y.shape[1:], dtype=np.float32)
    mask = np.zeros((capacity,), dtype=np.float32)
    xp[:n] = x
    yp[:n] = np.nan_to_num(y)
    mask[:n] = 1.0
    return xp, yp, mask
