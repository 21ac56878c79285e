"""Greedy station placement with an uncertainty acquisition.

Counterpart of ``deepsensornz_tpu/al/greedy.py`` (``GreedyAlgorithm`` and
``Stddev``). Two search modes:

- ``exhaustive``: every remaining candidate is added, hypothetically, to
  the context set (pseudo-observed at the current predictive mean) and the
  acquisition is scored over the task's targets; the best candidate is
  placed. All candidates are scored in one forward: candidate s is task s
  of a batch of S.
- ``fast``: place at the remaining candidate with the largest predictive
  std.

Each placement is fed back as context (its predicted mean), so later
placements account for earlier ones, and placed candidates leave the pool.

The feedback context set is padded once with one masked slot per placement
(x = -1e3, mask 0: inert in the SetConv encode), so every round runs the
same shapes. The rounds are a Python loop of device operations (JAX runs
them as one ``lax.scan``): the choices are argmax/argmin over masked scores
on the device, the chosen rows are gathered with ``index_select`` and
written into the chain's own copy of the context set, and nothing is read
back to the host until the placements and scores are fetched once at the
end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from deepsensornz_tpu_torch.infer.ar import _extend_point_context
from deepsensornz_tpu_torch.task.task import PointContext, TaskBatch


class Stddev:
    """Acquisition: mean predictive standard deviation over the targets
    (lower after adding a sensor = better placement)."""

    def __call__(self, mean: torch.Tensor, std: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.float()
        return (std[..., 0] * m).sum(-1) / m.sum(-1).clamp_min(1.0)


def _tile(t: Optional[torch.Tensor], S: int) -> Optional[torch.Tensor]:
    """A batch-1 leaf seen S times along the batch axis (a view)."""
    if t is None or t.ndim == 0 or t.shape[0] != 1:
        return t
    return t.expand((S,) + tuple(t.shape[1:]))


class GreedyAlgorithm:
    """Sequential greedy placement of ``n_placements`` new stations.

    ``model`` is the port's ``ConvNP`` with its weights; the placement runs
    on the model's device. ``ar_context_idx`` picks the point context set
    that receives the placements; ``mode`` is ``"fast"`` or (anything else,
    as in the JAX package) exhaustive. ``mesh``: a mesh whose spatial axis
    partitions the model's internal grid (``ConvNPConfig.mesh_axes``; JAX
    runs its AL chain under ``jax.set_mesh``); every rank runs the same
    chain and places the same candidates.
    """

    def __init__(self, model, acquisition: Optional[Callable] = None,
                 ar_context_idx: int = -1, mode: str = "exhaustive", mesh=None):
        self.model = model
        self.mesh = mesh
        self.acquisition = acquisition or Stddev()
        self.ar_context_idx = ar_context_idx
        self.mode = mode
        self.lik = model.cfg.make_likelihood()

    def _predict(self, task: TaskBatch) -> tuple[torch.Tensor, torch.Tensor]:
        return self.lik.mean_std(self.model(task, mesh=self.mesh))

    # -- public ---------------------------------------------------------------------

    @torch.inference_mode()
    def run(self, task: TaskBatch, candidates: np.ndarray, n_placements: int = 1,
            candidate_aux: Optional[np.ndarray] = None) -> dict:
        """Greedy placement on a single task (batch size 1). ``candidates``
        (S, 2) are x-space coordinates, ``candidate_aux`` (S, A) the aux
        channels at them.

        Returns {"placements": (n, 2), "acquisition_history": [n floats],
        "final_task": the task with the placements in its context set}.
        """
        if task.batch_size != 1:
            raise ValueError("active learning runs on a single task (B=1)")
        idx = self.ar_context_idx % len(task.points)
        dy = self.model.cfg.dim_yt
        S = len(candidates)
        if n_placements > S:
            raise ValueError(
                f"n_placements={n_placements} exceeds the {S} candidates — "
                "placed candidates leave the pool, so each placement needs "
                "a fresh site"
            )
        if task.points[idx].y.shape[-1] < dy:
            raise ValueError(
                f"AL context set has {task.points[idx].y.shape[-1]} channels "
                f"< dim_yt={dy} (wrong ar_context_idx?)"
            )
        if task.yt_aux is not None and candidate_aux is None:
            raise ValueError(
                "model was trained with aux_at_targets; pass candidate_aux "
                "(aux channels at the candidate sites) — zero-filled aux "
                "would score every candidate at the dataset-mean covariates"
            )
        dev = next(self.model.parameters()).device
        task = task.to(dev)
        cand = torch.as_tensor(np.asarray(candidates), dtype=torch.float32, device=dev)
        cand_aux = (None if candidate_aux is None else
                    torch.as_tensor(np.asarray(candidate_aux), dtype=torch.float32, device=dev))
        # n_placements masked slots, so every round has the same shapes
        base_n = task.points[idx].x.shape[1]
        task = dataclasses.replace(task, points=tuple(
            _extend_point_context(p, n_placements) if i == idx else p
            for i, p in enumerate(task.points)))
        final_task, best_xs, scores = self._run_chain(task, cand, cand_aux, base_n,
                                                      n_placements, idx, dy)
        return {
            "placements": best_xs.cpu().numpy(),
            "acquisition_history": [float(s) for s in scores.cpu().numpy()],
            "final_task": final_task,
        }

    @torch.inference_mode()
    def _run_chain(self, task, cand, cand_aux, base_n, n_placements, idx, dy):
        """All greedy rounds on the device; returns the final task and the
        (n, 2) placements and (n,) scores, still on the device. The
        placements are written in place into context set ``idx`` of
        ``task`` (the padded copy ``run`` made)."""
        S = cand.shape[0]
        dev = cand.device
        ctx_c = task.points[idx].y.shape[-1]
        n_extra = ctx_c - dy

        def feedback(y_vals, aux):
            """Context-channel feedback: the observed value(s) and the
            candidate's aux prefix for the aux_at_contexts channels (zeros
            only when no candidate aux exists, as ar.py feeds back)."""
            if n_extra == 0:
                return y_vals[..., :dy]
            if cand_aux is not None and cand_aux.shape[-1] >= n_extra:
                extra = aux[..., :n_extra]
            else:
                extra = y_vals.new_zeros(y_vals.shape[:-1] + (n_extra,))
            return torch.cat([y_vals[..., :dy], extra], -1)

        aux_rows = cand_aux if cand_aux is not None else cand.new_zeros((S, 0))
        taken = torch.zeros(S, dtype=torch.bool, device=dev)
        best_xs = cand.new_empty((n_placements, 2))
        scores = cand.new_empty((n_placements,))
        for t in range(n_placements):
            c_mean, c_std = self._predict(self._probe_at(task, cand, cand_aux))
            if self.mode == "fast":
                # placed candidates leave the pool (deepsensor semantics)
                masked = torch.where(taken, -torch.inf, c_std[0, :, 0])
                best = masked.argmax().reshape(1)
                score = c_std[0, :, 0].index_select(0, best)
            else:
                hyp_feed = feedback(c_mean[0], aux_rows)
                sc = self._exhaustive_scores_dev(task, cand, hyp_feed, idx)
                best = torch.where(taken, torch.inf, sc).argmin().reshape(1)
                score = sc.index_select(0, best)
            placed_feed = feedback(c_mean[0].index_select(0, best),
                                   aux_rows.index_select(0, best))
            x_new = cand.index_select(0, best)
            task = self._set_context_slot(task, idx, base_n + t, x_new[0], placed_feed[0])
            taken.index_fill_(0, best, True)
            best_xs[t] = x_new[0]
            scores[t] = score[0]
        return task, best_xs, scores

    # -- helpers ------------------------------------------------------------------------

    def _probe_at(self, task: TaskBatch, cand: torch.Tensor,
                  candidate_aux: Optional[torch.Tensor]) -> TaskBatch:
        """The task with the S candidates as its targets."""
        S = cand.shape[0]
        aux = None
        if task.yt_aux is not None:
            A = task.yt_aux.shape[-1]
            aux = (candidate_aux.float()[None] if candidate_aux is not None
                   else cand.new_zeros((1, S, A)))
        return dataclasses.replace(
            task, xt=cand[None], yt=cand.new_zeros((1, S, self.model.cfg.dim_yt)),
            yt_mask=cand.new_ones((1, S)), yt_aux=aux)

    @staticmethod
    def hypothetical_tasks(task: TaskBatch, cand: torch.Tensor, feed: torch.Tensor,
                           idx: int) -> TaskBatch:
        """S tasks from one: task s has candidate s (value and aux feedback
        ``feed[s]``) as an extra point of context set ``idx``. Point sets
        are materialised (the encode kernel reads contiguous tensors); the
        gridded contexts and targets stay expanded views of the single
        task's, which every op that reads them takes (the gridded encode's
        products, the off-grid decode, the aux concatenation, the
        acquisition's mask)."""
        S = cand.shape[0]
        points = []
        for i, p in enumerate(task.points):
            x, y, m = (_tile(t, S) for t in (p.x, p.y, p.mask))
            if i == idx:
                x = torch.cat([x, cand[:, None, :]], 1)
                y = torch.cat([y, feed[:, None, :].to(y.dtype)], 1)
                m = torch.cat([m, m.new_ones((S, 1))], 1)
            points.append(PointContext(x.contiguous(), y.contiguous(), m.contiguous()))
        return TaskBatch(
            grids=tuple(dataclasses.replace(g, y=_tile(g.y, S), mask=_tile(g.mask, S))
                        for g in task.grids),
            points=tuple(points), xt=_tile(task.xt, S), yt=_tile(task.yt, S),
            yt_mask=_tile(task.yt_mask, S), yt_aux=_tile(task.yt_aux, S),
            x1g=task.x1g, x2g=task.x2g)

    def _exhaustive_scores_dev(self, task: TaskBatch, cand: torch.Tensor, feed: torch.Tensor,
                               idx: int) -> torch.Tensor:
        """The acquisition of every candidate, (S,), from one batched forward
        over :meth:`hypothetical_tasks`."""
        tiled = self.hypothetical_tasks(task, cand, feed, idx)
        mean, std = self._predict(tiled)
        return self.acquisition(mean, std, tiled.yt_mask)

    @staticmethod
    def _set_context_slot(task: TaskBatch, idx: int, slot: int, x_new: torch.Tensor,
                          feed: torch.Tensor) -> TaskBatch:
        """Write a placed point (coordinates ``x_new`` (2,), value and aux
        feedback ``feed`` (C,)) into pre-padded slot ``slot`` of context set
        ``idx``, in place; shapes never change. Returns ``task``."""
        pc = task.points[idx]
        pc.x[0, slot] = x_new
        pc.y[0, slot] = feed.to(pc.y.dtype)
        pc.mask[0, slot].fill_(1.0)  # a fill, not a scalar copy from the host
        return task
