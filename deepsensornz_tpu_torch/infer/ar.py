"""Autoregressive (AR) sampling: coherent joint fields for any likelihood.

Counterpart of ``deepsensornz_tpu/infer/ar.py``: the targets are visited
in a random order in blocks; each block is sampled from the model's
predictive distribution and fed back as observed context for the next
block, so even the factorised heads (cnp, bernoulli-gamma, spikes-beta)
give spatially coherent samples.

The context set that takes the feedback is padded once with one empty slot
per visited target (x = −1e3, mask 0: inert in the SetConv encode); each
block fills its slots and re-runs the same forward, so every block has the
same shapes. The block chain is a loop of device operations: nothing is
read back to the host between blocks, and the sample of the whole chain is
copied once at its end. The feedback slots are written in place into the
chain's own copy of the context set (JAX builds a new one per block).

With a data mesh (``mesh=``), every rank passes the same global batch and
runs the chain on its rows; the visit orders and sample draws are those one
process makes for the whole batch (each rank draws them all and keeps its
rows, :func:`sample_rows`), so the samples do not depend on the number of
ranks, and the ranks' samples are gathered on the device in rank order.
The ranks of a spatial group run the same rows and draw the same samples;
a model with ``mesh_axes`` runs its grid in row blocks over that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepsensornz_tpu_torch.parallel.mesh import gather_rows, rank_indices, rows_of_rank
from deepsensornz_tpu_torch.task.batching import take
from deepsensornz_tpu_torch.task.task import PointContext, TaskBatch


def _extend_point_context(pc: PointContext, extra: int) -> PointContext:
    """Append ``extra`` masked-off slots to a point context set."""
    B, N, _ = pc.x.shape
    C = pc.y.shape[-1]
    kw = dict(dtype=torch.float32, device=pc.x.device)
    return PointContext(
        x=torch.cat([pc.x.float(), torch.full((B, extra, 2), -1e3, **kw)], 1),
        y=torch.cat([pc.y.float(), torch.zeros((B, extra, C), **kw)], 1),
        mask=torch.cat([pc.mask.float(), torch.zeros((B, extra), **kw)], 1),
    )


def sample_rows(lik, raw: torch.Tensor, generator: torch.Generator, n: int, mesh,
                batch: int) -> torch.Tensor:
    """``n`` samples (n, per, ..., dy) of this rank's rows ``raw`` (per,
    ..., K) of a ``batch``-task batch, from the draws that
    ``lik.sample(raw_of_the_batch, generator, n)`` makes in one process:
    every rank draws them for the whole batch (the mixed heads' draws read
    the values, so those gather the batch's ``raw`` first) and keeps its
    rows; the pad rows past ``batch`` get zero draws."""
    start, per = rows_of_rank(mesh, batch)
    if lik.draws_depend_on_raw:
        like = gather_rows(raw, mesh)[:batch]
    else:
        like = raw[:1].expand((batch,) + raw.shape[1:])  # the shape, no copy
    mine = []
    for d in lik.draw(like, generator, n):
        part = d[:, start:start + per]
        if part.shape[1] < per:
            part = torch.cat([part, part.new_zeros((d.shape[0], per - part.shape[1])
                                                   + d.shape[2:])], 1)
        mine.append(part)
    return lik.transform(raw, tuple(mine))


def block_geometry(M: int, n_blocks: int) -> tuple[int, int, int]:
    """(block, n_blocks, pad): ``n_blocks`` blocks of ``block`` targets
    cover M, the last one padded with ``pad`` revisits."""
    block = -(-M // n_blocks)
    n_blocks = -(-M // block)
    return block, n_blocks, n_blocks * block - M


def ar_sample(
    model,
    task: TaskBatch,
    n_samples: int = 1,
    n_blocks: int = 8,
    ar_context_idx: int = -1,
    generator: Optional[torch.Generator] = None,
    std_scale: float = 1.0,
    mesh=None,
) -> np.ndarray:
    """Draw AR samples at ``task.xt`` on the model's device. Returns
    (n_samples, B, M, dy).

    ``ar_context_idx`` selects the point context set that receives the
    sampled pseudo-observations; its channel count is ``dy`` plus the aux
    channels fed back with them (the first aux-at-target channels, or zeros
    where the targets carry fewer). ``std_scale`` applies the model's
    post-hoc spread recalibration to each block (``rescale_raw``).
    ``generator`` (on the model's device; a generator seeded 0 if None)
    draws the visit orders and the samples. ``mesh``: a data mesh over
    which the global ``task`` (the same on every rank) is split, padded to
    the data axis (``parallel.mesh.rank_indices``); every rank returns the
    whole batch's samples, equal to one process's with the same generator.
    """
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    batch = task.batch_size
    if mesh is not None:
        start, per = rows_of_rank(mesh, batch)
        task = take(task, rank_indices(mesh, np.arange(batch)))
    task = task.to(dev)
    B, M, _ = task.xt.shape
    dy = model.cfg.dim_yt
    idx = ar_context_idx % len(task.points)
    base_n = task.points[idx].x.shape[1]
    n_extra = task.points[idx].y.shape[-1] - dy
    if n_extra < 0:
        raise ValueError(f"AR context set has {task.points[idx].y.shape[-1]} channels "
                         f"< dim_yt={dy}")
    block, n_blocks, pad = block_geometry(M, n_blocks)
    # the extended context is built once: every sample's chain starts from it
    task_ext = dataclasses.replace(task, points=tuple(
        _extend_point_context(p, n_blocks * block) if i == idx else p
        for i, p in enumerate(task.points)))
    out = np.zeros((n_samples, batch, M, dy), np.float32)
    with torch.inference_mode():
        for s in range(n_samples):
            # a random visit order per task of the batch; the pad revisits the
            # first targets and is kept out of the output and feedback
            perm = torch.stack([torch.randperm(M, generator=generator, device=dev)
                                for _ in range(batch)])
            if mesh is not None:  # this rank's rows; the pad rows visit in order
                perm = torch.cat([perm, torch.arange(M, device=dev).expand(
                    start + per - min(start + per, batch), M)])[start:start + per]
            order = torch.cat([perm, perm[:, :pad]], 1) if pad else perm
            smp = run_chain(model, task_ext, order, generator, std_scale, idx=idx,
                            base_n=base_n, n_extra=n_extra, block=block, n_blocks=n_blocks,
                            pad=pad, mesh=mesh, batch=batch)
            if mesh is not None:
                smp = gather_rows(smp, mesh)[:batch]
            out[s] = smp.cpu().numpy()
    return out


@torch.inference_mode()
def run_chain(model, task_ext: TaskBatch, order: torch.Tensor, generator: torch.Generator,
              std_scale: float, *, idx: int, base_n: int, n_extra: int, block: int,
              n_blocks: int, pad: int, mesh=None, batch: int = 0) -> torch.Tensor:
    """One AR chain over the visit ``order`` (B, n_blocks·block); returns
    the (B, M, dy) sample on the device. ``task_ext`` has the feedback slots
    after the ``base_n`` real points of context set ``idx``. With ``mesh``,
    ``task_ext`` holds this rank's rows of a ``batch``-task batch, and each
    block's draws are the whole batch's (:func:`sample_rows`)."""
    lik = model.cfg.make_likelihood()
    dev = task_ext.xt.device
    B, M = task_ext.xt.shape[:2]
    dy = model.cfg.dim_yt
    pc = task_ext.points[idx]
    x, y, m = pc.x.clone(), pc.y.clone(), pc.mask.clone()
    points = list(task_ext.points)
    points[idx] = PointContext(x, y, m)
    rows = torch.arange(B, device=dev)[:, None]
    out = torch.zeros((B, M + 1, dy), dtype=torch.float32, device=dev)  # M: dump slot
    for b in range(n_blocks):
        start = b * block
        # 0 where the entry is a pad revisit of an already sampled target (the
        # last block when M % block != 0): its feedback is masked off, so the
        # block never sees two pseudo-observations at one coordinate
        dup_keep = torch.ones(block, dtype=torch.float32, device=dev)
        if pad and b == n_blocks - 1:
            dup_keep[block - pad:] = 0.0
        blk = order[:, start:start + block]                      # (B, block)
        xt_blk = task_ext.xt[rows, blk]
        aux_blk = None if task_ext.yt_aux is None else task_ext.yt_aux[rows, blk]
        mask_blk = task_ext.yt_mask[rows, blk].float() * dup_keep
        probe = dataclasses.replace(task_ext, points=tuple(points), xt=xt_blk, yt=None,
                                    yt_mask=mask_blk, yt_aux=aux_blk)
        raw = lik.rescale_raw(model(probe, mesh=mesh), std_scale)  # (B, block, K)
        sample = (lik.sample(raw, generator, 1) if mesh is None    # (B, block, dy)
                  else sample_rows(lik, raw, generator, 1, mesh, batch))[0]
        if n_extra == 0:
            feedback = sample
        elif aux_blk is not None and aux_blk.shape[-1] >= n_extra:
            feedback = torch.cat([sample, aux_blk[..., :n_extra].float()], -1)
        else:
            feedback = torch.cat([sample, sample.new_zeros(sample.shape[:-1] + (n_extra,))], -1)
        slot = base_n + start
        x[:, slot:slot + block] = xt_blk
        y[:, slot:slot + block] = feedback
        m[:, slot:slot + block] = mask_blk
        # pad revisits go to the dump slot, so the first visit's sample stays
        out[rows, torch.where(dup_keep[None] > 0, blk, M)] = sample
    return out[:, :M]
