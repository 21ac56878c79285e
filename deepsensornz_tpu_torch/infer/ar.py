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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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
) -> np.ndarray:
    """Draw AR samples at ``task.xt`` on the model's device. Returns
    (n_samples, B, M, dy).

    ``ar_context_idx`` selects the point context set that receives the
    sampled pseudo-observations; its channel count is ``dy`` plus the aux
    channels fed back with them (the first aux-at-target channels, or zeros
    where the targets carry fewer). ``std_scale`` applies the model's
    post-hoc spread recalibration to each block (``rescale_raw``).
    ``generator`` (on the model's device; a generator seeded 0 if None)
    draws the visit orders and the samples.
    """
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
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
    out = np.zeros((n_samples, B, M, dy), np.float32)
    with torch.inference_mode():
        for s in range(n_samples):
            # a random visit order per task; the pad revisits the first
            # targets and is kept out of the output and feedback (run_chain)
            perm = torch.stack([torch.randperm(M, generator=generator, device=dev)
                                for _ in range(B)])
            order = torch.cat([perm, perm[:, :pad]], 1) if pad else perm
            out[s] = run_chain(model, task_ext, order, generator, std_scale, idx=idx,
                               base_n=base_n, n_extra=n_extra, block=block,
                               n_blocks=n_blocks, pad=pad).cpu().numpy()
    return out


@torch.inference_mode()
def run_chain(model, task_ext: TaskBatch, order: torch.Tensor, generator: torch.Generator,
              std_scale: float, *, idx: int, base_n: int, n_extra: int, block: int,
              n_blocks: int, pad: int) -> torch.Tensor:
    """One AR chain over the visit ``order`` (B, n_blocks·block); returns
    the (B, M, dy) sample on the device. ``task_ext`` has the feedback slots
    after the ``base_n`` real points of context set ``idx``."""
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
        raw = lik.rescale_raw(model(probe), std_scale)           # (B, block, K)
        sample = lik.sample(raw, generator, 1)[0]                # (B, block, dy)
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
