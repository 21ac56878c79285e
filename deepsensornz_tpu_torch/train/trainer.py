"""Training loop: AdamW step with a finite guard, plateau LR, early stopping,
best-validation checkpointing and replay-equivalent resume.

Counterpart of ``deepsensornz_tpu/train/trainer.py``. The state is
functional, as in JAX: a :class:`TrainState` holds the parameters and the
optimizer state as tensors keyed by the model's ``state_dict`` names, and a
step returns a new state, leaving its input as it was. The model's own
parameters are the step's workspace: each step copies the state's
parameters into them, differentiates ``model.loss`` and builds the new
state out of place (:func:`load_params` puts a result back in the model).

The optimizer is written out by hand and reproduces the JAX package's
optax chain step for step: clip by global norm 10 (optax's rule: scale by
10/norm only when norm ≥ 10, the norm over every gradient), Adam (b1 0.9,
b2 0.999, eps 1e-8, bias correction by its own count), decoupled weight
decay, then ``p ← p − lr·(adam + wd·p)``. A step whose loss or gradient
norm is not finite changes neither the parameters nor any of the optimizer
state, its count included; the decision is made on the device, so a step
never waits for the host.

Data parallel (``mesh=``, one process per GPU): each rank takes its rows
of the global batch, divides its partial loss by the whole batch's counts
of valid tasks and targets, and the ranks' gradients and losses are summed
(not averaged: padding puts masked tasks on the last rank, so ranks differ
in valid tasks) before the finite check, the clip and Adam. Where the
model partitions its grid over the mesh's spatial axis, the gradients of
the parameters used before the decode's spatial sum are each rank's
block's share and are summed over every rank (data × spatial); the head's,
used after it, are whole on every spatial rank and, like the loss, are
summed over the data axis only.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deepsensornz_tpu_torch.parallel.mesh import data_group, shard_task
from deepsensornz_tpu_torch.parallel.multihost import replicate_multihost
from deepsensornz_tpu_torch.perf import spans
from deepsensornz_tpu_torch.task.batching import pad_batch_to_multiple, take
from deepsensornz_tpu_torch.task.task import TaskBatch

CLIP_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    params: dict        # name → tensor (the model's state_dict names)
    opt_state: dict     # {"count": int32 0-d, "mu": {name: tensor}, "nu": {name: tensor}}
    step: int


def _batches(idx: np.ndarray, batch_size: int):
    """Index slices covering all of ``idx``, the partial tail included."""
    for s in range(0, len(idx), batch_size):
        yield idx[s: s + batch_size]


def _take_padded(tasks: TaskBatch, sel: np.ndarray, batch_size: int) -> TaskBatch:
    batch = take(tasks, sel)
    if len(sel) < batch_size:
        batch, _ = pad_batch_to_multiple(batch, batch_size)
    return batch


def flax_path(name: str) -> str:
    """The flax parameter path of a port parameter name:
    ``unet.down_0.weight`` → ``params/unet/down_0/kernel``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(["params", *parts])


def freeze_mask(names: Iterable[str], patterns: Sequence[str]) -> dict[str, bool]:
    """True for each parameter whose flax path matches any regex: the same
    patterns select the same parameters as in the JAX package (e.g.
    ``("ls_grid", "ls_points", "unet")`` or ``r"/ls_"``)."""
    compiled = [re.compile(p) for p in patterns]
    return {n: any(c.search(flax_path(n)) for c in compiled) for n in names}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    some = next(iter(params.values()))
    return {"count": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Mapping[str, torch.Tensor], weight_decay: float = 0.0):
    """One step of the chain clip-by-global-norm(10) → Adam → decoupled
    weight decay → ×(−1), before the learning rate: returns (updates, new
    optimizer state) with updates = −(adam + wd·p)."""
    norm = global_norm(grads.values())
    keep = norm < CLIP_NORM
    count = opt_state["count"] + 1
    bc1 = 1 - ADAM_B1 ** count.float()
    bc2 = 1 - ADAM_B2 ** count.float()
    updates, mu, nu = {}, {}, {}
    for k, g in grads.items():
        g = torch.where(keep, g, (g / norm) * CLIP_NORM)
        mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * opt_state["mu"][k]
        nu[k] = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * opt_state["nu"][k]
        adam = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        updates[k] = -(adam + weight_decay * params[k])
    return updates, {"count": count, "mu": mu, "nu": nu}


def load_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Copy ``params`` into the model's own parameters."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])


def apply_gradients(state: TrainState, grads: Mapping[str, torch.Tensor], loss: torch.Tensor,
                    lr, weight_decay: float = 0.0, frozen_patterns: Sequence[str] = (),
                    lengthscale_lr_mult: float = 1.0) -> tuple[TrainState, torch.Tensor]:
    """The update of a train step from its loss and gradients (summed over
    the ranks of a data-parallel step): applied only where the loss and
    the gradients' global norm are finite, else the state passes through
    with its optimizer count. Returns (new state, loss or NaN)."""
    names = list(grads)
    frozen = freeze_mask(names, frozen_patterns)
    is_ls = freeze_mask(names, (r"/ls_",))
    mult = float(lengthscale_lr_mult)
    with torch.no_grad():
        loss = loss.detach()
        ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads.values()))
        updates, new_opt = adamw_update(grads, state.opt_state, state.params, weight_decay)
        params = {}
        for k in names:
            p = state.params[k]
            if frozen[k]:
                params[k] = p
                continue
            u = updates[k] * lr
            if is_ls[k] and mult != 1.0:
                # amplify the Adam part only: mult·(−(a + wd·p)·lr)
                # + (mult − 1)·wd·p·lr = −(mult·a + wd·p)·lr
                u = u * mult + (mult - 1.0) * weight_decay * p * lr
            params[k] = torch.where(ok, p + u, p)
        opt = {"count": torch.where(ok, new_opt["count"], state.opt_state["count"])}
        for m in ("mu", "nu"):
            opt[m] = {k: torch.where(ok, new_opt[m][k], state.opt_state[m][k]) for k in names}
        loss = torch.where(ok, loss, torch.full_like(loss, float("nan")))
    return TrainState(params=params, opt_state=opt, step=state.step + 1), loss


def _all_reduce_flat(tensors: list, group) -> list:
    """``tensors`` summed over ``group`` in one all-reduce of one flat buffer."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                          tensors)]


def shard_loss_and_grads(model: torch.nn.Module, task: TaskBatch, mesh,
                         anchor_scale=1.0) -> tuple[torch.Tensor, dict]:
    """The data-parallel loss and gradients of a global batch: this rank's
    rows (``shard_task``) over the whole batch's denominators (all-reduced
    first), then this rank's gradients and loss summed over the data axis in
    one all-reduce of one flat buffer. Where the model partitions its grid
    over the spatial axis (``model.partial_gradients``), the gradients of
    the parameters before the spatial sum go in a second flat buffer,
    summed over every rank. Every rank returns the same numbers: the whole
    batch's loss and gradients."""
    group = data_group(mesh)
    shard = shard_task(task, mesh)
    den = model.loss_denominators(shard)
    dist.all_reduce(den, group=group)
    workspace = dict(model.named_parameters())
    loss = model.loss(shard, anchor_scale, den, mesh=mesh)
    grads = dict(zip(workspace, torch.autograd.grad(loss, list(workspace.values()))))
    partial = model.partial_gradients(mesh)
    spatial = [k for k in workspace if k in partial]
    whole = [k for k in workspace if k not in partial]
    summed = dict(zip(spatial, _all_reduce_flat([grads[k] for k in spatial], None)))
    *rest, loss = _all_reduce_flat([grads[k] for k in whole] + [loss.detach()], group)
    summed.update(zip(whole, rest))
    return loss, {k: summed[k] for k in workspace}


def make_train_step(model: torch.nn.Module, weight_decay: float = 0.0,
                    frozen_patterns: Sequence[str] = (),
                    lengthscale_lr_mult: float = 1.0, mesh=None) -> Callable:
    """Build the (state, task, lr, anchor_scale=1.0) → (state, loss) step.

    ``lengthscale_lr_mult`` scales the Adam step of the SetConv
    length-scales (``ls_*``) and not their weight-decay pull; at 0 the
    decay still applies (``frozen_patterns`` freezes for real). Frozen
    parameters keep their values but their Adam moments advance. The
    returned loss is a 0-d device tensor, NaN for a skipped step.

    With a ``mesh`` (``parallel.mesh.make_mesh``) the step is data
    parallel: every rank calls it with the same global batch (on the host
    or the device), uploads its own rows, and the ranks' gradients are
    summed (:func:`shard_loss_and_grads`) before the finite check, the
    clip and Adam, so every rank applies or skips the same update and their
    states stay bitwise equal. The batch must divide the data axis; the
    step carries the mesh as ``step.mesh`` for :func:`train_epoch`."""
    workspace = dict(model.named_parameters())

    def step(state: TrainState, task: TaskBatch, lr, anchor_scale=1.0):
        load_params(model, state.params)
        if mesh is None:
            loss = model.loss(task, anchor_scale)
            grads = dict(zip(workspace, torch.autograd.grad(loss, list(workspace.values()))))
        else:
            loss, grads = shard_loss_and_grads(model, task, mesh, anchor_scale)
        return apply_gradients(state, grads, loss, lr, weight_decay, frozen_patterns,
                               lengthscale_lr_mult)

    step.mesh = mesh
    return step


def train_epoch(model, state: TrainState, tasks: TaskBatch, batch_size: int = 8,
                lr: float = 5e-5, shuffle: bool = True, step_fn: Optional[Callable] = None,
                rng: Optional[np.random.Generator] = None, anchor_scale: float = 1.0):
    """One epoch over ``tasks``; returns (state, per-batch losses). The tail
    batch is padded with masked tasks, so every task is trained. Batches go
    to the device of the parameters; the losses stay there until the epoch
    ends. Under a data-parallel ``step_fn`` (``step_fn.mesh``) every rank
    must draw the same permutation; each batch is padded to a multiple of
    the data axis and stays on the host, and the step uploads this rank's
    rows only. While the perf recorder records, each step is the spans
    ``train.batch`` (the batch's gather), ``train.upload`` and
    ``train.launch`` (the step's call), one group a step, and the epoch's
    loss fetch the span ``train.losses``."""
    step_fn = step_fn or make_train_step(model)
    mesh = getattr(step_fn, "mesh", None)
    rng = rng or np.random.default_rng(0)
    device = next(iter(state.params.values())).device
    n = tasks.batch_size
    batch_size = min(batch_size, n)
    n_data = 1 if mesh is None else mesh.size(0)
    padded = -(-batch_size // n_data) * n_data
    idx = rng.permutation(n) if shuffle else np.arange(n)
    losses = []
    for sel in _batches(idx, batch_size):
        group = spans.new_group()
        with spans.span("train.batch", group=group):
            batch = _take_padded(tasks, sel, padded)
        if mesh is None:
            with spans.span("train.upload", group=group):
                batch = batch.to(device)
        with spans.span("train.launch", group=group):
            state, loss = step_fn(state, batch, lr, anchor_scale)
        losses.append(loss)
    with spans.span("train.losses"):
        return state, torch.stack(losses).cpu().tolist()


def make_eval_step(model, mesh=None) -> Callable:
    """(params, task) → the validation loss, a 0-d device tensor. With a
    ``mesh`` each rank evaluates its rows of ``task`` (padded to a multiple
    of the data axis) and every rank returns the whole batch's loss."""

    def eval_step(params, task: TaskBatch) -> torch.Tensor:
        load_params(model, params)
        with torch.no_grad():
            if mesh is None:
                return model.loss(task)
            shard = shard_task(pad_batch_to_multiple(task, mesh.size(0))[0], mesh)
            den = model.loss_denominators(shard)
            dist.all_reduce(den, group=data_group(mesh))
            loss = model.loss(shard, 1.0, den, mesh=mesh)
            dist.all_reduce(loss, group=data_group(mesh))
            return loss

    return eval_step


def _copy(tensors: Mapping[str, torch.Tensor], device=None) -> dict:
    return {k: v.detach().to(device).clone() for k, v in tensors.items()}


def init_state(model, params: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
    """A fresh state from the model's parameters, or from a copy of
    ``params`` (never an alias of the caller's tensors), on the model's
    device."""
    device = next(model.parameters()).device
    params = _copy(dict(model.named_parameters()) if params is None else params, device)
    return TrainState(params=params, opt_state=adamw_init(params), step=0)


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (factor 0.1, patience 5 defaults)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 5,
                 min_lr: float = 0.0):
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = np.inf
        self.bad_epochs = 0

    def step(self, val_loss: float) -> float:
        if np.isfinite(val_loss) and val_loss < self.best - 1e-12:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": float(self.best), "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d.get("lr", self.lr))
        self.best = float(d.get("best", self.best))
        self.bad_epochs = int(d.get("bad_epochs", self.bad_epochs))


class EarlyStopping:
    """Stop after ``patience`` epochs without a validation improvement."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.best = np.inf
        self.bad_epochs = 0

    def step(self, val_loss: float) -> bool:
        if np.isfinite(val_loss) and val_loss < self.best - 1e-12:
            self.best = val_loss
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience

    def state_dict(self) -> dict:
        return {"best": float(self.best), "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d.get("best", self.best))
        self.bad_epochs = int(d.get("bad_epochs", self.bad_epochs))


class Trainer:
    """The training loop with best-validation checkpointing. Runs on the
    device of the model's parameters. With a ``mesh`` it trains data
    parallel: every rank runs ``fit`` with the same tasks, starts from rank
    0's parameters, computes the same losses and so takes the same plateau
    and early-stopping decisions; rank 0 alone writes checkpoints."""

    def __init__(self, model, lr: float = 5e-5, weight_decay: float = 0.0,
                 frozen_patterns: Sequence[str] = (), lengthscale_lr_mult: float = 1.0,
                 mesh=None):
        self.model = model
        self.lr0 = lr
        self.mesh = mesh
        self.train_step = make_train_step(model, weight_decay, frozen_patterns,
                                          lengthscale_lr_mult=lengthscale_lr_mult, mesh=mesh)
        self.eval_step = make_eval_step(model, mesh)

    def fit(self, train_tasks: TaskBatch, val_tasks: Optional[TaskBatch] = None,
            n_epochs: int = 30, batch_size: int = 8, params=None, plateau_patience: int = 5,
            plateau_factor: float = 0.1, early_stop_patience: int = 10,
            checkpoint_dir: Optional[str] = None, metadata: Optional[dict] = None,
            shuffle: bool = True, verbose: bool = True, resume_from: Optional[str] = None,
            anchor_schedule: Optional[Callable[[int], float]] = None) -> dict:
        """Train; returns {params (the best epoch's, a copy), final_state,
        train_losses, val_losses, best_val}. Each checkpoint holds the
        parameters as ``params.pt`` and as the JAX package's
        ``params.msgpack``, so either package serves it.

        ``resume_from``: a checkpoint directory whose parameters, optimizer
        state, loss history and schedule counters are restored, so the
        resumed run replays the uninterrupted one. ``anchor_schedule``:
        epoch → multiplier on the model's mean-anchor weight."""
        from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

        state = init_state(self.model, params)
        device = next(iter(state.params.values())).device
        start_epoch = 0
        prev_train, prev_val = [], []
        sched = PlateauScheduler(self.lr0, plateau_factor, plateau_patience)
        stopper = EarlyStopping(early_stop_patience)
        if resume_from is not None:
            loaded = load_checkpoint(resume_from, map_location=device)
            meta = loaded.get("metadata", {})
            state = TrainState(params=loaded["params"],
                               opt_state=loaded.get("opt_state", state.opt_state),
                               step=int(meta.get("step", 0)))
            prev_train = list(meta.get("train_losses", []))
            prev_val = list(meta.get("val_losses", []))
            start_epoch = int(meta.get("epoch", -1)) + 1
            # the LR schedule and patience counters as the uninterrupted run
            # carried them into the next epoch
            sched.load_state_dict(meta.get("sched", {}))
            stopper.load_state_dict(meta.get("stopper", {}))
        lead = self.mesh is None or dist.get_rank() == 0
        if self.mesh is not None:
            state = dataclasses.replace(state, params=replicate_multihost(state.params, self.mesh))
        elif val_tasks is not None:
            val_tasks = val_tasks.to(device)
        batch_size = min(batch_size, train_tasks.batch_size)
        best_val = min(prev_val) if prev_val else np.inf
        # snapshots are copies, never aliases of tensors a later step may
        # write in place
        best_params = _copy(state.params)
        train_losses, val_losses = prev_train, prev_val
        lr = sched.lr
        t_fit = time.time()
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            # a seed per epoch: a resumed run at epoch k draws the
            # permutation the uninterrupted run drew at epoch k
            order_rng = np.random.default_rng((0, epoch))
            a_scale = float(anchor_schedule(epoch)) if anchor_schedule else 1.0
            state, losses = train_epoch(
                self.model, state, train_tasks, batch_size=batch_size, lr=lr,
                shuffle=shuffle, step_fn=self.train_step, rng=order_rng,
                anchor_scale=a_scale)
            finite = [l for l in losses if np.isfinite(l)]
            train_loss = float(np.mean(finite)) if finite else np.nan
            train_losses.append(train_loss)
            val_loss = (float(self.eval_step(state.params, val_tasks))
                        if val_tasks is not None else train_loss)
            val_losses.append(val_loss)

            is_best = np.isfinite(val_loss) and val_loss < best_val
            # the schedule and stopper step before the checkpoint, so a
            # resumed run continues with this epoch's counters
            lr_used = lr
            lr = sched.step(val_loss)
            should_stop = stopper.step(val_loss)
            if is_best:
                best_val = val_loss
                best_params = _copy(state.params)
                if checkpoint_dir is not None and lead:
                    save_checkpoint(
                        checkpoint_dir, state.params, opt_state=state.opt_state,
                        step=state.step,
                        flax_upsample=self.model.cfg.upsample,
                        metadata={**(metadata or {}), "train_losses": train_losses,
                                  "val_losses": val_losses, "best_val": best_val,
                                  "epoch": epoch, "sched": sched.state_dict(),
                                  "stopper": stopper.state_dict()})
            if verbose and lead:
                done = epoch - start_epoch + 1
                eta = (time.time() - t_fit) / done * (n_epochs - epoch - 1)
                print(f"epoch {epoch:3d}  train {train_loss:.4f}  val {val_loss:.4f}"
                      f"  lr {lr_used:.2e}  {time.time() - t0:.1f}s  eta {eta / 60.0:.1f}m",
                      flush=True)
            if should_stop:
                break
        return {"params": best_params, "final_state": state, "train_losses": train_losses,
                "val_losses": val_losses, "best_val": best_val}
