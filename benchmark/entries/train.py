"""Entry ``train``: epochs of ``train.trainer.train_epoch`` over a host pool
of tasks, through one ``make_train_step`` (clip → Adam → decay), each batch
uploaded in the timed path as the trainer uploads it.

Set-up makes the pool and the weights from the seed, builds the port's
model, its train step and its state, and drives them through a first
epoch over the pool: the window's own call on the window's own pool, with
its shuffle and its batches, so each step's rows differ from the others'.
Its first ``check_steps`` steps are kept for the check: their losses,
Adam's first moment after the first (the first gradient as the optimizer
got it) and the parameters after the last, and the pool tasks each step
trained on, named by their station positions. That same model, step and
state go on into the window, which runs whole epochs over the pool until
``--seconds`` have passed; an epoch ends with the losses fetched to the
host. With ``--trace 1`` the first ``trace_epochs`` epochs run under the
profiler. After the window the plain reference follows the kept steps
from the same weights and tasks.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, inputs, work
from benchmark.entries import common
from benchmark.reference import convnp as ref
from benchmark.trace import Tracer, warm_profiler


def _work(cell, dom, pool, weights, epochs: int) -> dict:
    """Model FLOPs (the U-Net, the head and the off-grid decode forward and
    backward, B1 and its length-scale gradient at what their inputs need)
    and the B1 kernels' bounds over the traced epochs. The bound of a
    launch is taken at its batch's sums, batches of the pool in order."""
    m, tr = cell.config["model"], cell.traffic
    dens = m["internal_density"]
    H, W = len(dom.x1g), len(dom.x2g)
    T, bs, M = tr["pool_tasks"], tr["batch_size"], tr["target_stations"]
    C = m["decoder_channels"]
    cin = common.GRID_CHANNELS + 1 + tr["aux_channels"] + 1 + common.POINT_CHANNELS + 1
    per_task = 3.0 * (work.unet_flops(H, W, cin, m["unet_channels"], m["kernel_size"], C)
                      + work.mlp_flops(M, [C + common.AUX_AT_TARGETS]
                                       + [m["mlp_hidden"]] * m["mlp_layers"]
                                       + [ref.n_outputs(m)]))
    ls_p = common.lengthscale(weights, "ls_points_0", dens)
    ls_d = common.lengthscale(weights, "ls_decoder", dens)
    fwd, grad, flops = [], [], T * per_task
    for b in range(T):
        x, mk = pool["st_x"][b], pool["st_mask"][b]
        fwd.append(work.encode_work(dom.x1g, dom.x2g, x, mk, common.POINT_CHANNELS, ls_p))
        grad.append(work.encode_grad_work(dom.x1g, dom.x2g, x, mk, common.POINT_CHANNELS, ls_p))
        flops += (fwd[-1][0] + grad[-1][0]
                  + 3.0 * work.decode_offgrid_flops(dom.x1g, dom.x2g, pool["xt"][b], C, ls_d))

    def bound(parts):
        return sum(work.card_bound_s(sum(f for f, _ in parts[s:s + bs]),
                                     sum(b for _, b in parts[s:s + bs]) + 4.0 * (H + W))
                   for s in range(0, T, bs))

    steps = epochs * (-(-T // bs))
    return {"model_flops": epochs * flops, "b1": (epochs * bound(fwd), steps),
            "b1grad": (epochs * bound(grad), steps)}


class _KeepFirstSteps:
    """The port's step, keeping over its first ``n`` calls what the check
    compares: each batch's station positions, Adam's first moment after
    the first call and the parameters after the last."""

    def __init__(self, step, n: int):
        self.step, self.n, self.calls = step, n, 0
        self.mesh = getattr(step, "mesh", None)
        self.positions, self.mu1, self.after = [], None, None

    def __call__(self, state, task, lr, anchor_scale=1.0):
        state, loss = self.step(state, task, lr, anchor_scale)
        if self.calls < self.n:
            self.positions.append(task.points[0].x)
            if self.calls == 0:
                self.mu1 = {n: v.detach().clone() for n, v in state.opt_state["mu"].items()}
            if self.calls == self.n - 1:
                self.after = {n: v.detach().clone() for n, v in state.params.items()}
        self.calls += 1
        return state, loss


def _pool_rows(positions: list, pool_x: np.ndarray) -> list:
    """Per kept step, the pool tasks its batch rows are (by their station
    positions, which no two tasks share); -1 for a row that is none."""
    flat = pool_x.reshape(len(pool_x), -1)
    out = []
    for x in positions:
        rows = []
        for r in x.detach().cpu().numpy().reshape(len(x), -1):
            hit = np.flatnonzero((flat == r).all(1))
            rows.append(int(hit[0]) if len(hit) == 1 else -1)
        out.append(rows)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> common.Outcome:
    import torch

    from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step, train_epoch

    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    dom, pool, weights = common.train_inputs(cell, seed, device)
    tasks = common.task_batch(pool, dom, with_targets=True)
    model = common.port_model(cell, weights, device)
    step = make_train_step(model, weight_decay=tr["weight_decay"])
    state = init_state(model)
    bs, lr = tr["batch_size"], tr["lr"]
    rng = inputs.rng_for(seed, common.SHUFFLE_STREAM)

    # the first epoch: the window's call and pool; its first steps are checked
    kept = _KeepFirstSteps(step, tr["check_steps"])
    state, losses = train_epoch(model, state, tasks, batch_size=bs, lr=lr, step_fn=kept, rng=rng)
    first_losses = losses[:tr["check_steps"]]
    if trace:
        warm_profiler()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    n_traced = tr["trace_epochs"] if trace else 0
    tracer = Tracer(trace)
    steps = failed = done = 0
    epoch_s = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    host0 = common.host_counters()
    w0 = time.perf_counter()

    def epoch():
        nonlocal state, steps, failed, done
        e0 = time.perf_counter()
        state, losses = train_epoch(model, state, tasks, batch_size=bs, lr=lr, step_fn=step,
                                    rng=rng)
        epoch_s.append(time.perf_counter() - e0)
        steps += len(losses)
        failed += sum(not np.isfinite(v) for v in losses)
        done += tasks.batch_size

    with tracer:
        for _ in range(n_traced):
            epoch()
    traced_s = tracer.window_s
    while time.perf_counter() - w0 < seconds:
        epoch()
    window_s = time.perf_counter() - w0
    host = common.counters_over(host0, common.host_counters())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    q = np.quantile(epoch_s, [0.0, 0.5, 1.0])
    notes = {"steps": steps, "epochs": done // tasks.batch_size, "window_s": window_s,
             "epoch_s_min_median_max": [float(v) for v in q],
             "epochs_over_1.2x_median": int(sum(e > 1.2 * q[1] for e in epoch_s)),
             "host_over_window": host}
    readings = None
    if trace:
        traced_tasks = n_traced * tasks.batch_size
        notes["traced_tasks_per_s"] = traced_tasks / traced_s
        if done > traced_tasks:
            notes["untraced_tasks_per_s"] = (done - traced_tasks) / (window_s - traced_s)
        readings = common.Readings(trace=tracer.finish(), tasks=traced_tasks,
                                   work=_work(cell, dom, pool, weights, n_traced),
                                   peak_bytes=peak)
    e2e = {"train_tasks_per_s": done / window_s, "setup_s": setup_s}

    # the check: the program's state freed, then the reference from the same weights
    rows = _pool_rows(kept.positions, pool["st_x"])
    got = {"losses": first_losses,
           "grad": {n: float(v.double().norm()) for n, v in
                    ref.first_grad_from_adam(kept.mu1).items()},
           "update": {n: float((v.double() - weights[n].double()).norm())
                      for n, v in kept.after.items()}}
    del model, step, kept, state, tasks
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    notes["checked_tasks"] = rows
    if min(min(r) for r in rows) < 0:  # a batch the pool does not hold
        numbers = {k: float("inf") for k in cell.limits}
    else:
        want = ref.train_steps(weights, m, [inputs.take(pool, r) for r in rows], dom, lr, device)
        want = {"losses": want["losses"], **ref.grad_and_update_norms(want, weights)}
        numbers = check.train_numbers(got, want)
        notes.update(check.train_diagnostics(got, want))
        notes["reference_losses"] = want["losses"]
    notes["first_losses"] = first_losses
    return common.Outcome(attempted=steps, failed=failed, e2e=e2e, numbers=numbers,
                          peak_bytes=peak, readings=readings, notes=notes)
