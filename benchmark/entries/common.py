"""What both entries share: the port's model from the benchmark's weights,
task batches of the generator's arrays, and what a run hands back."""

from __future__ import annotations

import dataclasses
import resource
import time
from typing import Optional

from benchmark import inputs
from benchmark.reference import convnp as ref

GRID_CHANNELS = 3  # the base grid: the variable, cos and sin of the day of year
POINT_CHANNELS = 1
AUX_AT_TARGETS = 1


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read, over the traced part of a window."""

    trace: object              # trace.TraceSummary, or None
    tasks: int                 # tasks finished in the traced window
    work: dict                 # "model_flops", and per operation (bound seconds, launches)
    peak_bytes: int            # torch.cuda.max_memory_allocated() over the window


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict                  # end-to-end metric name → value
    numbers: dict              # the numbers compared, by name
    peak_bytes: int
    readings: Optional[Readings] = None
    notes: dict = dataclasses.field(default_factory=dict)  # printed on stderr


def serve_inputs(cell, seed: int, device) -> tuple:
    """(domain, pool of cycles, weights) of a serving cell from the seed."""
    dom = inputs.domain(cell.traffic, cell.config["model"], seed)
    pool = [inputs.serve_cycle(seed, k, dom, cell.traffic, cell.config["values"])
            for k in range(cell.traffic["pool"])]
    return dom, pool, ref.weights_from(spec_for(cell), cell.config["model"], seed, device)


def train_inputs(cell, seed: int, device) -> tuple:
    """(domain, pool of tasks, weights) of a training cell from the seed."""
    dom = inputs.domain(cell.traffic, cell.config["model"], seed)
    pool = inputs.train_pool(seed, dom, cell.traffic, cell.config["values"])
    return dom, pool, ref.weights_from(spec_for(cell), cell.config["model"], seed, device)


SHUFFLE_STREAM = 5  # the stream of ``inputs.rng_for`` that shuffles a train run's epochs


def first_batches(cell, pool: dict, seed: int) -> list:
    """The tasks of the steps a train run checks, one batch each: the first
    ``check_steps`` batches of its first epoch, as ``train_epoch`` draws
    them from the run's shuffle stream (the run itself names them by their
    rows)."""
    bs = cell.traffic["batch_size"]
    order = inputs.rng_for(seed, SHUFFLE_STREAM).permutation(cell.traffic["pool_tasks"])
    return [inputs.take(pool, order[k * bs:(k + 1) * bs])
            for k in range(cell.traffic["check_steps"])]


def spec_for(cell) -> dict:
    return ref.param_spec(cell.config["model"], [GRID_CHANNELS, cell.traffic["aux_channels"]],
                          [POINT_CHANNELS], AUX_AT_TARGETS)


def port_model(cell, weights: dict, device):
    """The port's ConvNP at the configuration's widths, holding ``weights``."""
    from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig

    model = ConvNP(ConvNPConfig.from_dict(cell.config["model"]),
                   [GRID_CHANNELS, cell.traffic["aux_channels"]], [POINT_CHANNELS],
                   AUX_AT_TARGETS, device=device)
    model.load_state_dict(weights)
    return model


def task_batch(a: dict, dom, with_targets: bool):
    """A port ``TaskBatch`` over the generator's host arrays (no copy)."""
    import torch

    from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch

    t = torch.from_numpy
    B = a["base"].shape[0]
    if with_targets:
        tgt = dict(xt=t(a["xt"]), yt=t(a["yt"]), yt_mask=t(a["yt_mask"]), yt_aux=t(a["yt_aux"]))
    else:  # the grid path reads neither the targets nor their aux
        tgt = dict(xt=torch.zeros(B, 1, 2), yt=None, yt_mask=torch.ones(B, 1),
                   yt_aux=torch.zeros(B, 1, AUX_AT_TARGETS))
    return TaskBatch(grids=(GridContext(t(dom.base_x[0]), t(dom.base_x[1]), t(a["base"])),
                            GridContext(t(dom.aux_x[0]), t(dom.aux_x[1]), t(a["aux"]))),
                     points=(PointContext(t(a["st_x"]), t(a["st_y"]), t(a["st_mask"])),),
                     x1g=t(dom.x1g), x2g=t(dom.x2g), **tgt)


def lengthscale(weights: dict, name: str, density: float) -> float:
    """A length-scale of the benchmark's weights, in f32 as the model forms it."""
    return float(ref.lengthscale({name: weights[name].float().cpu()}, name, density))


def host_counters() -> dict:
    """What the host did for this process, as counters to take differences
    of over a window: wall and CPU seconds, and involuntary context
    switches (another thread or process taking the core)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "cpu_s": time.process_time(),
            "involuntary_switches": ru.ru_nivcsw}


def counters_over(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before if k in after}
