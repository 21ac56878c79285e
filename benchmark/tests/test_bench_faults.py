"""The comparison that decides ``correct`` fails a broken timed path.

Each test runs a whole tiny run on the CPU (the harness's look for a card
is ``run.py``'s, not run here) with the port broken underneath, against
the cell's own limits, and sees ``correct`` come out false; the sound run
beside it comes out true. The faults are those a cell can have: an answer
altered where it is produced, half of the batch left out with the mean
taken over the rest, and, in training, a step that returns its state
unchanged. One card, so no exchange between cards to leave out.
"""

import dataclasses
import time

import pytest
import torch

from benchmark import core
from benchmark.tests.tiny import CPU, tiny_cell

SERVE = ["serve-cycle.gnp-d500", "serve-samples.bgamma-d500"]
TRAIN = ["train.gnp-d500", "train.bgamma-d500"]


def _run(workload):
    result, lines = core.run_cell(tiny_cell(workload), 2**31 + 99, 0.3, False, CPU,
                                  time.perf_counter())
    return result["correct"], lines


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_the_sound_run_is_correct(workload):
    ok, lines = _run(workload)
    assert ok, lines


@pytest.mark.parametrize("workload", TRAIN)
def test_the_checked_steps_are_the_first_epochs(workload):
    """The steps compared are the first batches of the run's first epoch,
    shuffled as the window shuffles: the rows the run names are those the
    control draws."""
    import ast

    from benchmark import inputs
    from benchmark.entries import common

    ok, lines = _run(workload)
    named = ast.literal_eval(next(ln for ln in lines if ln.startswith("checked_tasks: "))[15:])
    cell = tiny_cell(workload)
    T = cell.traffic["pool_tasks"]
    order = inputs.rng_for(2**31 + 99, common.SHUFFLE_STREAM).permutation(T)
    bs = cell.traffic["batch_size"]
    assert named == [order[k * bs:(k + 1) * bs].tolist() for k in range(len(named))]
    assert ok and len(named) == cell.traffic["check_steps"]


def _half_batch_forward(monkeypatch):
    """The model runs the first half of each batch; the other half gets the
    mean of those rows."""
    from deepsensornz_tpu_torch.models.convnp import ConvNP
    from deepsensornz_tpu_torch.task.batching import take

    forward = ConvNP.forward

    def half(self, task, target_grid=None, **kwargs):
        B = task.batch_size
        if B < 2:
            return forward(self, task, target_grid, **kwargs)
        if target_grid is not None and target_grid[2] is not None:
            target_grid = (*target_grid[:2], target_grid[2][:B // 2])
        out = forward(self, take(task, list(range(B // 2))), target_grid, **kwargs)
        return torch.cat([out, out.mean(0, keepdim=True).expand(B - B // 2, *out.shape[1:])])

    monkeypatch.setattr(ConvNP, "forward", half)


@pytest.mark.parametrize("workload", SERVE)
def test_serving_an_altered_answer_is_not_correct(workload, monkeypatch):
    from deepsensornz_tpu_torch.infer import predict

    quantize = predict._quantize

    def altered(v, bits):
        v = v.clone()
        v[0] += 0.05 * v.abs().mean()
        return quantize(v, bits)

    monkeypatch.setattr(predict, "_quantize", altered)
    assert not _run(workload)[0]


@pytest.mark.parametrize("workload", SERVE)
def test_serving_sea_cells_is_not_correct(workload, monkeypatch):
    """The sea mask dropped where the maps are made: ``sea_mismatch``'s
    fault (the fp8 control leaves the mask alone)."""
    from deepsensornz_tpu_torch.infer.predict import Predictor

    predict_grid = Predictor.predict_grid
    monkeypatch.setattr(Predictor, "predict_grid",
                        lambda self, *a, **k: predict_grid(self, *a, **{**k, "sea_mask": False}))
    ok, lines = _run(workload)
    assert not ok and any(line.startswith("check sea_mismatch") and "0.0 " not in line
                          for line in lines), lines


@pytest.mark.parametrize("workload", SERVE)
def test_serving_half_the_batch_is_not_correct(workload, monkeypatch):
    _half_batch_forward(monkeypatch)
    assert not _run(workload)[0]


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(workload, monkeypatch):
    from deepsensornz_tpu_torch.train import trainer

    apply = trainer.apply_gradients

    def unchanged(state, grads, loss, *args, **kwargs):
        new, out = apply(state, grads, loss, *args, **kwargs)
        return dataclasses.replace(state, opt_state=new.opt_state, step=new.step), out

    monkeypatch.setattr(trainer, "apply_gradients", unchanged)
    assert not _run(workload)[0]


@pytest.mark.parametrize("workload", TRAIN)
def test_training_on_half_the_batch_is_not_correct(workload, monkeypatch):
    from deepsensornz_tpu_torch.models.convnp import ConvNP
    from deepsensornz_tpu_torch.task.batching import take

    loss = ConvNP.loss

    def half(self, task, *args, **kwargs):
        return loss(self, take(task, list(range(max(task.batch_size // 2, 1)))), *args, **kwargs)

    monkeypatch.setattr(ConvNP, "loss", half)
    assert not _run(workload)[0]


@pytest.mark.parametrize("workload", TRAIN)
def test_an_altered_loss_is_not_correct(workload, monkeypatch):
    from deepsensornz_tpu_torch.models.convnp import ConvNP

    loss = ConvNP.loss
    monkeypatch.setattr(ConvNP, "loss", lambda self, *a, **k: 1.01 * loss(self, *a, **k))
    assert not _run(workload)[0]
