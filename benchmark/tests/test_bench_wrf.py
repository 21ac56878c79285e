"""The ``serve_wrf`` entry of ``serve-wrf.cnp-wrf-d500`` at a tiny size on
the CPU: its weights, its control and planted faults, its checked tasks
and the two span metrics it brought (``encode_grid_ms.serve``,
``decode_grid_ms.serve``), read in every serving cell. The weights' spec
against the port's ``state_dict`` is ``tests/test_torch_wrf_cnp.py``'s."""

import time

import numpy as np
import pytest
import torch

from benchmark import check, control_wrf, core, manifest
from benchmark.entries import common, serve_wrf
from benchmark.tests.tiny import CPU, tiny_cell

CELL = "serve-wrf.cnp-wrf-d500"
MAN = manifest.load_manifest()
NEW_SPANS = {"encode_grid_ms.serve": "model.encode_grid", "decode_grid_ms.serve": "model.decode_grid"}
SERVE = [w["name"] for w in MAN["workloads"] if w["name"].startswith("serve")]


@pytest.fixture
def spans():
    from deepsensornz_tpu_torch.perf import spans

    spans.clear()
    yield spans
    spans.clear()


def test_the_stems_density_columns_are_scaled_to_the_density():
    """Each gridded context's density channel reaches the stem at about
    unit scale; every other weight is ``weights_from``'s."""
    from benchmark.reference import convnp as ref

    cell = tiny_cell(CELL)
    dom, _, w = serve_wrf.serve_inputs(cell, 5, CPU)
    raw = ref.weights_from(serve_wrf.spec_for(cell), cell.config["model"], 5, CPU)
    dens = cell.config["model"]["internal_density"]
    cols = [0, 1 + common.GRID_CHANNELS]
    for i, (x, col) in enumerate(zip((dom.base_x, dom.aux_x), cols)):
        enc = ref.encode_grid(torch.from_numpy(dom.x1g), torch.from_numpy(dom.x2g),
                              *map(torch.from_numpy, x), torch.zeros(1, len(x[0]), len(x[1]), 1),
                              ref.lengthscale(w, f"ls_grid_{i}", dens))
        d = serve_wrf.density(dom, x, common.lengthscale(w, f"ls_grid_{i}", dens))
        assert d == pytest.approx(float(np.median(enc[0, ..., 0].numpy())), rel=1e-5)
        torch.testing.assert_close(w["unet.stem.weight"][:, col], raw["unet.stem.weight"][:, col] / d)
    others = [c for c in range(w["unet.stem.weight"].shape[1]) if c not in cols]
    assert torch.equal(w["unet.stem.weight"][:, others], raw["unet.stem.weight"][:, others])
    assert all(torch.equal(w[k], raw[k]) for k in raw if k != "unet.stem.weight")


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_the_fp8_control_is_not_correct(seed):
    cell = tiny_cell(CELL, "bfloat16")
    ok, table = check.verdict(control_wrf.readings(cell, seed, CPU), cell.limits)
    assert not ok, table


def test_the_checked_tasks_come_from_the_seed():
    cell = tiny_cell(CELL)
    cell.traffic["tasks_per_request"] = 24
    a = serve_wrf.checked_tasks(cell, 2**31 + 9, 4)
    assert len(a) == cell.traffic["check_tasks"] == 4 and len(set(a)) == 4
    assert np.array_equal(a, serve_wrf.checked_tasks(cell, 2**31 + 9, 4))
    assert not np.array_equal(a, serve_wrf.checked_tasks(cell, 2**31 + 9, 5))


@pytest.mark.parametrize("workload", SERVE)
def test_a_traced_tiny_serve_run_reports_the_grid_spans(workload, spans):
    cell = tiny_cell(workload)
    result, lines = core.run_cell(cell, 2**31 + 77, 0.3, True, CPU, time.perf_counter())
    assert result["correct"], lines
    for name, span in NEW_SPANS.items():
        assert workload in next(m for m in MAN["per_layer"] if m["name"] == name)["workloads"]
        assert result["metrics"][name]["value"] > 0 and result["metrics"][name]["unit"] == "ms"
        assert spans.snapshot()[span]["count"] == cell.traffic["trace_requests"]


@pytest.mark.parametrize("name", sorted(NEW_SPANS))
def test_a_grid_span_reader_finds_nothing_to_read(name, spans, monkeypatch):
    reader = manifest.load_metric(name)
    assert reader.read(None) is None
    monkeypatch.setattr(spans, "snapshot", lambda: {
        "predict_grid": {"count": 4, "total_s": 2.0},
        NEW_SPANS[name]: {"count": 4, "total_s": 0.2}})
    assert reader.read(None) == pytest.approx(50.0)


def _run():
    result, lines = core.run_cell(tiny_cell(CELL), 2**31 + 99, 0.3, False, CPU,
                                  time.perf_counter())
    return result["correct"], lines


def test_the_sound_run_is_correct():
    ok, lines = _run()
    assert ok, lines


def test_serving_an_altered_answer_is_not_correct(monkeypatch):
    from deepsensornz_tpu_torch.infer import predict

    quantize = predict._quantize

    def altered(v, bits):
        v = v.clone()
        v[:] += 0.05 * v.abs().mean()
        return quantize(v, bits)

    monkeypatch.setattr(predict, "_quantize", altered)
    assert not _run()[0]


def test_serving_sea_cells_is_not_correct(monkeypatch):
    from deepsensornz_tpu_torch.infer.predict import Predictor

    predict_grid = Predictor.predict_grid
    monkeypatch.setattr(Predictor, "predict_grid",
                        lambda self, *a, **k: predict_grid(self, *a, **{**k, "sea_mask": False}))
    ok, lines = _run()
    assert not ok and any(line.startswith("check sea_mismatch") and "0.0 " not in line
                          for line in lines), lines


def test_serving_half_the_batch_is_not_correct(monkeypatch):
    from benchmark.tests.test_bench_faults import _half_batch_forward

    _half_batch_forward(monkeypatch)
    assert not _run()[0]
