"""The readers of the program's spans (``source: program_span``): None with
nothing recorded or without the program's recorder, the value per request
or step from a hand-built snapshot, and a tiny ``--trace 1`` run of a serve
and a train cell on the CPU that reports them."""

import sys
import time

import pytest

from benchmark import core, manifest
from benchmark.tests.tiny import CPU, tiny_cell

MAN = manifest.load_manifest()
SPAN_METRICS = [m for m in MAN["per_layer"] if m["source"] == "program_span"]
# each reader: (the span it reads, the root it divides by)
READS = {"request_prep_ms.serve": ("predict_grid.prepare", "predict_grid"),
         "request_wait_ms.serve": ("predict_grid.wait", "predict_grid"),
         "request_maps_ms.serve": ("predict_grid.maps", "predict_grid"),
         "request_device_ms.serve": ("predict_grid.device", "predict_grid"),
         "sample_ms.serve": ("predict_grid.sample", "predict_grid"),
         "train_batch_ms.train": ("train.batch", "train.launch"),
         "train_upload_ms.train": ("train.upload", "train.launch"),
         "train_launch_ms.train": ("train.launch", "train.launch")}


@pytest.fixture
def spans():
    from deepsensornz_tpu_torch.perf import spans

    spans.clear()
    yield spans
    spans.clear()


def test_every_span_metric_has_a_reader_and_its_unit():
    assert {m["name"] for m in SPAN_METRICS} == set(READS)
    for m in SPAN_METRICS:
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert callable(manifest.load_metric(m["name"]).read)


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_finds_nothing_to_read(name, spans, monkeypatch):
    reader = manifest.load_metric(name)
    assert reader.read(None) is None
    # the root without the span, and the span without its root
    span, root = READS[name]
    monkeypatch.setattr(spans, "snapshot", lambda: {root: {"count": 3, "total_s": 1.0}})
    assert span == root or reader.read(None) is None
    monkeypatch.setattr(spans, "snapshot", lambda: {span: {"count": 3, "total_s": 1.0}}
                        if span != root else {})
    assert reader.read(None) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_without_the_programs_recorder_returns_none(name, monkeypatch):
    """A program that predates the recorder (the parent commit of the PR
    that brought it): the import fails, the reader says nothing."""
    import deepsensornz_tpu_torch.perf as perf

    monkeypatch.delattr(perf, "spans")
    monkeypatch.setitem(sys.modules, "deepsensornz_tpu_torch.perf.spans", None)
    assert manifest.load_metric(name).read(None) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_divides_by_its_root(name, spans, monkeypatch):
    span, root = READS[name]
    snap = {root: {"count": 4, "total_s": 0.8, "self_s": 0.0, "max_s": 0.3}}
    snap[span] = {"count": 8 if span != root else 4, "total_s": 0.2 if span != root else 0.8,
                  "self_s": 0.1, "max_s": 0.05}
    snap["unrelated"] = {"count": 1, "total_s": 9.0, "self_s": 9.0, "max_s": 9.0}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    want = 1e3 * snap[span]["total_s"] / 4
    assert manifest.load_metric(name).read(None) == pytest.approx(want)


@pytest.mark.parametrize("workload", ["serve-cycle.gnp-d500", "serve-samples.bgamma-d500",
                                      "train.gnp-d500", "train.bgamma-d500"])
def test_a_traced_tiny_run_reports_the_span_metrics(workload, spans):
    cell = tiny_cell(workload)
    result, lines = core.run_cell(cell, 2**31 + 77, 0.3, True, CPU, time.perf_counter())
    assert result["correct"], lines
    mine = {m["name"] for m in SPAN_METRICS if workload in m["workloads"]}
    assert mine and mine <= set(result["metrics"])
    for name in mine:
        assert result["metrics"][name]["value"] > 0 and result["metrics"][name]["unit"] == "ms"
    snap = spans.snapshot()
    tr = cell.traffic
    if workload.startswith("serve"):
        # one root a traced request, and nothing from set-up or the untraced window
        assert snap["predict_grid"]["count"] == tr["trace_requests"]
        parts = sum(result["metrics"][f"request_{k}_ms.serve"]["value"]
                    for k in ("prep", "wait", "maps"))
        assert parts < 1e3 * snap["predict_grid"]["total_s"] / tr["trace_requests"]
    else:
        steps = tr["trace_epochs"] * -(-tr["pool_tasks"] // tr["batch_size"])
        assert snap["train.launch"]["count"] == snap["train.batch"]["count"] == steps
        assert snap["train.losses"]["count"] == tr["trace_epochs"]
