"""The port's one store of spans and counters (``perf.spans``), the spans of
a gridded request and of a training epoch, and ``perf.harness.idle_by_span``
(CPU; the card's side is in ``tests/test_torch_spans_cuda.py``)."""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.native import taskpack
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.perf import harness, spans
from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step, train_epoch

REQUEST_CHILDREN = {"predict_grid.prepare", "predict_grid.upload", "predict_grid.launch",
                    "predict_grid.download", "predict_grid.wait", "predict_grid.maps",
                    "predict_grid.drain"}
# the model's device spans of a gridded forward, inside ``predict_grid.device``
MODEL_SPANS = {"model.encode_grid", "model.decode_grid"}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def empty():
    spans.clear()
    yield
    spans.clear()


def _by_name(records):
    out = {}
    for s in records:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parent_group_and_self_time():
    with spans.recording():
        with spans.span("root") as root:
            time.sleep(0.01)
            with spans.span("root.a") as a:
                time.sleep(0.02)
                with spans.span("root.a.x") as x:
                    time.sleep(0.01)
            with spans.span("root.b") as b:
                time.sleep(0.01)
        with spans.span("other") as other:
            pass
    assert (a.parent, b.parent, x.parent, root.parent) == (root.id, root.id, a.id, None)
    assert {a.group, b.group, x.group} == {root.id} and other.group == other.id != root.id
    assert len({s.thread for s in spans.records()}) == 1
    snap = spans.snapshot()
    assert {k: v["count"] for k, v in snap.items()} == {"root": 1, "root.a": 1, "root.a.x": 1,
                                                        "root.b": 1, "other": 1}
    r, ra = snap["root"], snap["root.a"]
    # self time: the duration less the part the children cover
    assert r["self_s"] == pytest.approx(r["total_s"] - ra["total_s"] - snap["root.b"]["total_s"],
                                        abs=1e-6)
    assert ra["self_s"] == pytest.approx(ra["total_s"] - snap["root.a.x"]["total_s"], abs=1e-6)
    assert 0.009 < r["self_s"] < r["total_s"] and r["max_s"] == r["total_s"] >= 0.05
    assert snap["root.a.x"]["self_s"] == snap["root.a.x"]["total_s"]


def test_overlapping_children_are_covered_once():
    """Children on worker threads overlap: the parent's self time is its
    duration less the union of their intervals."""
    with spans.recording():
        with spans.span("req") as req:
            here = spans.current()
            # every child is open when the barrier lets them go, so their
            # intervals overlap however the threads are scheduled
            together = threading.Barrier(3, timeout=10)

            def work():
                with spans.span("req.part", parent=here):
                    together.wait()
                    time.sleep(0.03)

            threads = [threading.Thread(target=work) for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
    parts = _by_name(spans.records())["req.part"]
    assert len(parts) == 3 and {p.parent for p in parts} == {req.id}
    assert {p.group for p in parts} == {req.group} and req.thread not in {p.thread for p in parts}
    snap = spans.snapshot()
    union = max(p.end_ns for p in parts) - min(p.start_ns for p in parts)
    assert snap["req"]["self_s"] == pytest.approx(snap["req"]["total_s"] - union / 1e9, abs=1e-6)
    assert snap["req"]["self_s"] < snap["req"]["total_s"] - 0.03


def _records_now() -> bool:
    with spans.span("probe") as s:
        return s is not None


def test_recording_off_costs_a_shared_no_op():
    ctx = spans.span("x")
    assert ctx is spans.span("y", device=torch.device("cpu"))
    with ctx as s:
        assert s is None and spans.current() is None
    assert spans.new_group() is None and spans.records() == []
    with spans.recording():
        assert _records_now() and spans.new_group() is not None
        with spans.recording():
            pass
        assert _records_now()
    assert not _records_now()
    assert [s.name for s in spans.records()] == ["probe", "probe"]


def test_the_profiler_flag_turns_recording_on_and_off():
    with spans.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("during"):
            torch.ones(4).add_(1)
    with spans.span("after"):
        pass
    assert [s.name for s in spans.records()] == ["during"]


def test_a_span_encloses_its_op_on_the_profilers_clock(tmp_path):
    """A span around a CPU op, and the op in the exported trace: the trace's
    ``baseTimeNanoseconds + ts·1000`` falls inside the span's stamps."""
    x = torch.randn(300, 300)
    with harness.profile_trace(str(tmp_path)):
        with spans.span("mm") as s:
            time.sleep(0.005)
            x @ x
            time.sleep(0.005)
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = int(trace["baseTimeNanoseconds"])
    (op,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    start = base + round(op["ts"] * 1e3)
    end = start + round(op["dur"] * 1e3)
    assert s.start_ns < start < end < s.end_ns
    assert start - s.start_ns > 3e6 and s.end_ns - end > 3e6  # the sleeps, not the clock


def _trace(ops, runtime=(), base=10**18):
    """A Chrome trace of device ops (name, start µs, end µs, correlation)
    and the host's launch events (tid, correlation)."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a,
           "args": {"correlation": c}} for n, a, b, c in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 1,
            "tid": tid, "args": {"correlation": c}} for tid, c in runtime]
    return {"traceEvents": ev, "baseTimeNanoseconds": base}


def _span(name, a_us, b_us, thread=1, parent=None, base=10**18):
    s = spans.Span(name, parent, None, None)
    s.start_ns, s.end_ns, s.thread = base + int(a_us * 1e3), base + int(b_us * 1e3), thread
    return s


def test_idle_by_span_charges_each_instant_to_the_innermost_span(tmp_path):
    # device busy 0-10, idle 10-40, busy 40-50 (overlapping ops), idle 50-60, busy 60-70
    trace = _trace([("k1", 0, 10, 1), ("k2", 40, 48, 2), ("k3", 45, 50, 3), ("k4", 60, 70, 4)],
                   runtime=[(1, 1), (1, 2), (1, 3), (1, 4)])
    root = _span("req", 5, 100)
    maps = _span("req.maps", 12, 25, parent=root)
    prep = _span("req.prepare", 30, 38, parent=root)
    worker = _span("req.maps", 0, 100, thread=2, parent=root)  # another thread: not charged
    dev = spans.Span("req.device", root, None, torch.device("cuda", 0))
    dev.start_ns, dev.end_ns = root.start_ns, root.end_ns   # device spans are never charged
    got = harness.idle_by_span(trace, [root, maps, prep, worker, dev])
    want = {"req": 2 + 5 + 2 + 10, "req.maps": 13, "req.prepare": 8}
    assert got.keys() == want.keys()
    for k, us in want.items():
        assert got[k] == pytest.approx(us * 1e-6)
    # a gap before any span opened: "no span"; from a file written as profile_trace writes it
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace([("k1", 0, 10, 1), ("k2", 20, 30, 2)])))
    assert harness.idle_by_span(str(path), [_span("late", 15, 40)]) == pytest.approx(
        {"no span": 5e-6, "late": 5e-6})


def test_idle_by_span_without_launch_events_reads_every_thread():
    trace = _trace([("k1", 0, 10, 1), ("k2", 20, 30, 2)])
    got = harness.idle_by_span(trace, [_span("a", 5, 15, thread=7), _span("b", 12, 40, thread=8)])
    assert got == pytest.approx({"a": 2e-6, "b": 8e-6})  # the later-opened span, same depth


def test_counters_and_their_views():
    spans.reset()
    spans.count("x.a")
    spans.count("x.a", 4)
    spans.count("y.b", 2)
    assert spans.counters("x.") == {"x.a": 5} and spans.counters() == {"x.a": 5, "y.b": 2}
    spans.reset("x.")
    assert spans.counters() == {"y.b": 2}
    setconv_cuda.reset_launch_counts()
    assert setconv_cuda.launch_counts() == {"encode_offgrid": 0, "encode_offgrid_grad": 0,
                                            "decode_grid": 0}
    spans.count("launches.decode_grid", 3)
    assert setconv_cuda.launch_counts()["decode_grid"] == 3
    setconv_cuda.reset_launch_counts()
    assert spans.counters("launches.") == {} and spans.counters("y.") == {"y.b": 2}
    taskpack.reset_call_counts()
    spans.count("taskpack.interp_grid_points")
    assert taskpack.call_counts() == {"pack_station_batches": 0, "interp_grid_points": 1}
    taskpack.reset_call_counts()
    spans.reset()


def test_counters_and_spans_from_many_threads_lose_nothing():
    spans.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n = 32, 400
    try:
        def work():
            for _ in range(n):
                spans.count("stress.n")
                with spans.span("stress"):
                    spans.count("stress.bytes", 3)

        with spans.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert spans.counters("stress.") == {"stress.n": n_threads * n,
                                         "stress.bytes": 3 * n_threads * n}
    recs = spans.records()
    assert len(recs) == n_threads * n and len({s.id for s in recs}) == len(recs)
    assert all(s.parent is None and s.group == s.id for s in recs)
    spans.reset()


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps a made-up device clock."""
    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock[0] += 7.0
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_a_device_span_times_the_device_between_its_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    dev = torch.device("cuda", 0)
    with spans.recording():
        with spans.span("launch") as launch:
            with spans.span("dev", device=dev) as d:       # events at 7 and 28
                with spans.span("dev.sample", device=dev):  # events at 14 and 21
                    pass
    assert d.parent == launch.id and d.device == dev
    snap = spans.snapshot()
    assert snap["dev"]["total_s"] == pytest.approx(21e-3)
    assert snap["dev"]["self_s"] == pytest.approx(14e-3)
    assert snap["dev.sample"]["total_s"] == pytest.approx(7e-3)
    # its host interval is the enqueue: the launch's own time
    assert snap["launch"]["self_s"] == snap["launch"]["total_s"]


def test_a_device_span_on_the_cpu_is_timed_on_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", None)  # any event would raise
    with spans.recording():
        with spans.span("dev", device=torch.device("cpu")) as d:
            time.sleep(0.002)
    assert d.device is None and spans.snapshot()["dev"]["total_s"] >= 0.002


@pytest.fixture(scope="module")
def tiny():
    dp = cs.make_processor("t")
    dem, aux = cs.target_fields(dp, (20, 18), seed=0)
    cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                       mlp_hidden=8, compute_dtype="float32")
    task = cs.cycle_task(0, 5, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18),
                         n_stations=12)
    model = cs.build_model(cfg, task, seed=0, device="cpu").eval()
    return dp, dem, aux, task, model


def _no_cuda_events(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made with recording off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)


@pytest.mark.parametrize("chunk,threads,n_samples", [(None, 1, 0), (2, 3, 0), (2, 2, 2)],
                         ids=["whole", "chunked", "chunked-samples"])
def test_predict_grid_records_its_spans(tiny, chunk, threads, n_samples, monkeypatch):
    dp, dem, aux, task, model = tiny
    p = Predictor(model, dp, "t", transfer_dtype="int16", batch_chunk=chunk,
                  download_threads=threads)
    _no_cuda_events(monkeypatch)
    p.predict_grid(task, dem, aux_at_targets=aux, n_samples=n_samples)  # warm, and off
    assert spans.records() == []
    with spans.recording():
        for i in range(2):
            p.predict_grid(task, dem, aux_at_targets=aux, n_samples=n_samples, seed=i)
    recs = _by_name(spans.records())
    roots = recs["predict_grid"]
    n_chunks = 1 if chunk is None else -(-task.batch_size // chunk)
    assert len(roots) == 2
    want = REQUEST_CHILDREN | MODEL_SPANS | {"predict_grid", "predict_grid.device"}
    if n_samples:
        want.add("predict_grid.sample")
    assert set(recs) == want
    for name in ("predict_grid.launch", "predict_grid.download", "predict_grid.device",
                 *MODEL_SPANS):
        assert len(recs[name]) == 2 * n_chunks, name
    device_ids = {s.id for s in recs["predict_grid.device"]}
    assert all(s.parent in device_ids for name in MODEL_SPANS for s in recs[name])
    # every child names its request; each chunk's maps, and the Fields,
    # are written under the request on its own thread, the last chunk's
    # and the Fields' inside its drain
    for root in roots:
        kids = [s for s in spans.records() if s.group == root.group and s is not root]
        assert {s.name for s in kids} == want - {"predict_grid"}
        assert all(s.parent is not None for s in kids)
        (drain,) = [s for s in kids if s.name == "predict_grid.drain"]
        assert drain.parent == root.id
        maps = [s for s in kids if s.name == "predict_grid.maps"]
        assert len(maps) == n_chunks + 1
        assert all(s.thread == root.thread for s in maps)
        assert [s.parent for s in maps] == [root.id] * (n_chunks - 1) + [drain.id] * 2
    snap = spans.snapshot()
    # the children account for the request's wall time
    assert snap["predict_grid"]["self_s"] <= 0.05 * snap["predict_grid"]["total_s"], snap


@pytest.mark.parametrize("chunk,n_chunks", [(None, 1), (2, 3), (5, 1)],
                         ids=["whole", "three-chunks", "one-chunk"])
def test_predict_grid_drains_once_after_its_last_wait(tiny, chunk, n_chunks):
    """``predict_grid.drain`` is recorded once a request, inside its
    ``predict_grid``, from the return of its last ``.wait`` to the
    request's return; ``predict_grid.chunks`` counts the chunks it
    launches. Neither records outside ``recording()``."""
    dp, dem, aux, task, model = tiny
    p = Predictor(model, dp, "t", transfer_dtype="int16", batch_chunk=chunk, download_threads=2)
    spans.reset("predict_grid.chunks")
    p.predict_grid(task, dem, aux_at_targets=aux, outputs=("mean",))
    assert spans.records() == [] and spans.counters("predict_grid.chunks") == {}
    with spans.recording():
        for i in range(2):
            p.predict_grid(task, dem, aux_at_targets=aux, seed=i, outputs=("mean",))
    assert spans.counters("predict_grid.chunks") == {"predict_grid.chunks": 2 * n_chunks}
    recs = spans.records()
    roots = [s for s in recs if s.name == "predict_grid"]
    assert len(roots) == 2
    for root in roots:
        mine = [s for s in recs if s.group == root.group]
        (drain,) = [s for s in mine if s.name == "predict_grid.drain"]
        waits = [s for s in mine if s.name == "predict_grid.wait"]
        assert len(waits) == n_chunks and drain.parent == root.id
        assert max(w.end_ns for w in waits) <= drain.start_ns <= drain.end_ns <= root.end_ns
        # everything after the drain opens is inside it: the last chunk's
        # maps and the Fields'
        after = [s for s in mine if s.start_ns >= drain.start_ns and s is not drain]
        assert [s.name for s in after] == ["predict_grid.maps"] * 2
        assert all(s.parent == drain.id and s.end_ns <= drain.end_ns for s in after)
    spans.reset("predict_grid.chunks")


@pytest.fixture(scope="module")
def cycle_land(tiny):
    """``cycle24``'s target grid (278×260) with the benchmark's land mask
    (cells near a registry site, 15.8 %) as the DEM's land, and a 2-task
    request of the tiny model."""
    from benchmark import inputs
    from deepsensornz_tpu_torch.task.batching import take

    dp, _, _, task, model = tiny
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "cycle24.json").read_text())
    land = inputs.domain(traffic, {"internal_density": 30}, 0).land
    dem, aux = cs.target_fields(dp, land.shape, seed=0)
    dem.data[...] = np.where(land, 100.0, np.nan)
    return dp, dem, aux, take(task, [0, 1]), model, land


@pytest.mark.parametrize("way", ["land", "samples", "no-sea-mask"])
def test_the_land_path_counts_its_live_tiles_and_cells(cycle_land, way):
    """A request without samples decodes the land alone: on ``cycle24``'s
    grid 15 block tiles × planes under ``decode_grid.tiles``, the 10 live
    ones (0.667) under ``decode_grid.tiles_live``, and B × 11 421 decoded
    cells under ``model.decode_grid_cells``. With samples or without a sea
    mask the whole grid is decoded: no ``decode_grid.`` counter, B × Ht × Wt
    cells. Nothing is counted outside recording."""
    dp, dem, aux, task, model, land = cycle_land
    p = Predictor(model, dp, "t", transfer_dtype="int16")
    kw = dict(aux_at_targets=aux, n_samples=2 if way == "samples" else 0,
              sea_mask=way != "no-sea-mask")
    spans.reset("decode_grid.")
    spans.reset("model.")
    p.predict_grid(task, dem, **kw)
    assert spans.counters("decode_grid.") == {} and spans.counters("model.") == {}
    with spans.recording():
        p.predict_grid(task, dem, **kw)
    got = spans.counters("decode_grid.")
    B, planes = task.batch_size, task.batch_size * model.cfg.decoder_channels
    assert int(land.sum()) == 11421 and land.shape == (278, 260)
    if way == "land":
        assert got == {"decode_grid.tiles": 15 * planes, "decode_grid.tiles_live": 10 * planes}
        assert spans.counters("model.decode_grid_cells") == {
            "model.decode_grid_cells": B * 11421}
    else:
        assert got == {}
        assert spans.counters("model.decode_grid_cells") == {
            "model.decode_grid_cells": B * 278 * 260}
    spans.reset("decode_grid.")
    spans.reset("model.")


def test_train_epoch_records_one_group_a_step(monkeypatch):
    cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                       mlp_hidden=8, compute_dtype="float32")
    task = cs.train_task(0, 5, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18),
                         n_stations=12, n_targets=6)
    model = cs.build_model(cfg, task, seed=0, device="cpu")
    step = make_train_step(model)
    _no_cuda_events(monkeypatch)
    state, _ = train_epoch(model, init_state(model), task, batch_size=2, step_fn=step)
    assert spans.records() == []
    with spans.recording():
        state, losses = train_epoch(model, state, task, batch_size=2, step_fn=step)
    recs = _by_name(spans.records())
    # the step's forward encodes its gridded contexts inside ``train.launch``
    assert len(losses) == 3 and {k: len(v) for k, v in recs.items()} == {
        "train.batch": 3, "train.upload": 3, "train.launch": 3, "train.losses": 1,
        "model.encode_grid": 3}
    groups = [launch.group for launch in recs["train.launch"]]
    assert len(set(groups)) == 3
    for g, launch in zip(groups, recs["train.launch"]):
        mine = sorted((s.name, s.parent) for s in spans.records() if s.group == g)
        assert mine == [("model.encode_grid", launch.id), ("train.batch", None),
                        ("train.launch", None), ("train.upload", None)]
