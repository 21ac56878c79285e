"""The perf recorder's clock on the card (``cuda`` marker; skips without a
GPU): a span around a synchronised SetConv kernel encloses the kernel in a
CUDA-only profile's trace, and ``idle_by_span`` puts the card's idle gaps
between serving requests down to the request's spans. Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_spans_cuda.py
"""

import json
import time

import numpy as np
import pytest
import torch

from deepsensornz_tpu_torch.perf import harness, spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spans.clear()
    yield torch.device("cuda", 0)
    spans.clear()


def _ns(trace, e):
    start = int(trace["baseTimeNanoseconds"]) + round(float(e["ts"]) * 1e3)
    return start, start + round(float(e["dur"]) * 1e3)


def test_a_span_encloses_its_kernel_on_the_profilers_clock(cuda, tmp_path):
    from deepsensornz_tpu_torch.ops import setconv_cuda

    rng = np.random.default_rng(0)
    x1g = torch.linspace(0, 1, 608, device=cuda)
    x = torch.from_numpy(rng.random((24, 512, 2), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(24, 512, 1)).astype(np.float32)).to(cuda)
    mask = torch.ones(24, 512, device=cuda)
    setconv_cuda.encode_offgrid(x1g, x1g, x, y, mask, 0.005)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with spans.span("encode") as s:
            time.sleep(0.001)
            setconv_cuda.encode_offgrid(x1g, x1g, x, y, mask, 0.005)
            torch.cuda.synchronize()
            time.sleep(0.001)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (k,) = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"
            and "encode_offgrid_kernel" in e["name"]]
    start, end = _ns(trace, k)
    print(f"kernel {(start - s.start_ns) / 1e3:.1f} us after the span's start, "
          f"{(s.end_ns - end) / 1e3:.1f} us before its end")
    assert s.start_ns < start < end < s.end_ns


def _serving(dev):
    import chip_smoke as cs
    from deepsensornz_tpu_torch.infer.predict import Predictor

    cfg = cs.flagship_config()
    dp = cs.make_processor("t")
    dem, aux = cs.target_fields(dp, cs.TARGET_HW, seed=0)
    task = cs.cycle_task(0, 24, cfg.internal_density)
    model = cs.build_model(cfg, task, seed=0, device=dev).eval()
    # as PredictService sets it
    p = Predictor(model, dp, "t", std_scale=0.8, transfer_dtype="int16", batch_chunk=24,
                  download_threads=8)
    return lambda: p.predict_grid(task, dem, aux_at_targets=aux)


def test_idle_between_requests_is_put_down_to_their_spans(cuda, tmp_path):
    """4 requests back to back under ``profile_trace``: the idle gaps
    between one request's last device operation and the next one's first
    (those holding the one's end and the next one's start) go at least
    90 % to named spans."""
    request = _serving(cuda)
    request()
    torch.cuda.synchronize()
    spans.clear()
    with harness.profile_trace(str(tmp_path)):
        for _ in range(4):
            request()
    recs = spans.records()
    roots = sorted((s for s in recs if s.name == "predict_grid"), key=lambda s: s.start_ns)
    assert len(roots) == 4
    trace = json.loads((tmp_path / "trace.json").read_text())
    gaps = harness.device_gaps(trace)
    between = [g for g in gaps if any(g[0] <= a.end_ns and b.start_ns <= g[1]
                                      for a, b in zip(roots, roots[1:]))]
    got = harness.charge_gaps(between, recs)
    total = sum(got.values())
    threads = {s.thread for s in recs}
    print(f"{len(between)} gaps between requests of {len(gaps)}, "
          f"{sum(g[1] - g[0] for g in between) / 1e6:.3f} ms; launching threads "
          f"{sorted({g[2] for g in between}, key=str)}, span threads {sorted(threads)}; "
          f"kinds {[(g[3][:24], g[4][:24]) for g in between]}; by span (ms) "
          f"{ {k: round(1e3 * v, 3) for k, v in got.items()} }")
    assert len(between) == 3 and {g[2] for g in between} <= threads
    assert total > 0 and got.get(harness.NO_SPAN, 0.0) <= 0.1 * total
    assert harness.idle_by_span(str(tmp_path / "trace.json"), recs) == pytest.approx(
        harness.charge_gaps(gaps, recs))
