"""Perf tooling for the port.

Counterpart of ``deepsensornz_tpu/perf/harness.py``:

- :func:`profile_trace` — context manager around ``torch.profiler`` (the
  CPU, and the CUDA devices where there are any) that writes a Chrome trace
  (``trace.json``) into a directory,
- :func:`benchmark_fn` — median/min wall time with an honest device sync
  (PyTorch returns before the card finishes, so each call ends in a
  synchronise of the device its output lives on),
- :func:`device_memory_stats` — per-device memory use,
- :class:`Timer` — labelled wall-clock sections,
- :func:`idle_by_span` — the device's idle time in a Chrome trace put down
  to the ``perf.spans`` the host was in, on the trace's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch


class Timer:
    """Labelled timing sections; ``report()`` prints a sorted table."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        lines = [
            f"{name:<40s} {t:8.3f}s"
            for name, t in sorted(self.sections.items(), key=lambda kv: -kv[1])
        ]
        out = "\n".join(lines)
        print(out)
        return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    when a card is present) and write its Chrome trace to
    ``log_dir/trace.json`` (default: ``torch-trace`` under the temporary
    directory). Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor leaf of a result (tensors, sequences, dicts and
    dataclasses), or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        leaves = out.values()
    elif isinstance(out, (list, tuple)):
        leaves = out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        leaves = (getattr(out, f.name) for f in dataclasses.fields(out))
    else:
        return None
    for leaf in leaves:
        t = _first_tensor(leaf)
        if t is not None:
            return t
    return None


def _sync(out) -> None:
    """Wait for the device of the result's first tensor leaf (nothing to
    wait for on the CPU or for a host result)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def benchmark_fn(fn: Callable, *args, warmup: int = 1, reps: int = 5) -> dict:
    """Median/min wall time of ``fn(*args)``, each call synchronised."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "p50_s": float(np.median(times)),
        "min_s": float(np.min(times)),
        "reps": reps,
    }


def device_memory_stats() -> list[dict]:
    """Per-device memory stats: one entry per CUDA device (bytes the
    caching allocator has handed out now and at its peak, and the card's
    total memory), or, without a card, one CPU entry whose fields are None."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "no span"


def device_gaps(trace: dict) -> list[tuple]:
    """The device's idle gaps between its first and last operation in a
    loaded Chrome trace: (start, end) in ns on ``time.time_ns()``'s clock
    (``baseTimeNanoseconds + ts·1000``), the thread that launched the
    operation after the gap (None where the trace holds no host launch
    events) and the names of the operations before and after it."""
    events = trace["traceEvents"]
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    launcher = {e["args"]["correlation"]: e.get("tid") for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ops = sorted((base_ns + round(float(e["ts"]) * 1e3),
                  base_ns + round((float(e["ts"]) + float(e["dur"])) * 1e3),
                  e.get("name", ""), launcher.get(e.get("args", {}).get("correlation")))
                 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps, end, before = [], None, None
    for a, b, name, tid in ops:
        if end is not None and a > end:
            gaps.append((end, a, tid, before, name))
        if end is None or b > end:
            end, before = b, name
    return gaps


def charge_gaps(gaps: list, spans) -> dict[str, float]:
    """Seconds of the ``gaps`` (:func:`device_gaps`) by span name: each
    instant of a gap goes to the innermost host span open then on the
    thread that launched the operation after the gap (on every thread
    where that is unknown or recorded no span), or to ``"no span"``."""
    host = [s for s in spans if s.device is None]
    by_id = {s.id: s for s in host}
    depth = {}

    def level(s) -> int:
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 0 if p is None else level(p) + 1
        return depth[s.id]

    threads = {}
    for s in sorted(host, key=lambda s: s.start_ns):
        threads.setdefault(s.thread, []).append(s)
        threads.setdefault(None, []).append(s)
    starts = {t: [s.start_ns for s in ss] for t, ss in threads.items()}
    out: dict[str, float] = {}
    for a, b, tid, *_ in gaps:
        t = tid if tid in threads else None
        ss = threads.get(t, [])
        # the spans open at some instant of [a, b): started before b, ended after a
        cand = [s for s in ss[:bisect.bisect_left(starts.get(t, []), b)] if s.end_ns > a]
        cuts = sorted({a, b} | {x for s in cand for x in (s.start_ns, s.end_ns) if a < x < b})
        for lo, hi in zip(cuts, cuts[1:]):
            open_ = [s for s in cand if s.start_ns <= lo and s.end_ns >= hi]
            name = max(open_, key=lambda s: (level(s), s.start_ns)).name if open_ else NO_SPAN
            out[name] = out.get(name, 0.0) + (hi - lo) / 1e9
    return out


def idle_by_span(trace, spans) -> dict[str, float]:
    """Seconds of device idle time by span name.

    ``trace``: a Chrome trace written by :func:`profile_trace` (its path,
    or the loaded object); ``spans``: the spans recorded over the same
    window (``perf.spans.records()``), whose ``time.time_ns()`` stamps are
    the trace's ``baseTimeNanoseconds + ts·1000``. Each idle gap between
    two device operations (kernels, copies, sets) is charged, instant by
    instant, to the innermost host span open on the thread that launched
    the operation after the gap (a trace without the host's launch events
    does not say: every thread's spans), or to ``"no span"`` where none
    was open (:func:`device_gaps`, :func:`charge_gaps`)."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    return charge_gaps(device_gaps(trace), spans)
