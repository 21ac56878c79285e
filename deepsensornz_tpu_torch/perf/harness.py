"""Perf tooling for the port.

Counterpart of ``deepsensornz_tpu/perf/harness.py``:

- :func:`profile_trace` — context manager around ``torch.profiler`` (the
  CPU, and the CUDA devices where there are any) that writes a Chrome trace
  (``trace.json``) into a directory,
- :func:`benchmark_fn` — median/min wall time with an honest device sync
  (PyTorch returns before the card finishes, so each call ends in a
  synchronise of the device its output lives on),
- :func:`device_memory_stats` — per-device memory use,
- :class:`Timer` — labelled wall-clock sections.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
