"""The profiler around the traced part of a window, and its reduction.

``Tracer`` is the benchmark's own copy of the port's ``profile_trace``
pattern, ``torch.profiler``, recording the card's activity only: with the
host's operators recorded too, the profiler's own cost halved the
training step's rate. The traced window is timed on the host clock; every
device operation in it was launched inside it and, since each request and
epoch ends by waiting for its results, finished inside it. The Chrome
trace is written under ``TMPDIR``, reduced and deleted. The reduction
gives the union of device intervals (kernels, copies, sets), the device
time by operation, and the idle gaps between device operations named by
the operations on either side (what the host did between them).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 20.0  # shorter idle gaps are summed under one name


def kernel_name(name: str) -> str:
    """A device op's bare name: no return type, namespace, template or
    arguments (``void (anonymous namespace)::decode_grid_kernel<false>(…)``
    → ``decode_grid_kernel``)."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = name[5:] if name.startswith("void ") else name
    name = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return name.rsplit("::", 1)[-1]


def short_name(name: str) -> str:
    """A device op's name for the breakdown: the kernel's bare name, or for
    PyTorch's generic elementwise kernels the functor they run."""
    m = re.search(r"(CUDAFunctor_\w+|direct_copy_kernel_cuda|launch_clamp_scalar|\w+_kernel_cuda"
                  r"|\w+Functor\w*)", name) if name.startswith("void at::native::") else None
    if m:
        return f"{kernel_name(name)}[{m.group(1)}]"
    t = re.match(r"(?:void )?cutlass::Kernel2?<(\w+)", name)
    return t.group(1) if t else kernel_name(name)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: dict           # device op name → (seconds, count)
    gaps: dict          # "op before → op after" → idle seconds

    def kernel(self, names) -> tuple[float, int]:
        """Seconds and count of the device ops whose bare kernel name is one
        of ``names``; (0.0, 0) when none ran."""
        s = n = 0
        for op, (sec, cnt) in self.ops.items():
            if kernel_name(op) in names:
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for op, (sec, _) in self.ops.items():
            ops[short_name(op)] = ops.get(short_name(op), 0.0) + sec

        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:top]

        return {"device_ops": rank(ops), "idle_gaps": rank(self.gaps)}


def reduce(events: list, window_s: float) -> TraceSummary:
    """Reduce Chrome-trace events (µs) of a window ``window_s`` long."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    ops, busy, gaps = {}, 0.0, {}
    end, before = None, None
    for a, b, name in dev:
        sec, cnt = ops.get(name, (0.0, 0))
        ops[name] = (sec + (b - a) / 1e6, cnt + 1)
        if end is None or a > end:
            if end is not None:
                key = (f"gaps under {SHORT_GAP_US:g} us" if a - end < SHORT_GAP_US
                       else f"{short_name(before)} -> {short_name(name)}")
                gaps[key] = gaps.get(key, 0.0) + (a - end) / 1e6
            busy += b - a
            end, before = b, name
        elif b > end:
            busy += b - end
            end, before = b, name
    busy_s = busy / 1e6
    edges = window_s - busy_s - sum(gaps.values())
    if dev and edges > 0:
        gaps["window start and end"] = edges
    return TraceSummary(window_s=window_s, busy_s=busy_s, ops=ops, gaps=gaps)


class Tracer:
    """``torch.profiler`` over the card (the CPU where there is none) when
    ``on``; a no-op otherwise. The block is the traced part of the window,
    timed on the host clock; :meth:`finish`, after the window, writes the
    trace, reduces it into ``summary`` and deletes it."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[TraceSummary] = None
        self.window_s = 0.0
        self._prof = None

    def __enter__(self):
        if self.on:
            self._prof = _profile()
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def finish(self) -> Optional[TraceSummary]:
        if self._prof is not None:
            with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
                path = Path(tmp) / "trace.json"
                self._prof.export_chrome_trace(str(path))
                self.summary = reduce(json.loads(path.read_text())["traceEvents"],
                                      self.window_s)
            self._prof = None
        return self.summary


def _profile():
    import torch

    act = (torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
           else torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=[act])


def warm_profiler() -> None:
    """Start and stop the profiler once (CUPTI's first start is slow), in
    set-up, so the traced window does not pay it."""
    import torch

    with _profile():
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
