"""One store for the port's spans and counters.

A **span** times one piece of the host's work on a request or a training
step: its name, its start and end on ``time.time_ns()`` (the clock of
``torch.profiler``'s Chrome traces, read as ``baseTimeNanoseconds +
ts·1000``), the span open around it on its thread (its parent), the
request or step it belongs to (its group: a root span's own id, inherited
by its children, or given) and its thread (``threading.get_native_id()``,
a trace's ``tid``). A span opened on a worker thread takes as its parent
the span that handed it the work (:func:`current` on the handing thread).

Spans record only while recording is on: while a torch profiler runs
(``torch.autograd.profiler._is_profiler_enabled``, which torch sets on any
profiler's start, for any activities) or inside :func:`recording`. With
recording off, :func:`span` reads two flags and returns one shared no-op
context: it allocates nothing and records no CUDA event. Recorded spans
are kept in a bounded buffer (the newest ``CAPACITY``; each one pushed out
counts under ``spans.dropped``) until :func:`clear`.

A **device span** (``device=`` a CUDA device) also records a pair of
timing CUDA events on that device's current stream; its seconds are the
device's between them, read at :func:`snapshot` once they have completed.
Its host interval is only the enqueue, so it covers none of its parent's
host time. On the CPU it is timed on the host.

**Counters** are integer adds under a lock, always on: :func:`count`,
:func:`counters`, :func:`reset`. The SetConv wrappers count their
launches under ``launches.`` (and, while recording, the gridded decode its
block tiles under ``decode_grid.``), ``native.taskpack`` its native calls under
``taskpack.`` and the spatial collectives their calls and bytes under
``halo.``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16

_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_recording = 0  # open recording() blocks
_counters: dict[str, int] = {}


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "id", "parent", "group", "thread", "start_ns", "end_ns", "device",
                 "_events", "_device_s")

    def __init__(self, name: str, parent: Optional["Span"], group: Optional[int],
                 device: Optional[torch.device]):
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if group is None:
            group = self.id if parent is None else parent.group
        self.group = group
        self.thread = threading.get_native_id()
        self.device = device if device is not None and device.type == "cuda" else None
        self._events = None
        self._device_s = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        _stack().append(self)
        if self.device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if len(_buffer) == CAPACITY:
            count("spans.dropped")
        _buffer.append(self)
        return False

    @property
    def seconds(self) -> float:
        """A device span's device time between its events (waiting for the
        second), any other span's host time from start to end."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self._events = None
        if self._device_s is not None:
            return self._device_s
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, parent: Optional[Span] = None, group: Optional[int] = None,
         device: Optional[torch.device] = None):
    """A context that records the span ``name`` while recording is on.
    ``parent``: a span open on another thread, for work it handed to this
    one; by default the innermost span open on this thread. ``group``: the
    request or step of a span with no parent (:func:`new_group`); by
    default the parent's, or a root's own id. ``device``: on a CUDA device,
    a device span (module docstring)."""
    if not active():
        return _OFF
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    return Span(name, parent, group, device)


def current() -> Optional[Span]:
    """The innermost span open on this thread (None while recording is off
    or outside every span): the parent to hand a worker thread."""
    stack = _stack()
    return stack[-1] if stack else None


def new_group() -> Optional[int]:
    """A fresh id for the spans of one request or step that share no root
    span; None while recording is off."""
    if not (_recording or _profiler._is_profiler_enabled):
        return None
    return next(_ids)


def active() -> bool:
    """Whether spans record now: a torch profiler runs or a
    :func:`recording` block is open."""
    return bool(_recording or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler (an
    operator's switch; the buffer is not cleared)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def records() -> list[Span]:
    """The recorded spans, oldest first."""
    return list(_buffer)


def clear() -> None:
    """Drop every recorded span."""
    _buffer.clear()


def _covered_ns(span: Span, children: list) -> int:
    """Nanoseconds of ``span``'s interval that the union of ``children``'s
    intervals covers."""
    lo, hi, total = span.start_ns, span.end_ns, 0
    end = lo
    for a, b in sorted((max(c.start_ns, lo), min(c.end_ns, hi)) for c in children):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def snapshot() -> dict[str, dict]:
    """By span name: ``count``, ``total_s``, ``self_s`` (the seconds less
    the part its child spans cover: for a host span, the union of its host
    children's intervals; for a device span, its device children's device
    seconds) and ``max_s``. Waits for the device spans' events."""
    spans = list(_buffer)
    host_children, device_children = collections.defaultdict(list), collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            (device_children if s.device is not None else host_children)[s.parent].append(s)
    out: dict[str, dict] = {}
    for s in spans:
        sec = s.seconds
        if s.device is not None:
            own = sec - sum(c.seconds for c in device_children.get(s.id, ()))
        else:
            own = sec - _covered_ns(s, host_children.get(s.id, ())) / 1e9
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0, "max_s": 0.0})
        row["count"] += 1
        row["total_s"] += sec
        row["self_s"] += max(own, 0.0)
        row["max_s"] = max(row["max_s"], sec)
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with ``prefix``, by full name."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix``."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
