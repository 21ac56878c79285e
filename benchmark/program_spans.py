"""What the readers of the program's spans share (``source: program_span``).

The port records its spans (``deepsensornz_tpu_torch.perf.spans``) while a
torch profiler runs, so after a ``--trace 1`` run its recorder holds the
spans of the traced requests or epochs and of nothing else. A reader
divides a span's seconds, summed over the window, by the count of the root
of a request (``predict_grid``) or of a step (``train.launch``). It
returns None, never 0, where nothing was recorded, or where the program
has no recorder.
"""

from __future__ import annotations

from typing import Optional

REQUEST = "predict_grid"
STEP = "train.launch"


def per_root_ms(name: str, root: str) -> Optional[float]:
    """Milliseconds of the span ``name`` per ``root`` span over the traced
    window: host time, or a device span's time between its CUDA events."""
    try:
        from deepsensornz_tpu_torch.perf import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    roots = snap.get(root, {}).get("count", 0)
    row = snap.get(name)
    if not roots or row is None or not row["count"]:
        return None
    return 1e3 * row["total_s"] / roots
