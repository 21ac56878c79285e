"""What the per-layer readers share. A reader that finds nothing to read
returns None, and the metric is left out of the line; a share of a
roofline or of a peak is never reported as 0 for want of a reading."""

from __future__ import annotations

from typing import Optional

from benchmark.work import PEAK_BF16_FLOPS


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the traced window over its wall time at the bf16 peak, %."""
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.work.get("model_flops"):
        return None
    return 100.0 * ctx.work["model_flops"] / (ctx.trace.window_s * PEAK_BF16_FLOPS)


def roofline(ctx, kernels: tuple, op: str) -> Optional[float]:
    """The operation's least time over its device time, %: the bound of a
    launch (``ctx.work[op]``: total bound seconds and launches) over the
    device time per launch of ``kernels`` (one launch each) in the trace."""
    if ctx.trace is None or op not in ctx.work:
        return None
    bound_s, launches = ctx.work[op]
    count = ctx.trace.kernel(kernels[:1])[1]   # launches of the operation's first kernel
    if count == 0 or launches == 0:
        return None
    seconds = ctx.trace.kernel(kernels)[0]
    return 100.0 * (bound_s / launches) * count / seconds


def idle_pct(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_gib(ctx) -> Optional[float]:
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
