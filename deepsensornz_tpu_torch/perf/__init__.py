"""Performance harness: profiling, timing, device-memory reporting, and the
port's one store of spans and counters (``perf.spans``)."""

from deepsensornz_tpu_torch.perf import spans  # noqa: F401
from deepsensornz_tpu_torch.perf.harness import (  # noqa: F401
    Timer,
    benchmark_fn,
    device_memory_stats,
    idle_by_span,
    profile_trace,
)
