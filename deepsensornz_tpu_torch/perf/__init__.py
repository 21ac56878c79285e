"""Performance harness: profiling, timing, device-memory reporting."""

from deepsensornz_tpu_torch.perf.harness import (  # noqa: F401
    Timer,
    benchmark_fn,
    device_memory_stats,
    profile_trace,
)
