"""peak_mem_gib.serve: ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start, GiB."""

from benchmark.readings import peak_gib


def read(ctx):
    return peak_gib(ctx)
