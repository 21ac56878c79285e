"""sample_ms.serve: the card's time in the head's draws of a request's
joint samples (device span ``predict_grid.sample``, between its CUDA
events), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.sample", REQUEST)
