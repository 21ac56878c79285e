"""encode_grid_ms.serve: the card's time resampling a request's gridded
contexts (the base and the aux) onto the internal grid (device span
``model.encode_grid``, between its CUDA events), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("model.encode_grid", REQUEST)
