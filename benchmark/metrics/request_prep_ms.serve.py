"""request_prep_ms.serve: the host's preparation of a request (target
coordinates, the aux resampled onto the 278x260 target grid, the sea mask;
span ``predict_grid.prepare``), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.prepare", REQUEST)
