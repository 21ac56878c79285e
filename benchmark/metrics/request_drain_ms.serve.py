"""request_drain_ms.serve: the host's work on a request that no queued
device work hides (span ``predict_grid.drain``: from the return of the
last chunk's ``.wait`` to the request's return, so the last chunk's maps
and the ``Field``s), per request, ms. In a one-chunk request it is the
request's maps."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.drain", REQUEST)
