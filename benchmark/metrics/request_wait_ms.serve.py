"""request_wait_ms.serve: the host waiting for a request's results to reach
pinned memory (span ``predict_grid.wait``: the copies' event, or the
chunks' workers), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.wait", REQUEST)
