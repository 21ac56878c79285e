"""request_device_ms.serve: the card's time through a request's forward,
moments, samples, land gather and quantisation (device span
``predict_grid.device``, between its CUDA events), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.device", REQUEST)
