"""request_maps_ms.serve: the host's work on a request's downloaded maps
(dequantise, scatter into NaN-sea maps, unnormalise, ``Field``s; spans
``predict_grid.maps``, summed over chunks), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.maps", REQUEST)
