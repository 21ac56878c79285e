"""decode_grid_ms.serve: the card's time from a request's U-Net features to
its raw parameters on the target grid: B2, the aux at the targets
appended and the MLP head, over all the grid's row blocks (device span
``model.decode_grid``, between its CUDA events), per request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("model.decode_grid", REQUEST)
