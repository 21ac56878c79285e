"""request_upload_ms.serve: the host's upload of a request's inputs to the
card (span ``predict_grid.upload``: the task's leaves, and where the program
uploads them there, the target grid's coordinates, aux and land index), per
request, ms."""

from benchmark.program_spans import REQUEST, per_root_ms


def read(ctx):
    return per_root_ms("predict_grid.upload", REQUEST)
