"""b1_roofline.train: B1, the station encode (``encode_offgrid_kernel``),
its bound per launch over its device time per launch, in the training
cells, %."""

from benchmark.readings import roofline

KERNELS = ("encode_offgrid_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, "b1")
