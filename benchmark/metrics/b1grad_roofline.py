"""b1grad_roofline: B1's length-scale gradient
(``encode_offgrid_grad_kernel``), its bound per launch (over the cells
some unmasked station reaches) over its device time per launch, %."""

from benchmark.readings import roofline

KERNELS = ("encode_offgrid_grad_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, "b1grad")
