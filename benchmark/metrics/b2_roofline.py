"""b2_roofline: B2, the gridded decode (``decode_grid_kernel`` and its
``channels_last_kernel``, one operation), its bound per launch over its
device time per launch, %."""

from benchmark.readings import roofline

KERNELS = ("decode_grid_kernel", "channels_last_kernel")


def read(ctx):
    return roofline(ctx, KERNELS, "b2")
