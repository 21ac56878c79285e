"""mfu.train: the training window's model FLOPs (the U-Net, the head and
the off-grid decode forward and backward, B1 and its length-scale gradient
at what their inputs need) over the traced window's wall time at the
H100's dense bf16 peak, %."""

from benchmark.readings import mfu


def read(ctx):
    return mfu(ctx)
