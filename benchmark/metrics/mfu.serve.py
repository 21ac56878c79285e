"""mfu.serve: the serving window's model FLOPs (the U-Net's convolutions,
B1 and B2 at what their inputs need, the MLP head) over the traced
window's wall time at the H100's dense bf16 peak, %."""

from benchmark.readings import mfu


def read(ctx):
    return mfu(ctx)
