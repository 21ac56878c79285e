"""device_idle_pct.train: the share of the traced window in which no kernel,
copy or set ran on the card, %."""

from benchmark.readings import idle_pct


def read(ctx):
    return idle_pct(ctx)
