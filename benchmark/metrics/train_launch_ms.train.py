"""train_launch_ms.train: the host's call of a step (span ``train.launch``:
the forward, backward and optimizer enqueued, and any wait for the card in
them), per step, ms."""

from benchmark.program_spans import STEP, per_root_ms


def read(ctx):
    return per_root_ms("train.launch", STEP)
