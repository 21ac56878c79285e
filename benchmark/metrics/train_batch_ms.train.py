"""train_batch_ms.train: the host's gather of a step's batch from the task
pool (span ``train.batch``), per step, ms."""

from benchmark.program_spans import STEP, per_root_ms


def read(ctx):
    return per_root_ms("train.batch", STEP)
