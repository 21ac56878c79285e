"""train_upload_ms.train: the host's upload of a step's batch to the card
(span ``train.upload``: ``batch.to(device)``, pageable), per step, ms."""

from benchmark.program_spans import STEP, per_root_ms


def read(ctx):
    return per_root_ms("train.upload", STEP)
