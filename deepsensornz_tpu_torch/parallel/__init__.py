"""Data parallelism over processes (counterpart of
``deepsensornz_tpu/parallel``): a (data, spatial) ``DeviceMesh``, one
process per GPU, each with its rows of every batch, to train and to serve
(the ranks' outputs gathered in rank order), and the spatial partition of
the internal grid into row blocks with a hand-written halo exchange
(:mod:`.halo`)."""

from deepsensornz_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    make_mesh,
    pad_batch_to_multiple,
    row_block,
    row_blocks,
    shard_task,
    task_shardings,
)
