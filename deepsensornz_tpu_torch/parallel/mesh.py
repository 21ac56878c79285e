"""The (data, spatial) device mesh, TaskBatch sharding for data-parallel
training and serving, the row blocks of the spatial partition, and the
gather of each rank's rows.

Counterpart of ``deepsensornz_tpu/parallel/mesh.py``, in torch's idiom: one
process per GPU, where JAX has one process drive every local device. The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (:func:`..parallel.multihost.initialize_multihost`
starts it), with dims ``("data", "spatial")``. A process holds only its own
rows of a batch (:func:`shard_task`); the gradient sum over the data axis
is an explicit all-reduce in ``train.trainer.make_train_step(mesh=...)``,
where XLA inserts a psum. Data-parallel serving (``Predictor`` and
``ar_sample`` with ``mesh=``) splits a global batch the same way and
:func:`gather_rows` puts the ranks' outputs back together in rank order,
on every rank, where a jitted JAX function returns one global array.

The spatial axis (``n_spatial > 1``) partitions the internal grid of a
model whose ``ConvNPConfig.mesh_axes`` names the axes: each rank of a
spatial group holds the same task rows and a contiguous block of the
grid's rows (:func:`row_blocks`, :func:`row_block`), as a JAX
``P(batch, spatial, None, None)`` sharding of the encoding does. Where XLA
SPMD writes the U-Net's halo exchange and the decode's reduction itself,
the port writes them by hand (:mod:`.halo`).

Not ported:

- ``batch_spec`` and ``replicate``: they are ``PartitionSpec``\\ s, layouts
  that ``jit`` applies to global arrays. A torch tensor lives in one
  process, so they have no counterpart: :func:`shard_task` takes a rank's
  rows, and ``multihost.replicate_multihost`` broadcasts rank 0's values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from deepsensornz_tpu_torch.task.batching import _map_batched, pad_batch_to_multiple  # noqa: F401
from deepsensornz_tpu_torch.task.task import TaskBatch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, spatial) mesh over every rank of the default process group;
    by default all of them on the data axis. Rank ``d * n_spatial + s`` sits
    at (d, s): a spatial group is ``n_spatial`` consecutive ranks, as JAX's
    ``reshape(n_data, n_spatial)`` of the device list packs them.
    ``device_type``: ``"cuda"`` or ``"cpu"``; by default ``"cuda"`` under
    NCCL and ``"cpu"`` otherwise. On ``"cuda"`` each rank's current device
    becomes ``cuda:(rank % count)``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost() "
                           "first")
    world = dist.get_world_size()
    n_spatial = int(n_spatial)
    n_data = max(world // n_spatial, 1) if n_data is None else int(n_data)
    if n_data * n_spatial != world:
        raise ValueError(f"a {n_data}x{n_spatial} mesh needs {n_data * n_spatial} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_spatial),
                            mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_group(mesh: DeviceMesh):
    """The process group of the data axis (the gradient all-reduce's)."""
    return mesh.get_group(DATA_AXIS)


def data_shard(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's index on the data axis, the axis' size)."""
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def spatial_group(mesh: DeviceMesh):
    """The process group of the spatial axis (the halo exchanges' and the
    decode's sum)."""
    return mesh.get_group(SPATIAL_AXIS)


def spatial_shard(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's index on the spatial axis, the axis' size)."""
    return mesh.get_local_rank(SPATIAL_AXIS), mesh.size(1)


def row_blocks(H: int, n: int, unit: int) -> tuple[tuple[int, int], ...]:
    """The row blocks ``[a, b)`` of an ``H``-row grid over ``n`` ranks.
    Blocks are whole multiples of ``unit`` rows (``2**len(unet_channels)``,
    so every U-Net level splits at integer rows), as equal as possible,
    the first ranks taking the extra units: 608 rows in units of 16 give
    304/304 over 2 ranks and 160/160/144/144 over 4. A split that would
    leave a rank without a row at the coarsest level raises."""
    if H % unit:
        raise ValueError(f"a grid of {H} rows does not split into units of {unit} rows "
                         "(the U-Net needs H divisible by 2**len(unet_channels))")
    units = H // unit
    if units < n:
        raise ValueError(f"a grid of {H} rows is {units} units of {unit} rows: too few for "
                         f"{n} spatial ranks, some rank would hold no row at the coarsest "
                         "U-Net level")
    per, extra = divmod(units, n)
    bounds = np.cumsum([0] + [(per + (r < extra)) * unit for r in range(n)])
    return tuple((int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]))


def row_block(mesh: DeviceMesh, H: int, unit: int) -> tuple[int, int]:
    """This rank's row block ``[a, b)`` of an ``H``-row grid
    (:func:`row_blocks` over the spatial axis)."""
    index, n = spatial_shard(mesh)
    return row_blocks(H, n, unit)[index]


def task_shardings(task: TaskBatch, mesh: DeviceMesh) -> dict[str, Optional[str]]:
    """Each leaf of ``task`` by its field path (``"points.0.x"``): the mesh
    axis its first dim is split over, ``DATA_AXIS`` for a batch-dimensioned
    leaf and None for a replicated one (the grid coordinate vectors). The
    JAX function decides by the leading dim's size; the port knows which
    fields carry the batch."""
    del mesh  # one layout on every mesh: the batch over the data axis
    specs = {}

    def leaves(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, tuple):
                for i, item in enumerate(v):
                    leaves(item, f"{prefix}{f.name}.{i}.")
            elif v is not None:
                specs[prefix + f.name] = v

    leaves(task, "")
    batched = set()
    _map_batched(task, lambda t: batched.add(id(t)) or t)
    return {k: (DATA_AXIS if id(v) in batched else None) for k, v in specs.items()}


def take_rows(task: TaskBatch, per: int, off: int, device) -> TaskBatch:
    """Rows ``[off, off + per)`` of every batch-dimensioned leaf, and the
    coordinate vectors, on ``device``: only those rows are copied there."""
    rows = _map_batched(task, lambda t: t[off: off + per])
    return rows.to(device)


def shard_task(task: TaskBatch, mesh: DeviceMesh) -> TaskBatch:
    """This rank's rows of a global TaskBatch on this rank's device, the
    batch split evenly over the data axis in rank order (as a JAX
    ``P("data")`` sharding splits it over the mesh's devices); the
    coordinate vectors whole. Every rank of a spatial group gets the same
    rows: the model cuts the grid itself. The batch must divide the data axis
    (:func:`pad_batch_to_multiple`)."""
    index, n = data_shard(mesh)
    b = task.batch_size
    if b % n:
        raise ValueError(f"batch {b} does not divide the data axis of {n} ranks; "
                         "pad it with pad_batch_to_multiple")
    per = b // n
    return take_rows(task, per, index * per, mesh_device(mesh))


def rows_of_rank(mesh: DeviceMesh, batch: int) -> tuple[int, int]:
    """(first row, rows per rank) of this rank's share of a ``batch``-row
    batch padded to a multiple of the data axis (the last rank's share may
    run past ``batch``: those are the pad rows)."""
    index, n = data_shard(mesh)
    per = -(-batch // n)
    return index * per, per


def rank_indices(mesh: DeviceMesh, idx) -> np.ndarray:
    """This rank's share of the task indices ``idx``, padded to a multiple
    of the data axis by repeating the last one (the padding of
    :func:`pad_batch_to_multiple`; the pad rows' outputs are dropped, so
    their target masks need not be zeroed)."""
    idx = np.asarray(idx)
    start, per = rows_of_rank(mesh, len(idx))
    idx = np.concatenate([idx, np.full(per * mesh.size(0) - len(idx), idx[-1], idx.dtype)])
    return idx[start:start + per]


def gather_rows(t: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """Every data rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in rank order, on every rank; over the data axis only (the
    ranks of a spatial group hold the same rows). The tensors travel as their bytes,
    so any dtype goes over any backend (gloo has no int16), bit for bit."""
    n = mesh.size(0)
    if n == 1:
        return t
    flat = t.contiguous().view(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=data_group(mesh))
    return torch.cat([p.view(t.dtype).view(t.shape) for p in parts], dim)
