"""Process-group start-up and per-process batch feeding across hosts.

Counterpart of ``deepsensornz_tpu/parallel/multihost.py``. Where JAX
starts ``jax.distributed`` and builds global arrays out of per-host data,
the port starts a ``torch.distributed`` process group, one process per GPU,
and each process holds its own rows and a copy of the parameters:

- :func:`initialize_multihost` starts the group from arguments or from the
  environment, the JAX package's names (``COORDINATOR_ADDRESS``,
  ``NUM_PROCESSES``, ``PROCESS_ID``) or torchrun's (``MASTER_ADDR``/
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
- :func:`make_global_mesh` is the (data, spatial) mesh over every rank;
- :func:`shard_task_multihost` uploads this process's rows of a global
  batch, :func:`shard_batch_for_host` says which;
- :func:`replicate_multihost` broadcasts rank 0's parameters or optimizer
  state, optionally checking that every rank already held them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from deepsensornz_tpu_torch.parallel.mesh import make_mesh, mesh_device, take_rows


def _env(*names: str) -> Optional[str]:
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> dict:
    """Start the default process group; returns {process_index,
    process_count, local_devices, global_devices} (one device per process).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to the JAX package's environment names, then
    torchrun's. With neither an address nor more than one process, the
    group is this process alone. ``backend``: ``"nccl"`` (the default) on
    ``cuda:LOCAL_RANK``, or ``"gloo"`` where the caller asks for it (the
    CPU). A failed NCCL start raises; nothing falls back to gloo. A second
    call returns the running group's numbers."""
    if not dist.is_initialized():
        addr = coordinator_address or _env("COORDINATOR_ADDRESS")
        if addr is None and _env("MASTER_ADDR") and _env("MASTER_PORT"):
            addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world = int(num_processes or _env("NUM_PROCESSES", "WORLD_SIZE") or 1)
        rank = int(process_id if process_id is not None else _env("PROCESS_ID", "RANK") or 0)
        local_rank = int(_env("LOCAL_RANK") or rank)
        backend = backend or "nccl"
        kwargs = {}
        if backend == "nccl":
            device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        if addr is not None:
            kwargs["init_method"] = f"tcp://{addr}"
        elif world == 1:
            kwargs["store"] = dist.HashStore()
        else:
            raise ValueError(f"{world} processes need a coordinator address "
                             "(COORDINATOR_ADDRESS, or MASTER_ADDR and MASTER_PORT)")
        dist.init_process_group(backend, world_size=world, rank=rank, **kwargs)
    n = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": n,
            "local_devices": 1, "global_devices": n}


def make_global_mesh(n_spatial: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """The (data, spatial) mesh over every process's device."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_spatial:
        raise ValueError(f"{n} devices not divisible by n_spatial={n_spatial}")
    return make_mesh(n // n_spatial, n_spatial, device_type)


def shard_batch_for_host(global_batch: int) -> tuple[int, int]:
    """(per-process batch, this process's offset) of a global batch that
    each process feeds only its own rows of."""
    pc, pi = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0))
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} hosts")
    per = global_batch // pc
    return per, pi * per


def shard_task_multihost(task, mesh: DeviceMesh):
    """This process's rows ``[off, off + per)`` of a global TaskBatch, the
    coordinate vectors whole, uploaded to this process's device (only these
    rows are copied there)."""
    per, off = shard_batch_for_host(task.batch_size)
    return take_rows(task, per, off, mesh_device(mesh))


def group_device() -> torch.device:
    """The device the default process group's collectives take: this
    rank's current CUDA device under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate_multihost(tree, mesh: Optional[DeviceMesh] = None, check: bool = False):
    """Rank 0's values of a parameter or optimizer dict (nested dicts of
    tensors) on every rank, on this rank's device; the input is left as it
    was. With ``check``, every rank must already hold rank 0's values
    bitwise, else every rank raises ``ValueError``; the flag that says so
    is all-reduced on ``mesh``'s device, or without a mesh on the group's
    (:func:`group_device`)."""
    device = mesh_device(mesh) if mesh is not None else None
    mismatched = []

    def place(node, path):
        if isinstance(node, dict):
            return {k: place(v, f"{path}/{k}") for k, v in node.items()}
        t = node.detach().to(device if device is not None else node.device).clone()
        dist.broadcast(t, src=0)
        if check and not torch.equal(t, node.to(t.device)):
            mismatched.append(path.lstrip("/"))
        return t

    out = place(tree, "")
    if check:
        flag = torch.tensor([float(len(mismatched))],
                            device=device if device is not None else group_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0:
            raise ValueError(f"ranks hold different values (this rank: {mismatched[:5]})")
    return out
