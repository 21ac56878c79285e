"""Start a group of the port's worker processes for a test (gloo, one CPU
each): ``tests/_torch_parallel_worker.py`` (or another worker script) under
the JAX package's or torchrun's environment names, one free port per group,
a time limit per group; the ranks' outputs come back by rank."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
GROUP_TIMEOUT = 120
_RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(inputs: dict, world: int, tmp: Path, env_names: str, mode: str = "train",
              worker: Path = WORKER) -> list:
    """``world`` processes of ``worker`` in ``mode`` on ``inputs`` (saved
    with ``torch.save``); their outputs by rank. A group that does not
    finish in ``GROUP_TIMEOUT`` seconds fails the test."""
    inp = tmp / "in.pt"
    torch.save(inputs, inp)
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in _RANK_ENV}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        if env_names == "jax":
            env.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(world),
                       PROCESS_ID=str(rank))
        else:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(worker), str(inp), str(tmp), mode],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {world}-process group did not finish in {GROUP_TIMEOUT} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
