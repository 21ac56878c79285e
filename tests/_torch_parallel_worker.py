"""One rank of a data-parallel group of the port, for tests/test_torch_parallel.py.

    python tests/_torch_parallel_worker.py IN_FILE OUT_DIR

The rank, the group's size and its address come from the environment, in
the JAX package's names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) or torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), as ``initialize_multihost``
reads them. ``IN_FILE`` (``torch.save``) holds the model config, its
parameters and the tasks; the rank writes ``OUT_DIR/rank{r}.pt``. Imports
the port only.
"""

import dataclasses
import sys

import torch

from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.parallel.mesh import (
    make_mesh, mesh_device, pad_batch_to_multiple, shard_task, task_shardings)
from deepsensornz_tpu_torch.parallel.multihost import (
    initialize_multihost, replicate_multihost, shard_batch_for_host, shard_task_multihost)
from deepsensornz_tpu_torch.train import trainer as tr

LR = 1e-3


def main(in_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    info = initialize_multihost(backend="gloo")
    rank, world = info["process_index"], info["process_count"]
    mesh = make_mesh()
    inp = torch.load(in_file, weights_only=False)
    cfg = ConvNPConfig(**inp["cfg"])
    task8, task3, train, val = inp["task8"], inp["task3"], inp["train"], inp["val"]
    model = ConvNP.from_task(cfg, task8, device=mesh_device(mesh))
    model.load_state_dict(inp["params"])
    out = {"info": info, "shard_for_host": shard_batch_for_host(8)}

    shard = shard_task(task8, mesh)
    out["shard"] = {"xt": shard.xt, "yt_mask": shard.yt_mask, "points.0.x": shard.points[0].x,
                    "grids.0.y": shard.grids[0].y, "x1g": shard.x1g}
    out["shard_multihost_equal"] = torch.equal(shard.xt, shard_task_multihost(task8, mesh).xt)
    out["specs"] = task_shardings(task8, mesh)

    step = tr.make_train_step(model, mesh=mesh)
    state0 = tr.init_state(model)
    s8, loss8 = step(state0, task8, LR)
    out["step"] = {"loss": loss8, "params": s8.params, "count": s8.opt_state["count"]}
    # the ranks hold bitwise-equal states: replicate's check raises otherwise
    replicate_multihost(s8.params, mesh, check=True)
    replicate_multihost(s8.opt_state["mu"], mesh, check=True)

    padded, n_real = pad_batch_to_multiple(task3, world)
    s3, loss3 = step(state0, padded, LR)
    out["uneven"] = {"n_real": n_real, "batch": padded.batch_size, "loss": loss3,
                     "params": s3.params}

    # the last rank's rows poisoned: every rank skips the step
    per = task8.batch_size // world
    yt = task8.yt.clone()
    yt[(world - 1) * per:] = float("nan")
    s_nan, loss_nan = step(s8, dataclasses.replace(task8, yt=yt), LR)
    out["nan"] = {"loss": loss_nan,
                  "unchanged": all(torch.equal(s_nan.params[k], s8.params[k]) for k in s8.params)
                  and all(torch.equal(s_nan.opt_state[m][k], s8.opt_state[m][k])
                          for m in ("mu", "nu") for k in s8.params),
                  "count": s_nan.opt_state["count"]}

    # a replicated check that must fail: rank 0 alone perturbs a parameter
    bad = {k: v.clone() for k, v in s8.params.items()}
    if rank == 0:
        bad["ls_decoder"] += 1.0
    try:
        replicate_multihost(bad, mesh, check=True)
        out["check_raised"] = False
    except ValueError:
        out["check_raised"] = True

    # Trainer.fit: batches of 3 (padded to the data axis), a checkpoint on rank 0
    model.load_state_dict(inp["params"])
    res = tr.Trainer(model, lr=LR, mesh=mesh).fit(
        train, val, n_epochs=2, batch_size=3, checkpoint_dir=f"{out_dir}/ckpt",
        verbose=False)
    out["fit"] = {"train_losses": res["train_losses"], "val_losses": res["val_losses"],
                  "params": res["final_state"].params}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(*sys.argv[1:3])
