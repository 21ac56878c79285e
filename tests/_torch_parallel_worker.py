"""One rank of a data-parallel group of the port, for
tests/test_torch_parallel.py (``train``) and tests/test_torch_dp_serve.py
(``serve``).

    python tests/_torch_parallel_worker.py IN_FILE OUT_DIR [train|serve]

The rank, the group's size and its address come from the environment, in
the JAX package's names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) or torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), as ``initialize_multihost``
reads them. ``IN_FILE`` (``torch.save``) holds the model config, its
parameters and the tasks (and, to serve, the grid, the processor and the
draws to feed the samplers); the rank writes ``OUT_DIR/rank{r}.pt``.
Imports the port only.
"""

import dataclasses
import sys

import numpy as np
import torch

from deepsensornz_tpu_torch.infer import ar
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.parallel.mesh import (
    make_mesh, mesh_device, pad_batch_to_multiple, shard_task, task_shardings)
from deepsensornz_tpu_torch.parallel.multihost import (
    initialize_multihost, replicate_multihost, shard_batch_for_host, shard_task_multihost)
from deepsensornz_tpu_torch.task.batching import take
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
    for m, key in ((mesh, "check_raised"), (None, "check_raised_no_mesh")):
        try:
            replicate_multihost(bad, m, check=True)
            out[key] = False
        except ValueError:
            out[key] = True
    # without a mesh the flag goes on the group's device (the CPU under gloo)
    same = replicate_multihost(s8.params, None, check=True)
    out["replicated_no_mesh"] = all(torch.equal(same[k], v) for k, v in s8.params.items())

    # Trainer.fit: batches of 3 (padded to the data axis), a checkpoint on rank 0
    model.load_state_dict(inp["params"])
    res = tr.Trainer(model, lr=LR, mesh=mesh).fit(
        train, val, n_epochs=2, batch_size=3, checkpoint_dir=f"{out_dir}/ckpt",
        verbose=False)
    out["fit"] = {"train_losses": res["train_losses"], "val_losses": res["val_losses"],
                  "params": res["final_state"].params}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def serve(in_file: str, out_dir: str) -> None:
    """Every data-parallel serving case on one group: ``predict_grid`` (8
    tasks; 7 tasks, padded; 2 samples; 8 tasks in int16 chunks of 3, the
    tail chunk padded; 2 samples with the draws given), ``predict_points``,
    ``ar_sample`` (the generator's draws, and with the mean fed back in a
    fixed visit order) and ``ar_sample_grid``."""
    torch.set_num_threads(1)
    info = initialize_multihost(backend="gloo")
    mesh = make_mesh()
    inp = torch.load(in_file, weights_only=False)
    task, dem, aux, dp, col = inp["task8"], inp["dem"], inp["aux"], inp["dp"], inp["st_col"]
    model = ConvNP.from_task(ConvNPConfig(**inp["cfg"]), task, device=mesh_device(mesh))
    model.load_state_dict(inp["params"])
    model.eval()
    pred = Predictor(model, dp, col)
    kw = dict(aux_at_targets=aux, mesh=mesh)
    seven = take(task, np.arange(7))  # padded to the data axis by the mesh
    out = {"info": info}
    grid = pred.predict_grid(task, dem, **kw)
    out["grid"] = {k: grid[k].data for k in ("mean", "std")}
    out["grid7"] = {k: v.data for k, v in pred.predict_grid(seven, dem, **kw).items()}
    out["samples"] = pred.predict_grid(task, dem, n_samples=2, seed=3, **kw)["samples"].data
    chunked = Predictor(model, dp, col, batch_chunk=3, transfer_dtype="int16")
    out["int16"] = {k: v.data for k, v in chunked.predict_grid(
        task, dem, n_samples=2, seed=3, **kw).items()}
    out["points"] = pred.predict_points(task, mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    out["ar"] = ar.ar_sample(model, task, n_samples=2, n_blocks=3, generator=gen, mesh=mesh)
    out["ar_grid"] = pred.ar_sample_grid(task, dem, aux_at_targets=aux, n_samples=1,
                                         subsample_factor=8, n_blocks=3, seed=2, mesh=mesh)
    # a head whose draws read the values: the batch's raw outputs gathered first
    mixed = ConvNP.from_task(ConvNPConfig(**dict(inp["cfg"], likelihood="bernoulli-gamma")),
                             task, generator=torch.Generator().manual_seed(1)).eval()
    out["mixed"] = Predictor(mixed, dp, col).predict_grid(
        task, dem, n_samples=2, seed=4, unnormalise=False, sea_mask=False, **kw)["samples"].data

    # the samplers fed the given draws (the whole batch's, as JAX draws them)
    e1, e2 = (torch.from_numpy(d) for d in inp["draws"])

    def given(self, raw, generator, n):
        assert raw.shape[:-1] == e1.shape[1:-1] and n == e1.shape[0]
        return e1, e2

    saved = tlik.LowRankGaussian.draw, tlik.LowRankGaussian.transform, torch.randperm
    tlik.LowRankGaussian.draw = given
    try:
        out["fed"] = pred.predict_grid(task, dem, n_samples=e1.shape[0], seed=0, unnormalise=False,
                                       sea_mask=False, **kw)["samples"].data
        # the mean fed back in the identity visit order: deterministic chains
        tlik.LowRankGaussian.draw = saved[0]
        tlik.LowRankGaussian.transform = lambda self, raw, draws: self.mean_std(raw)[0][None]
        torch.randperm = lambda m, generator=None, device=None: torch.arange(m, device=device)
        out["ar_mean"] = ar.ar_sample(model, task, n_samples=1, n_blocks=3, mesh=mesh)
        out["ar_grid_mean"] = Predictor(model, dp, col, std_scale=1.4).ar_sample_grid(
            task, dem, aux_at_targets=aux, subsample_factor=8, n_blocks=3, mesh=mesh)
    finally:
        tlik.LowRankGaussian.draw, tlik.LowRankGaussian.transform, torch.randperm = saved
    torch.save(out, f"{out_dir}/rank{info['process_index']}.pt")


if __name__ == "__main__":
    {"train": main, "serve": serve}[sys.argv[3] if len(sys.argv) > 3 else "train"](
        *sys.argv[1:3])
