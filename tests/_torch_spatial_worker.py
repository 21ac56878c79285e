"""One rank of a group that runs the port's spatial partition, for
tests/test_torch_spatial.py.

    python tests/_torch_spatial_worker.py IN_FILE OUT_DIR [grads|step]

The rank, the group's size and its address come from the environment, as
``initialize_multihost`` reads them. ``grads`` (4 ranks): the loss and
every gradient of the density-256 model on a (1, 4) and a (2, 2) mesh, and
the AL chain on a (1, 4) mesh. ``step`` (2 ranks, a (1, 2) mesh): one
train step under every remat policy, ``predict_grid``, ``ar_sample`` and a
``Train`` run written to a directory. ``IN_FILE`` (``torch.save``) holds
the configs, parameters and tasks; the rank writes ``OUT_DIR/rank{r}.pt``.
Imports the port only.
"""

import sys

import torch

from deepsensornz_tpu_torch.al import GreedyAlgorithm
from deepsensornz_tpu_torch.infer import ar
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.perf import spans
from deepsensornz_tpu_torch.parallel.mesh import (
    data_shard, make_mesh, row_block, spatial_shard)
from deepsensornz_tpu_torch.parallel.multihost import initialize_multihost, make_global_mesh
from deepsensornz_tpu_torch.train import trainer as tr

LR = 1e-3
SPATIAL = ("data", "spatial")


def _model(cfg: dict, params: dict, task, **changes) -> ConvNP:
    model = ConvNP.from_task(ConvNPConfig(**dict(cfg, mesh_axes=SPATIAL, **changes)), task)
    model.load_state_dict(params)
    return model


def grads(inp: dict, out: dict) -> None:
    mesh = make_global_mesh(n_spatial=2)
    out["global_mesh"] = {"shape": tuple(mesh.shape), "spatial": spatial_shard(mesh),
                          "data": data_shard(mesh), "block": row_block(mesh, 608, 16)}
    try:
        make_global_mesh(n_spatial=3)
        out["global_mesh"]["raised"] = False
    except ValueError:
        out["global_mesh"]["raised"] = True
    task = inp["task256"]
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape)
        model = _model(inp["cfg256"], inp["params256"], task)
        loss, g = tr.shard_loss_and_grads(model, task, mesh)
        out[shape] = {"loss": loss, "grads": g}
    mesh = make_mesh(1, 4)
    model = _model(inp["cfg"], inp["params"], inp["task"]).eval()
    for mode in ("exhaustive", "fast"):
        res = GreedyAlgorithm(model, mode=mode, mesh=mesh).run(
            inp["al_task"], inp["cand"], n_placements=2, candidate_aux=inp["cand_aux"])
        out[f"al_{mode}"] = {"placements": res["placements"],
                             "history": res["acquisition_history"]}


def halo_counts() -> dict:
    """The spatial collectives' counters since the last reset: exchanges,
    exchange_bytes, sums, sum_bytes."""
    counts = spans.counters("halo.")
    return {k: counts.get(f"halo.{k}", 0) for k in ("exchanges", "exchange_bytes", "sums",
                                                     "sum_bytes")}


def step(inp: dict, out: dict) -> None:
    mesh = make_mesh(1, 2)
    task = inp["task"]
    for policy in ("off", None, "acts", "dots"):
        kw = {"remat": False} if policy == "off" else {"remat": True, "remat_policy": policy}
        model = _model(inp["cfg"], inp["params"], task, **kw)
        spans.reset("halo.")
        s, loss = tr.make_train_step(model, mesh=mesh)(tr.init_state(model), task, LR)
        out[f"step_{policy}"] = {"loss": loss, "params": s.params, "stats": halo_counts()}
    model = _model(inp["cfg"], inp["params"], task).eval()
    pred = Predictor(model, inp["dp"], inp["st_col"])
    spans.reset("halo.")
    grid = pred.predict_grid(task, inp["dem"], aux_at_targets=inp["aux"], mesh=mesh)
    out["grid"] = {k: grid[k].data for k in ("mean", "std")}
    out["grid_stats"] = halo_counts()
    gen = torch.Generator().manual_seed(5)
    out["ar"] = ar.ar_sample(model, task, n_samples=1, n_blocks=3, generator=gen, mesh=mesh)
    out["run"] = train_run(inp, mesh)


def train_run(inp: dict, mesh) -> dict:
    """A ``Train`` run of a synthetic bundle on the mesh, written to
    ``inp["run_dir"]`` by rank 0."""
    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.pipeline.train import Train

    base, dem, stations = synthetic_bundle("temperature", **inp["run_size"])
    bundle = PreprocessForDownscaling("temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4)
    t = Train(bundle, device="cpu")
    t.setup_task_loader(internal_density=24)
    t.initialise_model(likelihood="cnp", mesh_axes=SPATIAL, **inp["run_model"])
    res = t.train_model(model_dir=inp["run_dir"], mesh=mesh, **inp["run_fit"])
    return {"train_losses": res["train_losses"], "val_losses": res["val_losses"],
            "params": res["params"], "times": t.task_times()}


def main(in_file: str, out_dir: str, mode: str) -> None:
    torch.set_num_threads(1)
    info = initialize_multihost(backend="gloo")
    inp = torch.load(in_file, weights_only=False)
    out = {"info": info}
    {"grads": grads, "step": step}[mode](inp, out)
    torch.save(out, f"{out_dir}/rank{info['process_index']}.pt")


if __name__ == "__main__":
    main(*sys.argv[1:4])
