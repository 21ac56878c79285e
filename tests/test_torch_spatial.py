"""The port's spatial partition of the internal grid (``mesh_axes``, a mesh
with a spatial axis: row blocks, the hand-written halo exchange and the
decode's sum over the blocks) against the JAX package and against one
process of the port, on the CPU.

- Each convolution kind of the U-Net on a block, its halo rows sliced
  from the whole input in this process: exactly the block's rows of the
  whole convolution, within f32 rounding (1e-6 of the largest value), at
  every cut of a 4-block split.
- The block rule (``mesh.row_blocks``).
- tests/test_parallel.py's density-256 case (U-Net (8, 8, 8, 8), gnp rank
  64, 2 tasks) in 4 gloo processes on a (1, 4) and a (2, 2) mesh: the loss
  within rel 2e-5 of JAX's single-device loss, every gradient within rtol
  5e-4 / atol 5e-5 of its largest magnitude (that test's bounds).
- tests/test_parallel.py's inference setting (U-Net (8, 8), gnp rank 4,
  density 32, 8 tasks) in 2 gloo processes on a (1, 2) mesh: one train
  step under every remat policy, its parameters within rtol 2e-5 / atol
  1e-6 of JAX's step on its (2, 4) mesh (tests/test_multihost.py's bound);
  ``predict_grid`` within rtol 2e-5 / atol 1e-6 and ``ar_sample`` within
  5e-4 / 1e-5 of one process of the port on the same draws
  (tests/test_parallel.py's bounds); a ``Train`` run written under the
  mesh, served by the JAX ``load_run``.
- The AL chain on a (1, 4) mesh: the placements within atol 1e-6 of the
  unsharded run. JAX runs its AL case on 8 spatial devices; the port uses
  4, so that no group of 8 processes runs here.

The workers (``tests/_torch_spatial_worker.py``) import the port only; a
group has 120 s. The ranks of a group return the same numbers, bitwise.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer.predict import Predictor as JPredictor
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.parallel import mesh as jmesh
from deepsensornz_tpu.pipeline.validate import load_run as jload_run
from deepsensornz_tpu.task.batching import take as jtake
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu.train import trainer as jtr
from deepsensornz_tpu_torch.al import GreedyAlgorithm
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle as port_synthetic_bundle
from deepsensornz_tpu_torch.infer import ar
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.models.unet import UNet
from deepsensornz_tpu_torch.parallel.halo import SpatialContext, _pack, conv_halo, transpose_halo
from deepsensornz_tpu_torch.parallel.mesh import row_blocks
from deepsensornz_tpu_torch.pipeline.validate import load_run
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

from _torch_groups import run_group

WORKER = Path(__file__).resolve().parent / "_torch_spatial_worker.py"
LR = 1e-3
SPATIAL = (jmesh.DATA_AXIS, jmesh.SPATIAL_AXIS)
RUN = dict(run_size=dict(n_times=10, base_hw=(24, 24), dem_hw=(96, 96), n_stations=20),
           run_model=dict(unet_channels=(8, 8), compute_dtype="float32", decoder_channels=8,
                          mlp_hidden=8),
           run_fit=dict(n_epochs=2, batch_size=4, lr=1e-3, verbose=False))


def _field(f) -> Field:
    return Field(f.data, f.dims, f.coords, f.name, dict(f.attrs))


def _loader(dem, base, stations, density):
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    aux = dp(dem.fillna(0.0).rename("elevation"), method="min_max")
    tl = TaskLoader(context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
                    target=dp(stations), aux_at_targets=aux, internal_density=density,
                    grid_multiple=16)
    return tl, dp, aux


# -- each conv on a block ----------------------------------------------------------


class _Sliced(SpatialContext):
    """A block's context whose exchange slices every rank's edge rows from
    the whole input held in this process."""

    def __init__(self, whole, index, bounds):
        super().__init__(None, index, bounds)
        object.__setattr__(self, "whole", whole)

    def all_gather(self, t):
        K = t.shape[2] // 2
        return [_pack(self.whole[:, :, a:b], K) for a, b in zip(self.bounds[:-1], self.bounds[1:])]


CONVS = [("down_0", 0), ("down_1", 1), ("down_2", 2), ("bottleneck", 3), ("up_2", 3),
         ("up_mix_2", 2), ("up_1", 2), ("up_mix_1", 1), ("up_0", 1), ("up_mix_0", 0)]


@pytest.mark.parametrize("top_kernel", [None, 3])
@pytest.mark.parametrize("name,level", CONVS)
def test_conv_on_a_block_equals_the_whole_conv(name, level, top_kernel):
    """Stride 1, stride-2 down, transposed up, and level 0's k=3 under
    ``top_kernel=3``: every block of a 4-block split of a 64-row grid (units
    of 8 rows) gives the whole conv's rows."""
    torch.manual_seed(0)
    unet = UNet(3, (4, 4, 4), 4, 5, torch.float32, "transpose", top_kernel)
    conv = getattr(unet, name)
    H, W = 64 >> level, 40 >> level
    x = torch.randn(2, conv.in_channels, H, W).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = conv(x)
        bounds = tuple(a >> level for a, _ in row_blocks(64, 4, 8)) + (H,)
        got = [conv(x[:, :, a:b], _Sliced(x, r, bounds))
               for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    scale = float(want.abs().max())
    for r, g in enumerate(got):
        a, b = (bounds[r] * want.shape[2]) // H, (bounds[r + 1] * want.shape[2]) // H
        assert g.shape == want[:, :, a:b].shape
        assert float((g - want[:, :, a:b]).abs().max()) <= 1e-6 * scale, f"block {r}"


def test_halo_sizes_follow_kernel_stride_and_padding():
    assert conv_halo(5, 1, 2) == (2, 2)
    assert conv_halo(5, 2, 1) == (1, 2)   # flax SAME pads (1, 2) at stride 2
    assert conv_halo(3, 1, 1) == (1, 1)
    assert conv_halo(3, 2, 0) == (0, 1)
    assert conv_halo(1, 1, 0) == (0, 0)
    assert transpose_halo(5, 2, 1) == (1, 1, 3)
    assert transpose_halo(3, 2, 0) == (1, 0, 2)


def test_row_blocks():
    assert row_blocks(608, 2, 16) == ((0, 304), (304, 608))
    assert row_blocks(608, 4, 16) == ((0, 160), (160, 320), (320, 464), (464, 608))
    assert row_blocks(64, 1, 16) == ((0, 64),)
    with pytest.raises(ValueError, match="too few for 5 spatial ranks"):
        row_blocks(64, 5, 16)
    with pytest.raises(ValueError, match="units of 16"):
        row_blocks(600, 2, 16)


# -- the settings ------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    """tests/test_parallel.py's density-256 model and its single-device
    loss and gradients."""
    base, dem, stations = synthetic_bundle(n_times=2, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    tl, _, _ = _loader(dem, base, stations, 256)
    jcfg = JConfig(unet_channels=(8, 8, 8, 8), likelihood="gnp", rank=64,
                   internal_density=256, decoder_channels=8, mlp_hidden=8,
                   compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    jtask = tl(list(base.coords["time"][:2]))
    assert len(np.asarray(jtask.x1g)) >= 320
    jparams = jmodel.init(jax.random.key(0), jtask)
    loss, grads = jax.value_and_grad(jmodel.loss)(jparams, jtask)
    return {"cfg": dataclasses.asdict(jcfg), "task": TaskBatch.from_numpy(jtask),
            "params": params_from_jax(jax.device_get(jparams), jcfg.upsample),
            "loss": float(loss), "grads": params_from_jax(jax.device_get(grads), jcfg.upsample)}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tests/test_parallel.py's inference setting, with its DEM as the
    prediction grid and its AL candidates."""
    base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    tl, jdp, jaux = _loader(dem, base, stations, 32)
    jtask = tl(list(base.coords["time"][:8]))
    jcfg = JConfig(unet_channels=(8, 8), likelihood="gnp", rank=4, internal_density=32,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    jparams = JConvNP(jcfg).init(jax.random.key(0), jtake(jtask, np.arange(1)))
    path = tmp_path_factory.mktemp("dp") / "data_processor.json"
    jdp.save(str(path))
    cand = np.stack(np.meshgrid(np.linspace(0.2, 0.8, 4), np.linspace(0.2, 0.8, 4),
                                indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    task = TaskBatch.from_numpy(jtask)
    return {"jcfg": jcfg, "jparams": jparams, "jtask": jtask, "cfg": dataclasses.asdict(jcfg),
            "params": params_from_jax(jax.device_get(jparams), jcfg.upsample), "task": task,
            "dp": DataProcessor.load(str(path)), "dem": _field(dem), "aux": _field(jaux),
            "st_col": [c for c in stations.columns if c.endswith("_station")][0],
            "al_task": TaskBatch.from_numpy(jtake(jtask, np.arange(1))), "cand": cand,
            "cand_aux": np.zeros((len(cand), jtask.yt_aux.shape[-1]), np.float32)}


def _model(s: dict, **changes) -> ConvNP:
    model = ConvNP.from_task(ConvNPConfig(**dict(s["cfg"], **changes)), s["task"])
    model.load_state_dict(s["params"])
    return model


@pytest.fixture(scope="module")
def four(dense, small, tmp_path_factory):
    inputs = {"cfg256": dense["cfg"], "params256": dense["params"], "task256": dense["task"],
              **{k: small[k] for k in ("cfg", "params", "task", "al_task", "cand",
                                       "cand_aux")}}
    return run_group(inputs, 4, tmp_path_factory.mktemp("spatial4"), "torchrun", mode="grads",
                     worker=WORKER)


@pytest.fixture(scope="module")
def two(small, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial2")
    inputs = {k: small[k] for k in ("cfg", "params", "task", "dp", "dem", "aux", "st_col")}
    inputs.update(RUN, run_dir=str(tmp / "run"))
    ranks = run_group(inputs, 2, tmp, "jax", mode="step", worker=WORKER)
    return {"ranks": ranks, "run_dir": str(tmp / "run")}


def _ranks_equal(ranks, get):
    a = get(ranks[0])
    for r in ranks[1:]:
        b = get(r)
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_global_mesh_with_a_spatial_axis(four):
    """tests/test_parallel.py's ``make_global_mesh`` case over 4 processes:
    a spatial group is consecutive ranks, 608 rows split 304/304."""
    for rank, r in enumerate(four):
        g = r["global_mesh"]
        assert g["shape"] == (2, 2) and g["raised"]
        assert g["spatial"] == (rank % 2, 2) and g["data"] == (rank // 2, 2)
        assert g["block"] == ((0, 304), (304, 608))[rank % 2]


# -- density 256 against JAX ------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_density256_loss_and_gradients_match_jax(four, dense, shape):
    for r in four:
        got = r[shape]
        assert float(got["loss"]) == pytest.approx(dense["loss"], rel=2e-5)
        assert got["grads"].keys() == dense["grads"].keys()
        for k, want in dense["grads"].items():
            want = want.numpy()
            scale = max(float(np.abs(want).max()), 1e-8)
            np.testing.assert_allclose(got["grads"][k].numpy(), want, rtol=5e-4,
                                       atol=5e-5 * scale, err_msg=k)
    _ranks_equal(four, lambda r: r[shape]["grads"])


# -- the train step against JAX's mesh step ------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh_step(small):
    """JAX's train step on its (2, 4) mesh with ``mesh_axes`` set."""
    jmodel = JConvNP(dataclasses.replace(small["jcfg"], mesh_axes=SPATIAL))
    mesh = jmesh.make_mesh(n_data=2, n_spatial=4)
    with jax.set_mesh(mesh):
        state = jtr.init_state(jmodel, None, small["jtask"], params=small["jparams"])
        s, loss = jtr.make_train_step(jmodel, donate=False)(
            state, jmesh.shard_task(small["jtask"], mesh), LR)
        return {"loss": float(loss), "params": params_from_jax(jax.device_get(s.params))}


@pytest.mark.parametrize("policy", ["off", None, "acts", "dots"])
def test_step_matches_jax_mesh_step(two, jax_mesh_step, policy):
    ranks = two["ranks"]
    for r in ranks:
        got = r[f"step_{policy}"]
        assert float(got["loss"]) == pytest.approx(jax_mesh_step["loss"], rel=2e-5)
        for k, want in jax_mesh_step["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=k)
        # forward and backward exchanges, the recomputation's too
        assert got["stats"]["exchanges"] >= 2 * 7 and got["stats"]["sums"] == 1
    _ranks_equal(ranks, lambda r: r[f"step_{policy}"]["params"])


# -- serving against one process ----------------------------------------------------


def test_predict_grid_matches_one_process(two, small):
    one = Predictor(_model(small).eval(), small["dp"], small["st_col"]).predict_grid(
        small["task"], small["dem"], aux_at_targets=small["aux"])
    for r in two["ranks"]:
        for k in ("mean", "std"):
            got, want = r["grid"][k], one[k].data
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            assert np.isfinite(want).any()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6, err_msg=k)
        # 7 convs with k > 1, each one exchange; one decode sum
        assert r["grid_stats"]["exchanges"] == 7 and r["grid_stats"]["sums"] == 1
    _ranks_equal(two["ranks"], lambda r: r["grid"]["mean"])


def test_ar_sample_matches_one_process(two, small):
    want = ar.ar_sample(_model(small).eval(), small["task"], n_samples=1, n_blocks=3,
                        generator=torch.Generator().manual_seed(5))
    mask = small["task"].yt_mask.numpy() > 0
    for r in two["ranks"]:
        np.testing.assert_allclose(r["ar"][0][mask], want[0][mask], rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["exhaustive", "fast"])
def test_al_placements_match_the_unsharded_run(four, small, mode):
    want = GreedyAlgorithm(_model(small).eval(), mode=mode).run(
        small["al_task"], small["cand"], n_placements=2, candidate_aux=small["cand_aux"])
    for r in four:
        np.testing.assert_allclose(r[f"al_{mode}"]["placements"], want["placements"], atol=1e-6)
    _ranks_equal(four, lambda r: r[f"al_{mode}"]["placements"])


def test_run_trained_on_a_spatial_mesh_serves_in_jax(two):
    """Rank 0 wrote the run; its config has no ``mesh_axes`` (as the JAX
    ``Train`` saves it), and the JAX ``load_run`` serves it as the port's
    ``load_run`` does."""
    run_dir = two["run_dir"]
    with open(os.path.join(run_dir, "metadata.json")) as f:
        assert "mesh_axes" not in json.load(f)["model_config"]
    losses = [r["run"]["train_losses"] for r in two["ranks"]]
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
    jrun = jload_run(run_dir)
    port = load_run(run_dir, device="cpu")
    for k, v in params_from_jax(jax.device_get(jrun["params"])).items():
        assert torch.equal(port["params"][k], v), k
        assert torch.equal(two["ranks"][0]["run"]["params"][k], v), k
    tl, ptl = jrun["task_loader"], port["task_loader"]
    times = list(two["ranks"][0]["run"]["times"][:2])
    want = JPredictor(jrun["model"], jrun["params"], jrun["data_processor"],
                      tl.target_var_IDs).predict_grid(
        tl(times, seed_override=3), synthetic_bundle(**RUN["run_size"])[1].coarsen(2),
        aux_at_targets=tl.aux_at_targets)
    got = Predictor(port["model"], port["data_processor"], ptl.target_var_IDs).predict_grid(
        ptl(times, seed_override=3), port_synthetic_bundle(**RUN["run_size"])[1].coarsen(2),
        aux_at_targets=ptl.aux_at_targets)
    for key in ("mean", "std"):
        a, b = got[key].data, np.asarray(want[key].data)
        assert np.isfinite(a).any()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.nanmax(np.abs(b))))
