"""The port's data parallelism (``parallel.mesh``, ``parallel.multihost``,
``make_train_step(mesh=)``, ``Trainer(mesh=)``) against the JAX package on
the CPU.

The setting is tests/test_parallel.py's: synthetic NZ-like data through the
JAX ``TaskLoader`` (8 tasks), a cnp ConvNP with a U-Net (8, 8) at internal
density 32 in float32, the same parameters on both sides. JAX runs its
data-parallel step on the 8-device virtual CPU mesh (``tests/conftest.py``);
the port runs in 2 and 4 processes (gloo, one CPU each,
``tests/_torch_parallel_worker.py``, which imports the port only), the
2-process group started from the JAX package's environment names and the
4-process one from torchrun's. Each group has 120 s: a hung rendezvous fails
its test.

Tolerances (f32): against JAX, its own for its data-parallel step
(tests/test_parallel.py: the loss rel 1e-5, ``head_out``'s updated kernel
rtol 1e-5 / atol 1e-7) and, for every parameter, tests/test_torch_train.py's
bound on the update (p_new − p)/lr, 2e-3: Adam's first step
g/(|g| + 1e-8) turns the two packages' rounding of a gradient near 0 into
~1e-6 of a parameter. The port's group against the port's one process:
every parameter rtol 1e-5 / atol 1e-7. The ranks of a group against each
other: bitwise.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.parallel import mesh as jmesh
from deepsensornz_tpu.task.batching import take as jtake
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu.train import trainer as jtr
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.parallel import mesh as pmesh
from deepsensornz_tpu_torch.parallel import multihost
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train import trainer as tr
from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint, params_from_jax

from _torch_groups import run_group

LR = 1e-3


@pytest.fixture(scope="module")
def setting():
    base, dem, stations = synthetic_bundle(n_times=10, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    tl = TaskLoader(
        context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
        target=dp(stations),
        aux_at_targets=dp(dem.fillna(0.0).rename("elevation"), method="min_max"),
        internal_density=32, grid_multiple=16)
    times = list(base.coords["time"])
    jtask8 = tl(times[:8])
    jcfg = JConfig(unet_channels=(8, 8), likelihood="cnp", internal_density=32,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    jparams = jmodel.init(jax.random.key(0), jtake(jtask8, np.arange(1)))
    cfg = dataclasses.asdict(jcfg)
    params = params_from_jax(jax.device_get(jparams), jcfg.upsample)
    return {"jmodel": jmodel, "jparams": jparams, "jtask8": jtask8, "cfg": cfg,
            "params": params, "task8": TaskBatch.from_numpy(jtask8),
            "task3": TaskBatch.from_numpy(jtake(jtask8, np.array([5, 1, 6]))),
            "train": TaskBatch.from_numpy(jtask8), "val": TaskBatch.from_numpy(tl(times[8:10]))}


def _run_group(setting, world: int, tmp: Path, env_names: str) -> list[dict]:
    """``world`` worker processes on one free port; their outputs by rank."""
    return run_group({k: setting[k] for k in ("cfg", "params", "task8", "task3", "train", "val")},
                     world, tmp, env_names)


@pytest.fixture(scope="module")
def groups(setting, tmp_path_factory):
    out = {}
    for world, names in ((2, "jax"), (4, "torchrun")):
        tmp = tmp_path_factory.mktemp(f"group{world}")
        out[world] = {"ranks": _run_group(setting, world, tmp, names), "dir": tmp}
    return out


@pytest.fixture(scope="module")
def jax_steps(setting):
    """JAX's data-parallel step on its CPU mesh at each world size, and its
    single-device step on the 3-task batch."""
    jmodel, jparams, jtask8 = setting["jmodel"], setting["jparams"], setting["jtask8"]
    step = jtr.make_train_step(jmodel, donate=False)
    state = jtr.init_state(jmodel, None, jtask8, params=jparams)
    out = {}
    for world in (2, 4):
        mesh = jmesh.make_mesh(n_data=world, n_spatial=1)
        sharded = jmesh.shard_task(jtask8, mesh)
        with jax.set_mesh(mesh):
            s, loss = step(state, sharded, LR)
        out[world] = {"loss": float(loss), "params": params_from_jax(jax.device_get(s.params)),
                      "sharded": sharded}
    s3, loss3 = step(state, jtake(jtask8, np.array([5, 1, 6])), LR)
    out["uneven"] = {"loss": float(loss3), "params": params_from_jax(jax.device_get(s3.params))}
    return out


def _params_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _jax_close(got: dict, want: dict, old: dict):
    """JAX's own bound on ``head_out``'s kernel; the update bound on all."""
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["head_out.weight"].numpy(), want["head_out.weight"].numpy(),
                               rtol=1e-5, atol=1e-7)
    for k in want:
        np.testing.assert_allclose(((got[k] - old[k]) / LR).numpy(),
                                   ((want[k] - old[k]) / LR).numpy(), rtol=0, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_rows_each_rank_gets_equal_jax_shards(setting, groups, jax_steps, world):
    ranks = groups[world]["ranks"]
    sharded = jax_steps[world]["sharded"]
    for name, get in (("xt", lambda t: t.xt), ("yt_mask", lambda t: t.yt_mask),
                      ("points.0.x", lambda t: t.points[0].x),
                      ("grids.0.y", lambda t: t.grids[0].y)):
        shards = sorted(get(sharded).addressable_shards, key=lambda s: s.index[0].start or 0)
        assert len(shards) == world
        for r, s in enumerate(shards):
            np.testing.assert_array_equal(ranks[r]["shard"][name].numpy(), np.asarray(s.data),
                                          err_msg=f"rank {r} {name}")
    for r in range(world):
        # the coordinate vectors are whole on every rank
        np.testing.assert_array_equal(ranks[r]["shard"]["x1g"].numpy(), setting["task8"].x1g)
        assert ranks[r]["shard_multihost_equal"]
        assert ranks[r]["shard_for_host"] == (8 // world, r * 8 // world)
        assert ranks[r]["info"] == {"process_index": r, "process_count": world,
                                    "local_devices": 1, "global_devices": world}


def test_task_shardings_match_jax(setting):
    """The batch-dimensioned leaves are those JAX shards over the data axis."""
    mesh = jmesh.make_mesh(n_data=2, n_spatial=1)
    jspecs = jmesh.task_shardings(setting["jtask8"], mesh)
    got = pmesh.task_shardings(setting["task8"], None)
    want = {"xt": jspecs.xt, "yt": jspecs.yt, "yt_mask": jspecs.yt_mask, "yt_aux": jspecs.yt_aux,
            "x1g": jspecs.x1g, "x2g": jspecs.x2g, "points.0.x": jspecs.points[0].x,
            "points.0.y": jspecs.points[0].y, "points.0.mask": jspecs.points[0].mask}
    for i, g in enumerate(jspecs.grids):
        want.update({f"grids.{i}.x1": g.x1, f"grids.{i}.x2": g.x2, f"grids.{i}.y": g.y})
        if g.mask is not None:
            want[f"grids.{i}.mask"] = g.mask
    assert got == {k: ("data" if s.spec == jax.sharding.PartitionSpec("data") else None)
                   for k, s in want.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_pad_batch_to_multiple_matches_jax(setting, world):
    """The mesh module's padding (the batching module's, re-exported) pads
    3 tasks as JAX's does: the last task repeated, its targets masked."""
    jt = jtake(setting["jtask8"], np.array([5, 1, 6]))
    (jp, jn), (p, n) = jmesh.pad_batch_to_multiple(jt, world), pmesh.pad_batch_to_multiple(
        setting["task3"], world)
    assert n == jn == 3 and p.batch_size == jp.batch_size == world * -(-3 // world)
    want = TaskBatch.from_numpy(jp)
    for a, b in ((p.xt, want.xt), (p.yt, want.yt), (p.yt_mask, want.yt_mask),
                 (p.points[0].x, want.points[0].x), (p.grids[0].y, want.grids[0].y)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(setting, groups, jax_steps, world):
    ranks = groups[world]["ranks"]
    want = jax_steps[world]
    for r in ranks:
        np.testing.assert_allclose(float(r["step"]["loss"]), want["loss"], rtol=1e-5)
        _jax_close(r["step"]["params"], want["params"], setting["params"])
        assert int(r["step"]["count"]) == 1
    for r in ranks[1:]:
        for k, v in ranks[0]["step"]["params"].items():
            assert torch.equal(r["step"]["params"][k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_one_process(setting, groups, world):
    model = ConvNP.from_task(ConvNPConfig(**setting["cfg"]), setting["task8"])
    model.load_state_dict(setting["params"])
    state, loss = tr.make_train_step(model)(tr.init_state(model), setting["task8"], LR)
    r0 = groups[world]["ranks"][0]["step"]
    np.testing.assert_allclose(float(r0["loss"]), float(loss), rtol=1e-5)
    _params_close(r0["params"], state.params)


@pytest.mark.parametrize("world", [2, 4])
def test_uneven_padding_matches_the_unpadded_batch(setting, groups, jax_steps, world):
    """3 tasks over 2 or 4 ranks: the padding's masked tasks sit on the
    last rank, so the ranks hold different numbers of valid tasks; the
    step still equals JAX's single-device step on the 3 tasks, and the
    port's one process on them."""
    want = jax_steps["uneven"]
    model = ConvNP.from_task(ConvNPConfig(**setting["cfg"]), setting["task8"])
    model.load_state_dict(setting["params"])
    one, one_loss = tr.make_train_step(model)(tr.init_state(model), setting["task3"], LR)
    for r in groups[world]["ranks"]:
        u = r["uneven"]
        assert u["n_real"] == 3 and u["batch"] == world * -(-3 // world)
        np.testing.assert_allclose(float(u["loss"]), want["loss"], rtol=1e-5)
        _jax_close(u["params"], want["params"], setting["params"])
        np.testing.assert_allclose(float(u["loss"]), float(one_loss), rtol=1e-5)
        _params_close(u["params"], one.params)


@pytest.mark.parametrize("world", [2, 4])
def test_nan_on_one_rank_skips_the_step_on_every_rank(groups, world):
    for r in groups[world]["ranks"]:
        assert torch.isnan(r["nan"]["loss"])
        assert r["nan"]["unchanged"]
        assert int(r["nan"]["count"]) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_check_raises_on_every_rank(groups, world):
    assert all(r["check_raised"] for r in groups[world]["ranks"])


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_without_a_mesh(groups, world):
    """``replicate_multihost(mesh=None, check=True)`` all-reduces its flag
    on the process group's device (the CPU under gloo, this rank's card
    under NCCL): equal ranks pass, a rank that differs raises on every
    rank."""
    for r in groups[world]["ranks"]:
        assert r["replicated_no_mesh"]
        assert r["check_raised_no_mesh"]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_fit_matches_one_process(setting, groups, world):
    """Two epochs of ``Trainer.fit`` at batch 3 (padded to the data axis):
    the same losses and parameters as one process, the same on every rank,
    one checkpoint (rank 0's) that loads."""
    model = ConvNP.from_task(ConvNPConfig(**setting["cfg"]), setting["task8"])
    model.load_state_dict(setting["params"])
    res = tr.Trainer(model, lr=LR).fit(setting["train"], setting["val"], n_epochs=2,
                                       batch_size=3, verbose=False)
    ranks = groups[world]["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["fit"]["train_losses"], res["train_losses"], rtol=1e-5)
        np.testing.assert_allclose(r["fit"]["val_losses"], res["val_losses"], rtol=1e-5)
        _params_close(r["fit"]["params"], res["final_state"].params)
        assert r["fit"]["val_losses"] == ranks[0]["fit"]["val_losses"]
    ck = load_checkpoint(str(groups[world]["dir"] / "ckpt"))
    assert ck["metadata"]["val_losses"] == ranks[0]["fit"]["val_losses"][: ck["metadata"]["epoch"] + 1]


@pytest.fixture
def one_process_group():
    yield multihost.initialize_multihost(backend="gloo")
    dist.destroy_process_group()


def test_initialize_multihost_in_one_process(one_process_group, setting):
    assert one_process_group == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                 "global_devices": 1}
    assert multihost.initialize_multihost() == one_process_group  # a second call
    mesh = multihost.make_global_mesh()
    assert mesh.mesh_dim_names == ("data", "spatial") and mesh.shape == (1, 1)
    assert multihost.shard_batch_for_host(16) == (16, 0)
    with pytest.raises(ValueError):
        multihost.make_global_mesh(n_spatial=3)
    # one process on a mesh: the step is the plain one, bitwise
    model = ConvNP.from_task(ConvNPConfig(**setting["cfg"]), setting["task8"])
    model.load_state_dict(setting["params"])
    s0 = tr.init_state(model)
    s1, l1 = tr.make_train_step(model, mesh=mesh)(s0, setting["task8"], LR)
    s2, l2 = tr.make_train_step(model)(s0, setting["task8"], LR)
    assert torch.equal(l1, l2)
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s2.params)


def test_group_device_follows_the_backend(one_process_group):
    assert multihost.group_device() == torch.device("cpu")  # gloo
    params = {"a": torch.arange(3.0), "b": {"c": torch.ones(2)}}
    out = multihost.replicate_multihost(params, check=True)
    assert torch.equal(out["a"], params["a"]) and torch.equal(out["b"]["c"], params["b"]["c"])


def test_spatial_partition_raises(one_process_group):
    """A spatial axis is built like the data axis (tests/test_torch_spatial.py
    runs it); a mesh larger than the process group raises."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(n_spatial=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(n_data=2)
    mesh = pmesh.make_mesh(n_spatial=1)
    assert pmesh.spatial_shard(mesh) == (0, 1) and pmesh.row_block(mesh, 64, 16) == (0, 64)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        pmesh.make_mesh()
