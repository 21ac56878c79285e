"""The JAX optimizer state file, ``opt_state.msgpack``, read and written by
the port's checkpoints on the CPU.

The setting is tests/test_torch_train.py's (a cnp ConvNP, U-Net (8, 8),
internal density 32, float32, the same parameters on both sides). A JAX run
mid-training resumes in the port, and a port run resumes in the JAX
``Trainer.fit``, each from the other's checkpoint directory with no
``.pt`` file in it.

Tolerances (f32, tests/test_torch_train.py's): losses rtol 1e-5; Adam's
moments rtol 1e-4 with an atol of 1e-4 times the largest magnitude; the
parameters as (p − p_checkpoint)/lr within 2e-3 per step taken since the
checkpoint (Adam's step g/(|g| + 1e-8) amplifies the rounding of gradients
near 1e-8).
"""

import dataclasses
import os
import shutil

import flax.serialization as fser
import jax
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.task.batching import take as jtake
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu.train import checkpoint as jck
from deepsensornz_tpu.train import trainer as jtr
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train import trainer as tr
from deepsensornz_tpu_torch.train.checkpoint import (
    load_checkpoint, opt_state_from_jax, opt_state_to_jax, params_from_jax, save_checkpoint)

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
    jtrain, jval = tl(times[:8]), tl(times[8:10])
    jcfg = JConfig(unet_channels=(8, 8), likelihood="cnp", internal_density=32,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    jparams = jmodel.init(jax.random.key(0), jtake(jtrain, np.arange(2)))
    return jmodel, jparams, jtrain, jval


def _port_model(jmodel, jparams, jtrain):
    cfg = ConvNPConfig(**dataclasses.asdict(jmodel.cfg))
    model = ConvNP.from_task(cfg, TaskBatch.from_numpy(jtrain))
    model.load_state_dict(params_from_jax(jax.device_get(jparams), cfg.upsample))
    return model


def _port(tree) -> dict:
    return dict(params_from_jax(jax.device_get(tree)))


def _near(got: dict, want: dict, old: dict, steps: int):
    for k in want:
        np.testing.assert_allclose(((got[k] - old[k]) / LR).numpy(),
                                   ((want[k] - old[k]) / LR).numpy(), rtol=0,
                                   atol=2e-3 * steps, err_msg=k)


def _moments_close(got: dict, want: dict):
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-30, err_msg=k)


def test_flax_state_dict_and_optax_tuple_convert_alike(setting):
    """``opt_state_from_jax`` takes optax's tuple and flax's state dict of
    it (the form ``opt_state.msgpack`` restores to) to the same state, and
    ``opt_state_to_jax`` gives that state dict back, leaf for leaf."""
    jmodel, jparams, jtrain, _ = setting
    jstate = jtr.init_state(jmodel, None, jtrain, params=jparams)
    jstate, _ = jtr.make_train_step(jmodel, donate=False)(jstate, jtake(jtrain, np.arange(4)), LR)
    host = jax.device_get(jstate.opt_state)
    sd = fser.to_state_dict(host)
    assert list(sd) == ["0", "1", "2", "3"] and sd["0"] == sd["2"] == sd["3"] == {}
    a, b = opt_state_from_jax(host), opt_state_from_jax(sd)
    assert int(a["count"]) == int(b["count"]) == 1
    for m in ("mu", "nu"):
        assert all(torch.equal(a[m][k], b[m][k]) for k in a[m])
    back = opt_state_to_jax(a)
    restored = fser.from_state_dict(host, back)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)),
                 restored, host)
    assert np.asarray(restored[1].count).dtype == np.int32


def test_jax_checkpoint_resumes_in_the_port(setting, tmp_path):
    """Two JAX steps, ``save_checkpoint`` with the optimizer state; the
    port's ``load_checkpoint`` reads both msgpack files, and one more step
    on each side agrees: loss, parameters, Adam's moments and count."""
    jmodel, jparams, jtrain, _ = setting
    jstep = jtr.make_train_step(jmodel, weight_decay=1e-2, donate=False)
    jstate = jtr.init_state(jmodel, None, jtrain, weight_decay=1e-2, params=jparams)
    for idx in (np.arange(4), np.arange(4, 8)):
        jstate, _ = jstep(jstate, jtake(jtrain, idx), LR)
    jck.save_checkpoint(str(tmp_path), jstate.params, opt_state=jstate.opt_state,
                        step=int(jstate.step), metadata={"epoch": 0})
    assert sorted(os.listdir(tmp_path)) == ["metadata.json", "opt_state.msgpack",
                                            "params.msgpack"]
    loaded = load_checkpoint(str(tmp_path))
    assert int(loaded["opt_state"]["count"]) == 2 and loaded["metadata"]["step"] == 2
    want = opt_state_from_jax(jax.device_get(jstate.opt_state))
    for m in ("mu", "nu"):
        assert all(torch.equal(loaded["opt_state"][m][k], want[m][k]) for k in want[m])

    model = _port_model(jmodel, jparams, jtrain)
    state = tr.TrainState(params=loaded["params"], opt_state=loaded["opt_state"], step=2)
    batch = jtake(jtrain, np.array([1, 3, 5, 7]))
    jstate3, jloss = jstep(jstate, batch, LR)
    state3, loss = tr.make_train_step(model, weight_decay=1e-2)(
        state, TaskBatch.from_numpy(batch), LR)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _near(state3.params, _port(jstate3.params), state.params, steps=1)
    jopt = opt_state_from_jax(jax.device_get(jstate3.opt_state))
    assert int(state3.opt_state["count"]) == int(jopt["count"]) == 3
    _moments_close(state3.opt_state["mu"], jopt["mu"])
    _moments_close(state3.opt_state["nu"], jopt["nu"])


def test_port_checkpoint_resumes_in_the_jax_trainer(setting, tmp_path):
    """Two epochs of the port's ``Trainer.fit`` write ``params.msgpack`` and
    ``opt_state.msgpack``; the JAX ``Trainer.fit(resume_from=...)`` and the
    port's, from the same files alone, train the third epoch alike."""
    jmodel, jparams, jtrain, jval = setting
    train, val = TaskBatch.from_numpy(jtrain), TaskBatch.from_numpy(jval)
    port_dir = tmp_path / "port"
    model = _port_model(jmodel, jparams, jtrain)
    first = tr.Trainer(model, lr=LR).fit(train, val, n_epochs=2, batch_size=4,
                                         checkpoint_dir=str(port_dir), verbose=False)
    assert {"opt_state.msgpack", "params.msgpack"} <= set(os.listdir(port_dir))
    # the JAX layout alone: no .pt file
    jax_only = tmp_path / "jax_only"
    shutil.copytree(port_dir, jax_only)
    for name in ("params.pt", "opt_state.pt"):
        (jax_only / name).unlink()
    ck = load_checkpoint(str(jax_only))
    epoch, step = ck["metadata"]["epoch"], ck["metadata"]["step"]
    assert int(ck["opt_state"]["count"]) == step == 2 * (epoch + 1)

    jres = jtr.Trainer(jmodel, lr=LR).fit(jtrain, jval, n_epochs=3, batch_size=4,
                                          resume_from=str(jax_only), verbose=False)
    pres = tr.Trainer(_port_model(jmodel, jparams, jtrain), lr=LR).fit(
        train, val, n_epochs=3, batch_size=4, resume_from=str(jax_only), verbose=False)
    assert jres["train_losses"][: epoch + 1] == first["train_losses"][: epoch + 1]
    np.testing.assert_allclose(pres["train_losses"], jres["train_losses"], rtol=1e-5)
    np.testing.assert_allclose(pres["val_losses"], jres["val_losses"], rtol=1e-5)
    assert int(jres["final_state"].step) == pres["final_state"].step == 6
    _near(pres["final_state"].params, _port(jres["final_state"].params), ck["params"],
          steps=6 - step)


def test_save_checkpoint_writes_the_jax_opt_state_on_request(setting, tmp_path):
    """With ``flax_upsample`` the optimizer state is written for JAX too and
    loads in the JAX ``load_checkpoint`` with the JAX state as template;
    without it only the port's files are written; ``opt_state.pt`` wins
    where both exist."""
    jmodel, jparams, jtrain, _ = setting
    model = _port_model(jmodel, jparams, jtrain)
    state, _ = tr.make_train_step(model)(tr.init_state(model),
                                         TaskBatch.from_numpy(jtake(jtrain, np.arange(4))), LR)
    save_checkpoint(str(tmp_path / "a"), state.params, state.opt_state, step=1)
    assert "opt_state.msgpack" not in os.listdir(tmp_path / "a")
    save_checkpoint(str(tmp_path / "b"), state.params, state.opt_state, step=1,
                    flax_upsample=model.cfg.upsample)
    template = jtr.init_state(jmodel, None, jtrain, params=jparams)
    jl = jck.load_checkpoint(str(tmp_path / "b"), template.params, template.opt_state)
    got = opt_state_from_jax(jax.device_get(jl["opt_state"]))
    assert int(got["count"]) == 1
    for m in ("mu", "nu"):
        assert all(torch.equal(got[m][k], state.opt_state[m][k]) for k in got[m])
    # both files: the port's own is read (a marker only it carries)
    marked = dict(state.opt_state, count=torch.tensor(7, dtype=torch.int32))
    torch.save(marked, tmp_path / "b" / "opt_state.pt")
    assert int(load_checkpoint(str(tmp_path / "b"))["opt_state"]["count"]) == 7
