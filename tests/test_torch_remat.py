"""The port's remat policies against ``remat=False`` and against the JAX
package's ``remat_policy`` on the CPU.

The setting is tests/test_torch_train.py's: synthetic NZ-like data through
the JAX ``TaskLoader``, a ConvNP with a U-Net (8, 8) at internal density 32
in float32, the same parameters on both sides (``params_from_jax``).

Tolerances (f32, stated where used):
- against ``remat=False`` in the port: the loss exactly (the forward is
  the same computation). None and ``"dots"`` recompute the same operations
  in the same order: their gradients are bitwise equal. ``"acts"`` runs the
  stem in two blocks, so the stem's gradients, and the encoder's through
  them, are a sum of two products where ``remat=False`` has one product of
  a sum: within rtol 1e-5 and an atol of 1e-5 times the tensor's largest
  magnitude (the length-scale gradient, a sum that cancels, moves by
  3.4e-6 of its value here).
- against JAX with the same policy: tests/test_torch_train.py's bounds
  (loss rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-4 times the
  largest magnitude; one train step's update (p_new − p)/lr within 2e-3).
"""

import dataclasses

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
from deepsensornz_tpu.train import trainer as jtr
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.models.unet import UNet
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train import trainer as tr
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

LR = 1e-3
POLICIES = [None, "acts", "dots"]


@pytest.fixture(scope="module")
def jtasks():
    base, dem, stations = synthetic_bundle(n_times=4, base_hw=(16, 16), dem_hw=(48, 48),
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
    return tl(list(base.coords["time"]))


_JAX_PARAMS = {}


def _jax_params(jtasks, likelihood):
    """The JAX ConvNP's initial parameters (the same tree with and without
    remat), initialised once per head."""
    if likelihood not in _JAX_PARAMS:
        jcfg = JConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=32,
                       rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
        _JAX_PARAMS[likelihood] = jax.jit(JConvNP(jcfg).init)(jax.random.key(0),
                                                              jtake(jtasks, np.arange(2)))
    return _JAX_PARAMS[likelihood]


def _models(jtasks, policy, likelihood="gnp"):
    """(JAX model with the policy, its params, port remat=False, port with
    the policy), all from the same parameters."""
    jcfg = JConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=32, rank=4,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32",
                   remat=True, remat_policy=policy)
    jmodel = JConvNP(jcfg)
    jparams = _jax_params(jtasks, likelihood)
    cfg = ConvNPConfig(**dataclasses.asdict(jcfg))
    sd = params_from_jax(jax.device_get(jparams), cfg.upsample)
    task = TaskBatch.from_numpy(jtasks)
    plain = ConvNP.from_task(dataclasses.replace(cfg, remat=False), task)
    remat = ConvNP.from_task(cfg, task)
    for m in (plain, remat):
        m.load_state_dict(sd, strict=True)
    return jmodel, jparams, plain, remat


def _loss_grads(model, task):
    loss = model.loss(task)
    names = [k for k, _ in model.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


@pytest.mark.parametrize("likelihood", ["gnp", "cnp"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_no_remat(jtasks, policy, likelihood):
    _, _, plain, remat = _models(jtasks, policy, likelihood)
    task = TaskBatch.from_numpy(jtasks)
    loss0, g0 = _loss_grads(plain, task)
    loss1, g1 = _loss_grads(remat, task)
    assert torch.equal(loss1, loss0)
    tol = 1e-5 if policy == "acts" else 0.0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=tol,
                                   atol=tol * float(g0[k].abs().max()), msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(jtasks, policy):
    """Loss and gradients, then one train step, against JAX with the same
    ``remat_policy``."""
    jmodel, jparams, _, remat = _models(jtasks, policy)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jtasks)
    loss, grads = _loss_grads(remat, TaskBatch.from_numpy(jtasks))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(params_from_jax(jax.device_get(jgrads)))
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-30, err_msg=k)

    jstate = jtr.init_state(jmodel, None, jtasks, params=jparams)
    jstate2, jstep_loss = jtr.make_train_step(jmodel, donate=False)(jstate, jtasks, LR)
    state = tr.init_state(remat)
    state2, step_loss = tr.make_train_step(remat)(state, TaskBatch.from_numpy(jtasks), LR)
    np.testing.assert_allclose(float(step_loss), float(jstep_loss), rtol=1e-5)
    jnew = dict(params_from_jax(jax.device_get(jstate2.params)))
    for k, w in jnew.items():
        np.testing.assert_allclose(((state2.params[k] - state.params[k]) / LR).numpy(),
                                   ((w - state.params[k]) / LR).numpy(), rtol=0, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_keeps_what_it_names(policy):
    """What the backward holds after the forward: None only the input,
    ``"acts"`` the tagged level outputs besides, ``"dots"`` every conv and
    product output; a U-Net without remat holds more than each."""
    torch.manual_seed(0)
    unet = UNet(3, (4, 4), 4, 3)
    x = torch.randn(2, 3, 16, 16)
    held = {}
    for name, run in (("plain", unet.raw), (policy, lambda h: unet.raw_remat(h, policy))):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            run(x.clone().requires_grad_(True)).sum().backward()
        held[name] = saved
    # the checkpoint's outer record holds its inputs and what its policy
    # keeps: count the distinct activation-shaped tensors (batch 2, 4
    # channels; a block input saved by two blocks counts once)
    n = {k: len({t.untyped_storage().data_ptr() for t in v
                 if t.dim() == 4 and t.shape[:2] == (2, 4)})
         for k, v in held.items()}
    # levels (4, 16²) → (4, 8²) → (4, 4²); tagged: down_0, down_1,
    # bottleneck, up_mix_1, up_mix_0
    expected = {None: 0, "acts": 5, "dots": None}[policy]
    if expected is not None:
        assert n[policy] == expected, n
    assert n[policy] < n["plain"], n


def test_unknown_policy_raises(jtasks):
    cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=32, rank=4, decoder_channels=8,
                       mlp_hidden=8, compute_dtype="float32", remat=True, remat_policy="all")
    with pytest.raises(ValueError, match="unknown remat_policy 'all'; use None/'dots'/'acts'"):
        ConvNP.from_task(cfg, TaskBatch.from_numpy(jtasks))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        UNet(3, (4,), 4, 3).raw_remat(torch.zeros(1, 3, 4, 4), "all")
