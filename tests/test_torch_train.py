"""The port's training path against the JAX package on the CPU.

The setting is tests/test_train.py's: synthetic NZ-like data through the
JAX ``TaskLoader`` (8 training and 2 validation tasks), a ConvNP with a
U-Net (8, 8) at internal density 32 in float32. The port gets the same
tasks (``TaskBatch.from_numpy``) and the same parameters
(``params_from_jax``). Covered: ``ConvNP.loss`` with the mean anchor and
its gradients for every parameter, remat, the optimizer on identical
gradients against optax's chain, one train step and a step from a JAX
mid-run state, the finite guard, the padded tail batch, freezing,
``lengthscale_lr_mult``, the scheduler and stopper, checkpoints and resume,
and two epochs of ``Trainer.fit``.

Tolerances (f32 on both sides, stated where used): losses rtol 1e-5;
gradients rtol 1e-4 with an atol of 1e-4 times the tensor's largest
magnitude (a dozen conv layers and the SetConvs summed in different orders
by XLA and oneDNN); updated parameters as (p_new − p)/lr within 2e-3, since
Adam's step g/(|g| + 1e-8) is about ±1 per element and amplifies the
relative rounding of gradients near 1e-8.
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
from deepsensornz_tpu.parallel.mesh import pad_batch_to_multiple as jpad
from deepsensornz_tpu.task.batching import take as jtake
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu.train import trainer as jtr
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.batching import pad_batch_to_multiple, take
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train import trainer as tr
from deepsensornz_tpu_torch.train.checkpoint import (
    load_checkpoint,
    opt_state_from_jax,
    params_from_jax,
    params_to_jax,
    save_checkpoint,
    update_metadata,
)

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
    return tl(times[:8]), tl(times[8:10])


def _pair(jtasks, likelihood="cnp", **cfg_kw):
    """A JAX ConvNP and its params; the port's ConvNP loaded with them."""
    jcfg = JConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=32, rank=4,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32", **cfg_kw)
    jmodel = JConvNP(jcfg)
    jparams = jmodel.init(jax.random.key(0), jtake(jtasks, np.arange(2)))
    cfg = ConvNPConfig(**dataclasses.asdict(jcfg))
    model = ConvNP.from_task(cfg, TaskBatch.from_numpy(jtasks))
    model.load_state_dict(params_from_jax(jax.device_get(jparams), cfg.upsample), strict=True)
    return jmodel, jparams, model


def _port(tree) -> dict:
    return dict(params_from_jax(jax.device_get(tree)))


def _grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-30, err_msg=k)


def _steps_close(new: dict, old: dict, want: dict, lr=LR, atol=2e-3):
    for k in want:
        np.testing.assert_allclose(((new[k] - old[k]) / lr).numpy(),
                                   ((want[k] - old[k]) / lr).numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def _task(jtasks, idx) -> TaskBatch:
    return TaskBatch.from_numpy(jtake(jtasks, np.asarray(idx)))


# -- the loss and its gradients -----------------------------------------------------------


@pytest.mark.parametrize("likelihood,cfg_kw,anchor_scale", [
    ("gnp", {}, 1.0),                     # auto anchor 1.0
    ("cnp", {"mean_anchor": 0.5}, 0.3),   # explicit anchor, scaled
    ("bernoulli-gamma", {}, 1.0),
    ("cnp-spikes-beta", {}, 1.0),
])
def test_loss_and_grads_match_jax(setting, likelihood, cfg_kw, anchor_scale):
    jtasks, _ = setting
    jmodel, jparams, model = _pair(jtasks, likelihood, **cfg_kw)
    jbatch = jtake(jtasks, np.arange(4))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jbatch, anchor_scale)
    loss = model.loss(TaskBatch.from_numpy(jbatch), anchor_scale)
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(grads, _port(jgrads))


def test_remat_gives_identical_loss_and_grads(setting):
    jtasks, _ = setting
    _, jparams, model = _pair(jtasks, "gnp")
    # the whole U-Net recomputed (remat_policy None); each policy against
    # remat=False and against JAX: tests/test_torch_remat.py
    remat = ConvNP.from_task(dataclasses.replace(model.cfg, remat=True, remat_policy=None),
                             _task(jtasks, [0]))
    remat.load_state_dict(model.state_dict())
    task = _task(jtasks, np.arange(4))
    out = []
    for m in (model, remat):
        loss = m.loss(task)
        out.append((loss.detach(), torch.autograd.grad(loss, list(m.parameters()))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the optimizer ----------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [0.01, 50.0])  # global norm below / above 10
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adamw_matches_optax_chain(rng, grad_scale, wd):
    """The hand-written chain on identical gradients, three steps, against
    ``_adamw_core``: updates and the whole state (mu, nu, count) agree to
    f32 rounding. Above norm 10 the gradients are scaled by exactly
    10/norm (optax), not by 10/(norm + 1e-6) (torch's clip_grad_norm_)."""
    shapes = {"a": (3, 4), "b": (5,), "c": ()}
    params = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    opt = jtr._adamw_core(wd)
    jstate = opt.init(params)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = tr.adamw_init(tparams)
    for _ in range(3):
        grads = {k: np.asarray(grad_scale * rng.normal(size=s), np.float32)
                 for k, s in shapes.items()}
        jupd, jstate = opt.update(grads, jstate, params)
        tupd, tstate = tr.adamw_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                       tstate, tparams, wd)
        adam = jstate[1]
        assert int(tstate["count"]) == int(adam.count)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tstate["mu"][k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6)
            np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)


# -- the train step ----------------------------------------------------------------------


@pytest.mark.parametrize("likelihood", ["gnp", "cnp"])
def test_train_step_matches_jax(setting, likelihood):
    jtasks, _ = setting
    jmodel, jparams, model = _pair(jtasks, likelihood)
    jbatch = jtake(jtasks, np.arange(4))
    jstate = jtr.init_state(jmodel, None, jbatch, weight_decay=1e-2, params=jparams)
    jstate2, jloss = jtr.make_train_step(jmodel, weight_decay=1e-2, donate=False)(
        jstate, jbatch, LR)
    state = tr.init_state(model)
    state2, loss = tr.make_train_step(model, weight_decay=1e-2)(
        state, TaskBatch.from_numpy(jbatch), LR)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state2.step == 1 and int(state2.opt_state["count"]) == 1
    _steps_close(state2.params, state.params, _port(jstate2.params))


def test_step_from_jax_mid_run_state(setting):
    """Two JAX steps, then the JAX state carried over (params_from_jax,
    opt_state_from_jax) takes a third step in both: the loss, the new
    parameters and the Adam moments agree."""
    jtasks, _ = setting
    jmodel, jparams, model = _pair(jtasks, "gnp")
    jstep = jtr.make_train_step(jmodel, weight_decay=1e-2, donate=False)
    jstate = jtr.init_state(jmodel, None, jtasks, weight_decay=1e-2, params=jparams)
    for idx in (np.arange(4), np.arange(4, 8)):
        jstate, _ = jstep(jstate, jtake(jtasks, idx), LR)
    state = tr.TrainState(params=_port(jstate.params),
                          opt_state=opt_state_from_jax(jstate.opt_state), step=2)
    assert int(state.opt_state["count"]) == 2
    jbatch = jtake(jtasks, np.array([1, 3, 5, 7]))
    jstate3, jloss = jstep(jstate, jbatch, LR)
    state3, loss = tr.make_train_step(model, weight_decay=1e-2)(
        state, TaskBatch.from_numpy(jbatch), LR)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _steps_close(state3.params, state.params, _port(jstate3.params))
    jopt = opt_state_from_jax(jstate3.opt_state)
    assert int(state3.opt_state["count"]) == int(jopt["count"]) == 3
    _grads_close(state3.opt_state["mu"], jopt["mu"])


def _poisoned(task: TaskBatch) -> TaskBatch:
    return dataclasses.replace(task, yt=torch.full_like(task.yt, float("nan")))


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        _equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k]) for k in a)


def test_nan_loss_does_not_poison_params(setting):
    jtasks, _ = setting
    _, _, model = _pair(jtasks)
    state = tr.init_state(model)
    state2, loss = tr.make_train_step(model)(state, _poisoned(_task(jtasks, [0, 1])), LR)
    assert torch.isnan(loss)
    assert all(bool(torch.isfinite(p).all()) for p in state2.params.values())


def test_nonfinite_step_is_true_noop(setting):
    """A non-finite step moves no parameter (Adam moments and weight decay
    would, even from zeroed gradients) and leaves the whole optimizer state,
    its count included, as it was; the state's step still counts it."""
    jtasks, _ = setting
    _, _, model = _pair(jtasks)
    step = tr.make_train_step(model, weight_decay=1e-2)
    batch = _task(jtasks, [0, 1])
    state, _ = step(tr.init_state(model), batch, LR)  # moments nonzero
    state2, loss = step(state, _poisoned(batch), LR)
    assert torch.isnan(loss)
    assert _equal(state2.params, state.params), "params moved on a skipped step"
    assert _equal(state2.opt_state, state.opt_state), "opt state (incl. count) not rolled back"
    assert state2.step == state.step + 1


def test_take_and_pad_match_jax(setting):
    jtasks, _ = setting
    idx = np.array([5, 1, 6])
    jt, (jp, n_real) = jtake(jtasks, idx), jpad(jtake(jtasks, idx), 4)
    t, (p, m) = take(TaskBatch.from_numpy(jtasks), idx), pad_batch_to_multiple(
        take(TaskBatch.from_numpy(jtasks), idx), 4)
    assert n_real == m == 3
    for got, want in ((t, jt), (p, jp)):
        ref = TaskBatch.from_numpy(want)
        assert got.batch_size == ref.batch_size
        for a, b in ((got.xt, ref.xt), (got.yt, ref.yt), (got.yt_mask, ref.yt_mask),
                     (got.yt_aux, ref.yt_aux), (got.points[0].x, ref.points[0].x),
                     (got.grids[0].y, ref.grids[0].y), (got.x1g, ref.x1g)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not bool(p.yt_mask[3].any())


def test_tail_partial_batch_is_trained(setting):
    """8 tasks at batch size 5: the 3-task tail is padded with masked tasks,
    not dropped, and its loss equals the unpadded tail's."""
    jtasks, _ = setting
    _, _, model = _pair(jtasks)
    tasks = TaskBatch.from_numpy(jtasks)
    state = tr.init_state(model)
    _, losses = tr.train_epoch(model, state, tasks, batch_size=5, lr=0.0, shuffle=False,
                               step_fn=tr.make_train_step(model))
    assert len(losses) == 2
    tail = take(tasks, np.arange(5, 8))
    evaluate = tr.make_eval_step(model)
    raw_tail = float(evaluate(state.params, tail))
    assert float(evaluate(state.params, pad_batch_to_multiple(tail, 5)[0])) == pytest.approx(
        raw_tail, rel=1e-6)
    assert losses[1] == pytest.approx(raw_tail, rel=1e-6)


def test_freeze_mask_and_frozen_training(setting):
    """The same patterns select the same parameters as JAX's freeze_mask on
    the flax tree; frozen parameters keep their values while their Adam
    moments advance."""
    jtasks, _ = setting
    _, jparams, model = _pair(jtasks)
    patterns = ("unet", "ls_grid", "ls_points")
    jmask = jtr.freeze_mask(jparams, patterns)
    jsel = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0] if v}
    mask = tr.freeze_mask([k for k, _ in model.named_parameters()], patterns)
    assert {tr.flax_path(k) for k, v in mask.items() if v} == jsel
    assert mask["unet.down_0.weight"] and not mask["head_out.weight"]
    assert tr.freeze_mask(mask, (r"/ls_",))["ls_decoder"]

    state = tr.init_state(model)
    state2, _ = tr.make_train_step(model, frozen_patterns=patterns)(
        state, _task(jtasks, [0, 1]), 1e-2)
    assert torch.equal(state2.params["unet.down_0.weight"], state.params["unet.down_0.weight"])
    assert not torch.equal(state2.params["head_out.weight"], state.params["head_out.weight"])
    assert bool(state2.opt_state["mu"]["unet.down_0.weight"].any())


def test_lengthscale_lr_mult_scales_only_ls_updates(setting):
    """``lengthscale_lr_mult`` multiplies the update of the ``ls_*`` params
    exactly and leaves every other param's update bit-identical."""
    jtasks, _ = setting
    _, _, model = _pair(jtasks)
    state = tr.init_state(model)
    batch = _task(jtasks, [0, 1])
    s1, _ = tr.make_train_step(model)(state, batch, 1e-4)
    s100, _ = tr.make_train_step(model, lengthscale_lr_mult=100.0)(state, batch, 1e-4)
    checked = 0
    for k, p0 in state.params.items():
        if k.startswith("ls_"):
            d1, d100 = float(s1.params[k] - p0), float(s100.params[k] - p0)
            assert abs(d1) > 0
            # each delta is recovered as f32 (p + u) − p: one ulp(p) each
            ulp = np.finfo(np.float32).eps * max(1.0, abs(float(p0)))
            np.testing.assert_allclose(d100, 100.0 * d1, rtol=1e-4, atol=202.0 * ulp)
            checked += 1
    assert checked == 3
    assert torch.equal(s1.params["head_out.weight"], s100.params["head_out.weight"])


class _ZeroLoss(ConvNP):
    """A model whose loss is 0 and whose gradients are all zero."""

    def loss(self, task, anchor_scale=1.0):
        return sum(0.0 * p.sum() for p in self.parameters())


def test_lengthscale_lr_mult_does_not_amplify_weight_decay(setting):
    """With zero gradients the update is pure decay (−wd·lr·p); under
    mult = 100 the ls params decay at the same rate as every other param."""
    jtasks, _ = setting
    _, _, model = _pair(jtasks)
    zero = _ZeroLoss.from_task(model.cfg, _task(jtasks, [0]))
    zero.load_state_dict(model.state_dict())
    wd, lr = 0.1, 1e-2
    state = tr.init_state(zero)
    s2, _ = tr.make_train_step(zero, weight_decay=wd, lengthscale_lr_mult=100.0)(
        state, _task(jtasks, [0, 1]), lr)
    for k in ("ls_grid_0", "ls_points_0", "ls_decoder", "head_out.weight"):
        p0 = state.params[k].numpy()
        np.testing.assert_allclose(s2.params[k].numpy() - p0, -wd * lr * p0, rtol=1e-3,
                                   atol=5e-7, err_msg=k)


# -- scheduler, stopper, checkpoints, fit -------------------------------------------------


def test_plateau_scheduler():
    s = tr.PlateauScheduler(lr=1.0, factor=0.1, patience=2)
    assert s.step(1.0) == 1.0
    assert s.step(0.9) == 1.0
    s.step(0.95)
    s.step(0.95)
    assert s.step(0.95) == pytest.approx(0.1)  # 3rd bad epoch > patience
    s2 = tr.PlateauScheduler(lr=1.0)
    s2.load_state_dict(s.state_dict())
    assert s2.state_dict() == s.state_dict()


def test_early_stopping():
    e = tr.EarlyStopping(patience=2)
    assert not e.step(1.0)
    assert not e.step(1.1)
    assert e.step(1.2)


def test_checkpoint_roundtrip(setting, tmp_path):
    """Tensors and metadata come back as written; ``update_metadata`` merges
    without touching the tensors; no temporary file is left behind; the
    flax tree converts back exactly."""
    jtasks, _ = setting
    _, jparams, model = _pair(jtasks)
    state, _ = tr.make_train_step(model)(tr.init_state(model), _task(jtasks, [0, 1]), LR)
    save_checkpoint(str(tmp_path), state.params, state.opt_state, step=state.step,
                    metadata={"variable": "temperature", "n": np.int64(3)})
    update_metadata(str(tmp_path), std_scale=1.25)
    loaded = load_checkpoint(str(tmp_path))
    assert _equal(loaded["params"], state.params)
    assert _equal(loaded["opt_state"], state.opt_state)
    assert loaded["metadata"] == {"step": 1, "variable": "temperature", "n": 3, "std_scale": 1.25}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "metadata.json", "opt_state.pt", "params.pt"]
    back = params_to_jax(params_from_jax(jax.device_get(jparams)))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 back, jax.device_get(jparams))


def test_trainer_fit_and_checkpoint(setting, tmp_path):
    jtasks, jval = setting
    _, _, model = _pair(jtasks)
    out = tr.Trainer(model, lr=LR).fit(
        TaskBatch.from_numpy(jtasks), TaskBatch.from_numpy(jval), n_epochs=3, batch_size=4,
        checkpoint_dir=str(tmp_path / "ckpt"), metadata={"variable": "temperature"},
        verbose=False)
    assert len(out["train_losses"]) == 3 and np.isfinite(out["best_val"])
    loaded = load_checkpoint(str(tmp_path / "ckpt"))
    assert _equal(loaded["params"], out["params"])
    assert loaded["metadata"]["variable"] == "temperature"
    assert "val_losses" in loaded["metadata"]
    assert "sched" in loaded["metadata"] and "stopper" in loaded["metadata"]


def test_fit_snapshots_are_copies(setting):
    """The best parameters are a copy taken at the best epoch: training on
    past it (a high LR makes validation bounce) leaves them unchanged."""
    jtasks, jval = setting
    _, _, model = _pair(jtasks)
    out = tr.Trainer(model, lr=0.3).fit(TaskBatch.from_numpy(jtasks), TaskBatch.from_numpy(jval),
                                        n_epochs=4, batch_size=4, verbose=False)
    best = int(np.argmin(out["val_losses"]))
    final = out["final_state"].params
    assert best < 3
    assert all(p.data_ptr() != final[k].data_ptr() for k, p in out["params"].items())
    evaluate = tr.make_eval_step(model)
    assert float(evaluate(out["params"], TaskBatch.from_numpy(jval))) == pytest.approx(
        out["best_val"], rel=1e-6)


def test_resume_is_replay_equivalent(setting, tmp_path):
    """2 epochs, a checkpoint, then a resumed run to 4 epochs reproduce the
    uninterrupted 4-epoch run: per-epoch shuffle seeds, restored optimizer
    state, loss history and schedule counters."""
    jtasks, jval = setting
    _, _, model = _pair(jtasks)
    tasks, val = TaskBatch.from_numpy(jtasks), TaskBatch.from_numpy(jval)
    params0 = tr.init_state(model).params
    full = tr.Trainer(model, lr=LR).fit(tasks, val, n_epochs=4, batch_size=4, params=params0,
                                        verbose=False)
    ck = str(tmp_path / "replay")
    first = tr.Trainer(model, lr=LR).fit(tasks, val, n_epochs=2, batch_size=4, params=params0,
                                         checkpoint_dir=ck, verbose=False)
    resumed = tr.Trainer(model, lr=LR).fit(tasks, val, n_epochs=4, batch_size=4,
                                           resume_from=ck, verbose=False)
    assert resumed["train_losses"][:2] == first["train_losses"]
    assert len(resumed["train_losses"]) == 4
    np.testing.assert_allclose(resumed["train_losses"], full["train_losses"], rtol=1e-6)
    np.testing.assert_allclose(resumed["val_losses"], full["val_losses"], rtol=1e-6)


def test_fit_matches_jax_fit(setting):
    """Two epochs of ``Trainer.fit`` (shuffled batches of 4, validation each
    epoch) from the same parameters: the per-epoch losses agree to rtol 1e-4
    (four Adam steps of f32 rounding differences)."""
    jtasks, jval = setting
    jmodel, jparams, model = _pair(jtasks)
    jout = jtr.Trainer(jmodel, lr=LR).fit(jtasks, jval, n_epochs=2, batch_size=4,
                                          params=jparams, verbose=False)
    out = tr.Trainer(model, lr=LR).fit(TaskBatch.from_numpy(jtasks), TaskBatch.from_numpy(jval),
                                       n_epochs=2, batch_size=4, verbose=False)
    np.testing.assert_allclose(out["train_losses"], jout["train_losses"], rtol=1e-4)
    np.testing.assert_allclose(out["val_losses"], jout["val_losses"], rtol=1e-4)
