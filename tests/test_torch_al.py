"""Active learning of the port against the JAX package (CPU).

The setting is tests/test_ar_and_al.py's: synthetic NZ-like data through
the JAX ``TaskLoader`` (one task), small ConvNPs at float32 with the cnp
and gnp heads, the same parameters on both sides (``params_from_jax``).

Tolerances: predictions at the candidates, per-candidate exhaustive scores,
acquisition histories and the final context set within rtol 1e-4 with an
atol of 1e-5 times the largest magnitude (float32 forwards in different
summation orders, whose outputs are fed back as context for the next
round). Placements must be the same; each round's best score is held
further than twice that tolerance from the runner-up, so a near-tie shows
as a failure rather than as a placement that differs by chance. The scores
of these random-weight models lie within ~1 % of each other, and about a
third of 8-candidate draws have an exhaustive round closer than that; the
candidate draws below (``CAND_SEED``) are ones where every round is
decisive, on both heads and in both modes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepsensornz_tpu.al.greedy import GreedyAlgorithm as JGreedy
from deepsensornz_tpu.al.greedy import Stddev as JStddev
from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer.ar import _extend_point_context as j_extend
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu_torch.al import GreedyAlgorithm, Stddev
from deepsensornz_tpu_torch.infer.ar import _extend_point_context
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.task import PointContext, TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

RTOL = 1e-4
ATOL_FRAC = 1e-5
HEADS = ["cnp", "gnp"]
CAND_SEED = 2


@pytest.fixture(scope="module")
def data():
    base, dem, stations = synthetic_bundle(n_times=4, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=12)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    elev = dp(dem.fillna(0.0).rename("elevation"), method="min_max")
    return base, dp(base, method="mean_std"), dp(stations, method="mean_std"), dp(stations), elev


def _task(data, aux_at_targets=True, aux_at_contexts=False):
    base, base_n, st_ctx, st_tgt, elev = data
    tl = TaskLoader(context=[base_n, st_ctx], target=st_tgt,
                    aux_at_targets=elev if aux_at_targets else None,
                    aux_at_contexts=elev if aux_at_contexts else None,
                    internal_density=32, grid_multiple=16)
    return tl(list(base.coords["time"][:1]))


@pytest.fixture(scope="module")
def jtask(data):
    return _task(data)


def _models(jt, likelihood, seed=0):
    jcfg = JConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=32,
                   decoder_channels=8, mlp_hidden=8, rank=3, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    params = jmodel.init(jax.random.key(seed), jt)
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), TaskBatch.from_numpy(jt))
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module", params=HEADS)
def models(request, jtask):
    return request.param, _models(jtask, request.param)


def _candidates(seed, S, A=1):
    rng = np.random.default_rng(seed)
    return (rng.random((S, 2)).astype(np.float32),
            rng.normal(size=(S, A)).astype(np.float32))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * float(np.abs(want).max()))


def test_stddev_matches_jax():
    rng = np.random.default_rng(0)
    mean, std = rng.normal(size=(2, 3, 7, 1)).astype(np.float32)
    std = np.abs(std)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    mask[2] = 0.0  # no valid target: the denominator's floor of 1
    want = np.asarray(JStddev()(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(mask)))
    got = Stddev()(*map(torch.from_numpy, (mean, std, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[2] == 0.0


def test_probe_predictions_match_jax(jtask, models):
    likelihood, (jmodel, params, model) = models
    cand, aux = _candidates(0, 10)
    jalg, alg = JGreedy(jmodel, params), GreedyAlgorithm(model)
    jprobe = jalg._probe_at(jtask, jnp.asarray(cand), aux)
    want = jalg._predict(params, jprobe)
    probe = alg._probe_at(TaskBatch.from_numpy(jtask), torch.from_numpy(cand),
                          torch.from_numpy(aux))
    for name in ("xt", "yt", "yt_mask", "yt_aux"):
        np.testing.assert_array_equal(getattr(probe, name).numpy(),
                                      np.asarray(getattr(jprobe, name)), err_msg=name)
    with torch.no_grad():
        got = alg._predict(probe)
    for g, w in zip(got, want):
        assert g.shape == (1, 10, 1)
        _close(g.numpy(), w)


def test_exhaustive_scores_match_jax(jtask, models):
    """One round's per-candidate scores, on the context set padded with two
    masked placement slots as ``run`` pads it."""
    likelihood, (jmodel, params, model) = models
    cand, aux = _candidates(1, 8)
    feed = np.random.default_rng(2).normal(size=(8, 1)).astype(np.float32)
    jext = jtask.replace(points=tuple(j_extend(p, 2) if i == 0 else p
                                      for i, p in enumerate(jtask.points)))
    want = JGreedy(jmodel, params)._exhaustive_scores_dev(
        params, jext, jnp.asarray(cand), jnp.asarray(feed), 0)
    task = TaskBatch.from_numpy(jtask)
    ext = dataclasses.replace(task, points=tuple(_extend_point_context(p, 2) if i == 0 else p
                                                 for i, p in enumerate(task.points)))
    alg = GreedyAlgorithm(model)
    tiled = alg.hypothetical_tasks(ext, torch.from_numpy(cand), torch.from_numpy(feed), 0)
    n = task.points[0].x.shape[1]
    assert tiled.points[0].x.shape == (8, n + 3, 2) and tiled.points[0].x.is_contiguous()
    np.testing.assert_array_equal(tiled.points[0].x[:, -1].numpy(), cand)
    np.testing.assert_array_equal(tiled.points[0].y[:, -1].numpy(), feed)
    with torch.no_grad():
        got = alg._exhaustive_scores_dev(ext, torch.from_numpy(cand), torch.from_numpy(feed), 0)
    assert got.shape == (8,)
    _close(got.numpy(), want)


def _assert_margins(rounds, placed_idx, mode):
    """Each round's choice beats the runner-up among the remaining
    candidates by more than both sides' tolerance."""
    for t, (best, second, top) in enumerate(cs.round_margins(rounds, placed_idx, mode)):
        margin = abs(best - second)
        tol = 2 * (RTOL * abs(best) + ATOL_FRAC * top)
        assert margin > tol, f"round {t}: best and runner-up within {margin:.3e} (tol {tol:.3e})"


def _assert_same_run(jout, out, cand, idx):
    np.testing.assert_array_equal(out["placements"], np.asarray(jout["placements"]))
    _close(out["acquisition_history"], jout["acquisition_history"])
    jp, p = jout["final_task"].points[idx], out["final_task"].points[idx]
    for name in ("x", "y", "mask"):
        _close(getattr(p, name).numpy(), np.asarray(getattr(jp, name)))
    return cs.placement_indices(cand, out["placements"])


@pytest.mark.parametrize("mode", ["exhaustive", "fast"])
def test_run_matches_jax(jtask, models, mode):
    likelihood, (jmodel, params, model) = models
    cand, aux = _candidates(CAND_SEED, 8)
    jout = JGreedy(jmodel, params, mode=mode).run(jtask, cand, n_placements=3,
                                                  candidate_aux=aux)
    alg = GreedyAlgorithm(model, mode=mode)
    rounds = cs.record_rounds(alg)
    out = alg.run(TaskBatch.from_numpy(jtask), cand, n_placements=3, candidate_aux=aux)
    assert out["placements"].shape == (3, 2) and len(out["acquisition_history"]) == 3
    placed = _assert_same_run(jout, out, cand, idx=0)
    assert len(set(placed)) == 3 and len(rounds) == 3
    _assert_margins(rounds, placed, mode)
    # the placements sit in the pre-padded slots, after the real points
    n = jtask.points[0].x.shape[1]
    final = out["final_task"].points[0]
    np.testing.assert_array_equal(final.x[0, n:].numpy(), out["placements"])
    assert (final.mask[0, n:] == 1.0).all()


def test_exhaustive_placement_lowers_the_acquisition(jtask):
    """tests/test_ar_and_al.py's check, on its cnp model (a random-weight
    gnp head's std rises with these placements, on both sides alike)."""
    model = _models(jtask, "cnp")[2]
    cand, aux = _candidates(1, 6)
    alg = GreedyAlgorithm(model, mode="exhaustive")
    task = TaskBatch.from_numpy(jtask)
    with torch.no_grad():
        before = float(Stddev()(*alg._predict(task), task.yt_mask)[0])
    out = alg.run(task, cand, n_placements=2, candidate_aux=aux)
    final = out["final_task"]
    with torch.no_grad():
        after = float(Stddev()(*alg._predict(final), final.yt_mask)[0])
    assert after <= before + 1e-6
    assert np.isfinite(out["acquisition_history"]).all()


@pytest.mark.parametrize("with_aux", [True, False])
def test_feedback_with_context_aux_matches_jax(data, with_aux):
    """``aux_at_contexts`` gives the station context set channels beyond
    dim_yt: each placement feeds back its mean and the candidate's aux
    prefix, or zeros where there is no candidate aux (a loader without
    aux at the targets)."""
    jt = _task(data, aux_at_targets=with_aux, aux_at_contexts=True)
    assert jt.points[0].y.shape[-1] == 2
    jmodel, params, model = _models(jt, "cnp", seed=1)
    cand, aux = _candidates(CAND_SEED, 7)
    kw = dict(n_placements=2, candidate_aux=aux if with_aux else None)
    jout = JGreedy(jmodel, params).run(jt, cand, **kw)
    alg = GreedyAlgorithm(model)
    rounds = cs.record_rounds(alg)
    out = alg.run(TaskBatch.from_numpy(jt), cand, **kw)
    placed = _assert_same_run(jout, out, cand, idx=0)
    _assert_margins(rounds, placed, "exhaustive")
    n = jt.points[0].x.shape[1]
    extra = out["final_task"].points[0].y[0, n:, 1].numpy()
    np.testing.assert_array_equal(extra, aux[placed, 0] if with_aux else np.zeros(2, np.float32))


def _value_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["B=1", "exceeds the 3 candidates", "channels",
                                  "candidate_aux"])
def test_errors_match_jax(jtask, case):
    jmodel, params, model = _models(jtask, "cnp")
    cand, aux = _candidates(5, 3)
    jp = jtask.points[0]
    jt, kw = {
        "B=1": (jtask.replace(**{k: jnp.concatenate([getattr(jtask, k)] * 2)
                                 for k in ("xt", "yt", "yt_mask", "yt_aux")}),
                dict(n_placements=1, candidate_aux=aux)),
        "exceeds the 3 candidates": (jtask, dict(n_placements=4, candidate_aux=aux)),
        "channels": (jtask.replace(points=(jp.replace(y=jp.y[..., :0]),)),
                     dict(n_placements=1, candidate_aux=aux)),
        "candidate_aux": (jtask, dict(n_placements=1)),
    }[case]
    want = _value_error(lambda: JGreedy(jmodel, params).run(jt, cand, **kw))
    got = _value_error(lambda: GreedyAlgorithm(model).run(TaskBatch.from_numpy(jt), cand, **kw))
    assert got == want and case in got


def test_run_leaves_the_callers_task_alone(jtask):
    jmodel, params, model = _models(jtask, "cnp")
    task = TaskBatch.from_numpy(jtask)
    before = [t.clone() for p in task.points for t in (p.x, p.y, p.mask)]
    cand, aux = _candidates(6, 5)
    out = GreedyAlgorithm(model, mode="fast").run(task, cand, n_placements=2, candidate_aux=aux)
    after = [t for p in task.points for t in (p.x, p.y, p.mask)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert out["final_task"].points[0].x.shape[1] == task.points[0].x.shape[1] + 2
    assert isinstance(out["final_task"].points[0], PointContext)
