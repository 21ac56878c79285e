"""The port's data-parallel serving (``predict_grid``, ``predict_points``,
``ar_sample`` and ``ar_sample_grid`` with ``mesh=``) against one process
of the port and against the JAX package under its data mesh, on the CPU.

The setting is tests/test_parallel.py's inference setting: synthetic
NZ-like data through the JAX ``TaskLoader`` (8 tasks), a gnp (rank 4)
ConvNP with a U-Net (8, 8) at internal density 32 in float32, the same
parameters on both sides, and the DEM with its sea cells as the grid. The
port runs in a 2- and a 4-process gloo group (one CPU each,
``tests/_torch_parallel_worker.py serve``, which imports the port only;
one group per world size computes every case, 120 s each). JAX runs its
``Predictor`` and ``ar_sample`` on the batch placed by ``shard_task`` on
its 8-device CPU mesh (``tests/conftest.py``).

Tolerances: against one process of the port, JAX's own bounds for its
data-parallel forward (tests/test_parallel.py:231-234: rtol 2e-5,
atol 1e-6) and AR chain (:249-250: rtol 5e-4, atol 1e-5); an int16 map
may also differ by one quantisation step, (max − min)/65535 of its task's
map, where the two forwards' rounding puts a value on either side of a
step. Against JAX, tests/test_torch_predict.py's: rtol 1e-5 with an atol
of 1e-5 times the field's largest magnitude (the AR chain rtol 1e-4). The
ranks of a group return the same result, bitwise. Samples are compared
with the same draws on both sides: the port's generator in both of its
runs (for the gnp head, and for bernoulli-gamma, whose draws read the
head's outputs), numpy's draws handed to both packages' samplers against
JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer import ar as jar
from deepsensornz_tpu.infer.predict import Predictor as JPredictor
from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.parallel import mesh as jmesh
from deepsensornz_tpu.task.batching import take as jtake
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.infer import ar
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.batching import take
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

from _torch_groups import run_group

N_SAMPLES = 2


def _field(f) -> Field:
    return Field(f.data, f.dims, f.coords, f.name, dict(f.attrs))


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=16)
    jdp = JProcessor()
    jdp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    jaux = jdp(dem.fillna(0.0).rename("elevation"), method="min_max")
    st_col = [c for c in stations.columns if c.endswith("_station")][0]
    tl = TaskLoader(context=[jdp(base, method="mean_std"), jdp(stations, method="mean_std")],
                    target=jdp(stations), aux_at_targets=jaux, internal_density=32,
                    grid_multiple=16)
    jtask = tl(list(base.coords["time"][:8]))
    jcfg = JConfig(unet_channels=(8, 8), likelihood="gnp", rank=4, internal_density=32,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    jparams = jmodel.init(jax.random.key(0), jtake(jtask, np.arange(1)))
    path = tmp_path_factory.mktemp("dp") / "data_processor.json"
    jdp.save(str(path))
    dp = DataProcessor.load(str(path))
    task = TaskBatch.from_numpy(jtask)
    cfg = dataclasses.asdict(jcfg)
    params = params_from_jax(jax.device_get(jparams), jcfg.upsample)
    model = ConvNP.from_task(ConvNPConfig(**cfg), task)
    model.load_state_dict(params)
    model.eval()
    rng = np.random.default_rng(7)
    cells = dem.shape[0] * dem.shape[1]
    draws = (rng.normal(size=(N_SAMPLES, 8, cells, 1)).astype(np.float32),
             rng.normal(size=(N_SAMPLES, 8, 4)).astype(np.float32))
    return dict(jmodel=jmodel, jparams=jparams, jtask=jtask, jdp=jdp, jdem=dem, jaux=jaux,
                st_col=st_col, cfg=cfg, params=params, task=task, dp=dp, dem=_field(dem),
                aux=_field(jaux), model=model, draws=draws)


@pytest.fixture(scope="module")
def groups(setting, tmp_path_factory):
    inputs = {"cfg": setting["cfg"], "params": setting["params"], "task8": setting["task"],
              "dem": setting["dem"], "aux": setting["aux"], "dp": setting["dp"],
              "st_col": setting["st_col"], "draws": setting["draws"]}
    return {world: run_group(inputs, world, tmp_path_factory.mktemp(f"serve{world}"), names,
                             mode="serve")
            for world, names in ((2, "jax"), (4, "torchrun"))}


@pytest.fixture(scope="module")
def one(setting):
    """The port in one process, no mesh."""
    s = setting
    pred = Predictor(s["model"], s["dp"], s["st_col"])
    kw = dict(aux_at_targets=s["aux"])
    out = {"grid": pred.predict_grid(s["task"], s["dem"], **kw),
           "grid7": pred.predict_grid(take(s["task"], np.arange(7)), s["dem"], **kw),
           "samples": pred.predict_grid(s["task"], s["dem"], n_samples=N_SAMPLES, seed=3,
                                        **kw)["samples"].data,
           "int16": Predictor(s["model"], s["dp"], s["st_col"], batch_chunk=3,
                              transfer_dtype="int16").predict_grid(
               s["task"], s["dem"], n_samples=N_SAMPLES, seed=3, **kw),
           "points": pred.predict_points(s["task"]),
           "ar": ar.ar_sample(s["model"], s["task"], n_samples=N_SAMPLES, n_blocks=3,
                              generator=torch.Generator().manual_seed(5)),
           "ar_grid": pred.ar_sample_grid(s["task"], s["dem"], subsample_factor=8, n_blocks=3,
                                          seed=2, **kw)}
    mixed = ConvNP.from_task(ConvNPConfig(**dict(s["cfg"], likelihood="bernoulli-gamma")),
                             s["task"], generator=torch.Generator().manual_seed(1)).eval()
    out["mixed"] = Predictor(mixed, s["dp"], s["st_col"]).predict_grid(
        s["task"], s["dem"], n_samples=N_SAMPLES, seed=4, unnormalise=False, sea_mask=False,
        **kw)["samples"].data
    e1, e2 = (torch.from_numpy(d) for d in s["draws"])
    saved = tlik.LowRankGaussian.draw
    tlik.LowRankGaussian.draw = lambda self, raw, gen, n: (e1, e2)
    try:
        out["fed"] = pred.predict_grid(s["task"], s["dem"], n_samples=N_SAMPLES, seed=0,
                                       unnormalise=False, sea_mask=False, **kw)["samples"].data
    finally:
        tlik.LowRankGaussian.draw = saved
    return out


@pytest.fixture(scope="module")
def jax_mesh(setting):
    """The JAX package on the batch ``shard_task`` placed on its 8-device
    data mesh (7 tasks padded to 8 with its ``pad_batch_to_multiple``)."""
    s = setting
    mesh = jmesh.make_mesh(n_data=8, n_spatial=1)
    sharded = jmesh.shard_task(s["jtask"], mesh)
    padded7, _ = jmesh.pad_batch_to_multiple(jtake(s["jtask"], np.arange(7)), 8)
    pred = JPredictor(s["jmodel"], s["jparams"], s["jdp"], s["st_col"])
    kw = dict(aux_at_targets=s["jaux"])
    out = {}
    with jax.set_mesh(mesh):
        out["grid"] = pred.predict_grid(sharded, s["jdem"], **kw)
        out["grid7"] = pred.predict_grid(jmesh.shard_task(padded7, mesh), s["jdem"], **kw)
        out["int16"] = JPredictor(s["jmodel"], s["jparams"], s["jdp"], s["st_col"],
                                  batch_chunk=3, transfer_dtype="int16").predict_grid(
            sharded, s["jdem"], **kw)
        out["points"] = pred.predict_points(sharded)
        draws = iter([jnp.asarray(d) for d in s["draws"]])
        normal = jax.random.normal
        jax.random.normal = lambda key, shape, dtype=jnp.float32: next(draws)
        try:
            out["fed"] = pred.predict_grid(sharded, s["jdem"], n_samples=N_SAMPLES, seed=0,
                                           unnormalise=False, sea_mask=False,
                                           **kw)["samples"].data
        finally:
            jax.random.normal = normal
        sample, perm = jlik.LowRankGaussian.sample, jax.random.permutation
        jlik.LowRankGaussian.sample = lambda self, raw, rng, n: self.mean_std(raw)[0][None]
        jax.random.permutation = lambda key, m: jnp.arange(m)
        jar._chain_fn.cache_clear()  # no chain traced with the real sampler
        try:
            out["ar_mean"] = jar.ar_sample(s["jmodel"], s["jparams"], sharded, n_samples=1,
                                           n_blocks=3, rng=jax.random.key(0))
            out["ar_grid_mean"] = JPredictor(
                s["jmodel"], s["jparams"], s["jdp"], s["st_col"], std_scale=1.4).ar_sample_grid(
                sharded, s["jdem"], subsample_factor=8, n_blocks=3, **kw)
        finally:
            jlik.LowRankGaussian.sample, jax.random.permutation = sample, perm
            jar._chain_fn.cache_clear()
    return out


def _dp_close(got, want, rtol=2e-5, atol=1e-6, extra=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isnan(want) | (np.abs(got - want) <= rtol * np.abs(want) + atol + extra)
    assert ok.all(), f"{int((~ok).sum())} of {ok.size} off; largest {np.nanmax(np.abs(got - want))}"


def _jax_close(got, want, rtol=1e-5, extra=0.0):
    _dp_close(got, want, rtol=rtol, atol=1e-5 * float(np.nanmax(np.abs(want))), extra=extra)


def _ranks_equal(ranks, get):
    for r in ranks[1:]:
        np.testing.assert_array_equal(get(r), get(ranks[0]))


def _int16_step(field):
    """One quantisation step of each task's map, (max − min)/65535."""
    d = np.asarray(field, np.float64)
    axes = tuple(range(d.ndim - 2, d.ndim))
    return (np.nanmax(d, axis=axes, keepdims=True) - np.nanmin(d, axis=axes, keepdims=True)) / 65535


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_grid_matches_one_process_and_jax(groups, one, jax_mesh, world):
    ranks = groups[world]
    assert [r["info"]["process_count"] for r in ranks] == [world] * world
    for key in ("mean", "std"):
        _ranks_equal(ranks, lambda r: r["grid"][key])
        _dp_close(ranks[0]["grid"][key], one["grid"][key].data)
        _jax_close(ranks[0]["grid"][key], jax_mesh["grid"][key].data)


@pytest.mark.parametrize("world", WORLDS)
def test_padded_batch_drops_the_pad_rows(groups, one, jax_mesh, world):
    """7 tasks over 2 or 4 ranks: padded to 8, the pad row dropped."""
    ranks = groups[world]
    for key in ("mean", "std"):
        got = ranks[0]["grid7"][key]
        assert got.shape == (7, 48, 48)
        _ranks_equal(ranks, lambda r: r["grid7"][key])
        _dp_close(got, one["grid7"][key].data)
        _jax_close(got, jax_mesh["grid7"][key].data[:7])


@pytest.mark.parametrize("world", WORLDS)
def test_samples_do_not_depend_on_the_ranks(groups, one, world):
    """Every rank draws the whole batch's numbers from one seed and keeps
    its rows: the samples are one process's."""
    ranks = groups[world]
    _ranks_equal(ranks, lambda r: r["samples"])
    assert ranks[0]["samples"].shape == (N_SAMPLES, 8, 48, 48)
    _dp_close(ranks[0]["samples"], one["samples"])


@pytest.mark.parametrize("world", WORLDS)
def test_mixed_head_samples_do_not_depend_on_the_ranks(groups, one, world):
    """bernoulli-gamma: its Bernoulli and Gamma draws read the head's
    outputs, so the ranks gather the batch's outputs and draw from them."""
    ranks = groups[world]
    _ranks_equal(ranks, lambda r: r["mixed"])
    assert ranks[0]["mixed"].shape == (N_SAMPLES, 8, 48, 48)
    assert (ranks[0]["mixed"] == 0).any() and (ranks[0]["mixed"] > 0).any()  # dry and wet
    _dp_close(ranks[0]["mixed"], one["mixed"])


@pytest.mark.parametrize("world", WORLDS)
def test_samples_from_given_draws_match_jax(groups, one, jax_mesh, world):
    ranks = groups[world]
    _ranks_equal(ranks, lambda r: r["fed"])
    _dp_close(ranks[0]["fed"], one["fed"])
    _jax_close(ranks[0]["fed"], jax_mesh["fed"])


@pytest.mark.parametrize("world", WORLDS)
def test_chunked_int16_request_splits_each_chunk(groups, one, jax_mesh, world):
    """8 tasks in chunks of 3 (the tail chunk padded with its last task),
    each chunk's rows split over the ranks: the chunks, their sample seeds
    and each map's quantisation scale are one process's."""
    ranks = groups[world]
    for key in ("mean", "std", "samples"):
        _ranks_equal(ranks, lambda r: r["int16"][key])
        want = one["int16"][key].data
        _dp_close(ranks[0]["int16"][key], want, extra=_int16_step(want))
    for key in ("mean", "std"):
        want = jax_mesh["int16"][key].data
        _jax_close(ranks[0]["int16"][key], want, extra=_int16_step(want))


@pytest.mark.parametrize("world", WORLDS)
def test_points_match_one_process_and_jax(groups, one, jax_mesh, world):
    ranks = groups[world]
    for key in ("mean", "std", "mask"):
        _ranks_equal(ranks, lambda r: r["points"][key])
    np.testing.assert_array_equal(ranks[0]["points"]["mask"], one["points"]["mask"])
    for key in ("mean", "std"):
        _dp_close(ranks[0]["points"][key], one["points"][key])
        _jax_close(ranks[0]["points"][key], jax_mesh["points"][key])


@pytest.mark.parametrize("world", WORLDS)
def test_ar_sample_matches_one_process(groups, one, setting, world):
    """The visit orders and every block's draws are the whole batch's, so
    the chains are one process's (JAX's bound for its data-parallel AR,
    on the targets with a mask)."""
    ranks = groups[world]
    _ranks_equal(ranks, lambda r: r["ar"])
    got = ranks[0]["ar"]
    assert got.shape == (N_SAMPLES, 8, setting["task"].xt.shape[1], 1)
    mask = setting["task"].yt_mask.numpy() > 0
    _dp_close(got[:, mask], one["ar"][:, mask], rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ar_mean_feedback_matches_jax(groups, jax_mesh, setting, world):
    """With the samplers returning the mean and the identity visit order,
    the chains are deterministic: the port's ranks equal JAX's sharded
    chain and its ``ar_sample_grid``."""
    ranks = groups[world]
    mask = setting["task"].yt_mask.numpy() > 0
    _ranks_equal(ranks, lambda r: r["ar_mean"])
    _jax_close(ranks[0]["ar_mean"][:, mask], jax_mesh["ar_mean"][:, mask], rtol=1e-4)
    _ranks_equal(ranks, lambda r: r["ar_grid_mean"])
    _jax_close(ranks[0]["ar_grid_mean"], jax_mesh["ar_grid_mean"], rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_ar_sample_grid_matches_one_process(groups, one, setting, world):
    ranks = groups[world]
    _ranks_equal(ranks, lambda r: r["ar_grid"])
    got = ranks[0]["ar_grid"]
    assert got.shape == (1, 8, 48, 48)
    sea = np.isnan(setting["dem"].data)
    assert np.isnan(got[..., sea]).all() and np.isfinite(got[..., ~sea]).all()
    _dp_close(got, one["ar_grid"], rtol=5e-4, atol=1e-5)
