"""AR sampling of the port against the JAX package (CPU).

The setting is tests/test_ar_and_al.py's: synthetic NZ-like data through
the JAX ``TaskLoader`` (two tasks), small ConvNPs at float32, the same
parameters on both sides (``params_from_jax``).

Parity: JAX and torch draw different numbers, so the chain itself is held
against JAX's ``_chain_fn`` with each side's head ``sample`` patched to
return the mean: then, for one explicit visit order (with a pad:
M % block != 0) and a spread rescale, the chain is deterministic and the
port's sample equals JAX's to rtol 1e-4 with an atol of 1e-5 times its
largest magnitude (f32 forwards whose outputs feed the next block's
encode). The random chain is held to the JAX package's own AR tests:
shapes, finiteness, draws that differ, and feedback that correlates the
targets.
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
from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.task.loader import TaskLoader
from deepsensornz_tpu.task.task import PointContext as JPointContext
from deepsensornz_tpu_torch.infer import ar as tar
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

M = 10  # targets: with 4 blocks of 3 the last block holds 2 pad revisits


@pytest.fixture(scope="module")
def jtask():
    base, dem, stations = synthetic_bundle(n_times=4, base_hw=(16, 16), dem_hw=(48, 48),
                                           n_stations=12)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    tl = TaskLoader(context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
                    target=dp(stations),
                    aux_at_targets=dp(dem.fillna(0.0).rename("elevation"), method="min_max"),
                    internal_density=32, grid_multiple=16)
    task = tl(list(base.coords["time"][:2]))
    mask = np.asarray(task.yt_mask[:, :M]).copy()
    mask[1, 3] = 0.0  # one masked target
    return task.replace(xt=task.xt[:, :M], yt=task.yt[:, :M], yt_mask=jnp.asarray(mask),
                        yt_aux=task.yt_aux[:, :M])


def _with_extra_channels(task, extra: int):
    """The station context set with ``extra`` more channels, as
    aux_at_contexts would give it."""
    if extra == 0:
        return task
    p = task.points[0]
    cols = [p.y * (0.5 + 0.25 * i) + 0.1 for i in range(extra)]
    return task.replace(points=(JPointContext(x=p.x, y=jnp.concatenate([p.y] + cols, -1),
                                              mask=p.mask),))


def _models(jt, likelihood, seed=0):
    jcfg = JConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=32,
                   decoder_channels=8, mlp_hidden=8, rank=3, compute_dtype="float32")
    jmodel = JConvNP(jcfg)
    params = jmodel.init(jax.random.key(seed), jt)
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), TaskBatch.from_numpy(jt))
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, model.eval()


def _patch_sample_to_mean(monkeypatch, likelihood):
    jcls = type(jlik.get_likelihood(likelihood))
    tcls = type(tlik.get_likelihood(likelihood))
    monkeypatch.setattr(jcls, "sample", lambda self, raw, rng, n: self.mean_std(raw)[0][None])
    monkeypatch.setattr(tcls, "sample", lambda self, raw, gen, n: self.mean_std(raw)[0][None])


@pytest.mark.parametrize("likelihood,extra", [("cnp", 0), ("cnp", 1), ("gnp", 2),
                                              ("bernoulli-gamma", 0), ("cnp-spikes-beta", 1)])
def test_mean_feedback_chain_matches_jax(jtask, rng, monkeypatch, likelihood, extra):
    """extra 1: the sample and the first aux-at-target channel are fed back;
    extra 2: more channels than the targets' aux, so zeros are fed back."""
    jt = _with_extra_channels(jtask, extra)
    jmodel, params, model = _models(jt, likelihood)
    _patch_sample_to_mean(monkeypatch, likelihood)
    B = jt.xt.shape[0]
    block, n_blocks, pad = tar.block_geometry(M, 4)
    assert (block, n_blocks, pad) == (3, 4, 2)
    perm = np.stack([rng.permutation(M) for _ in range(B)])
    order = np.concatenate([perm, perm[:, :pad]], 1)
    base_n = jt.points[0].x.shape[1]
    geom = dict(idx=0, base_n=base_n, n_extra=extra, block=block, n_blocks=n_blocks, pad=pad)
    chain = jar._chain_fn.__wrapped__(jmodel, B, M, 1, *geom.values())  # never the cached one
    jext = jt.replace(points=(jar._extend_point_context(jt.points[0], n_blocks * block),))
    want = np.asarray(chain(params, jext, jnp.asarray(order), jax.random.key(0),
                            jnp.asarray(1.3, jnp.float32)))
    task = TaskBatch.from_numpy(jt)
    text = dataclasses.replace(task, points=(tar._extend_point_context(task.points[0],
                                                                       n_blocks * block),))
    got = tar.run_chain(model, text, torch.from_numpy(order), torch.Generator(), 1.3, **geom)
    assert got.shape == want.shape == (B, M, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_extend_point_context_matches_jax(jtask):
    p = jtask.points[0]
    a = jar._extend_point_context(p, 5)
    b = tar._extend_point_context(TaskBatch.from_numpy(jtask).points[0], 5)
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)))


@pytest.mark.parametrize("m,n_blocks", [(10, 4), (12, 4), (7, 8), (4550, 8), (512, 8)])
def test_block_geometry(m, n_blocks):
    block, n, pad = tar.block_geometry(m, n_blocks)
    assert n <= n_blocks and n * block == m + pad and 0 <= pad < block
    assert (n - 1) * block < m  # no block of revisits only


@pytest.fixture(scope="module")
def cnp(jtask):
    return _models(jtask, "cnp")[2], TaskBatch.from_numpy(jtask)


def test_ar_sample_shapes_and_finiteness(cnp):
    model, task = cnp
    samples = tar.ar_sample(model, task, n_samples=2, n_blocks=3,
                            generator=torch.Generator().manual_seed(0))
    assert samples.shape == (2, 2, M, 1) and samples.dtype == np.float32
    mask = task.yt_mask.numpy().astype(bool)
    assert np.isfinite(samples[:, mask]).all()


def test_ar_samples_differ_between_draws_and_seeds(cnp):
    model, task = cnp
    mask = task.yt_mask.numpy().astype(bool)

    def draw(seed):
        return tar.ar_sample(model, task, n_samples=2, n_blocks=2,
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(1), draw(1), draw(2)
    assert not np.allclose(a[0][mask], a[1][mask])
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a[0][mask], c[0][mask])
    np.testing.assert_array_equal(tar.ar_sample(model, task, n_blocks=2), draw(0)[:1])


def test_ar_feedback_changes_distribution(cnp):
    """As tests/test_ar_and_al.py: feedback makes the samples of different
    targets correlated, which independent marginal draws would not be."""
    model, task = cnp
    n = 24
    samples = tar.ar_sample(model, task, n_samples=n, n_blocks=4,
                            generator=torch.Generator().manual_seed(0))
    mask = task.yt_mask.numpy()[0].astype(bool)
    corr = np.corrcoef(samples[:, 0, mask, 0].T)
    assert np.nanmax(np.abs(corr[~np.eye(corr.shape[0], dtype=bool)])) > 0.15


def test_chain_encodes_once_per_block_and_reads_nothing_back(cnp, monkeypatch):
    """Each block re-runs the model (one station encode), and no block
    reads a tensor back to the host: the host reads raise inside the chain."""
    model, task = cnp
    calls = []
    encode = setconv_cuda.encode_offgrid

    def counting(*args):
        calls.append(args[2].shape[1])
        return encode(*args)

    monkeypatch.setattr(setconv_cuda, "encode_offgrid", counting)
    block, n_blocks, pad = tar.block_geometry(M, 4)
    base_n = task.points[0].x.shape[1]
    text = dataclasses.replace(task, points=(tar._extend_point_context(task.points[0],
                                                                       n_blocks * block),))
    order = torch.cat([torch.arange(M).repeat(2, 1), torch.arange(pad).repeat(2, 1)], 1)

    def refuse(*a, **k):
        raise AssertionError("host read inside the AR chain")

    with monkeypatch.context() as mp:
        for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__float__", "__int__"):
            mp.setattr(torch.Tensor, name, refuse)
        out = tar.run_chain(model, text, order, torch.Generator().manual_seed(0), 1.0, idx=0,
                            base_n=base_n, n_extra=0, block=block, n_blocks=n_blocks, pad=pad)
    assert calls == [base_n + n_blocks * block] * n_blocks
    assert out.shape == (2, M, 1) and bool(torch.isfinite(out).all())


def test_ar_sample_rejects_a_narrow_context_set(jtask):
    model, task = _models(jtask, "cnp")[2], TaskBatch.from_numpy(jtask)
    model.cfg = dataclasses.replace(model.cfg, dim_yt=2)
    with pytest.raises(ValueError):
        tar.ar_sample(model, task)
