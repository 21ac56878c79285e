"""Sampling, CDF bounds and CRPS of the port's four heads against JAX (CPU).

JAX's threefry and torch's Philox give different numbers from one seed, so
parity for random outputs comes in two parts:

- exact, given the draws: each port head splits ``sample`` into ``draw``
  (the standard random numbers) and ``transform``; the test makes the
  draws with numpy and hands them to the port's ``transform`` and, through
  ``jax.random`` functions patched to return them, to the JAX head's own
  ``sample``. Tolerance rtol 1e-5, atol 1e-6 x max (f32; the gnp factor
  product sums rank terms in another order);
- in distribution: the port's samples against ``mean_std`` within Monte
  Carlo error (5 standard errors, n = 8192), point-mass frequencies against
  the head's probabilities, and the gnp sample covariance against
  diag(var) + F Fᵀ.

``cdf_bounds`` and the closed-form ``crps`` are deterministic and are held
against JAX: rtol 1e-5 with atol 1e-6 for the Gaussian heads; atol 1e-5 for
bernoulli-gamma (``gammainc`` against ``lax.igamma``, both f32); atol 1e-4
for cnp-spikes-beta, whose JAX ``betainc`` is off scipy's float64 value by
up to 5.7e-5 in f32 on the inputs below (the port's runs in float64 and is
held against scipy to 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu_torch.models import likelihoods as tlik

HEADS = [("gnp", 1, {"rank": 4}), ("gnp", 2, {"rank": 3}), ("cnp", 1, {}), ("cnp", 2, {}),
         ("bernoulli-gamma", 1, {}), ("cnp-spikes-beta", 1, {})]
IDS = [f"{n}-dy{d}" for n, d, _ in HEADS]
N_MC = 8192


def _pair(name, dim_y, kw):
    return (jlik.get_likelihood(name, dim_y=dim_y, **kw),
            tlik.get_likelihood(name, dim_y=dim_y, **kw))


def _raw(rng, lik, shape=(2, 5), scale=1.5):
    return (scale * rng.normal(size=shape + (lik.num_params(),))).astype(np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rtol=1e-5, atol_frac=1e-6, atol=None):
    want = np.asarray(want, np.float64)
    if atol is None:
        atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol, atol=atol)


def _numpy_draws(rng, name, jl, raw, n):
    """Standard draws for ``n`` samples, as numpy arrays, in the order the
    JAX head asks ``jax.random`` for them."""
    B, M = raw.shape[:2]
    if name == "cnp":
        return [rng.normal(size=(n, B, M, jl.dim_y))]
    if name == "gnp":
        return [rng.normal(size=(n, B, M, jl.dim_y)), rng.normal(size=(n, B, jl.rank))]
    if name == "bernoulli-gamma":
        p, k, _ = (np.asarray(v) for v in jl._split(jnp.asarray(raw)))
        return [rng.random((n, B, M)) < p, rng.gamma(k, 1.0, (n, B, M))]
    _, alpha, beta = (np.asarray(v) for v in jl._split(jnp.asarray(raw)))
    return [rng.integers(0, 3, (n, B, M)), rng.beta(alpha, beta, (n, B, M))]


@pytest.mark.parametrize("name,dim_y,kw", HEADS, ids=IDS)
def test_sample_transform_matches_jax(rng, monkeypatch, name, dim_y, kw):
    jl, tl = _pair(name, dim_y, kw)
    raw = _raw(rng, jl)
    n = 3
    draws = _numpy_draws(rng, name, jl, raw, n)
    queue = [jnp.asarray(d.astype(np.float32) if d.dtype.kind == "f" else d) for d in draws]
    fake = lambda *a, **k: queue.pop(0)  # noqa: E731
    for fn in ("normal", "bernoulli", "gamma", "categorical", "beta"):
        monkeypatch.setattr(jax.random, fn, fake)
    want = np.asarray(jl.sample(jnp.asarray(raw), jax.random.key(0), n))
    assert not queue  # the JAX head used every draw
    got = tl.transform(torch.from_numpy(raw), tuple(torch.from_numpy(
        d.astype(np.float32) if d.dtype.kind == "f" else d) for d in draws))
    assert got.shape == want.shape == (n, 2, 5, dim_y)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name,dim_y,kw", HEADS, ids=IDS)
def test_sample_moments_match_mean_std(rng, name, dim_y, kw):
    """The sample mean within 5 standard errors of ``mean_std``'s mean; the
    sample variance within 5 standard errors (from the samples' fourth
    central moment) of its variance."""
    tl = tlik.get_likelihood(name, dim_y=dim_y, **kw)
    raw = torch.from_numpy(_raw(rng, tl, scale=1.0))
    xs = tl.sample(raw, _gen(1), N_MC).double()
    assert xs.shape == (N_MC, 2, 5, dim_y)
    assert bool(torch.isfinite(xs).all())
    mean, std = (v.double() for v in tl.mean_std(raw))
    m = xs.mean(0)
    assert bool(((m - mean).abs() <= 5.0 * std / np.sqrt(N_MC)).all())
    c = xs - m
    var_hat, m4 = (c ** 2).mean(0), (c ** 4).mean(0)
    se_var = torch.sqrt(torch.clamp(m4 - var_hat ** 2, min=0.0) / N_MC)
    assert bool(((var_hat - std ** 2).abs() <= 5.0 * se_var + 1e-12).all())


@pytest.mark.parametrize("name", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_point_masses_match_probabilities(rng, name):
    """The share of exact 0s (and 1s) within 5 standard errors of the
    head's mass there; every sample inside the support."""
    tl = tlik.get_likelihood(name)
    raw = torch.from_numpy(_raw(rng, tl, scale=1.0))
    xs = tl.sample(raw, _gen(2), N_MC)[..., 0].double()
    if name == "bernoulli-gamma":
        p = torch.sigmoid(raw[..., 0]).double()
        masses = [(0.0, 1.0 - p)]
        assert bool((xs >= 0).all())
    else:
        probs = torch.softmax(raw[..., :3], -1).double()
        masses = [(0.0, probs[..., 0]), (1.0, probs[..., 1])]
        assert bool(((xs >= 0) & (xs <= 1)).all())
    for value, q in masses:
        share = (xs == value).double().mean(0)
        assert bool(((share - q).abs() <= 5.0 * torch.sqrt(q * (1 - q) / N_MC) + 1e-9).all())


def test_gnp_samples_are_joint(rng):
    """Across one task's targets the gnp sample covariance matches
    diag(var) + F Fᵀ within 5 standard errors: e2 is shared by every
    target of a task, e1 is not."""
    tl = tlik.get_likelihood("gnp", dim_y=1, rank=3)
    raw = torch.from_numpy(_raw(rng, tl, shape=(1, 6), scale=1.0))
    xs = tl.sample(raw, _gen(3), N_MC)[:, 0, :, 0].double()     # (n, M)
    _, var, fac = (v.double() for v in tl._split(raw[0]))
    cov = torch.diag(var[:, 0]) + fac[:, 0] @ fac[:, 0].T
    c = xs - xs.mean(0)
    prod = c[:, :, None] * c[:, None, :]
    cov_hat = prod.mean(0)
    se = prod.std(0) / np.sqrt(N_MC)
    assert bool(((cov_hat - cov).abs() <= 5.0 * se).all())
    # off-diagonal covariance is really there: the factors correlate targets
    assert float((cov - torch.diag(torch.diag(cov))).abs().max()) > 10.0 * float(se.max())


@pytest.mark.parametrize("name,dim_y,kw", HEADS, ids=IDS)
def test_sampling_is_seeded_and_needs_a_generator(rng, name, dim_y, kw):
    tl = tlik.get_likelihood(name, dim_y=dim_y, **kw)
    raw = torch.from_numpy(_raw(rng, tl))
    a, b, c = (tl.sample(raw, _gen(s), 4) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        tl.sample(raw, None, 4)


def _cdf_targets(rng, name, shape):
    """Values on every side of the heads' point masses: dry days and exact
    spikes, just inside them, and the body."""
    if name == "bernoulli-gamma":
        v = np.concatenate([[0.0, 1e-7, 1e-6, 1e-5], rng.gamma(2.0, 1.5, 64)])
    elif name == "cnp-spikes-beta":
        v = np.concatenate([[0.0, 1.0, 1e-7, 1 - 1e-7, 1e-4, 1 - 1e-4, -0.1, 1.1],
                            rng.random(64)])
    else:
        v = rng.normal(scale=2.0, size=72)
    return np.resize(v, shape).astype(np.float32)


@pytest.mark.parametrize("name,dim_y,kw", HEADS, ids=IDS)
def test_cdf_bounds_match_jax(rng, name, dim_y, kw):
    jl, tl = _pair(name, dim_y, kw)
    raw = _raw(rng, jl, shape=(4, 18))
    y = _cdf_targets(rng, name, (4, 18, dim_y))
    tol = {"bernoulli-gamma": dict(atol=1e-5), "cnp-spikes-beta": dict(atol=1e-4)}.get(name, {})
    got = tl.cdf_bounds(torch.from_numpy(raw), torch.from_numpy(y))
    want = jl.cdf_bounds(jnp.asarray(raw), jnp.asarray(y))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 18, dim_y)
        _close(g.numpy(), w, **tol)
    lo, hi = got
    assert bool(((lo >= 0) & (lo <= hi + 1e-7) & (hi <= 1)).all())
    if name in ("bernoulli-gamma", "cnp-spikes-beta"):  # the point masses bracket
        p_at0 = (1.0 - torch.sigmoid(torch.from_numpy(raw[..., 0])) if name == "bernoulli-gamma"
                 else torch.softmax(torch.from_numpy(raw[..., :3]), -1)[..., 0])
        at0 = torch.from_numpy(y[..., 0] <= 0.0)
        torch.testing.assert_close(hi[..., 0][at0], p_at0[at0], rtol=1e-6, atol=1e-7)
        assert bool((lo[..., 0][at0] == 0).all())


def test_betainc_matches_jax_and_scipy(rng):
    """α, β in [1e-2, 1e2] (log-uniform), y uniform and within 1e-7..1e-1 of
    0 and of 1: to 1e-6 of scipy's float64 value, to 1e-4 of JAX's f32."""
    n = 3000
    a = (10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    b = (10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    near = 10.0 ** rng.uniform(-7, -1, n // 3)
    y = np.concatenate([rng.random(n - 2 * (n // 3)), near, 1.0 - near]).astype(np.float32)
    got = tlik.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(y))
    assert got.dtype == torch.float32
    ref = scipy.special.betainc(a.astype(np.float64), b.astype(np.float64), y.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    jx = np.asarray(jax.scipy.special.betainc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), jx, rtol=0, atol=1e-4)


def test_betainc_edges_and_symmetry(rng):
    a = torch.tensor([0.3, 2.0, 50.0], dtype=torch.float64)
    b = torch.tensor([4.0, 0.05, 60.0], dtype=torch.float64)
    assert torch.equal(tlik.betainc(a, b, torch.zeros(3, dtype=torch.float64)), torch.zeros(3, dtype=torch.float64))
    assert torch.equal(tlik.betainc(a, b, torch.ones(3, dtype=torch.float64)), torch.ones(3, dtype=torch.float64))
    x = torch.from_numpy(rng.random(3))
    torch.testing.assert_close(tlik.betainc(a, b, x), 1.0 - tlik.betainc(b, a, 1.0 - x),
                               rtol=0, atol=1e-13)
    # I_x(1, 1) = x and I_x(a, 1) = x^a
    torch.testing.assert_close(tlik.betainc(1.0, 1.0, x), x, rtol=0, atol=1e-14)
    torch.testing.assert_close(tlik.betainc(a, 1.0, x), x ** a, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name,dim_y,kw", [h for h in HEADS if h[0] in ("cnp", "gnp")],
                         ids=[i for i, h in zip(IDS, HEADS) if h[0] in ("cnp", "gnp")])
def test_gaussian_crps_matches_jax(rng, name, dim_y, kw):
    jl, tl = _pair(name, dim_y, kw)
    raw = _raw(rng, jl, shape=(3, 11))
    y = rng.normal(scale=2.0, size=(3, 11, dim_y)).astype(np.float32)
    got = tl.crps(torch.from_numpy(raw), torch.from_numpy(y))
    want = jl.crps(jnp.asarray(raw), jnp.asarray(y))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    assert bool((got > 0).all())


@pytest.mark.parametrize("name", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_sampled_crps_matches_jax_on_fixed_samples(rng, monkeypatch, name):
    """The mixed heads' CRPS is the energy form over samples: with both
    heads' ``sample`` patched to return the same fixed samples (ties from
    the point masses included), the sorted U-statistic gives JAX's value."""
    jl, tl = _pair(name, 1, {})
    raw = _raw(rng, jl, shape=(2, 7))
    n = 33
    xs = _targets_with_ties(rng, (n, 2, 7, 1))
    y = _targets_with_ties(rng, (2, 7, 1))
    monkeypatch.setattr(type(jl), "sample", lambda self, r, k, m: jnp.asarray(xs))
    monkeypatch.setattr(type(tl), "sample", lambda self, r, g, m: torch.from_numpy(xs))
    want = np.asarray(jl.crps(jnp.asarray(raw), jnp.asarray(y), jax.random.key(0), n))
    got = tl.crps(torch.from_numpy(raw), torch.from_numpy(y), _gen(), n)
    _close(got.numpy(), want)
    # the U-statistic against the O(n²) pairwise mean
    pair = np.abs(xs[:, None] - xs[None]).sum((0, 1)) / (n * (n - 1))
    direct = np.abs(xs - y[None]).mean(0) - 0.5 * pair
    np.testing.assert_allclose(got.numpy(), direct, rtol=1e-5, atol=1e-6)


def _targets_with_ties(rng, shape):
    v = rng.random(shape)
    return np.where(v < 0.25, 0.0, np.where(v > 0.85, 1.0, v)).astype(np.float32)


def test_sampled_crps_converges_to_the_closed_form(rng):
    """For a Gaussian the energy form over 8192 samples is within 5
    standard errors of the closed form (the errors of its two terms, from
    the samples: |X−y| and |X−X′| over disjoint halves)."""
    tl = tlik.get_likelihood("cnp")
    raw = torch.from_numpy(_raw(rng, tl, shape=(2, 6), scale=1.0))
    y = torch.from_numpy(rng.normal(size=(2, 6, 1)).astype(np.float32))
    closed = tl.crps(raw, y)
    xs = tl.sample(raw, _gen(4), N_MC)
    sampled = tlik.energy_crps(xs, y)
    half = N_MC // 2
    se = ((xs - y).abs().std(0) / np.sqrt(N_MC)
          + 0.5 * (xs[:half] - xs[half:]).abs().std(0) / np.sqrt(half))
    assert bool(((sampled - closed).abs() <= 5.0 * se).all())


@pytest.mark.parametrize("name", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_sampled_crps_needs_a_generator(rng, name):
    tl = tlik.get_likelihood(name)
    raw = torch.from_numpy(_raw(rng, tl))
    y = torch.zeros(2, 5, 1)
    with pytest.raises(ValueError):
        tl.crps(raw, y)
    got = tl.crps(raw, y, _gen(), 16)
    assert got.shape == (2, 5, 1) and bool(torch.isfinite(got).all())
