"""The four likelihood heads of the port against the JAX package on the CPU.

For each head: the masked NLL and its gradient with respect to the raw
parameters (``jax.grad`` against torch autograd), with a fully masked
(padded) task and a partly masked one in the batch; the moments,
``rescale_raw`` and ``body_interval`` of the two mixed heads; and a gnp
task whose capacitance cannot be factored in f32 (learned factors grown
against the floored noise), which both sides must send to the diagonal
fallback.

Inputs are made with numpy from a seed. Tolerances: the values agree to
rtol 1e-5 (f32, sums of a few dozen terms in different orders); gradients
to rtol 1e-4 with an atol of 1e-5 times their largest magnitude (the gnp
gradient passes through a Cholesky factor and a triangular solve, whose
rounding differs between LAPACK calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu_torch.models import likelihoods as tlik

HEADS = [("gnp", 1, {"rank": 4}), ("gnp", 2, {"rank": 3}), ("cnp", 1, {}), ("cnp", 2, {}),
         ("bernoulli-gamma", 1, {}), ("cnp-spikes-beta", 1, {})]


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30))


def _targets(rng, name, shape):
    if name == "bernoulli-gamma":  # dry (exact zeros) and wet days
        return np.where(rng.random(shape) < 0.4, 0.0, rng.gamma(2.0, 1.5, shape))
    if name == "cnp-spikes-beta":  # both spikes and the body
        u = rng.random(shape)
        return np.where(u < 0.2, 0.0, np.where(u > 0.8, 1.0, rng.beta(2.0, 3.0, shape)))
    return rng.normal(size=shape)


def _inputs(rng, name, dim_y, jl, B=4, M=9):
    raw = (1.5 * rng.normal(size=(B, M, jl.num_params()))).astype(np.float32)
    y = _targets(rng, name, (B, M, dim_y)).astype(np.float32)
    mask = (rng.random((B, M)) > 0.3).astype(np.float32)
    mask[1] = 0.0  # a padded task
    return raw, y, mask


def _nll_and_grad(jl, tl, raw, y, mask):
    jfun = lambda r: jl.nll(r, jnp.asarray(y), jnp.asarray(mask))  # noqa: E731
    jv, jg = jax.value_and_grad(jfun)(jnp.asarray(raw))
    traw = torch.from_numpy(raw).requires_grad_(True)
    tv = tl.nll(traw, torch.from_numpy(y), torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tv, traw)
    return (float(tv.detach()), tg.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("name,dim_y,kw", HEADS)
def test_nll_and_grad_match_jax(rng, name, dim_y, kw):
    jl = jlik.get_likelihood(name, dim_y=dim_y, **kw)
    tl = tlik.get_likelihood(name, dim_y=dim_y, **kw)
    assert tl.num_params() == jl.num_params()
    raw, y, mask = _inputs(rng, name, dim_y, jl)
    (tv, tg), (jv, jg) = _nll_and_grad(jl, tl, raw, y, mask)
    assert np.isfinite(tv)
    _close(tv, jv)
    _close(tg, jg, rtol=1e-4, atol_frac=1e-5)
    assert not tg[1].any()  # the padded task gets no gradient


@pytest.mark.parametrize("name,dim_y,kw", HEADS)
def test_padded_task_adds_nothing(rng, name, dim_y, kw):
    """A fully masked task changes neither the value nor the mean over the
    real tasks (the gnp 2π term uses the raw count)."""
    tl = tlik.get_likelihood(name, dim_y=dim_y, **kw)
    raw, y, mask = _inputs(rng, name, dim_y, tl)
    keep = [0, 2, 3]
    full = tl.nll(*(torch.from_numpy(a) for a in (raw, y, mask)))
    real = tl.nll(*(torch.from_numpy(a[keep]) for a in (raw, y, mask)))
    torch.testing.assert_close(full, real, rtol=1e-6, atol=0)


def test_gnp_unfactorable_capacitance_falls_back(rng):
    """Factors of 1e18 against the 1e-4 noise floor overflow FᵀD⁻¹F in f32:
    JAX's Cholesky returns NaN there, torch's reports it in ``info`` or
    with a non-finite factor. Both take the diagonal-only likelihood for
    that task, with a finite value and gradient."""
    jl = jlik.get_likelihood("gnp", dim_y=1, rank=4)
    tl = tlik.get_likelihood("gnp", dim_y=1, rank=4)
    raw, y, mask = _inputs(rng, "gnp", 1, jl)
    raw[0, :, 1] = -30.0  # noise variance on its floor
    raw[0, :, 2:] = 1e18
    (tv, tg), (jv, jg) = _nll_and_grad(jl, tl, raw, y, mask)
    assert np.isfinite(tv) and np.isfinite(tg).all()
    _close(tv, jv)
    _close(tg, jg, rtol=1e-4, atol_frac=1e-5)
    # task 0 alone equals its diagonal-only likelihood
    m = mask[0] > 0
    var = np.maximum(np.log1p(np.exp(-30.0)) + 1e-6, 1e-4)
    diag = 0.5 * np.mean((y[0, m, 0] - raw[0, m, 0]) ** 2 / var + np.log(var) + np.log(2 * np.pi))
    only0 = tl.nll(*(torch.from_numpy(a[:1]) for a in (raw, y, mask)))
    np.testing.assert_allclose(float(only0), diag, rtol=1e-5)


@pytest.mark.parametrize("name", ["bernoulli-gamma", "cnp-spikes-beta"])
def test_mixed_heads_moments_rescale_and_body_match_jax(rng, name):
    jl = jlik.get_likelihood(name)
    tl = tlik.get_likelihood(name)
    raw = (1.5 * rng.normal(size=(3, 7, jl.num_params()))).astype(np.float32)
    for s in (1.0, 1.7):
        jr = np.asarray(jl.rescale_raw(jnp.asarray(raw), s))
        tr = tl.rescale_raw(torch.from_numpy(raw), s)
        _close(tr.numpy(), jr)
        for g, w in zip(tl.mean_std(tr), jl.mean_std(jnp.asarray(jr))):
            _close(g.numpy(), w)
        for g, w in zip(tl.body_interval(tr), jl.body_interval(jnp.asarray(jr))):
            _close(g.numpy(), w)


@pytest.mark.parametrize("method,args", [("sample", (None, 4)),
                                         ("cdf_bounds", (torch.zeros(1, 2, 1),)),
                                         ("crps", (torch.zeros(1, 2, 1),))])
def test_unported_methods_raise(method, args):
    with pytest.raises(NotImplementedError):
        getattr(tlik.get_likelihood("cnp"), method)(torch.zeros(1, 2, 2), *args)
