"""Likelihood heads: parameter layout, masked NLL, moments, spread rescale.

Counterpart of ``deepsensornz_tpu/models/likelihoods.py``, all four
families: ``cnp`` (heteroscedastic diagonal Gaussian), ``gnp`` (low-rank +
diagonal multivariate Gaussian), ``bernoulli-gamma`` (point mass at 0 +
Gamma body) and ``cnp-spikes-beta`` (point masses at 0 and 1 + Beta body),
each with ``num_params``, ``nll``, ``mean_std``, ``rescale_raw``,
``sample``, ``cdf_bounds`` and ``crps``; the mixed heads also with
``body_interval``. A head consumes a raw parameter block (..., M, K) from
the ConvNP decoder, targets (..., M, dy) and a validity mask (..., M). NLLs
are per-target normalised over valid targets, and a fully masked (padded)
task contributes nothing; ``nll(..., n_tasks=)`` divides by a count of
valid tasks given from outside (a data-parallel shard's, the whole batch's
count). All math is float32, except :func:`betainc`,
which runs its continued fraction in float64.

Sampling takes an explicit ``torch.Generator`` on the device of ``raw``
and never the global generator. Each head splits it in two: ``draw``
makes the standard random numbers (normals, Bernoulli and gamma draws, a
component index and a Beta body) and ``transform`` maps them to samples
with the JAX package's formula, so the same draws give the same samples
on both sides.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

_EPS = 1e-6
_LOG_2PI = 1.8378770664093453


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) + _EPS


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_softplus``: x with softplus(x) + eps = y."""
    z = torch.clamp(y - _EPS, min=1e-8)
    # log(expm1(z)) is stable below ~20; above, softplus(x) ≈ x
    return torch.where(z < 20.0, torch.log(torch.expm1(z)), z)


def _task_mean(per_task: torch.Tensor, n_valid: torch.Tensor, n_tasks=None) -> torch.Tensor:
    """Σ of the per-task NLLs of the tasks with a valid target over the
    number of such tasks: this batch's, or ``n_tasks`` (0-d) where the
    batch is one shard of a larger one (the whole batch's count, so that the
    shards' losses sum to the whole batch's)."""
    has_valid = (n_valid > 0).float()
    count = has_valid.sum() if n_tasks is None else n_tasks
    return (per_task * has_valid).sum() / torch.clamp(count, min=1.0)


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """What every head shares: the masked per-task mean, the sampled CRPS
    and the interface each head fills in."""

    dim_y: int = 1
    name: str = "base"
    # whether :meth:`draw` reads the values of ``raw`` (the mixed heads'
    # Bernoulli and Gamma/Beta draws) or only its shape (the Gaussians')
    draws_depend_on_raw = True

    def _norm(self, pointwise_nll: torch.Tensor, mask: torch.Tensor,
              n_tasks=None) -> torch.Tensor:
        # batch mean weighted by per-task validity: a fully masked (padded)
        # task contributes neither a constant nor a dilution
        m = mask.float()
        n_valid = m.sum(-1)
        per_task = (pointwise_nll * m).sum(-1) / torch.clamp(n_valid, min=1.0)
        return _task_mean(per_task, n_valid, n_tasks)

    def draw(self, raw, generator: torch.Generator, n: int) -> tuple:
        """The standard random draws behind ``n`` samples."""
        raise NotImplementedError(f"{self.name} defines no sampler")

    def transform(self, raw, draws: tuple) -> torch.Tensor:
        """Samples (n, ..., M, dy) from the draws of :meth:`draw`."""
        raise NotImplementedError(f"{self.name} defines no sampler")

    def sample(self, raw, generator: torch.Generator, n: int) -> torch.Tensor:
        """n joint samples, shape (n, ..., M, dy)."""
        return self.transform(raw, self.draw(raw, generator, n))

    def cdf_bounds(self, raw, y):
        """(F(y⁻), F(y)) of the predictive distribution at each target: equal
        for the continuous heads, bracketing the point masses of the mixed
        ones (the randomised PIT draws between them)."""
        raise NotImplementedError(f"{self.name} defines no cdf")

    def crps(self, raw, y, generator=None, n: int = 64) -> torch.Tensor:
        """Marginal CRPS per target, shape (..., M, dy), from ``n`` samples:
        the energy form E|X−y| − ½E|X−X′| (:func:`energy_crps`). The
        Gaussian heads override it with the closed form."""
        return energy_crps(self.sample(raw, generator, n), y)

    @staticmethod
    def _gaussian_crps(mu, sigma, y):
        """Closed-form CRPS of N(mu, sigma²) at y:
        σ·[z(2Φ(z)−1) + 2φ(z) − 1/√π]."""
        z = (y.float() - mu) / sigma
        phi = torch.exp(-0.5 * torch.square(z)) / math.sqrt(2.0 * math.pi)
        return sigma * (z * (2.0 * torch.special.ndtr(z) - 1.0) + 2.0 * phi
                        - 1.0 / math.sqrt(math.pi))


@dataclasses.dataclass(frozen=True)
class HeteroscedasticGaussian(Likelihood):
    """``cnp``: per-target mean and softplus std."""

    name: str = "cnp"
    draws_depend_on_raw = False

    def num_params(self) -> int:
        return 2 * self.dim_y

    def _split(self, raw):
        mu = raw[..., : self.dim_y]
        sigma = _softplus(raw[..., self.dim_y: 2 * self.dim_y])
        return mu, sigma

    def nll(self, raw, y, mask, n_tasks=None):
        mu, sigma = self._split(raw)
        z = (y.float() - mu) / sigma
        point = 0.5 * (torch.square(z) + 2.0 * torch.log(sigma) + _LOG_2PI)
        return self._norm(point.sum(-1), mask, n_tasks)

    def mean_std(self, raw):
        return self._split(raw)

    def draw(self, raw, generator, n):
        return (_randn((n,) + raw.shape[:-1] + (self.dim_y,), raw, generator),)

    def transform(self, raw, draws):
        mu, sigma = self._split(raw)
        return mu + sigma * draws[0]

    def cdf_bounds(self, raw, y):
        mu, sigma = self._split(raw)
        f = torch.special.ndtr((y.float() - mu) / sigma)
        return f, f

    def crps(self, raw, y, generator=None, n=0):
        mu, sigma = self._split(raw)
        return self._gaussian_crps(mu, sigma, y)

    def rescale_raw(self, raw, s):
        """Spread ×s, mean unchanged."""
        dy = self.dim_y
        sigma = _softplus(raw[..., dy: 2 * dy]) * s
        return torch.cat([raw[..., :dy], _inv_softplus(sigma)], dim=-1)


@dataclasses.dataclass(frozen=True)
class LowRankGaussian(Likelihood):
    """``gnp``: Σ = diag(σ²) + FFᵀ with F ∈ R^{M·dy × R}; Woodbury NLL,
    O(M·R²)."""

    rank: int = 64
    name: str = "gnp"
    draws_depend_on_raw = False

    def num_params(self) -> int:
        return self.dim_y * (2 + self.rank)

    def _split(self, raw):
        dy, r = self.dim_y, self.rank
        mu = raw[..., :dy]
        # noise variance after softplus, floored at 1e-4: keeps FᵀD⁻¹F
        # conditioned in f32; the floor is the model everywhere
        var = torch.clamp(_softplus(raw[..., dy: 2 * dy]), min=1e-4)
        fac = raw[..., 2 * dy:].reshape(raw.shape[:-1] + (dy, r)) / math.sqrt(float(r))
        return mu, var, fac

    def _flatten(self, raw, mask):
        """(…, M, dy) → (…, M·dy) with mask-neutralised pads."""
        mu, var, fac = self._split(raw)
        m = mask.float()[..., None]
        lead = raw.shape[:-2]
        n = raw.shape[-2] * self.dim_y
        mu = (mu * m).reshape(lead + (n,))
        var = torch.where(m > 0, var, 1.0).reshape(lead + (n,))
        fac = (fac * m[..., None]).reshape(lead + (n, self.rank))
        mflat = m.expand(m.shape[:-1] + (self.dim_y,)).reshape(lead + (n,))
        return mu, var, fac, mflat

    def nll(self, raw, y, mask, n_tasks=None):
        mu, var, fac, mflat = self._flatten(raw, mask)
        yf = y.float().reshape(raw.shape[:-2] + (-1,)) * mflat
        r = (yf - mu) * mflat
        dinv = 1.0 / var
        dinv_r = dinv * r
        ft_dinv_r = torch.einsum("...nr,...n->...r", fac, dinv_r)
        cap = torch.einsum("...nr,...ns->...rs", fac, dinv[..., None] * fac)
        # scale-invariant jitter keeps the Cholesky PSD under f32 rounding
        diag_scale = 1.0 + cap.diagonal(dim1=-2, dim2=-1).mean(-1, keepdim=True)[..., None]
        eye = torch.eye(self.rank, dtype=torch.float32, device=raw.device)
        cap = cap + eye * (1.0 + 1e-6 * diag_scale)
        # a probe factorisation decides, per task, whether the capacitance
        # is factorable in f32; where it is not, that task falls back to the
        # diagonal-only likelihood. torch reports failure in `info` (with a
        # partial, finite factor) where JAX returns NaN, so both count. The
        # second factorisation runs on the sanitised matrix, so no failed
        # factor enters the differentiated graph.
        with torch.no_grad():
            probe, info = torch.linalg.cholesky_ex(cap.detach())
            cap_ok = (info == 0) & torch.isfinite(probe.diagonal(dim1=-2, dim2=-1)).all(-1)
        cap_safe = torch.where(cap_ok[..., None, None], cap, eye)
        chol = torch.linalg.cholesky_ex(cap_safe).L  # _ex: no host sync on its info
        sol = torch.cholesky_solve(ft_dinv_r[..., None], chol)[..., 0]
        # quad = rᵀΣ⁻¹r ≥ 0 in exact arithmetic; f32 cancellation in the
        # Woodbury form can push it negative, a hole the optimiser would
        # dive into, so clamp it to the cone
        corr = torch.where(cap_ok, (ft_dinv_r * sol).sum(-1), 0.0)
        quad = torch.clamp((r * dinv_r).sum(-1) - corr, min=0.0)
        logdet_lr = torch.where(
            cap_ok, 2.0 * torch.log(chol.diagonal(dim1=-2, dim2=-1)).sum(-1), 0.0)
        logdet = (torch.log(var) * mflat).sum(-1) + logdet_lr
        n_valid_raw = mflat.sum(-1)
        # the raw count for the 2π constant, so a padded task adds exactly
        # zero; the batch mean is weighted by per-task validity (as _norm)
        nll = 0.5 * (quad + logdet + n_valid_raw * _LOG_2PI)
        return _task_mean(nll / torch.clamp(n_valid_raw, min=1.0), n_valid_raw, n_tasks)

    def mean_std(self, raw):
        mu, var, fac = self._split(raw)
        return mu, torch.sqrt(var + torch.sum(torch.square(fac), dim=-1))

    def draw(self, raw, generator, n):
        """e1 (n, ..., M, dy) per target, e2 (n, ..., rank) per task: e2 is
        shared by all M targets of a task, which makes the sample joint."""
        lead = raw.shape[:-2]
        return (_randn((n,) + raw.shape[:-1] + (self.dim_y,), raw, generator),
                _randn((n,) + lead + (self.rank,), raw, generator))

    def transform(self, raw, draws):
        """mu + √var·e1 + F·e2; the correlated part is one batched product
        per sample, so no (n, ..., M, rank) tensor is formed."""
        e1, e2 = draws
        mu, var, fac = self._split(raw)
        lead, M = raw.shape[:-2], raw.shape[-2]
        f = fac.reshape(-1, M * self.dim_y, self.rank)   # (L, M·dy, rank)
        out = mu + torch.sqrt(var) * e1
        for s in range(e2.shape[0]):
            corr = torch.bmm(f, e2[s].reshape(-1, self.rank, 1))
            out[s] += corr.reshape(lead + (M, self.dim_y))
        return out

    def cdf_bounds(self, raw, y):
        # the marginal cdf: the joint structure enters the NLL, not the
        # pointwise calibration diagnostic
        mu, std = self.mean_std(raw)
        f = torch.special.ndtr((y.float() - mu) / std)
        return f, f

    def crps(self, raw, y, generator=None, n=0):
        # the marginal CRPS, with the low-rank-inclusive std of mean_std
        mu, std = self.mean_std(raw)
        return self._gaussian_crps(mu, std, y)

    def rescale_raw(self, raw, s):
        """Whole covariance ×s² (marginal std ×s), mean unchanged."""
        dy = self.dim_y
        var = torch.clamp(_softplus(raw[..., dy: 2 * dy]), min=1e-4) * (s * s)
        return torch.cat([raw[..., :dy], _inv_softplus(var), raw[..., 2 * dy:] * s], dim=-1)


@dataclasses.dataclass(frozen=True)
class BernoulliGamma(Likelihood):
    """``bernoulli-gamma`` (precipitation): P(y=0) = 1-p; y > 0 ~
    Gamma(k, rate). dim_y must be 1."""

    name: str = "bernoulli-gamma"

    def num_params(self) -> int:
        return 3 * self.dim_y

    def _split(self, raw):
        return torch.sigmoid(raw[..., 0]), _softplus(raw[..., 1]), _softplus(raw[..., 2])

    def nll(self, raw, y, mask, n_tasks=None):
        p, k, rate = self._split(raw)
        yv = y[..., 0].float()
        wet = yv > _EPS
        y_safe = torch.clamp(yv, min=_EPS)
        log_gamma = (k * torch.log(rate) + (k - 1.0) * torch.log(y_safe) - rate * y_safe
                     - torch.lgamma(k))
        log_p = torch.log(torch.clamp(p, _EPS, 1 - _EPS))
        log_1mp = torch.log(torch.clamp(1.0 - p, _EPS, 1 - _EPS))
        point = -torch.where(wet, log_p + log_gamma, log_1mp)
        return self._norm(point, mask, n_tasks)

    def mean_std(self, raw):
        p, k, rate = self._split(raw)
        mean_wet = k / rate
        var_wet = k / torch.square(rate)
        mean = p * mean_wet
        var = p * var_wet + p * (1.0 - p) * torch.square(mean_wet)
        return mean[..., None], torch.sqrt(var)[..., None]

    def draw(self, raw, generator, n):
        """wet ~ Bernoulli(p) and g ~ Gamma(k, 1), each (n, ..., M)."""
        _require(generator)
        p, k, _ = self._split(raw)
        shape = (n,) + p.shape
        wet = torch.bernoulli(p.expand(shape), generator=generator) > 0
        return wet, torch._standard_gamma(k.expand(shape).contiguous(), generator=generator)

    def transform(self, raw, draws):
        wet, g = draws
        _, _, rate = self._split(raw)
        return torch.where(wet, g / rate, 0.0)[..., None]

    def cdf_bounds(self, raw, y):
        p, k, rate = self._split(raw)
        yv = y[..., 0].float()
        dry = yv <= _EPS
        # F(y) = (1−p) + p·P(k, rate·y) for y > 0; a point mass 1−p at 0
        f_wet = (1.0 - p) + p * torch.special.gammainc(k, rate * torch.clamp(yv, min=_EPS))
        lo = torch.where(dry, 0.0, f_wet)
        hi = torch.where(dry, 1.0 - p, f_wet)
        return lo[..., None], hi[..., None]

    def rescale_raw(self, raw, s):
        """Gamma(k/s², rate/s²): mean k/rate unchanged, std ×s; the dry
        probability (a point mass) is untouched."""
        s2 = s * s
        k = _softplus(raw[..., 1]) / s2
        rate = _softplus(raw[..., 2]) / s2
        return torch.stack([raw[..., 0], _inv_softplus(k), _inv_softplus(rate)], dim=-1)

    def body_interval(self, raw):
        """(F_lo, F_hi) of the Gamma body in cdf space: [1−p, 1]."""
        p = torch.sigmoid(raw[..., 0])
        return (1.0 - p)[..., None], torch.ones_like(p)[..., None]


@dataclasses.dataclass(frozen=True)
class SpikesBeta(Likelihood):
    """``cnp-spikes-beta`` (humidity in [0, 1]): spike at 0 (w.p. p0),
    spike at 1 (w.p. p1), Beta(α, β) body (w.p. p_body)."""

    name: str = "cnp-spikes-beta"

    def num_params(self) -> int:
        return 5 * self.dim_y

    def _split(self, raw):
        probs = torch.softmax(raw[..., :3], dim=-1)  # (p0, p1, p_body)
        return probs, _softplus(raw[..., 3]), _softplus(raw[..., 4])

    def nll(self, raw, y, mask, n_tasks=None):
        probs, alpha, beta = self._split(raw)
        yv = torch.clamp(y[..., 0].float(), 0.0, 1.0)
        at0 = yv < _EPS
        at1 = yv > 1.0 - _EPS
        y_safe = torch.clamp(yv, _EPS, 1.0 - _EPS)
        betaln = torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)
        log_beta_pdf = ((alpha - 1.0) * torch.log(y_safe)
                        + (beta - 1.0) * torch.log1p(-y_safe) - betaln)
        lp = torch.log(torch.clamp(probs, _EPS, 1.0))
        point = -torch.where(at0, lp[..., 0],
                             torch.where(at1, lp[..., 1], lp[..., 2] + log_beta_pdf))
        return self._norm(point, mask, n_tasks)

    def mean_std(self, raw):
        probs, alpha, beta = self._split(raw)
        ab = alpha + beta
        mean_body = alpha / ab
        var_body = alpha * beta / (torch.square(ab) * (ab + 1.0))
        mean = probs[..., 1] + probs[..., 2] * mean_body
        ex2 = probs[..., 1] + probs[..., 2] * (var_body + torch.square(mean_body))
        var = torch.clamp(ex2 - torch.square(mean), min=0.0)
        return mean[..., None], torch.sqrt(var)[..., None]

    def draw(self, raw, generator, n):
        """The component (0: spike at 0, 1: spike at 1, 2: body), drawn with
        the JAX package's probabilities clip(p, 1e-6, 1) renormalised, and a
        Beta(α, β) body, each (n, ..., M)."""
        _require(generator)
        probs, alpha, beta = self._split(raw)
        shape = (n,) + alpha.shape
        q = torch.clamp(probs, _EPS, 1.0)
        cum = torch.cumsum(q / q.sum(-1, keepdim=True), dim=-1)
        u = _rand(shape, raw, generator)
        comp = (u >= cum[..., 0]).long() + (u >= cum[..., 1]).long()
        body = torch.sigmoid(_log_gamma_draw(alpha, shape, raw, generator)
                             - _log_gamma_draw(beta, shape, raw, generator))
        return comp, body

    def transform(self, raw, draws):
        comp, body = draws
        out = torch.where(comp == 0, 0.0, torch.where(comp == 1, 1.0, body))
        return out[..., None]

    def cdf_bounds(self, raw, y):
        probs, alpha, beta = self._split(raw)
        p0, pb = probs[..., 0], probs[..., 2]
        yv = torch.clamp(y[..., 0].float(), 0.0, 1.0)
        at0 = yv < _EPS
        at1 = yv > 1.0 - _EPS
        f_body = p0 + pb * betainc(alpha, beta, torch.clamp(yv, _EPS, 1.0 - _EPS))
        lo = torch.where(at0, 0.0, torch.where(at1, p0 + pb, f_body))
        hi = torch.where(at0, p0, torch.where(at1, 1.0, f_body))
        return lo[..., None], hi[..., None]

    def rescale_raw(self, raw, s):
        """Beta(α/s², β/s²): mean α/(α+β) unchanged, std ≈ ×s; the spike
        masses are untouched."""
        s2 = s * s
        alpha = _softplus(raw[..., 3]) / s2
        beta = _softplus(raw[..., 4]) / s2
        return torch.cat([raw[..., :3], _inv_softplus(alpha)[..., None],
                          _inv_softplus(beta)[..., None]], dim=-1)

    def body_interval(self, raw):
        """(F_lo, F_hi) of the Beta body in cdf space: [p0, p0 + p_body]."""
        probs = torch.softmax(raw[..., :3], dim=-1)
        return probs[..., 0:1], (probs[..., 0] + probs[..., 2])[..., None]


def _require(generator) -> None:
    if not isinstance(generator, torch.Generator):
        raise ValueError("sampling needs an explicit torch.Generator on the device of raw")


def _randn(shape: tuple, like: torch.Tensor, generator) -> torch.Tensor:
    _require(generator)
    return torch.randn(shape, generator=generator, device=like.device, dtype=torch.float32)


def _rand(shape: tuple, like: torch.Tensor, generator) -> torch.Tensor:
    _require(generator)
    return torch.rand(shape, generator=generator, device=like.device, dtype=torch.float32)


def _log_gamma_draw(a: torch.Tensor, shape: tuple, like: torch.Tensor, generator) -> torch.Tensor:
    """log of a Gamma(a, 1) draw, as log G + log(U)/a with G ~ Gamma(a+1, 1)
    and U ~ U(0, 1]: finite for any a > 0, where a float32 Gamma(a) draw
    itself underflows (for a = 0.01 in ~40 % of draws)."""
    g = torch._standard_gamma((a + 1.0).expand(shape).contiguous(), generator=generator)
    u = 1.0 - _rand(shape, like, generator)
    return torch.log(torch.clamp(g, min=torch.finfo(torch.float32).tiny)) + torch.log(u) / a


def energy_crps(xs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CRPS from samples xs (n, ..., M, dy) at y (..., M, dy): E|X−y| minus
    half the unbiased pairwise mean, Σ_{i≠j}|x_i−x_j| / (n(n−1)) =
    2·Σ_k (2k−n+1)·x_(k) / (n(n−1)) over the sorted samples (k from 0)."""
    n = xs.shape[0]
    term1 = torch.mean(torch.abs(xs - y.float()[None]), dim=0)
    k = torch.arange(n, dtype=torch.float32, device=xs.device)
    w = (2.0 * k - n + 1.0) / (n * (n - 1.0))
    return term1 - torch.tensordot(w, torch.sort(xs, dim=0).values, dims=([0], [0]))


_BETACF_MAX_ITER = 1000
_BETACF_TINY = 1e-300


def betainc(a, b, x) -> torch.Tensor:
    """The regularised incomplete beta function I_x(a, b), elementwise with
    broadcasting, for a, b > 0 and x in [0, 1] (torch has none).

    The continued fraction of I_x(a, b) by the modified Lentz method, in
    float64, on the side where it converges fast: for x > (a+1)/(a+b+2) it
    evaluates 1 − I_{1−x}(b, a). The result has the dtype of the inputs'
    promotion (float32 for float32 inputs)."""
    a, b, x = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (a, b, x)))
    out_dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    a, b, x = a.double(), b.double(), x.double()
    swap = x > (a + 1.0) / (a + b + 2.0)
    xc = torch.clamp(x, 1e-300, 1.0 - 1e-16)  # both logs finite in every branch
    log_x, log_1mx = torch.log(xc), torch.log1p(-xc)
    a_, b_ = torch.where(swap, b, a), torch.where(swap, a, b)
    x_ = torch.where(swap, 1.0 - xc, xc)
    log_front = (a_ * torch.where(swap, log_1mx, log_x) + b_ * torch.where(swap, log_x, log_1mx)
                 - (torch.lgamma(a_) + torch.lgamma(b_) - torch.lgamma(a_ + b_)))
    res = torch.exp(log_front) * _betacf(a_, b_, x_) / a_
    res = torch.where(swap, 1.0 - res, res)
    res = torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, res))
    return res.to(out_dtype)


def _betacf(a, b, x) -> torch.Tensor:
    """The continued fraction of the incomplete beta function (modified
    Lentz), float64; converged when every factor is within 1e-15 of 1."""
    def nonzero(v):
        return torch.where(torch.abs(v) < _BETACF_TINY, _BETACF_TINY, v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / nonzero(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_MAX_ITER + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / nonzero(1.0 + aa * d)
        c = nonzero(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / nonzero(1.0 + aa * d)
        c = nonzero(1.0 + aa / c)
        step = d * c
        h = h * step
        # one convergence test (a host read) every 8 terms
        if m % 8 == 0 and bool((torch.abs(step - 1.0) <= 1e-15).all()):
            break
    return h


_REGISTRY = {
    "cnp": HeteroscedasticGaussian,
    "het": HeteroscedasticGaussian,
    "gnp": LowRankGaussian,
    "lowrank": LowRankGaussian,
    "bernoulli-gamma": BernoulliGamma,
    "cnp-spikes-beta": SpikesBeta,
}


def get_likelihood(name: str, dim_y: int = 1, **kw) -> Likelihood:
    """Factory by likelihood name."""
    return _REGISTRY[name](dim_y=dim_y, **kw)
