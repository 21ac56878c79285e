"""Likelihood heads: parameter layout, masked NLL, moments, spread rescale.

Counterpart of ``deepsensornz_tpu/models/likelihoods.py``, all four
families: ``cnp`` (heteroscedastic diagonal Gaussian), ``gnp`` (low-rank +
diagonal multivariate Gaussian), ``bernoulli-gamma`` (point mass at 0 +
Gamma body) and ``cnp-spikes-beta`` (point masses at 0 and 1 + Beta body),
each with ``num_params``, ``nll``, ``mean_std`` and ``rescale_raw``; the
mixed heads also with ``body_interval``. A head consumes a raw parameter
block (..., M, K) from the ConvNP decoder, targets (..., M, dy) and a
validity mask (..., M). NLLs are per-target normalised over valid targets,
and a fully masked (padded) task contributes nothing. All math is float32.

Not ported yet: ``sample``, ``cdf_bounds`` and ``crps`` (they raise
``NotImplementedError``).
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


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """What every head shares: the masked per-task mean and the methods
    that wait for a later port."""

    dim_y: int = 1
    name: str = "base"

    def _norm(self, pointwise_nll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # batch mean weighted by per-task validity: a fully masked (padded)
        # task contributes neither a constant nor a dilution
        m = mask.float()
        n_valid = m.sum(-1)
        per_task = (pointwise_nll * m).sum(-1) / torch.clamp(n_valid, min=1.0)
        has_valid = (n_valid > 0).float()
        return (per_task * has_valid).sum() / torch.clamp(has_valid.sum(), min=1.0)

    def sample(self, raw, generator, n):
        raise NotImplementedError(f"{self.name}.sample is not ported yet")

    def cdf_bounds(self, raw, y):
        raise NotImplementedError(f"{self.name}.cdf_bounds is not ported yet")

    def crps(self, raw, y, generator=None, n=64):
        raise NotImplementedError(f"{self.name}.crps is not ported yet")


@dataclasses.dataclass(frozen=True)
class HeteroscedasticGaussian(Likelihood):
    """``cnp``: per-target mean and softplus std."""

    name: str = "cnp"

    def num_params(self) -> int:
        return 2 * self.dim_y

    def _split(self, raw):
        mu = raw[..., : self.dim_y]
        sigma = _softplus(raw[..., self.dim_y: 2 * self.dim_y])
        return mu, sigma

    def nll(self, raw, y, mask):
        mu, sigma = self._split(raw)
        z = (y.float() - mu) / sigma
        point = 0.5 * (torch.square(z) + 2.0 * torch.log(sigma) + _LOG_2PI)
        return self._norm(point.sum(-1), mask)

    def mean_std(self, raw):
        return self._split(raw)

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

    def nll(self, raw, y, mask):
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
        has_valid = (n_valid_raw > 0).float()
        per_task = nll / torch.clamp(n_valid_raw, min=1.0)
        return (per_task * has_valid).sum() / torch.clamp(has_valid.sum(), min=1.0)

    def mean_std(self, raw):
        mu, var, fac = self._split(raw)
        return mu, torch.sqrt(var + torch.sum(torch.square(fac), dim=-1))

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

    def nll(self, raw, y, mask):
        p, k, rate = self._split(raw)
        yv = y[..., 0].float()
        wet = yv > _EPS
        y_safe = torch.clamp(yv, min=_EPS)
        log_gamma = (k * torch.log(rate) + (k - 1.0) * torch.log(y_safe) - rate * y_safe
                     - torch.lgamma(k))
        log_p = torch.log(torch.clamp(p, _EPS, 1 - _EPS))
        log_1mp = torch.log(torch.clamp(1.0 - p, _EPS, 1 - _EPS))
        point = -torch.where(wet, log_p + log_gamma, log_1mp)
        return self._norm(point, mask)

    def mean_std(self, raw):
        p, k, rate = self._split(raw)
        mean_wet = k / rate
        var_wet = k / torch.square(rate)
        mean = p * mean_wet
        var = p * var_wet + p * (1.0 - p) * torch.square(mean_wet)
        return mean[..., None], torch.sqrt(var)[..., None]

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

    def nll(self, raw, y, mask):
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
        return self._norm(point, mask)

    def mean_std(self, raw):
        probs, alpha, beta = self._split(raw)
        ab = alpha + beta
        mean_body = alpha / ab
        var_body = alpha * beta / (torch.square(ab) * (ab + 1.0))
        mean = probs[..., 1] + probs[..., 2] * mean_body
        ex2 = probs[..., 1] + probs[..., 2] * (var_body + torch.square(mean_body))
        var = torch.clamp(ex2 - torch.square(mean), min=0.0)
        return mean[..., None], torch.sqrt(var)[..., None]

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
