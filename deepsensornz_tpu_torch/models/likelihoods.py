"""Likelihood heads: parameter layout, predictive moments, spread rescale.

Counterpart of ``deepsensornz_tpu/models/likelihoods.py`` for serving:
``cnp`` (heteroscedastic diagonal Gaussian) and ``gnp`` (low-rank +
diagonal multivariate Gaussian) with ``num_params``, ``mean_std`` and
``rescale_raw``. A head consumes a raw parameter block (..., M, K) from
the ConvNP decoder. All math is float32.

Not ported yet: ``nll``, ``sample``, ``crps``, ``cdf_bounds`` and the
``bernoulli-gamma`` / ``cnp-spikes-beta`` heads (training and sampling).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

_EPS = 1e-6


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) + _EPS


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_softplus``: x with softplus(x) + eps = y."""
    z = torch.clamp(y - _EPS, min=1e-8)
    # log(expm1(z)) is stable below ~20; above, softplus(x) ≈ x
    return torch.where(z < 20.0, torch.log(torch.expm1(z)), z)


@dataclasses.dataclass(frozen=True)
class HeteroscedasticGaussian:
    """``cnp``: per-target mean and softplus std."""

    dim_y: int = 1
    name: str = "cnp"

    def num_params(self) -> int:
        return 2 * self.dim_y

    def _split(self, raw):
        mu = raw[..., : self.dim_y]
        sigma = _softplus(raw[..., self.dim_y: 2 * self.dim_y])
        return mu, sigma

    def mean_std(self, raw):
        return self._split(raw)

    def rescale_raw(self, raw, s):
        """Spread ×s, mean unchanged."""
        dy = self.dim_y
        sigma = _softplus(raw[..., dy: 2 * dy]) * s
        return torch.cat([raw[..., :dy], _inv_softplus(sigma)], dim=-1)


@dataclasses.dataclass(frozen=True)
class LowRankGaussian:
    """``gnp``: Σ = diag(σ²) + FFᵀ with F ∈ R^{M·dy × R}."""

    dim_y: int = 1
    rank: int = 64
    name: str = "gnp"

    def num_params(self) -> int:
        return self.dim_y * (2 + self.rank)

    def _split(self, raw):
        dy, r = self.dim_y, self.rank
        mu = raw[..., :dy]
        # noise variance after softplus, floored at 1e-4 (the JAX head's
        # conditioning floor, applied consistently everywhere)
        var = torch.clamp(_softplus(raw[..., dy: 2 * dy]), min=1e-4)
        fac = raw[..., 2 * dy:].reshape(raw.shape[:-1] + (dy, r)) / math.sqrt(float(r))
        return mu, var, fac

    def mean_std(self, raw):
        mu, var, fac = self._split(raw)
        return mu, torch.sqrt(var + torch.sum(torch.square(fac), dim=-1))

    def rescale_raw(self, raw, s):
        """Whole covariance ×s² (marginal std ×s), mean unchanged."""
        dy = self.dim_y
        var = torch.clamp(_softplus(raw[..., dy: 2 * dy]), min=1e-4) * (s * s)
        return torch.cat([raw[..., :dy], _inv_softplus(var), raw[..., 2 * dy:] * s], dim=-1)


_REGISTRY = {
    "cnp": HeteroscedasticGaussian,
    "het": HeteroscedasticGaussian,
    "gnp": LowRankGaussian,
    "lowrank": LowRankGaussian,
}
_NOT_PORTED = ("bernoulli-gamma", "cnp-spikes-beta")


def get_likelihood(name: str, dim_y: int = 1, **kw):
    """Factory by likelihood name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"likelihood {name!r} is not ported to PyTorch yet")
    return _REGISTRY[name](dim_y=dim_y, **kw)
