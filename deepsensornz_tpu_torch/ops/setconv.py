"""SetConv encode/decode: the plain PyTorch versions.

Counterpart of ``deepsensornz_tpu/ops/setconv.py``. The RBF kernel is
separable over the two coordinate axes,

    k((g1,g2),(p1,p2)) = exp(-(g1-p1)²/2ℓ²) · exp(-(g2-p2)²/2ℓ²),

so every SetConv is two dense contractions. Conventions kept from the JAX
package: the RBF is computed in float32, encoded grids carry the density
channel FIRST, the validity mask folds into the density, value channels
are divided by ``density + 1e-8``, and the gridded/off-grid decodes are
normalised by the separable sum of weights.

Layouts are the JAX ones: NHWC grids ``(B, H, W, C)``. The point-set
encode, its length-scale gradient and the gridded decode have hand-written
CUDA kernels (:mod:`.setconv_cuda`); these functions are their plain
versions, used on the CPU and as the kernels' reference on the card.
"""

from __future__ import annotations

import torch

DENSITY_EPS = 1e-8


def rbf(a: torch.Tensor, b: torch.Tensor, lengthscale) -> torch.Tensor:
    """exp(-(a-b)²/2ℓ²) with broadcasting; computed in f32."""
    d = a.float() - b.float()
    ls = torch.as_tensor(lengthscale, dtype=torch.float32, device=d.device)
    return torch.exp(-0.5 * torch.square(d / ls))


def _density_normalise(f: torch.Tensor) -> torch.Tensor:
    density = f[..., :1]
    return torch.cat([density, f[..., 1:] / (density + DENSITY_EPS)], dim=-1)


def _augment(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[mask, y·mask] along the last axis: density channel first."""
    m = mask.float()[..., None]
    return torch.cat([m, y.float() * m], dim=-1)


def setconv_encode_offgrid(x1g, x2g, x, y, mask, lengthscale) -> torch.Tensor:
    """Scatter a ragged point set onto the internal grid.

    x1g (H,), x2g (W,), x (B, N, 2), y (B, N, C), mask (B, N) →
    (B, H, W, C+1): channel 0 the density, 1..C density-normalised values.
    Padded points contribute exactly zero to both.
    """
    w1 = rbf(x1g[None, :, None], x[:, None, :, 0], lengthscale)  # (B, H, N)
    w2 = rbf(x2g[None, None, :], x[:, :, None, 1], lengthscale)  # (B, N, W)
    t = w2[..., None] * _augment(y, mask)[:, :, None, :]          # (B, N, W, C+1)
    return _density_normalise(torch.einsum("bhn,bnwc->bhwc", w1, t))


def encode_offgrid_grad_ls_terms(x1g, x2g, x, y, mask, lengthscale,
                                 grad_out) -> tuple[torch.Tensor, ...]:
    """The summands of dL/dℓ for :func:`setconv_encode_offgrid`, given
    ``grad_out`` = dL/d(output) (B, H, W, C+1), computed in its dtype.

    With w = exp(-(d1²+d2²)/2ℓ²) and yaug = [mask, y·mask]:
    S_c = Σ_n w·yaug_c (the forward's sums), T_c = Σ_n w·(d1²+d2²)·yaug_c/ℓ³
    (= dS_c/dℓ) and D = S_0 + 1e-8, the three terms g_0·T_0 (B, H, W, 1),
    g_c·T_c/D and −g_c·S_c·T_0/D² (B, H, W, C). Their sum is dL/dℓ; the
    sum of their absolute values is the scale its rounding error is judged
    by. T is separable like S: (W1∘D1²)·(W2∘yaug) + W1·(W2∘D2²∘yaug)."""
    dt = grad_out.dtype
    ls = torch.as_tensor(lengthscale, dtype=dt, device=x.device)
    d1 = torch.square((x1g.to(dt)[None, :, None] - x[:, None, :, 0].to(dt)) / ls)  # (B, H, N)
    d2 = torch.square((x2g.to(dt)[None, None, :] - x[:, :, None, 1].to(dt)) / ls)  # (B, N, W)
    w1, w2 = torch.exp(-0.5 * d1), torch.exp(-0.5 * d2)
    m = mask.to(dt)[..., None]
    t = w2[..., None] * torch.cat([m, y.to(dt) * m], dim=-1)[:, :, None, :]  # (B, N, W, C+1)
    S = torch.einsum("bhn,bnwc->bhwc", w1, t)
    T = (torch.einsum("bhn,bnwc->bhwc", w1 * d1, t)
         + torch.einsum("bhn,bnwc->bhwc", w1, t * d2[..., None])) / ls
    D = S[..., :1] + DENSITY_EPS
    g = grad_out
    return (g[..., :1] * T[..., :1], g[..., 1:] * T[..., 1:] / D,
            -g[..., 1:] * S[..., 1:] * T[..., :1] / (D * D))


def setconv_encode_offgrid_grad_ls(x1g, x2g, x, y, mask, lengthscale, grad_out) -> torch.Tensor:
    """dL/dℓ of :func:`setconv_encode_offgrid` from the closed form, a
    0-d tensor in ``grad_out``'s dtype: the plain version of the encode's
    backward kernel (``csrc/setconv_encode_grad.cu``). ℓ is the only input
    it differentiates."""
    return sum(t.sum() for t in encode_offgrid_grad_ls_terms(
        x1g, x2g, x, y, mask, lengthscale, grad_out))


def setconv_encode_grid(x1g, x2g, xc1, xc2, y, lengthscale, mask=None) -> torch.Tensor:
    """Resample a gridded context set (B, Hc, Wc, C) onto the internal grid:
    ``A @ y_aug @ Bᵀ`` with A = (H, Hc), B = (W, Wc). Returns (B, H, W, C+1)."""
    A = rbf(x1g[:, None], xc1[None, :], lengthscale)   # (H, Hc)
    Bm = rbf(x2g[:, None], xc2[None, :], lengthscale)  # (W, Wc)
    if mask is None:
        mask = torch.ones(y.shape[:3], dtype=torch.float32, device=y.device)
    t = torch.einsum("hi,bijc->bhjc", A, _augment(y, mask))
    return _density_normalise(torch.einsum("wj,bhjc->bhwc", Bm, t))


def setconv_decode_offgrid(x1g, x2g, f, xt, lengthscale, normalize=True) -> torch.Tensor:
    """Interpolate internal-grid features (B, H, W, C) at off-grid targets
    xt (B, M, 2) → (B, M, C); normalised per target by (Σ_h w1)(Σ_w w2)."""
    w1 = rbf(xt[:, :, None, 0], x1g[None, None, :], lengthscale)  # (B, M, H)
    w2 = rbf(xt[:, :, None, 1], x2g[None, None, :], lengthscale)  # (B, M, W)
    t = torch.einsum("bmh,bhwc->bmwc", w1, f.float())
    out = torch.einsum("bmw,bmwc->bmc", w2, t)
    if normalize:
        z = w1.sum(-1) * w2.sum(-1)
        out = out / (z[..., None] + DENSITY_EPS)
    return out


def setconv_decode_grid(x1g, x2g, f, xt1, xt2, lengthscale, normalize=True) -> torch.Tensor:
    """Interpolate internal-grid features (B, H, W, C) onto the regular
    target grid xt1 (Ht,) × xt2 (Wt,) → (B, Ht, Wt, C): two matmuls,
    (Ht,H) @ f @ (W,Wt), normalised by (Σ_h A)(Σ_w B)."""
    A = rbf(xt1[:, None], x1g[None, :], lengthscale)   # (Ht, H)
    Bm = rbf(xt2[:, None], x2g[None, :], lengthscale)  # (Wt, W)
    t = torch.einsum("th,bhwc->btwc", A, f.float())
    out = torch.einsum("uw,btwc->btuc", Bm, t)
    if normalize:
        z = A.sum(-1)[:, None] * Bm.sum(-1)[None, :]
        out = out / (z[None, ..., None] + DENSITY_EPS)
    return out
