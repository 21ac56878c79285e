"""Plain PyTorch reference of the ConvNP with the ``cnp`` head, serving a
target grid that does not fit whole: the 0.01° WRF grid, 1390×1300.

Written from the model's equations, not from the port: it imports nothing
of ``deepsensornz_tpu_torch`` (or of the JAX package) and calls none of
their kernels, plain versions or helpers. The encodes, the U-Net (in the
configuration's dtype, bfloat16) and the MLP head are :mod:`.convnp`'s;
everything else is float32 with TF32 off (the caller sets the backend
flags). This file adds:

- the ``cnp`` head: mean μ = raw₀, std σ = softplus(raw₁) + 1e-6, and the
  spread rescale multiplying σ by ``std_scale``;
- :func:`serve_maps`, which computes a request's maps for a few of its
  tasks at a time and, for each, the target grid in blocks of target rows:
  each block's decode weights A (rows, H) against the whole internal grid,
  normalised by the block's own row sums (a target row's sum runs over all
  H, so no block needs another's), the aux at those targets appended, the
  head. Nothing is restricted to a band: every RBF sum runs over every
  source row and column, so no term is skipped, zero or not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import convnp as ref


def n_outputs(model: dict) -> int:
    if model["likelihood"] != "cnp":
        raise ValueError(f"this reference has the cnp head only, not {model['likelihood']!r}")
    return 2 * model["dim_yt"]


def param_spec(model: dict, grid_channels, point_channels, aux_channels: int) -> dict:
    """name → (shape, fan_in), in the port's ``state_dict`` order: the
    reference's spec of the same widths with the cnp head's outputs."""
    spec = ref.param_spec({**model, "likelihood": "bernoulli-gamma"}, grid_channels,
                          point_channels, aux_channels)
    k = n_outputs(model)
    (_, width), fan_in = spec["head_out.weight"]
    spec["head_out.weight"] = ((k, width), fan_in)
    spec["head_out.bias"] = ((k,), 0)
    return spec


def mean_std(raw: torch.Tensor, s: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """μ and σ·s of the cnp head, per target (dim_yt 1)."""
    return raw[..., 0], (F.softplus(raw[..., 1]) + ref.EPS) * s


def raw_rows(p: dict, model: dict, f: torch.Tensor, x1g, x2g, xt1, xt2, aux_t) -> torch.Tensor:
    """(B, rows, Wt, K) raw parameters on target rows ``xt1`` × ``xt2`` from
    the U-Net's features f (B, C, H, W): the decode normalised by the sums
    of its weights, the aux at those targets (rows, Wt, A) appended, the
    head."""
    ls = ref.lengthscale(p, "ls_decoder", model["internal_density"])
    A = ref.rbf(xt1[:, None], x1g[None, :], ls)           # (rows, H)
    Bm = ref.rbf(xt2[:, None], x2g[None, :], ls)          # (Wt, W)
    u = torch.einsum("th,bchw->bctw", A, f)
    dec = torch.einsum("bctw,uw->btuc", u, Bm)
    dec = dec / (A.sum(1)[:, None, None] * Bm.sum(1)[None, :, None] + ref.DENSITY_EPS)
    aux = aux_t[None].expand(dec.shape[0], *aux_t.shape)
    return ref.head(p, model, torch.cat([dec, aux], -1))


def serve_maps(p: dict, model: dict, cycle: dict, dom, norm: dict, std_scale: float,
               device, prec: Optional[str] = None, block: int = 4, rows: int = 128) -> dict:
    """The physical maps one request returns for the tasks of ``cycle``:
    mean and std (B, Ht, Wt), NaN on sea. ``prec``: the U-Net's
    arithmetic, by default the configuration's; ``block`` tasks and
    ``rows`` target rows at a time."""
    q = ref.Arith(prec or model["compute_dtype"])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    aux_t = (ref.lin_weights(dom.highres_x[0], dom.xt1) @ dom.highres.astype(np.float64)
             @ ref.lin_weights(dom.highres_x[1], dom.xt2).T).astype(np.float32)[..., None]
    land = dom.land.ravel()
    B = cycle["base"].shape[0]
    Ht, Wt = dom.land.shape
    mean = np.empty((B, Ht, Wt), np.float32)
    std = np.empty((B, Ht, Wt), np.float32)
    x1g, x2g, xt1, xt2 = dev(dom.x1g), dev(dom.x2g), dev(dom.xt1), dev(dom.xt2)
    with torch.no_grad():
        for s in range(0, B, block):
            t = {k: dev(cycle[k][s:s + block]) for k in ("base", "aux", "st_x", "st_y", "st_mask")}
            t.update(x1g=x1g, x2g=x2g, base_x=tuple(map(dev, dom.base_x)),
                     aux_x=tuple(map(dev, dom.aux_x)))
            f = ref.features(p, model, t, q)
            for r in range(0, Ht, rows):
                raw = raw_rows(p, model, f, x1g, x2g, xt1[r:r + rows], xt2,
                               dev(aux_t[r:r + rows]))
                mu, sigma = mean_std(raw, std_scale)
                mean[s:s + block, r:r + rows] = mu.cpu().numpy()
                std[s:s + block, r:r + rows] = sigma.cpu().numpy()
            del f
    scale, offset = ref.affine(norm)
    maps = {}
    for k, v in (("mean", mean), ("std", std)):
        v = ref.int16_roundtrip(v.reshape(B, -1)[:, land]).astype(np.float64)
        v = v * abs(scale) if k == "std" else v * scale + offset
        full = np.full((B, Ht * Wt), np.nan, np.float32)
        full[:, land] = v
        maps[k] = full.reshape(B, Ht, Wt)
    return maps
