"""Plain PyTorch reference of the ConvNP with the ``cnp-spikes-beta`` head,
the humidity model, serving the 0.05° NZ grid as a year run sends it: a
month of hourly tasks a request, the mean the product.

Written from the model's equations, not from the port: it imports nothing
of ``deepsensornz_tpu_torch`` (or of the JAX package) and calls none of
their kernels, plain versions or helpers. The encodes, the U-Net (in the
configuration's dtype, bfloat16), the dense decode onto the target grid
and the MLP head are :mod:`.convnp`'s; everything else is float32 with
TF32 off (the caller sets the backend flags). This file adds:

- the ``cnp-spikes-beta`` head: (p₀, p₁, p_body) = softmax(raw₀..₂), a
  spike at 0, a spike at 1 and a Beta(α, β) body, α = softplus(raw₃) +
  1e-6 and β = softplus(raw₄) + 1e-6 (the heads' positivity floor, as
  :mod:`.convnp`'s other heads have it); the spread rescale by ``s`` is
  Beta(α/s², β/s²), the spikes untouched; mean = p₁ + p_body·α/(α+β);
  std from the mixture's second moment, E[y²] = p₁ + p_body·(var_body +
  mean_body²) with var_body = αβ/((α+β)²(α+β+1));
- the humidity shift from model space [0, 1] to the min_max space [-1, 1]
  (y ↦ 2y − 1, std ↦ 2·std), then the min_max unnormalisation
  (physical = y·(max − min)/2 + (max + min)/2), after the int16 transfer,
  which quantises the model-space moments per task over the land cells;
- the inputs as the deployment sends them: the task's value leaves (the
  base and aux grids' values and the stations' values and mask) rounded
  to float16, the request's ``upload_dtype``. That is an input precision
  the configuration states, not a shortcut of the computation, which
  takes those rounded values in float32; coordinates stay float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import convnp as ref

VALUE_LEAVES = ("base", "aux", "st_y", "st_mask")


def n_outputs(model: dict) -> int:
    if model["likelihood"] != "cnp-spikes-beta":
        raise ValueError(f"this reference has the cnp-spikes-beta head only, "
                         f"not {model['likelihood']!r}")
    return 5 * model["dim_yt"]


def param_spec(model: dict, grid_channels, point_channels, aux_channels: int) -> dict:
    """name → (shape, fan_in), in the port's ``state_dict`` order: the
    reference's spec of the same widths with this head's 5 outputs."""
    spec = ref.param_spec({**model, "likelihood": "bernoulli-gamma"}, grid_channels,
                          point_channels, aux_channels)
    k = n_outputs(model)
    (_, width), fan_in = spec["head_out.weight"]
    spec["head_out.weight"] = ((k, width), fan_in)
    spec["head_out.bias"] = ((k,), 0)
    return spec


def parts(raw: torch.Tensor, s: float = 1.0):
    """(p₀, p₁, p_body), α/s², β/s² of the head, per target (dim_yt 1)."""
    probs = torch.softmax(raw[..., :3], dim=-1)
    s2 = s * s
    alpha = (F.softplus(raw[..., 3]) + ref.EPS) / s2
    beta = (F.softplus(raw[..., 4]) + ref.EPS) / s2
    return probs, alpha, beta


def mean_std(raw: torch.Tensor, s: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixture's mean and std in model space [0, 1]."""
    probs, alpha, beta = parts(raw, s)
    ab = alpha + beta
    mean_body = alpha / ab
    var_body = alpha * beta / (torch.square(ab) * (ab + 1.0))
    mean = probs[..., 1] + probs[..., 2] * mean_body
    ex2 = probs[..., 1] + probs[..., 2] * (var_body + torch.square(mean_body))
    return mean, torch.sqrt(torch.clamp(ex2 - torch.square(mean), min=0.0))


def min_max_affine(norm: dict) -> tuple[float, float]:
    """min_max space [-1, 1] → physical: (scale, offset)."""
    if norm["method"] != "min_max":
        raise ValueError(f"this reference unnormalises min_max only, not {norm['method']!r}")
    lo, hi = norm["params"]["min"], norm["params"]["max"]
    return (hi - lo) / 2.0, (hi + lo) / 2.0


def as_sent(cycle: dict) -> dict:
    """The task's arrays as the request sends them: the value leaves
    rounded to float16 and back, the rest as they are."""
    return {k: (v.astype(np.float16).astype(np.float32) if k in VALUE_LEAVES else v)
            for k, v in cycle.items()}


def serve_maps(p: dict, model: dict, cycle: dict, dom, norm: dict, std_scale: float,
               device, prec: Optional[str] = None, block: int = 4) -> dict:
    """The physical maps a request computes for the tasks of ``cycle``:
    mean and std (B, Ht, Wt), NaN on sea (the std as the request would
    return it with ``outputs=("mean", "std")``). ``prec``: the U-Net's
    arithmetic, by default the configuration's; ``block`` tasks at a
    time, each over the whole target grid."""
    q = ref.Arith(prec or model["compute_dtype"])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    sent = as_sent(cycle)
    aux_t = (ref.lin_weights(dom.highres_x[0], dom.xt1) @ dom.highres.astype(np.float64)
             @ ref.lin_weights(dom.highres_x[1], dom.xt2).T).astype(np.float32)[..., None]
    land = dom.land.ravel()
    B = cycle["base"].shape[0]
    Ht, Wt = dom.land.shape
    moments = {"mean": [], "std": []}
    with torch.no_grad():
        for s in range(0, B, block):
            t = {k: dev(sent[k][s:s + block]) for k in ("base", "aux", "st_x", "st_y", "st_mask")}
            t.update(x1g=dev(dom.x1g), x2g=dev(dom.x2g), base_x=tuple(map(dev, dom.base_x)),
                     aux_x=tuple(map(dev, dom.aux_x)))
            raw = ref.raw_on_grid(p, model, t, dev(dom.xt1), dev(dom.xt2), dev(aux_t), q)
            mean, std = mean_std(raw.reshape(raw.shape[0], -1, raw.shape[-1]), std_scale)
            moments["mean"].append(mean[:, land].cpu().numpy())
            moments["std"].append(std[:, land].cpu().numpy())
    scale, offset = min_max_affine(norm)
    maps = {}
    for k, blocks in moments.items():
        v = ref.int16_roundtrip(np.concatenate(blocks)).astype(np.float64)
        # model space [0, 1] → [-1, 1] → physical
        v = 2.0 * v * abs(scale) if k == "std" else (2.0 * v - 1.0) * scale + offset
        full = np.full((B, Ht * Wt), np.nan, np.float32)
        full[:, land] = v
        maps[k] = full.reshape(B, Ht, Wt)
    return maps


def to_model_space(maps: dict, norm: dict) -> dict:
    """Physical maps back in model space [0, 1] (float64): the inverse of
    the unnormalisation and the humidity shift."""
    scale, offset = min_max_affine(norm)
    out = {}
    for k, v in maps.items():
        v = np.asarray(v, np.float64)
        out[k] = v / (2.0 * abs(scale)) if k == "std" else ((v - offset) / scale + 1.0) / 2.0
    return out
