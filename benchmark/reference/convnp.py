"""Plain PyTorch reference of the ConvNP the benchmark runs.

Written from the model's equations, not from the port: it imports nothing
of ``deepsensornz_tpu_torch`` (or of the JAX package) and calls none of
their kernels, plain versions or helpers. It computes the U-Net in the
precision the configuration states (``compute_dtype``: each convolution
on inputs, weights and biases in that dtype, as the model is specified)
and everything else in float32 with TF32 off (the caller sets the backend
flags), the gnp likelihood densely in float64, and works out again
everything the system derives from the benchmark's inputs and weights:

- the SetConv encodes onto the internal grid (RBF weights exp(-d²/2ℓ²),
  separable over the two axes, density channel first, values divided by
  density + 1e-8, length-scale softplus(θ) + 0.5/density);
- the U-Net (1×1 stem, stride-2 k×k down convs, a bottleneck, stride-2
  transposed convs with skip concatenation and a mix conv, 1×1 head),
  with flax's SAME padding; the transposed conv is lax's: the input
  dilated by 2, padded (k-1 or ⌈k/2⌉, the rest) and correlated with the
  kernel (the stored weight is that kernel flipped, in torch's
  conv_transpose2d layout);
- the decode onto the target grid or at off-grid targets, normalised by
  the sums of the weights, the aux at the targets appended, the MLP head;
- the likelihood: gnp (mean μ, noise variance max(softplus + 1e-6, 1e-4),
  low-rank factor F/√R; std √(var + ΣF²)) and bernoulli-gamma
  (p = σ(r0), k and rate softplus + 1e-6; mean pk/rate); the spread
  rescale by ``std_scale``; the int16 transfer; unnormalisation; sea NaN;
- training: the NLL (gnp as a dense M×M Gaussian, bernoulli-gamma per
  point), the mean anchor, clip by global norm 10 → Adam → decay.

``prec`` selects the U-Net's arithmetic: ``"float32"``, ``"bfloat16"``,
or ``"fp8"``, the control of a bfloat16 configuration: every
convolution's input and weight rounded to float8 e4m3 with one scale per
tensor (their gradients to e5m2), the products accumulated and rounded
as in bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

DENSITY_EPS = 1e-8
EPS = 1e-6
LOG_2PI = math.log(2.0 * math.pi)
CLIP_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
VAR_FLOOR = 1e-4


# -- parameters ------------------------------------------------------------------------

def n_outputs(model: dict) -> int:
    if model["likelihood"] == "gnp":
        return model["dim_yt"] * (2 + model["rank"])
    if model["likelihood"] == "bernoulli-gamma":
        return 3
    raise ValueError(f"the reference has no {model['likelihood']!r} head")


def param_spec(model: dict, grid_channels, point_channels, aux_channels: int) -> dict:
    """name → (shape, fan_in); fan_in None for a length-scale (0-d) and 0
    for a bias."""
    k = model["kernel_size"]
    ch = list(model["unet_channels"])
    spec = {}
    for i in range(len(grid_channels)):
        spec[f"ls_grid_{i}"] = ((), None)
    for i in range(len(point_channels)):
        spec[f"ls_points_{i}"] = ((), None)
    spec["ls_decoder"] = ((), None)

    def conv(name, cin, cout, size, transpose=False):
        shape = (cin, cout, size, size) if transpose else (cout, cin, size, size)
        spec[f"unet.{name}.weight"] = (shape, cin * size * size)
        spec[f"unet.{name}.bias"] = ((cout,), 0)

    cin = sum(c + 1 for c in grid_channels) + sum(c + 1 for c in point_channels)
    conv("stem", cin, ch[0], 1)
    c = ch[0]
    for i, w in enumerate(ch):
        conv(f"down_{i}", c, w, k)
        c = w
    conv("bottleneck", c, ch[-1], k)
    c = ch[-1]
    skip = [ch[0]] + ch[:-1]
    for i in reversed(range(len(ch))):
        conv(f"up_{i}", c, ch[i], k, transpose=True)
        conv(f"up_mix_{i}", ch[i] + skip[i], ch[i], k)
        c = ch[i]
    conv("head", c, model["decoder_channels"], 1)
    dims = [model["decoder_channels"] + aux_channels] + [model["mlp_hidden"]] * model["mlp_layers"]
    names = [f"head_{j}" for j in range(model["mlp_layers"])]
    for j, name in enumerate(names):
        spec[f"{name}.weight"] = ((dims[j + 1], dims[j]), dims[j])
        spec[f"{name}.bias"] = ((dims[j + 1],), 0)
    spec["head_out.weight"] = ((n_outputs(model), dims[-1]), dims[-1])
    spec["head_out.bias"] = ((n_outputs(model),), 0)
    return spec


def lengthscale(p: dict, name: str, density: float) -> torch.Tensor:
    return F.softplus(p[name]) + 0.5 / float(density)


# -- arithmetic of the U-Net -------------------------------------------------------------

def _round_scaled(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = fmax / amax
    return (x.float() * s).to(dtype).float().div(s).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, 57344.0)


class Arith:
    """The U-Net's arithmetic: the dtype it computes in and the rounding of
    each convolution's operands."""

    def __init__(self, prec: str):
        if prec not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {prec!r}")
        self.dtype = torch.float32 if prec == "float32" else torch.bfloat16
        self.fp8 = prec == "fp8"

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return _FP8.apply(t) if self.fp8 else t


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride, q):
    k = w.shape[-1]
    hl, hh = _same(x.shape[2], k, stride)
    wl, wh = _same(x.shape[3], k, stride)
    return F.conv2d(F.pad(q(x), (wl, wh, hl, hh)), q(w), b.to(q.dtype), stride=stride)


def conv_transpose(x, w, b, q):
    """Stride-2 SAME transposed conv as lax computes it: dilate, pad,
    correlate. ``w`` (I, O, k, k) holds the kernel flipped spatially."""
    B, C, H, W = x.shape
    k = w.shape[-1]
    pad_a = k - 1 if 2 > k - 1 else math.ceil(k / 2)
    pad_b = k - pad_a
    xd = x.new_zeros(B, C, 2 * H - 1, 2 * W - 1)
    xd[:, :, ::2, ::2] = x
    return F.conv2d(F.pad(q(xd), (pad_a, pad_b, pad_a, pad_b)),
                    q(w.permute(1, 0, 2, 3).flip(2, 3)), b.to(q.dtype))


def unet(p: dict, x: torch.Tensor, levels: int, q) -> torch.Tensor:
    def c(name, h, stride=1):
        return conv(h, p[f"unet.{name}.weight"], p[f"unet.{name}.bias"], stride, q)

    x = c("stem", x)
    skips = []
    for i in range(levels):
        x = F.relu(x)
        skips.append(x)
        x = c(f"down_{i}", x, 2)
    x = c("bottleneck", F.relu(x))
    for i in reversed(range(levels)):
        x = conv_transpose(F.relu(x), p[f"unet.up_{i}.weight"], p[f"unet.up_{i}.bias"], q)
        x = c(f"up_mix_{i}", F.relu(torch.cat([x, skips[i]], 1)))
    return c("head", F.relu(x))


# -- SetConvs ----------------------------------------------------------------------------

def rbf(a: torch.Tensor, b: torch.Tensor, ls) -> torch.Tensor:
    return torch.exp(-0.5 * torch.square((a - b) / ls))


def _normalise(s: torch.Tensor) -> torch.Tensor:
    d = s[..., :1]
    return torch.cat([d, s[..., 1:] / (d + DENSITY_EPS)], -1)


def encode_grid(x1g, x2g, xc1, xc2, y, ls) -> torch.Tensor:
    """A fully valid gridded context (B, Hc, Wc, C) → (B, H, W, C+1)."""
    A = rbf(x1g[:, None], xc1[None, :], ls)
    Bm = rbf(x2g[:, None], xc2[None, :], ls)
    aug = torch.cat([torch.ones_like(y[..., :1]), y], -1)
    t = torch.einsum("hi,bijc->bhjc", A, aug)
    return _normalise(torch.einsum("bhjc,wj->bhwc", t, Bm))


def encode_points(x1g, x2g, x, y, mask, ls) -> torch.Tensor:
    """A point set (B, N, ·) with its mask → (B, H, W, C+1)."""
    w1 = rbf(x1g[None, :, None], x[:, None, :, 0], ls)   # (B, H, N)
    w2 = rbf(x2g[None, None, :], x[:, :, None, 1], ls)   # (B, N, W)
    m = mask[..., None]
    aug = torch.cat([m, y * m], -1)                     # (B, N, C+1)
    return _normalise(torch.einsum("bhn,bnwc->bhwc", w1, w2[..., None] * aug[:, :, None, :]))


def features(p: dict, model: dict, t: dict, q) -> torch.Tensor:
    """U-Net features (B, C, H, W) of task tensors ``t``."""
    dens = model["internal_density"]
    x1g, x2g = t["x1g"], t["x2g"]
    enc = [encode_grid(x1g, x2g, *t["base_x"], t["base"], lengthscale(p, "ls_grid_0", dens)),
           encode_grid(x1g, x2g, *t["aux_x"], t["aux"], lengthscale(p, "ls_grid_1", dens)),
           encode_points(x1g, x2g, t["st_x"], t["st_y"], t["st_mask"],
                         lengthscale(p, "ls_points_0", dens))]
    h = torch.cat(enc, -1).permute(0, 3, 1, 2)
    return unet(p, h.to(q.dtype), len(model["unet_channels"]), q).float()


def head(p: dict, model: dict, dec: torch.Tensor) -> torch.Tensor:
    z = dec
    for j in range(model["mlp_layers"]):
        z = F.relu(F.linear(z, p[f"head_{j}.weight"], p[f"head_{j}.bias"]))
    return F.linear(z, p["head_out.weight"], p["head_out.bias"])


def raw_on_grid(p, model, t, xt1, xt2, aux_t, q) -> torch.Tensor:
    """(B, Ht, Wt, K) raw likelihood parameters on the target grid."""
    f = features(p, model, t, q)
    ls = lengthscale(p, "ls_decoder", model["internal_density"])
    A = rbf(xt1[:, None], t["x1g"][None, :], ls)          # (Ht, H)
    Bm = rbf(xt2[:, None], t["x2g"][None, :], ls)         # (Wt, W)
    u = torch.einsum("th,bchw->bctw", A, f)
    dec = torch.einsum("bctw,uw->btuc", u, Bm)
    dec = dec / (A.sum(1)[:, None, None] * Bm.sum(1)[None, :, None] + DENSITY_EPS)
    aux = aux_t[None].expand(dec.shape[0], *aux_t.shape)
    return head(p, model, torch.cat([dec, aux], -1))


def raw_at_targets(p, model, t, q) -> torch.Tensor:
    """(B, M, K) raw likelihood parameters at the off-grid targets."""
    f = features(p, model, t, q)
    ls = lengthscale(p, "ls_decoder", model["internal_density"])
    xt = t["xt"]
    w1 = rbf(xt[:, :, None, 0], t["x1g"][None, None, :], ls)   # (B, M, H)
    w2 = rbf(xt[:, :, None, 1], t["x2g"][None, None, :], ls)   # (B, M, W)
    u = torch.einsum("bmh,bchw->bmcw", w1, f)
    dec = torch.einsum("bmcw,bmw->bmc", u, w2)
    dec = dec / (w1.sum(-1) * w2.sum(-1) + DENSITY_EPS)[..., None]
    return head(p, model, torch.cat([dec, t["yt_aux"]], -1))


# -- likelihoods ---------------------------------------------------------------------------

def _sp(x):
    return F.softplus(x) + EPS


def gnp_parts(raw, rank: int, s: float = 1.0):
    """μ, noise variance and factor after the spread rescale by s (the
    whole covariance ×s²; the variance floor applies after it)."""
    mu = raw[..., 0]
    var = torch.clamp(torch.clamp(_sp(raw[..., 1]), min=VAR_FLOOR) * (s * s), min=VAR_FLOOR)
    fac = raw[..., 2:2 + rank] * (s / math.sqrt(rank))
    return mu, var, fac


def bgamma_parts(raw, s: float = 1.0):
    """p, k, rate after the spread rescale: Gamma(k/s², rate/s²)."""
    return torch.sigmoid(raw[..., 0]), _sp(raw[..., 1]) / (s * s), _sp(raw[..., 2]) / (s * s)


def mean_std(model: dict, raw, s: float = 1.0):
    if model["likelihood"] == "gnp":
        mu, var, fac = gnp_parts(raw, model["rank"], s)
        return mu, torch.sqrt(var + torch.square(fac).sum(-1))
    p, k, rate = bgamma_parts(raw, s)
    m = k / rate
    return p * m, torch.sqrt(p * k / torch.square(rate) + p * (1.0 - p) * torch.square(m))


def bgamma_samples(raw, s: float, n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, ..., M): n draws of the rescaled bernoulli-gamma, each wet with
    probability p and then Gamma(k, 1)/rate; drawn as the port documents
    its sampler (the Bernoulli draws, then the standard-gamma draws, over
    the whole grid), so the same generator seed gives the same draws."""
    p, k, rate = bgamma_parts(raw, s)
    shape = (n,) + p.shape
    wet = torch.bernoulli(p.expand(shape), generator=generator) > 0
    g = torch._standard_gamma(k.expand(shape).contiguous(), generator=generator)
    return torch.where(wet, g / rate, 0.0)


def nll(model: dict, raw, y, mask) -> torch.Tensor:
    """Mean over tasks with a valid target of the per-target NLL."""
    if model["likelihood"] == "gnp":
        mu, var, fac = gnp_parts(raw, model["rank"])
        per_task = []
        for b in range(raw.shape[0]):
            v = mask[b] > 0
            n = int(v.sum())
            if n == 0:
                continue
            cov = (torch.diag(var[b][v].double())
                   + fac[b][v].double() @ fac[b][v].double().T)
            L = torch.linalg.cholesky(cov)
            r = (y[b, v, 0] - mu[b][v]).double()
            z = torch.linalg.solve_triangular(L, r[:, None], upper=False)[:, 0]
            quad = torch.dot(z, z)
            logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
            per_task.append(0.5 * (quad + logdet + n * LOG_2PI) / n)
        return torch.stack(per_task).mean().float()
    p, k, rate = bgamma_parts(raw)
    yv = y[..., 0]
    ys = torch.clamp(yv, min=EPS)
    log_g = k * torch.log(rate) + (k - 1.0) * torch.log(ys) - rate * ys - torch.lgamma(k)
    point = -torch.where(yv > EPS, torch.log(torch.clamp(p, EPS, 1 - EPS)) + log_g,
                         torch.log(torch.clamp(1.0 - p, EPS, 1 - EPS)))
    nv = mask.sum(-1)
    per_task = (point * mask).sum(-1) / torch.clamp(nv, min=1.0)
    has = (nv > 0).float()
    return (per_task * has).sum() / torch.clamp(has.sum(), min=1.0)


def loss(p: dict, model: dict, t: dict, q) -> torch.Tensor:
    """NLL plus, for the gnp head, the mean anchor: the MSE of μ over the
    valid targets (weight 1)."""
    raw = raw_at_targets(p, model, t, q)
    out = nll(model, raw, t["yt"], t["yt_mask"])
    if model["likelihood"] == "gnp":
        m = t["yt_mask"]
        se = torch.square(raw[..., 0] - t["yt"][..., 0]) * m
        out = out + se.sum() / torch.clamp(m.sum(), min=1.0)
    return out


# -- host side of a served request ------------------------------------------------------------

def int16_roundtrip(v: np.ndarray) -> np.ndarray:
    """(..., cells) float32 through the int16 transfer: per leading index
    an affine map of the cells' range onto 65536 steps, rounded, and back."""
    lo = v.min(-1, keepdims=True)
    hi = v.max(-1, keepdims=True)
    scale = np.maximum((hi - lo) / np.float32(65535.0), np.float32(1e-12)).astype(np.float32)
    q = np.round((v - lo) / scale)
    return (q * scale + lo).astype(np.float32)


def lin_weights(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """(len(new), len(old)) linear interpolation, clamped at the ends."""
    old = np.asarray(old, np.float64)
    new = np.asarray(new, np.float64)
    W = np.zeros((len(new), len(old)))
    for i, x in enumerate(new):
        if x <= old[0]:
            W[i, 0] = 1.0
        elif x >= old[-1]:
            W[i, -1] = 1.0
        else:
            j = int(np.searchsorted(old, x, side="right"))
            w = (x - old[j - 1]) / (old[j] - old[j - 1])
            W[i, j - 1], W[i, j] = 1.0 - w, w
    return W


def serve_maps(p: dict, model: dict, cycle: dict, dom, norm: dict, std_scale: float,
               device, prec: Optional[str] = None, n_samples: int = 0, seed: int = 0,
               block: int = 8) -> dict:
    """The physical maps one request returns: mean, std (B, Ht, Wt) and,
    with ``n_samples``, samples (n, B, Ht, Wt), NaN on sea. ``prec``: the
    U-Net's arithmetic, by default the configuration's."""
    q = Arith(prec or model["compute_dtype"])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    aux_t = (lin_weights(dom.highres_x[0], dom.xt1) @ dom.highres.astype(np.float64)
             @ lin_weights(dom.highres_x[1], dom.xt2).T).astype(np.float32)[..., None]
    land = dom.land.ravel()
    B = cycle["base"].shape[0]
    raws = []
    with torch.no_grad():
        for s in range(0, B, block):
            t = {k: dev(cycle[k][s:s + block]) for k in ("base", "aux", "st_x", "st_y", "st_mask")}
            t.update(x1g=dev(dom.x1g), x2g=dev(dom.x2g), base_x=tuple(map(dev, dom.base_x)),
                     aux_x=tuple(map(dev, dom.aux_x)))
            raws.append(raw_on_grid(p, model, t, dev(dom.xt1), dev(dom.xt2), dev(aux_t), q))
        raw = torch.cat(raws).reshape(B, -1, raws[0].shape[-1])
        mean, std = mean_std(model, raw, std_scale)
        out = {"mean": mean, "std": std}
        if n_samples:
            gen = torch.Generator(device=raw.device).manual_seed(int(seed))
            out["samples"] = bgamma_samples(raw, std_scale, n_samples, gen)
        host = {k: v.float().cpu().numpy()[..., land] for k, v in out.items()}
    scale, offset = affine(norm)
    maps = {}
    Ht, Wt = dom.land.shape
    for k, v in host.items():
        v = int16_roundtrip(v).astype(np.float64)
        v = v * abs(scale) if k == "std" else v * scale + offset
        full = np.full(v.shape[:-1] + (Ht * Wt,), np.nan, np.float32)
        full[..., land] = v
        maps[k] = full.reshape(v.shape[:-1] + (Ht, Wt))
    return maps


def affine(norm: dict) -> tuple[float, float]:
    """physical = normalised·scale + offset."""
    prm = norm["params"]
    if norm["method"] == "mean_std":
        return prm["std"], prm["mean"]
    if norm["method"] == "positive_semidefinite":
        return prm["std"], 0.0
    raise ValueError(f"the reference has no {norm['method']!r} normalisation")


# -- training ---------------------------------------------------------------------------------

def train_steps(weights: dict, model: dict, batches: list, dom, lr: float, device,
                prec: Optional[str] = None, half_batch: bool = False) -> dict:
    """Steps of clip → Adam → decay (weight decay 0) from ``weights`` over
    ``batches`` (dicts of task arrays). Returns each step's loss, the first
    step's gradient as the optimizer gets it (after the clip) and the
    parameters after the last step. ``prec``: the U-Net's arithmetic, by
    default the configuration's. ``half_batch`` is a planted fault: the
    loss of the first half of each batch only."""
    q = Arith(prec or model["compute_dtype"])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    p = {k: v.detach().to(device).float().clone().requires_grad_(True)
         for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, arrays in enumerate(batches, 1):
        if half_batch:
            arrays = {k: v[:len(v) // 2] for k, v in arrays.items()}
        t = {k: dev(v) for k, v in arrays.items()}
        t.update(x1g=dev(dom.x1g), x2g=dev(dom.x2g), base_x=tuple(map(dev, dom.base_x)),
                 aux_x=tuple(map(dev, dom.aux_x)))
        out = loss(p, model, t, q)
        grads = dict(zip(p, torch.autograd.grad(out, list(p.values()))))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
            clip = torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm)
            grads = {k: g * clip for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            for k, g in grads.items():
                mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * torch.square(g)
                m_hat = mu[k] / (1 - ADAM_B1 ** step)
                v_hat = nu[k] / (1 - ADAM_B2 ** step)
                p[k] -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        losses.append(float(out.detach()))
    return {"losses": losses, "grad": first,
            "params": {k: v.detach() for k, v in p.items()}}


def grad_and_update_norms(result: dict, weights: dict) -> dict:
    """Per leaf: the norm of the first clipped gradient and of the change
    of the parameters over the steps (float64)."""
    return {"grad": {k: float(g.double().norm()) for k, g in result["grad"].items()},
            "update": {k: float((v.double().cpu() - weights[k].double().cpu()).norm())
                       for k, v in result["params"].items()}}


def first_grad_from_adam(mu: dict) -> dict:
    """The first clipped gradient from Adam's first moment after one step
    from zero: μ₁ = (1 - b1)·g."""
    return {k: v / (1 - ADAM_B1) for k, v in mu.items()}


def weights_from(spec: dict, model: dict, seed: int, device) -> dict:
    """Random weights for ``spec`` from ``seed``: one normal draw on the
    device for every weight, clamped to ±2 and scaled to the lecun std
    1/√fan_in (over the truncation's 0.8796), small normal biases, and the
    length-scales at twice the grid spacing (θ = softplus⁻¹(2/density))."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    theta = math.log(math.expm1(2.0 / float(model["internal_density"])))
    out = {}
    for (name, (shape, fan_in)), chunk in zip(spec.items(), torch.split(flat, sizes)):
        chunk = chunk.reshape(shape)
        if fan_in is None:
            out[name] = torch.full(shape, theta, device=device)
        elif fan_in == 0:
            out[name] = 0.01 * chunk
        else:
            out[name] = chunk.clamp(-2.0, 2.0) * (math.sqrt(1.0 / fan_in) / 0.8796256610342398)
    return out
