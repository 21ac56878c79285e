"""ConvNP: SetConv encoder → U-Net → SetConv decoder → likelihood head.

Counterpart of ``deepsensornz_tpu/models/convnp.py`` (``ConvNPConfig`` and
``ConvNP.__call__``). Each context set is encoded onto the shared internal
grid with its own learnable RBF length-scale, the concatenated encoding runs
through the U-Net, and the features are decoded at off-grid targets or onto
a regular target grid before the MLP head emits the likelihood parameters.

On a CUDA device the point-set encode and the gridded decode run the
hand-written kernels (:mod:`..ops.setconv_cuda`); on the CPU they run the
plain versions. The device decides, not a config field. The gridded-context
encode and the off-grid decode are plain tensor contractions, as they are
XLA einsums in the JAX package.

The module is built explicitly from a task's shapes
(:meth:`ConvNP.from_task`); its ``state_dict`` names mirror the flax tree
(``unet.down_0.weight`` ↔ ``params/unet/down_0/kernel``, see
:func:`..train.checkpoint.params_from_jax`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepsensornz_tpu_torch.models.likelihoods import get_likelihood
from deepsensornz_tpu_torch.models.unet import UNet, lecun_normal_
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.ops.grids import default_lengthscale
from deepsensornz_tpu_torch.ops.setconv import setconv_decode_offgrid, setconv_encode_grid
from deepsensornz_tpu_torch.task.task import TaskBatch


@dataclasses.dataclass(frozen=True)
class ConvNPConfig:
    """Static model hyperparameters; every field of the JAX config, so a JAX
    ``metadata.json`` config loads. Fields that only steer TPU lowerings
    (``downsample``, ``lane_pack``, ``use_pallas``) and ``remat_policy``
    are accepted and change nothing: ``remat`` recomputes the whole U-Net
    in the backward whatever the policy (per-level saving waits)."""

    unet_channels: tuple = (64, 64, 64, 64)
    likelihood: str = "gnp"
    internal_density: float = 500.0
    dim_yt: int = 1
    rank: int = 64
    decoder_channels: int = 64
    mlp_hidden: int = 64
    mlp_layers: int = 1
    kernel_size: int = 5
    upsample: str = "transpose"
    downsample: str = "strided"
    lane_pack: Union[bool, str] = "auto"
    top_kernel: Optional[int] = None
    compute_dtype: str = "bfloat16"
    sigmoid_output: bool = False
    mesh_axes: Optional[tuple] = None
    use_pallas: bool = False
    remat: bool = False
    remat_policy: Optional[str] = "acts"
    mean_anchor: Optional[float] = None
    hoist_head: bool = True
    init_lengthscale: Optional[Union[float, tuple]] = None

    def __post_init__(self):
        object.__setattr__(self, "unet_channels", tuple(self.unet_channels))
        il = self.init_lengthscale
        if il is not None and not isinstance(il, (int, float)):
            pairs = il.items() if hasattr(il, "items") else il
            norm = tuple(sorted((str(k), float(v)) for k, v in pairs))
            bad = [k for k, _ in norm
                   if not re.fullmatch(r"ls_(decoder|(grid|points)_\d+)", k)]
            if bad:
                raise ValueError(
                    f"unknown init_lengthscale scale name(s) {bad}; valid "
                    "names are 'ls_decoder', 'ls_grid_<i>', 'ls_points_<i>'"
                )
            object.__setattr__(self, "init_lengthscale", norm)

    @classmethod
    def from_dict(cls, d: dict) -> "ConvNPConfig":
        """Build from a JSON-decoded config (lists become tuples)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) and k != "init_lengthscale" else v)
              for k, v in d.items() if k in names}
        return cls(**kw)

    def anchor_weight(self) -> float:
        """Weight of the mean-anchor MSE in :meth:`ConvNP.loss`: explicit, or
        1.0 for the joint (gnp) head and 0.0 for the per-point heads."""
        if self.mean_anchor is not None:
            return float(self.mean_anchor)
        return 1.0 if self.likelihood in ("gnp", "lowrank") else 0.0

    def make_likelihood(self):
        kw = {"rank": self.rank} if self.likelihood in ("gnp", "lowrank") else {}
        return get_likelihood(self.likelihood, dim_y=self.dim_yt, **kw)


def _inv_softplus(x: float) -> float:
    return float(math.log(math.expm1(x))) if x < 20 else float(x)


def _dense(cin: int, cout: int, generator, device) -> nn.Linear:
    """A flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(cin, cout, device=device)
    lecun_normal_(lin.weight, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


class ConvNP(nn.Module):
    """``forward(task)`` → raw likelihood parameters (B, M, K) at
    ``task.xt``; ``forward(task, target_grid=(xt1, xt2, aux))`` →
    (B, Ht, Wt, K) on the regular grid xt1 × xt2."""

    def __init__(self, cfg: ConvNPConfig, grid_channels: Sequence[int],
                 point_channels: Sequence[int], aux_channels: int = 0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if cfg.mesh_axes is not None:
            raise NotImplementedError("mesh_axes (spatial sharding) is not ported")
        self.cfg = cfg
        self.n_grids = len(grid_channels)
        self.n_points = len(point_channels)
        self.aux_channels = int(aux_channels)
        self.min_ls = 0.5 / float(cfg.internal_density)
        for i in range(self.n_grids):
            self._add_lengthscale(f"ls_grid_{i}", device)
        for i in range(self.n_points):
            self._add_lengthscale(f"ls_points_{i}", device)
        self._add_lengthscale("ls_decoder", device)
        in_ch = sum(c + 1 for c in grid_channels) + sum(c + 1 for c in point_channels)
        self.unet = UNet(
            in_ch, cfg.unet_channels, cfg.decoder_channels, cfg.kernel_size,
            getattr(torch, cfg.compute_dtype), cfg.upsample, cfg.top_kernel,
            generator=generator, device=device)
        num_out = cfg.make_likelihood().num_params()
        self.first_feats = cfg.mlp_hidden if cfg.mlp_layers >= 1 else num_out
        self.first_name = "head_0" if cfg.mlp_layers >= 1 else "head_out"
        setattr(self, self.first_name, _dense(
            cfg.decoder_channels + self.aux_channels, self.first_feats, generator, device))
        for j in range(1, cfg.mlp_layers):
            setattr(self, f"head_{j}", _dense(cfg.mlp_hidden, cfg.mlp_hidden, generator, device))
        if cfg.mlp_layers >= 1:
            self.head_out = _dense(cfg.mlp_hidden, num_out, generator, device)

    @classmethod
    def from_task(cls, cfg: ConvNPConfig, task: TaskBatch, *,
                  generator: Optional[torch.Generator] = None, device=None) -> "ConvNP":
        """Size the model from a task's context sets and aux-at-targets."""
        return cls(cfg, [g.y.shape[-1] for g in task.grids],
                   [p.y.shape[-1] for p in task.points],
                   0 if task.yt_aux is None else task.yt_aux.shape[-1],
                   generator=generator, device=device)

    # -- length-scales -----------------------------------------------------------

    def _add_lengthscale(self, name: str, device) -> None:
        # the floor (half the grid spacing) keeps the RBF exponent finite
        il = self.cfg.init_lengthscale
        if il is not None and not isinstance(il, (int, float)):
            il = dict(il).get(name)
        if il is not None:
            if float(il) <= self.min_ls:
                raise ValueError(
                    f"init_lengthscale {il} for {name} must exceed the grid "
                    f"resolution floor 0.5/internal_density = {self.min_ls}")
            init = _inv_softplus(float(il) - self.min_ls)
        else:
            init = _inv_softplus(default_lengthscale(self.cfg.internal_density))
        self.register_parameter(name, nn.Parameter(
            torch.tensor(init, dtype=torch.float32, device=device)))

    def lengthscale(self, name: str) -> torch.Tensor:
        return F.softplus(getattr(self, name)) + self.min_ls

    # -- forward -------------------------------------------------------------------

    def encode(self, task: TaskBatch) -> torch.Tensor:
        """Every context set on the internal grid, concatenated: (B, H, W, Σ(C+1))."""
        enc = [setconv_encode_grid(task.x1g, task.x2g, g.x1, g.x2, g.y,
                                   self.lengthscale(f"ls_grid_{i}"), g.mask)
               for i, g in enumerate(task.grids)]
        enc += [setconv_cuda.encode_offgrid(task.x1g, task.x2g, p.x, p.y, p.mask,
                                            self.lengthscale(f"ls_points_{i}"))
                for i, p in enumerate(task.points)]
        return torch.cat(enc, dim=-1)

    def features(self, task: TaskBatch) -> torch.Tensor:
        """U-Net features on the internal grid, NHWC (B, H, W, decoder_channels),
        in the U-Net's compute dtype: the gridded decode kernel reads bf16
        features as they are (their f32 widening holds the same values)."""
        h = self.encode(task).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        if self.cfg.remat and torch.is_grad_enabled():
            # the backward recomputes the U-Net instead of keeping its
            # activations; the parameters it reads are the module's own, so
            # the recomputation sees the values the forward saw
            f = checkpoint(self.unet.raw, h, use_reentrant=False)
        else:
            f = self.unet.raw(h)
        return f.permute(0, 2, 3, 1)

    def forward(self, task: TaskBatch, target_grid: Optional[tuple] = None) -> torch.Tensor:
        cfg = self.cfg
        f = self.features(task)
        ls_dec = self.lengthscale("ls_decoder")
        if target_grid is None:
            aux = task.yt_aux
        else:
            xt1, xt2, aux = target_grid
        first = getattr(self, self.first_name)
        k0, b0 = first.weight, first.bias  # (out, in), (out,)
        dc = cfg.decoder_channels
        hoist = (
            cfg.hoist_head and target_grid is not None
            and f.shape[1] * f.shape[2] < xt1.shape[0] * xt2.shape[0]
            # only when the first layer narrows what the decode moves
            and self.first_feats < dc
        )
        if hoist:
            # the decode is linear in f: decode(f) @ W == decode(f @ W)
            g = (f.float() @ k0[:, :dc].T).contiguous()
            z = setconv_cuda.decode_grid(task.x1g, task.x2g, g, xt1, xt2, ls_dec)
            if aux is not None:
                z = z + aux.float() @ k0[:, dc:].T
            z = z + b0
        else:
            if target_grid is None:
                dec = setconv_decode_offgrid(task.x1g, task.x2g, f.float(), task.xt, ls_dec)
            else:
                dec = setconv_cuda.decode_grid(task.x1g, task.x2g, f, xt1, xt2, ls_dec)
            if aux is not None:
                dec = torch.cat([dec, aux.float()], dim=-1)
            z = F.linear(dec, k0, b0)
        if cfg.mlp_layers >= 1:
            z = F.relu(z)
            for j in range(1, cfg.mlp_layers):
                z = F.relu(getattr(self, f"head_{j}")(z))
            raw = self.head_out(z)
        else:
            raw = z
        if cfg.sigmoid_output:
            raw = _sigmoid_squash(raw, cfg.dim_yt)
        return raw

    def loss(self, task: TaskBatch, anchor_scale=1.0) -> torch.Tensor:
        """Normalised NLL at ``task.xt`` plus ``anchor_weight() · anchor_scale``
        times the masked MSE of the predictive mean (a 0-d tensor).
        ``anchor_scale`` may change from call to call (an anchor decayed
        over epochs)."""
        raw = self(task)
        lik = self.cfg.make_likelihood()
        out = lik.nll(raw, task.yt, task.yt_mask)
        anchor = self.cfg.anchor_weight()
        if anchor > 0.0:
            mean, _ = lik.mean_std(raw)
            m = task.yt_mask.float()[..., None]
            se = torch.square(mean - task.yt.float()) * m
            mse = se.sum() / torch.clamp(m.sum() * mean.shape[-1], min=1.0)
            out = out + anchor * anchor_scale * mse
        return out


def _sigmoid_squash(raw: torch.Tensor, dy: int) -> torch.Tensor:
    """Sigmoid on the mean channels; the (pre-softplus) scale channels shift
    by log σ'(μ), so the spread scales with the sigmoid's derivative."""
    sig_mu = torch.sigmoid(raw[..., :dy])
    dsig = sig_mu * (1.0 - sig_mu)
    rest = raw[..., dy:]
    if rest.shape[-1] >= dy:
        scale = rest[..., :dy] + torch.log(torch.clamp(dsig, min=1e-6))
        rest = torch.cat([scale, rest[..., dy:]], dim=-1)
    return torch.cat([sig_mu, rest], dim=-1)
