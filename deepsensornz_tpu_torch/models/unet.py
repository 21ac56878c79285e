"""U-Net backbone over the internal grid (counterpart of
``deepsensornz_tpu/models/unet.py``).

The plain graph of the JAX ``UNet.__call__``: a 1×1 stem, L stride-2 k×k
down convs, a stride-1 bottleneck, L stride-2 transposed-conv (or nearest
+ conv) ups with skip concatenation and a stride-1 mix conv each, and a
1×1 head. Parameters are float32; the convs compute in ``compute_dtype``.

The JAX module's ``lane_pack``, ``s2d``/``packw`` down-sampling and
``subpixel`` up-sampling are exact reparameterisations of this same graph
with the same parameter names and shapes, written for the TPU's layouts;
the port computes the plain graph whatever those fields say.

Padding follows flax's ``"SAME"`` exactly, which torch's symmetric
``padding=`` does not: a stride-2 conv pads ``total = max((⌈n/s⌉-1)·s + k
- n, 0)`` split low-first (``low = total // 2``), and a stride-2 SAME
transposed conv equals ``conv_transpose2d`` with the flax kernel flipped
spatially (done once, in :func:`..train.checkpoint.params_from_jax`),
padding ``k-1-pad_a`` and the surplus trailing row/column cropped.

Tensors are NCHW in PyTorch's sense; the model keeps them in
``torch.channels_last`` memory, so an NHWC tensor enters and leaves
without a copy.

Given a spatial context (:class:`..parallel.halo.SpatialContext`: the
spatial group and the row blocks), the U-Net runs on this rank's block of
rows: each convolution with k > 1 takes its halo rows from the other blocks
(:func:`..parallel.halo.halo`), as many as its kernel, stride and padding
read past the block, and gives exactly the block's rows of the whole
grid's convolution; the 1×1 stem and head exchange nothing.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from deepsensornz_tpu_torch.parallel.halo import conv_halo, halo, transpose_halo

REMAT_POLICIES = (None, "acts", "dots")
# what remat_policy="dots" keeps: the convolutions' and products' outputs
_DOTS_SAVED = [torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
               torch.ops.aten.bmm.default]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in."""
    # 0.8796...: std of a standard normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int = 2) -> tuple[int, int]:
    """lax ``conv_transpose`` SAME padding (pad_a, pad_b) of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


class Conv(nn.Conv2d):
    """A flax ``nn.Conv`` with SAME padding: weight (O, I, k, k), bias (O,)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 generator=None, device=None):
        super().__init__(cin, cout, k, stride=stride, device=device)
        lecun_normal_(self.weight, cin * k * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp``: the spatial context at x's level; x is then the block's
        rows, and so is the output (the block's rows of the whole conv)."""
        k, s = self.kernel_size[0], self.stride[0]
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        wl, wh = _same_pads(x.shape[3], k, s)
        if sp is not None:
            # the halo stands in for the rows' padding: SAME pads of the whole grid
            x = halo(x, sp, *conv_halo(k, s, _same_pads(sp.rows, k, s)[0]))
            if wl == wh:
                return F.conv2d(x, w, b, stride=s, padding=(0, wl))
            return F.conv2d(F.pad(x, (wl, wh, 0, 0)), w, b, stride=s)
        hl, hh = _same_pads(x.shape[2], k, s)
        if s == 1 and hl == hh and wl == wh:
            return F.conv2d(x, w, b, padding=hl)
        x = F.pad(x, (wl, wh, hl, hh))
        return F.conv2d(x, w, b, stride=s)


class ConvTranspose(nn.ConvTranspose2d):
    """A flax ``nn.ConvTranspose`` with stride 2 and SAME padding; weight
    (I, O, k, k) holds the flax kernel flipped spatially."""

    def __init__(self, cin: int, cout: int, k: int, *, generator=None, device=None):
        super().__init__(cin, cout, k, stride=2, device=device)
        # flax's fan_in for a (k, k, in, out) kernel is k·k·in
        lecun_normal_(self.weight, cin * k * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp``: the spatial context at x's level; x is then the block's
        rows, and the output the block's rows at the level above."""
        k = self.kernel_size[0]
        pad_a, pad_b = _transpose_pads(k)
        extra = pad_b - pad_a  # >0: pad at the end, <0: crop at the end
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        p = k - 1 - pad_a
        if sp is not None:
            above, below, first = transpose_halo(k, 2, p)
            h = x.shape[2]
            y = F.conv_transpose2d(halo(x, sp, above, below), w, b, stride=2, padding=(0, p),
                                   output_padding=(0, max(extra, 0)))
            y = y[:, :, first:first + 2 * h]
            return y[..., :extra] if extra < 0 else y
        y = F.conv_transpose2d(x, w, b, stride=2, padding=p, output_padding=max(extra, 0))
        if extra < 0:
            y = y[:, :, :extra, :extra]
        return y


def _at(spatial, level: int):
    return None if spatial is None else spatial.at(level)


class UNet(nn.Module):
    """Stride-2 conv U-Net. forward: (B, C, H, W) → (B, out_channels, H, W)
    float32; H and W must be divisible by ``2**len(channels)``."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (64, 64, 64, 64),
                 out_channels: int = 64, kernel_size: int = 5,
                 compute_dtype: torch.dtype = torch.float32, upsample: str = "transpose",
                 top_kernel: Optional[int] = None, *, generator=None, device=None):
        super().__init__()
        if upsample not in ("transpose", "subpixel", "nearest"):
            raise ValueError(f"unknown upsample {upsample!r}")
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        self.upsample = upsample
        kw = dict(generator=generator, device=device)

        def ksz(level: int) -> int:
            return top_kernel if (level == 0 and top_kernel is not None) else kernel_size

        self.stem = Conv(in_channels, self.channels[0], 1, **kw)
        cin = self.channels[0]
        for i, ch in enumerate(self.channels):
            setattr(self, f"down_{i}", Conv(cin, ch, ksz(i), stride=2, **kw))
            cin = ch
        L = len(self.channels)
        self.bottleneck = Conv(cin, self.channels[-1], ksz(L), **kw)
        cin = self.channels[-1]
        # skips[i] has the width of the level's input: channels[i-1], stem at 0
        skip = (self.channels[0],) + self.channels[:-1]
        for i in reversed(range(L)):
            ch = self.channels[i]
            if upsample == "nearest":
                up = Conv(cin, ch, ksz(i), **kw)
            else:  # "subpixel" is the same transposed conv, reparameterised
                up = ConvTranspose(cin, ch, ksz(i), **kw)
            setattr(self, f"up_{i}", up)
            setattr(self, f"up_mix_{i}", Conv(ch + skip[i], ch, ksz(i), **kw))
            cin = ch
        self.head = Conv(cin, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.raw(x).float()

    def raw(self, x: torch.Tensor, inplace_bias: bool = True, spatial=None) -> torch.Tensor:
        """The forward pass with the output left in ``compute_dtype``: in
        bf16 its values are exactly those :meth:`forward` widens to f32.
        ``spatial``: a spatial context at level 0; x is then this rank's
        block of rows, and so is the output."""
        x = self.stem(x.to(self.compute_dtype))
        skips = []
        for i in range(len(self.channels)):
            x = F.relu(x)
            skips.append(x)
            x = getattr(self, f"down_{i}")(x, _at(spatial, i))
        x = self.bottleneck(F.relu(x), _at(spatial, len(self.channels)))
        for i in reversed(range(len(self.channels))):
            x = self._up(i, x, skips[i], spatial)
        return self._head_channel_first(F.relu(x), inplace_bias)

    def raw_remat(self, x: torch.Tensor, policy: Optional[str], spatial=None) -> torch.Tensor:
        """:meth:`raw` under rematerialisation: the backward recomputes what
        the forward did not keep. ``policy`` says what it keeps, as the JAX
        package's ``remat_policy`` does:

        - None: nothing inside the U-Net (its input only);
        - ``"acts"``: the tensors the JAX U-Net tags (``_tag``): each
          ``down_i`` output, the bottleneck's and each ``up_mix_i`` output.
          Each span between them is one checkpointed block; the stem, which
          feeds the first block and the last up block, runs in both;
        - ``"dots"``: the output of every convolution and matrix product;
          the ReLUs, pads, casts and concatenations are recomputed. (JAX's
          ``dots_with_no_batch_dims_saveable`` names ``dot_general`` only,
          which the flax U-Net's convolutions are not.)

        The parameters the recomputation reads are the module's own, so it
        sees the values the forward saw. On a block (``spatial``) the
        recomputation issues the forward's halo exchanges again, in the
        forward's order, on every rank of the group."""
        if policy is None:
            return checkpoint(functools.partial(self.raw, spatial=spatial), x,
                              use_reentrant=False)
        if policy == "dots":
            # the head's bias is added out of place: an in-place add would
            # change the saved product
            return checkpoint(functools.partial(self.raw, inplace_bias=False, spatial=spatial),
                              x, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts, _DOTS_SAVED))
        if policy != "acts":
            raise ValueError(f"unknown remat_policy {policy!r}; use None/'dots'/'acts'")

        def block(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)

        def stem(h):
            return F.relu(self.stem(h.to(self.compute_dtype)))

        L, sp = len(self.channels), spatial
        acts = [block(lambda h: self.down_0(stem(h), _at(sp, 0)), x)]
        for i in range(1, L):
            acts.append(block(lambda d, i=i: getattr(self, f"down_{i}")(F.relu(d), _at(sp, i)),
                              acts[-1]))
        y = block(lambda d: self.bottleneck(F.relu(d), _at(sp, L)), acts[-1])
        for i in reversed(range(1, L)):
            y = block(lambda y, d, i=i: self._up(i, y, F.relu(d), sp), y, acts[i - 1])
        y = block(lambda y, h: self._up(0, y, stem(h), sp), y, x)
        return block(lambda m: self._head_channel_first(F.relu(m)), y)

    def _up(self, i: int, x: torch.Tensor, skip: torch.Tensor, spatial=None) -> torch.Tensor:
        """Level i's way up: ``up_i``, the skip concatenated, ``up_mix_i``."""
        x = F.relu(x)
        if self.upsample == "nearest":
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = getattr(self, f"up_{i}")(x, _at(spatial, i))
        else:
            x = getattr(self, f"up_{i}")(x, _at(spatial, i + 1))
        x = torch.cat([x, skip], dim=1)
        return getattr(self, f"up_mix_{i}")(F.relu(x), _at(spatial, i))

    def _head_channel_first(self, x: torch.Tensor, inplace_bias: bool = True) -> torch.Tensor:
        """The 1×1 head as one batched product that writes channel-first
        memory (a contiguous (B, C, H, W)) from channels-last x without a
        transpose pass: the decode kernel reads the channel planes in place."""
        B, _, H, W = x.shape
        w = self.head.weight.to(x.dtype).flatten(1)          # (C, cin)
        xs = x.permute(0, 2, 3, 1).reshape(B, H * W, -1)     # a view when channels-last
        out = torch.matmul(w, xs.transpose(1, 2))            # (B, C, H·W)
        bias = self.head.bias.to(x.dtype)[:, None]
        out = out.add_(bias) if inplace_bias else out + bias
        return out.view(B, -1, H, W)
