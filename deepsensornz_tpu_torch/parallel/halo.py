"""The spatial partition's communication: the U-Net's halo exchange and the
sum of the decode's partials over the spatial axis.

JAX has no counterpart: with ``ConvNPConfig.mesh_axes`` set, XLA SPMD
shards the encoding as ``P(batch, spatial, None, None)`` and writes the
exchanges of the U-Net's convolutions and the reduction of the decode
itself. The port writes them by hand. Each rank of a spatial group holds a
contiguous block of the internal grid's rows (``mesh.row_blocks``):

- :func:`halo` gives a block the rows a convolution reads above and below
  it, from the neighbouring blocks, and zeros past the grid's edges (the
  convolution's own zero padding). Its forward is one ``all_gather`` of
  every rank's packed edge rows over the spatial group, never
  ``send``/``recv``: gloo moves CUDA tensors through collectives only. Its
  backward adds each halo row's gradient back into its owner's row, through
  one more ``all_gather``. The rows travel as their bytes, bit for bit;
  :func:`conv_halo` and :func:`transpose_halo` derive how many rows a
  convolution needs from its kernel, stride and padding.
- :func:`spatial_sum` sums a partial (a decode over the block's rows) over
  the group: an all-reduce forward and the identity backward.

Every rank of the group must make the same calls in the same order, or
the collectives deadlock; the model's graph is the same on every rank, so
the forward, the backward and a rematerialised recomputation all are.
The perf recorder counts the exchanges and the sums and their bytes
(``halo.exchanges``, ``halo.exchange_bytes``, ``halo.sums``,
``halo.sum_bytes``; the bytes each rank gathers or sums) and, while it
records, times each collective on the host as the span ``halo.exchange``
or ``halo.sum`` (for CUDA tensors under gloo, the copies through the host
included).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepsensornz_tpu_torch.perf import spans


@dataclasses.dataclass(frozen=True)
class SpatialContext:
    """Where a block sits: the spatial axis' process ``group``, this rank's
    ``index`` on it and the block ``bounds`` of every rank at one U-Net
    level (rank r holds rows ``[bounds[r], bounds[r + 1])`` of a
    ``bounds[-1]``-row grid)."""

    group: object
    index: int
    bounds: tuple

    @property
    def rows(self) -> int:
        return self.bounds[-1]

    @property
    def start(self) -> int:
        return self.bounds[self.index]

    @property
    def stop(self) -> int:
        return self.bounds[self.index + 1]

    def at(self, level: int) -> "SpatialContext":
        """The same blocks at U-Net level ``level`` (rows halved per level)."""
        return dataclasses.replace(self, bounds=tuple(b >> level for b in self.bounds))

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape and dtype on every rank), by rank,
        as its bytes: any dtype over any backend."""
        flat = t.contiguous().view(-1).view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(len(self.bounds) - 1)]
        dist.all_gather(parts, flat, group=self.group)
        return [p.view(t.dtype).view(t.shape) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        dist.all_reduce(t, group=self.group)
        return t


def spatial_context(mesh, H: int, unit: int) -> SpatialContext:
    """This rank's context on ``mesh``'s spatial axis for an ``H``-row grid
    cut into blocks of whole ``unit``-row multiples (``mesh.row_blocks``)."""
    from deepsensornz_tpu_torch.parallel.mesh import row_blocks, spatial_group, spatial_shard

    index, n = spatial_shard(mesh)
    blocks = row_blocks(H, n, unit)
    return SpatialContext(spatial_group(mesh), index, tuple(a for a, _ in blocks) + (H,))


def conv_halo(k: int, s: int, pad_lo: int) -> tuple[int, int]:
    """(above, below): the rows a k-row, stride-s convolution with
    ``pad_lo`` rows of low padding reads beyond a block whose first row is
    a multiple of s, to give the block's own output rows. Output row o
    reads rows o·s − pad_lo … o·s − pad_lo + k − 1: a stride-1 k=5 conv
    needs (2, 2), the stride-2 k=5 SAME conv (pads (1, 2)) needs (1, 2)."""
    above, below = pad_lo, k - s - pad_lo
    if below < 0:
        raise ValueError(f"a k={k}, stride-{s} convolution reads fewer rows than it steps")
    return above, below


def transpose_halo(k: int, s: int, p: int) -> tuple[int, int, int]:
    """(above, below, first): a stride-s transposed convolution with a
    k-row kernel and ``p`` rows of padding (``conv_transpose2d``'s), run on
    a block of input rows [a, b) with ``above`` and ``below`` halo rows and
    no padding, gives output rows s·a … s·b − 1 at rows ``first`` … of its
    result. Output row o sums input rows i with o = i·s + j − p for a
    kernel row j: for the U-Net's k=5 up conv (p = 1), (1, 1, 3)."""
    above, below = (k - 1 - p) // s, (p - 1) // s + 1
    return above, below, p + above * s


@functools.lru_cache(maxsize=None)
def _plan(bounds: tuple, r: int, above: int, below: int, K: int) -> tuple:
    """Rank r's halo rows as two tuples of runs, above the block and below
    it: (owner, first slot in the owner's packed edges, length); owner -1
    is a run of zeros past the grid's edge. A rank packs its first K rows,
    then its last K (a block of fewer than K rows padded after, then
    before), so global row g of rank j sits at slot g − a_j in the head
    and at 2K − b_j + g in the tail; a row above a block lies in some
    earlier rank's tail and a row below it in some later rank's head."""
    H = bounds[-1]
    a, b = bounds[r], bounds[r + 1]
    out = []
    for rows, tail in ((range(a - above, a), True), (range(b, b + below), False)):
        side = []
        for g in rows:
            if g < 0 or g >= H:
                j, slot = -1, -1
            else:
                j = bisect.bisect_right(bounds, g) - 1
                slot = 2 * K - bounds[j + 1] + g if tail else g - bounds[j]
            if side and side[-1][0] == j and (j < 0 or side[-1][1] + side[-1][2] == slot):
                side[-1][2] += 1
            else:
                side.append([j, slot, 1])
        out.append(tuple(tuple(x) for x in side))
    return tuple(out)


def _pack(x: torch.Tensor, K: int) -> torch.Tensor:
    """A block's first K rows and its last K rows (B, C, 2K, W), contiguous."""
    h = x.shape[2]
    head = x[:, :, :K] if h >= K else F.pad(x, (0, 0, 0, K - h))
    tail = x[:, :, h - K:] if h >= K else F.pad(x, (0, 0, K - h, 0))
    return torch.cat([head, tail], 2).contiguous()


def _gather(sp: SpatialContext, t: torch.Tensor) -> list[torch.Tensor]:
    with spans.span("halo.exchange"):
        parts = sp.all_gather(t)
    spans.count("halo.exchanges")
    spans.count("halo.exchange_bytes", sum(p.numel() * p.element_size() for p in parts))
    return parts


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp: SpatialContext, above: int, below: int):
        K = max(above, below)
        parts = _gather(sp, _pack(x, K))
        B, C, h, W = x.shape
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)

        def rows(runs):
            return [(x.new_zeros((B, C, n, W)) if j < 0 else parts[j][:, :, slot:slot + n]
                     ).contiguous(memory_format=fmt) for j, slot, n in runs]

        up, down = _plan(sp.bounds, sp.index, above, below, K)
        ctx.sp, ctx.geom = sp, (above, below, K, h)
        return torch.cat(rows(up) + [x] + rows(down), 2)

    @staticmethod
    def backward(ctx, grad):
        sp = ctx.sp
        above, below, K, h = ctx.geom
        gx = grad[:, :, above:above + h].clone()
        parts = _gather(sp, torch.cat([grad[:, :, :above], grad[:, :, above + h:]], 2))
        # every rank's halo rows that this rank owns, added back rank by rank
        # (within one rank's halo each row appears once: a fixed order)
        for r, part in enumerate(parts):
            pos = 0
            for j, slot, n in sum(_plan(sp.bounds, r, above, below, K), ()):
                if j == sp.index:
                    lo = slot if slot < K else slot - 2 * K + h
                    gx[:, :, lo:lo + n] += part[:, :, pos:pos + n]
                pos += n
        return gx, None, None, None


def halo(x: torch.Tensor, sp: SpatialContext, above: int, below: int) -> torch.Tensor:
    """The block ``x`` (B, C, h, W), rows ``[sp.start, sp.stop)`` of the
    grid, with ``above`` rows before it and ``below`` after it from the
    other blocks (zeros past the grid's edges): (B, C, above + h + below,
    W), in ``x``'s memory format. Differentiable: the halo rows' gradients
    go back to the ranks that own them."""
    if above == 0 and below == 0:
        return x
    return _Halo.apply(x, sp, above, below)


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp: SpatialContext):
        out = t.contiguous().clone()
        with spans.span("halo.sum"):
            sp.all_reduce(out)
        spans.count("halo.sums")
        spans.count("halo.sum_bytes", out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def spatial_sum(t: torch.Tensor, sp: SpatialContext) -> torch.Tensor:
    """The partials ``t`` of every rank of the spatial group, summed: every
    rank gets the sum. Backward: the identity, since every rank computes
    the same function of the sum, each partial's gradient is the sum's."""
    return _SpatialSum.apply(t, sp)
