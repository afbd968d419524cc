"""The collectives of a spatially sharded UNet: what XLA's partitioner
inserts around the JAX package's layers on a ``(data, spatial)`` mesh.

Rank i of the spatial axis holds image rows [i·H/n, (i+1)·H/n) (dim 2 of
the model's NCHW tensors). Each function here is a ``torch.autograd.
Function`` whose backward is a collective too, so a train step's backward
runs the exchanges in reverse:

* :func:`halo_rows` brings rows from the neighbouring strips (a 3×3
  convolution's, a bilinear resize's); at the image's own border it fills
  zeros or copies the edge row. Its backward sends each halo row's
  gradient back to its owner, which adds it to that row.
* :func:`spatial_sum` sums over the spatial group (GroupNorm's and the SE
  block's statistics); its backward is the same sum of the gradients.
* :func:`gather_rows` all-gathers along a dim (softmax attention's tokens,
  the fused IRB's rows); its backward sums the whole gradient over the
  group and keeps this rank's rows. :func:`scatter_rows` keeps this rank's
  rows of a tensor every rank holds whole.

Why nothing is counted twice: every rank's loss is its share of the
global loss, so the gradient that reaches a value on one rank carries that
rank's share only; a collective's backward adds the shares of the ranks
that used the value once each, and the parameters' gradients are then
averaged once over the whole mesh (``training.train_state.
reduce_gradients``).

Every rank issues the same collectives in the same order, the forward
again included where ``remat`` recomputes a block in the backward. Under
gloo, ``all_gather`` takes host tensors only: :func:`~.mesh.
all_gather_rows` stages a CUDA tensor through the host; bf16 travels as
its bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import SpatialShard, all_gather_rows

EDGES = ("zero", "replicate")


def _gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every member's ``t`` (equal shapes) stacked [n, ...] in group order."""
    bits = t.dtype == torch.bfloat16          # gloo gathers no 16-bit integers
    local = t.contiguous()
    parts = all_gather_rows((local.view(torch.uint8) if bits else local)[None], group)
    return parts.view(torch.bfloat16) if bits else parts


def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor)."""
    out = t.contiguous().clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, edge, shard):
        ctx.top, ctx.bottom, ctx.edge, ctx.shard = top, bottom, edge, shard
        i, n = shard.index, shard.size
        rows = x.shape[2]
        # what the neighbours take: the first `bottom` rows (rank i−1's bottom
        # halo), then the last `top` rows (rank i+1's top halo)
        send = torch.cat([x[:, :, :bottom], x[:, :, rows - top:]], dim=2)
        parts = _gather(send, shard.group, n) if n > 1 else send[None]
        pieces = []
        if top:
            if i > 0:
                pieces.append(parts[i - 1][:, :, bottom:])
            elif edge == "zero":
                pieces.append(x.new_zeros(x.shape[:2] + (top,) + x.shape[3:]))
            else:
                pieces.append(x[:, :, :1].expand(-1, -1, top, -1))
        pieces.append(x)
        if bottom:
            if i < n - 1:
                pieces.append(parts[i + 1][:, :, :bottom])
            elif edge == "zero":
                pieces.append(x.new_zeros(x.shape[:2] + (bottom,) + x.shape[3:]))
            else:
                pieces.append(x[:, :, -1:].expand(-1, -1, bottom, -1))
        return torch.cat(pieces, dim=2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        top, bottom, shard = ctx.top, ctx.bottom, ctx.shard
        i, n = shard.index, shard.size
        rows = g.shape[2] - top - bottom
        g_top, g_bottom = g[:, :, :top], g[:, :, top + rows:]
        dx = g[:, :, top:top + rows].clone()
        # each halo row's gradient goes back to the rank that owns the row
        send = torch.cat([g_top, g_bottom], dim=2)
        parts = _gather(send, shard.group, n) if n > 1 else send[None]
        if top:
            if i < n - 1:       # my last rows were the top halo of rank i + 1
                dx[:, :, rows - top:] += parts[i + 1][:, :, :top]
            if i == 0 and ctx.edge == "replicate":
                dx[:, :, :1] += g_top.sum(dim=2, keepdim=True)
        if bottom:
            if i > 0:           # my first rows were the bottom halo of rank i − 1
                dx[:, :, :bottom] += parts[i - 1][:, :, top:]
            if i == n - 1 and ctx.edge == "replicate":
                dx[:, :, -1:] += g_bottom.sum(dim=2, keepdim=True)
        return dx, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, edge: str,
              shard: SpatialShard) -> torch.Tensor:
    """x [B, C, L, W], this rank's strip → [B, C, top + L + bottom, W]: the
    last ``top`` rows of the strip above and the first ``bottom`` rows of
    the strip below around it. Above row 0 and below row H − 1 of the
    image: zeros (``edge="zero"``, a convolution's padding) or copies of
    the edge row (``"replicate"``, the clamp of a bilinear resize)."""
    if edge not in EDGES:
        raise ValueError(f"edge {edge!r}: one of {EDGES}")
    if not 0 <= top <= x.shape[2] or not 0 <= bottom <= x.shape[2]:
        raise ValueError(f"a halo of {top} and {bottom} rows around a strip "
                         f"of {x.shape[2]}")
    return _HaloRows.apply(x, top, bottom, edge, shard)


class _SpatialSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _reduced(t, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


def spatial_sum(t: torch.Tensor, shard: SpatialShard) -> torch.Tensor:
    """``t`` summed over the spatial group (every rank gets the sum)."""
    return _SpatialSum.apply(t, shard.group)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard, ctx.rows = dim, shard, x.shape[dim]
        parts = _gather(x, shard.group, shard.size)        # [n, ...]
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        whole = _reduced(g, ctx.shard.group)
        return (whole.narrow(ctx.dim, ctx.shard.index * ctx.rows,
                             ctx.rows).contiguous(), None, None)


def gather_rows(x: torch.Tensor, dim: int, shard: SpatialShard) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    whole image (dim 2 of NCHW) or sequence (dim 1 of [B, N, H, D])."""
    return _GatherRows.apply(x, dim, shard)


def scatter_rows(x: torch.Tensor, dim: int, shard: SpatialShard) -> torch.Tensor:
    """This rank's rows along ``dim`` of ``x``, which every rank holds
    whole (the reverse of :func:`gather_rows`)."""
    rows = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * rows, rows)
