"""EfficientUNet building blocks as ``nn.Module``s, NCHW.

Counterpart of ``cv_diffusion_tpu/models/blocks.py`` (float path). Module and
parameter names are those of the reference torch EfficientUNet, which the
JAX package's ``export_unet_state_dict`` emits, so a state dict from either
loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_irb_kernel, upcast
from ..ops.attention import linear_attention
from ..ops.fused_irb import irb_args
from ..ops.norms import (gn2_film_affine_gram, gn_num_groups, group_norm,
                         group_norm_film)


def activation(x: torch.Tensor, quantization_friendly: bool) -> torch.Tensor:
    """ReLU6 when quantization friendly, SiLU otherwise."""
    if quantization_friendly:
        return x.clamp(0.0, 6.0)
    return F.silu(x)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, max_period: int = 10000,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding in ``[cos, sin]`` order; t [B] →
    [B, dim], computed in ``dtype`` (float32, as the JAX package)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dtype, device=t.device) / half)
    args = t.to(dtype)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training-mode dropout as flax's ``nn.Dropout``: each element kept with
    probability 1 − rate and scaled by 1/(1 − rate), the mask drawn from
    ``generator`` (the train step's), never from torch's global RNG."""
    if generator is None:
        raise ValueError("dropout in training needs the train step's "
                         "torch.Generator (generator=...)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's group rule and float32 statistics."""

    def __init__(self, channels: int, max_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = gn_num_groups(channels, max_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return sinusoidal_pos_emb(t, self.dim, dtype=dtype)


class TimeEmbedding(nn.Sequential):
    """SinPosEmb(base_ch) → Linear(time_dim) → SiLU → Linear(time_dim). The
    embedding is computed in at least float32 and cast to the layers' dtype,
    as flax's ``Dense`` casts its input."""

    def __init__(self, base_channels: int, time_embed_dim: int):
        super().__init__(SinusoidalPosEmb(base_channels),
                         nn.Linear(base_channels, time_embed_dim), nn.SiLU(),
                         nn.Linear(time_embed_dim, time_embed_dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dtype = self[1].weight.dtype
        emb = self[0](t, torch.promote_types(dtype, torch.float32)).to(dtype)
        return self[3](self[2](self[1](emb)))


class SqueezeExcitation(nn.Module):
    """Mean pool → 1×1 squeeze → act → 1×1 expand → sigmoid (in f32) gate."""

    def __init__(self, channels: int, ratio: float = 0.25,
                 quantization_friendly: bool = True):
        super().__init__()
        squeezed = max(1, int(channels * ratio))
        self.quantization_friendly = quantization_friendly
        self.fc1 = nn.Conv2d(channels, squeezed, 1)
        self.fc2 = nn.Conv2d(squeezed, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = F.linear(s, self.fc1.weight.flatten(1), self.fc1.bias)
        s = activation(s, self.quantization_friendly)
        s = F.linear(s, self.fc2.weight.flatten(1), self.fc2.bias)
        s = torch.sigmoid(upcast(s)).to(x.dtype)
        return x * s[:, :, None, None]


class InvertedResidualBlock(nn.Module):
    """GN → act → 1×1 expand → GN ⊕ FiLM(time) → act → 3×3 depthwise → SE →
    1×1 project → dropout (training only, mask from the ``generator`` given
    to ``forward``) → residual (1×1 skip conv when the channel count changes;
    no residual at all for stride ≠ 1 with equal counts, as in the
    reference).

    Two inference rewrites of the JAX block, both off in training mode and
    neither changing the parameters: ``use_pallas_irb`` runs a stride-1 block
    as one call of the fused-IRB kernel's wrapper (the CUDA kernel for CUDA
    tensors, its plain version on the CPU); ``fold_gn`` keeps the separate
    convs but applies GN2 ⊕ FiLM as the affine folded from the Gram of x̂,
    so the expand output needs no statistics pass."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_embed_dim: int, expansion_ratio: int = 4,
                 stride: int = 1, use_se: bool = True, se_ratio: float = 0.25,
                 quantization_friendly: bool = True, dropout: float = 0.0,
                 use_pallas_irb: bool = False, fold_gn: bool = False):
        super().__init__()
        hidden = int(in_channels * expansion_ratio)
        self.quantization_friendly = quantization_friendly
        self.dropout = dropout
        self.stride = stride
        self.use_pallas_irb = use_pallas_irb
        self.fold_gn = fold_gn
        self.use_residual = stride == 1 and in_channels == out_channels
        self.norm1 = GroupNorm(in_channels)
        self.expand = nn.Conv2d(in_channels, hidden, 1, bias=False)
        self.norm2 = GroupNorm(hidden)
        self.time_mlp = nn.Sequential(nn.SiLU(),
                                      nn.Linear(time_embed_dim, hidden * 2))
        self.depthwise = nn.Conv2d(hidden, hidden, 3, stride=stride, padding=1,
                                   groups=hidden, bias=False)
        self.se = (SqueezeExcitation(hidden, se_ratio, quantization_friendly)
                   if use_se else None)
        self.project = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.skip = (nn.Conv2d(in_channels, out_channels, 1, stride=stride,
                               bias=False)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        film_scale, film_shift = self.time_mlp(time_emb).chunk(2, dim=-1)
        if self.use_pallas_irb and self.stride == 1 and not self.training:
            return fused_irb_kernel.fused_irb_v2(
                x, film_scale=film_scale, film_shift=film_shift,
                **irb_args(self))
        h = activation(self.norm1(x), self.quantization_friendly)
        if self.fold_gn and not self.training:
            a2, b2 = gn2_film_affine_gram(
                h, self.expand.weight, self.norm2.weight, self.norm2.bias,
                film_scale, film_shift, self.norm2.num_groups, self.norm2.eps)
            h = self.expand(h)
            h = (upcast(h) * a2[:, :, None, None]
                 + b2[:, :, None, None]).to(h.dtype)
        else:
            h = self.expand(h)
            h = group_norm_film(h, self.norm2.weight, self.norm2.bias,
                                film_scale, film_shift, self.norm2.num_groups,
                                self.norm2.eps)
        h = activation(h, self.quantization_friendly)
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        if self.dropout > 0 and self.training:
            h = dropout(h, self.dropout, generator)
        if self.skip is not None:
            return h + self.skip(x)
        if self.use_residual:
            return h + x
        return h


class LinearAttention(nn.Module):
    """The attention op of :class:`LinearAttentionBlock` on q, k, v
    [B, N, heads, dim]. A module of its own, without parameters, so that a
    forward hook can see its inputs."""

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return linear_attention(q, k, v)


class LinearAttentionBlock(nn.Module):
    """GN → 1×1 qkv → φ-linear attention → 1×1 out → GN → +residual."""

    def __init__(self, channels: int, num_heads: int = 4, dim_head: int = 32):
        super().__init__()
        inner = num_heads * dim_head
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.norm = GroupNorm(channels)
        self.to_qkv = nn.Conv2d(channels, inner * 3, 1, bias=False)
        self.attn = LinearAttention()
        self.to_out = nn.Sequential(nn.Conv2d(inner, channels, 1, bias=False),
                                    GroupNorm(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hgt, wid = x.shape
        qkv = self.to_qkv(self.norm(x))
        # NHWC token order, split as (b, N, 3, heads, dh) like the JAX block;
        # one copy makes q, k and v each contiguous.
        qkv = (qkv.permute(0, 2, 3, 1)
               .reshape(b, hgt * wid, 3, self.num_heads, self.dim_head)
               .permute(2, 0, 1, 3, 4).contiguous())
        out = self.attn(qkv[0], qkv[1], qkv[2])
        out = out.reshape(b, hgt, wid, -1).permute(0, 3, 1, 2)
        return self.to_out(out) + x


class Downsample(nn.Module):
    """3×3 stride-2 conv, padding 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.down = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


class Upsample(nn.Module):
    """Bilinear ×2 in float32 with half-pixel centres, then a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(upcast(x), scale_factor=2, mode="bilinear",
                           align_corners=False, antialias=False).to(x.dtype)
        return self.conv(up)
