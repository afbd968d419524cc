"""Group normalisation with float32 statistics, channels on axis 1 (NCHW).

Counterpart of ``cv_diffusion_tpu/ops/norms.py``: the same group rule and the
same statistics, ``var = E[x²] − E[x]²`` clamped at 0, so that the port
agrees with the JAX package to float rounding.
"""

from __future__ import annotations

import torch

from . import upcast


def gn_num_groups(channels: int, max_groups: int = 32) -> int:
    """Largest group count ≤ min(max_groups, channels) dividing channels."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def _normalized(x: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    """(x − mean) · rstd per (batch, group), in float32, shaped like x."""
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xg = upcast(x.reshape(b, num_groups, -1))
    mean = xg.mean(dim=-1, keepdim=True)
    mean2 = xg.square().mean(dim=-1, keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)


def _per_channel(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """[C] or [B, C] → broadcastable against [B, C, *spatial]."""
    return upcast(p).reshape(p.shape + (1,) * (ndim - 2))


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``torch.nn.GroupNorm`` semantics with f32 statistics; x's dtype kept."""
    xn = _normalized(x, num_groups, eps)
    out = xn * _per_channel(weight, x.dim()) + _per_channel(bias, x.dim())
    return out.to(x.dtype)


def group_norm_film(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    film_scale: torch.Tensor, film_shift: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then FiLM: ``gn(x)·(1 + s) + b``, with s, b [B, C]."""
    xn = _normalized(x, num_groups, eps)
    xn = xn * _per_channel(weight, x.dim()) + _per_channel(bias, x.dim())
    out = (xn * (1.0 + _per_channel(film_scale, x.dim()))
           + _per_channel(film_shift, x.dim()))
    return out.to(x.dtype)
