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


_GRAM_CHUNK = 2048


def gn2_film_affine_gram(xhat: torch.Tensor, wexp: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         film_scale: torch.Tensor, film_shift: torch.Tensor,
                         num_groups: int, eps: float = 1e-5):
    """GroupNorm ⊕ FiLM of a 1×1 conv's output, folded into a per-(batch,
    channel) affine without forming that output.

    Counterpart of ``gn2_film_affine_gram`` in the JAX package's
    ``ops/norms.py``. For h1 = x̂·W (W = ``wexp`` [Chid, Cin], the 1×1 conv
    weight), every per-channel moment of h1 follows from the augmented Gram
    of x̂ [B, Cin, H, W]: Σ_p h1_c = (Σ_p x̂_p)·w_c and Σ_p h1_c² =
    w_cᵀ(x̂ᵀx̂)w_c. The group variance E[h²] − E[h]² is clamped at 0.

    Precision: that difference cancels, so the Gram and both W-projections
    must be full float32 products (the JAX package runs them at
    ``Precision.HIGHEST``). Here they are ``torch.bmm``/``einsum`` in at least
    float32 (float64 inputs stay float64, as :func:`upcast`); on the card
    that needs TF32 off for matmuls, which ``device.pin_fp32`` sets.

    Returns (a, b), each [B, Chid], such that GN2⊕FiLM(h1) = h1·a + b.
    """
    b, cin = xhat.shape[:2]
    chid = wexp.shape[0]
    if chid % num_groups:
        raise ValueError(f"{chid} channels do not split into {num_groups} groups")
    flat = upcast(xhat.reshape(b, cin, -1))                 # [B, Cin, N]
    n = flat.shape[-1]
    # Σ_p x̂ x̂ᵀ over N up to 65,536 pixels: as one product per image it
    # runs on B·(Cin/32)² blocks of the card; split over chunks of ~2048
    # pixels and summed in a fixed order, it fills the card.
    s = max(1, n // _GRAM_CHUNK)
    while n % s:
        s -= 1
    chunks = flat.reshape(b, cin, s, n // s).transpose(1, 2).reshape(b * s, cin, -1)
    gram = torch.bmm(chunks, chunks.transpose(1, 2)).reshape(b, s, cin, cin).sum(1)
    asum = flat.sum(dim=-1)                                 # Σ_p x̂
    wf = wexp.reshape(chid, cin).to(flat.dtype)
    m1 = asum @ wf.t() / n                                  # E[h1_c]
    gw = gram @ wf.t()                                      # [B, Cin, Chid]
    m2 = (gw * wf.t()).sum(dim=1) / n                       # E[h1_c²]
    per = chid // num_groups
    mg = m1.reshape(b, num_groups, per).mean(dim=2)
    eg2 = m2.reshape(b, num_groups, per).mean(dim=2)
    var = (eg2 - mg.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mg.repeat_interleave(per, dim=1)               # [B, Chid]
    rstd_c = rstd.repeat_interleave(per, dim=1)
    fs = 1.0 + film_scale.to(flat.dtype)
    gamma = scale.to(flat.dtype)[None]
    a = rstd_c * gamma * fs
    shift = (bias.to(flat.dtype)[None] - mean_c * rstd_c * gamma) * fs
    return a, shift + film_shift.to(flat.dtype)
