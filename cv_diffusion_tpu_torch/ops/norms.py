"""Group normalisation with float32 statistics, channels on axis 1 (NCHW).

Counterpart of ``cv_diffusion_tpu/ops/norms.py``: the same group rule and the
same statistics, ``var = E[x²] − E[x]²`` clamped at 0, so that the port
agrees with the JAX package to float rounding.

Under a spatial shard (``parallel.mesh.spatial_scope``) each rank holds a
strip of image rows: its sums are added over the spatial group
(``parallel.halo.spatial_sum``, one collective a normalisation) and the
means taken over the whole image's count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.halo import spatial_sum
from ..parallel.mesh import current_spatial
from . import upcast


def _image_sums(parts: torch.Tensor, count: int) -> Tuple[torch.Tensor, int]:
    """(``parts`` summed over the spatial group, ``count`` over the whole
    image): sums over this rank's elements and their number, as they are
    without a spatial shard."""
    shard = current_spatial()
    if shard is None:
        return parts, count
    return spatial_sum(parts, shard), count * shard.size


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
    if current_spatial() is None:
        mean = xg.mean(dim=-1, keepdim=True)
        mean2 = xg.square().mean(dim=-1, keepdim=True)
    else:
        sums, n = _image_sums(torch.stack([xg.sum(dim=-1), xg.square().sum(dim=-1)]),
                              xg.shape[-1])
        mean, mean2 = (m[..., None] / n for m in sums)
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
    if current_spatial() is not None:
        sums, n = _image_sums(torch.cat([gram.reshape(b, -1), asum], dim=1), n)
        gram, asum = sums[:, :cin * cin].reshape(b, cin, cin), sums[:, cin * cin:]
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


def concat_group_norm_parts(u: torch.Tensor, s: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, eps: float = 1e-5):
    """GroupNorm of ``cat([u, s], dim=1)`` applied to each part without
    forming the concatenation.

    Counterpart of ``concat_group_norm_parts`` in the JAX package's
    ``ops/norms.py:70-121`` (channels on axis 1 here). The group statistics
    come from per-channel sums and sums of squares of each part, in float32
    (at least), so a group that straddles the boundary sees both; the
    variance E[x²] − E[x]² is clamped at 0. Returns (û, ŝ): each part
    normalised with its slice of the affine, in its own dtype.
    """
    cu, cs = u.shape[1], s.shape[1]
    c = cu + cs
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    gs = c // num_groups
    spatial = tuple(range(2, u.dim()))
    uf, sf = upcast(u), upcast(s)
    sums = torch.cat([uf.sum(dim=spatial), sf.sum(dim=spatial)], dim=1)   # [B, C]
    sums2 = torch.cat([uf.square().sum(dim=spatial),
                       sf.square().sum(dim=spatial)], dim=1)
    (sums, sums2), n = _image_sums(torch.stack([sums, sums2]), gs * u[0, 0].numel())
    n = float(n)
    mean = sums.reshape(-1, num_groups, gs).sum(-1) / n                   # [B, G]
    var = (sums2.reshape(-1, num_groups, gs).sum(-1) / n
           - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(gs, dim=1)                            # [B, C]
    rstd_c = rstd.repeat_interleave(gs, dim=1)

    def part(x, xf, lo, hi):
        shape = (x.shape[0], hi - lo) + (1,) * len(spatial)
        m = mean_c[:, lo:hi].reshape(shape)
        r = rstd_c[:, lo:hi].reshape(shape)
        g = _per_channel(weight[lo:hi], x.dim())
        b = _per_channel(bias[lo:hi], x.dim())
        return ((xf - m) * r * g + b).to(x.dtype)

    return part(u, uf, 0, cu), part(s, sf, cu, c)
