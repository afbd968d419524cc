"""The fused stride-1 inverted residual block (IRB) forward, in plain PyTorch.

Counterparts of the JAX package's two fused IRB kernels
(``cv_diffusion_tpu/ops/pallas_irb.py``), which compute the same function:

    out = project(SE(dw3x3(act(GN2⊕FiLM(expand(act(GN1 x))))))) + residual

``fused_irb_v2`` folds both GroupNorms into per-(batch, channel) affines
before the kernel runs (:func:`folded_gn_scales`: GN2 from the Gram of x̂,
so h1 is never formed), so the kernel itself computes

    h2  = act(a2·((act(a1·x + b1))·W_exp) + b2)
    h3  = dw3x3(h2)            zero rows and columns outside the image
    out = (h3·gate)·W_proj + (x or x·W_skip)

``fused_irb`` (v1) takes both GroupNorms' statistics inside the kernel, GN2's
from h1 itself. :func:`fused_irb_v2_plain` and :func:`fused_irb_v1_plain`
are the plain versions of the hand-written CUDA kernel's two entry points in
:mod:`.fused_irb_kernel`; the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds the kernel against them on the card.

Layouts are the port's: x and out NCHW, and every weight in the layout of the
port's module parameters (``wexp`` [Chid, Cin], ``wdw`` [Chid, 3, 3],
``wproj`` [Cout, Chid], ``wskip`` [Cout, Cin], ``se_w1`` [Csq, Chid],
``se_w2`` [Chid, Csq]); :func:`irb_args` takes them from a block.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import upcast
from .norms import (gn2_film_affine_gram, gn_num_groups, group_norm,
                    group_norm_film)


def _act(v: torch.Tensor, silu: bool) -> torch.Tensor:
    return F.silu(v) if silu else v.clamp(0.0, 6.0)


def folded_gn_scales(x: torch.Tensor, wexp: torch.Tensor,
                     gn1_scale: torch.Tensor, gn1_bias: torch.Tensor,
                     gn2_scale: torch.Tensor, gn2_bias: torch.Tensor,
                     film_scale: torch.Tensor, film_shift: torch.Tensor,
                     eps: float = 1e-5, silu: bool = False):
    """GN1 and GN2⊕FiLM as per-(batch, channel) affines, and x̂:
    ((a1, b1) [B, Cin], (a2, b2) [B, Chid], x̂ = act(a1·x + b1) [B, Cin, H,
    W]), in at least float32.

    Counterpart of ``_folded_gn_scales`` (``pallas_irb.py:552-601``): GN1's
    statistics are one reduction over x (``E[x²] − E[x]²`` clamped at 0), and
    GN2's come from the augmented Gram of x̂ = act(GN1 x) through
    :func:`.norms.gn2_film_affine_gram`, so h1 = x̂·W_exp is never formed.
    As in the JAX package this runs outside the kernel, as tensor ops.
    """
    b, cin = x.shape[:2]
    g1 = gn_num_groups(cin)
    xf = upcast(x)
    xg = xf.reshape(b, g1, -1)
    mean1 = xg.mean(dim=-1)                                    # [B, G1]
    var1 = (xg.square().mean(dim=-1) - mean1.square()).clamp_min(0.0)
    rstd1 = torch.rsqrt(var1 + eps)
    per = cin // g1
    a1 = rstd1.repeat_interleave(per, dim=1) * gn1_scale.to(xf.dtype)[None]
    b1 = gn1_bias.to(xf.dtype)[None] - mean1.repeat_interleave(per, dim=1) * a1
    xhat = _act(xf * a1[:, :, None, None] + b1[:, :, None, None], silu)
    a2, b2 = gn2_film_affine_gram(xhat, wexp, gn2_scale, gn2_bias, film_scale,
                                  film_shift, gn_num_groups(wexp.shape[0]), eps)
    return (a1, b1), (a2, b2), xhat


def fused_irb_v2_plain(x: torch.Tensor, wexp: torch.Tensor, wdw: torch.Tensor,
                       wproj: torch.Tensor, gn1_scale: torch.Tensor,
                       gn1_bias: torch.Tensor, gn2_scale: torch.Tensor,
                       gn2_bias: torch.Tensor, film_scale: torch.Tensor,
                       film_shift: torch.Tensor,
                       se_w1: Optional[torch.Tensor] = None,
                       se_b1: Optional[torch.Tensor] = None,
                       se_w2: Optional[torch.Tensor] = None,
                       se_b2: Optional[torch.Tensor] = None,
                       wskip: Optional[torch.Tensor] = None,
                       eps: float = 1e-5, silu: bool = False,
                       use_se: bool = True) -> torch.Tensor:
    """The stride-1 IRB forward of ``fused_irb_v2``, in plain PyTorch: x
    [B, Cin, H, W] → [B, Cout, H, W] in x's dtype, computed in at least
    float32. The residual is the identity unless ``wskip`` is given.

    The SE pool is the mean of h3 itself. The TPU kernel (and the CUDA one)
    get the same mean from h2's total, edge-row, edge-column and corner sums,
    which spares them the halo; the plain version keeps to the definition so
    that it checks that identity rather than repeating it.
    """
    _, (a2, b2), xhat = folded_gn_scales(
        x, wexp, gn1_scale, gn1_bias, gn2_scale, gn2_bias, film_scale,
        film_shift, eps, silu)
    xf = upcast(x)
    dt = xf.dtype
    chid = wexp.shape[0]

    def per_channel(v):
        return v.to(dt)[:, :, None, None]

    h1 = torch.einsum("bkhw,ck->bchw", xhat, wexp.reshape(chid, -1).to(dt))
    h2 = _act(h1 * per_channel(a2) + per_channel(b2), silu)
    return _irb_tail(h2, xf, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip,
                     silu, use_se).to(x.dtype)


def _irb_tail(h2, xf, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip, silu,
              use_se):
    """depthwise 3×3 (zero padding), the SE gate from the mean of h3 itself,
    project, and the residual: what both versions do after h2, in h2's
    dtype."""
    dt = h2.dtype
    chid = h2.shape[1]
    h3 = F.conv2d(h2, wdw.reshape(chid, 1, 3, 3).to(dt), padding=1,
                  groups=chid)
    if use_se:
        s = _act(h3.mean(dim=(2, 3)) @ se_w1.to(dt).t() + se_b1.to(dt), silu)
        gate = torch.sigmoid(s @ se_w2.to(dt).t() + se_b2.to(dt))
        h3 = h3 * gate[:, :, None, None]
    out = torch.einsum("bchw,oc->bohw", h3,
                       wproj.reshape(wproj.shape[0], chid).to(dt))
    if wskip is not None:
        return out + torch.einsum("bkhw,ok->bohw", xf,
                                  wskip.reshape(wskip.shape[0], -1).to(dt))
    return out + xf


def check_tile_h(height: int, tile_h: int) -> None:
    """Raise unless ``fused_irb``'s (v1) row tile, ``min(tile_h, height)``,
    divides the image's height, as the TPU kernel requires
    (``pallas_irb.py:269-271``). The tile does not change the result."""
    tile = min(tile_h, height)
    if tile < 1 or height % tile:
        raise ValueError(f"tile_h {tile_h} (taken as {tile}) does not divide "
                         f"the image's {height} rows")


def fused_irb_v1_plain(x: torch.Tensor, wexp: torch.Tensor, wdw: torch.Tensor,
                       wproj: torch.Tensor, gn1_scale: torch.Tensor,
                       gn1_bias: torch.Tensor, gn2_scale: torch.Tensor,
                       gn2_bias: torch.Tensor, film_scale: torch.Tensor,
                       film_shift: torch.Tensor,
                       se_w1: Optional[torch.Tensor] = None,
                       se_b1: Optional[torch.Tensor] = None,
                       se_w2: Optional[torch.Tensor] = None,
                       se_b2: Optional[torch.Tensor] = None,
                       wskip: Optional[torch.Tensor] = None,
                       eps: float = 1e-5, silu: bool = False,
                       use_se: bool = True, tile_h: int = 16) -> torch.Tensor:
    """The stride-1 IRB forward of ``fused_irb`` (v1, ``pallas_irb.py:241``),
    in plain PyTorch: the arguments of :func:`fused_irb_v2_plain`, and
    ``tile_h``, which is checked as the TPU kernel checks it
    (:func:`check_tile_h`) and changes nothing else.

    Step by step as v1 computes it, in at least float32 (float64 stays
    float64) with only the output cast to x's dtype: GN1 over x; h1 =
    act(GN1 x)·W_exp, formed; GN2's statistics over h1 itself, one pass
    (E[h1²] − E[h1]² clamped at 0); FiLM as ((h1 − μ)·rstd·γ + β)·(1 + fs) +
    fb; act; then the same depthwise, SE, project and residual as v2.
    """
    check_tile_h(x.shape[2], tile_h)
    xf = upcast(x)
    dt = xf.dtype
    chid = wexp.shape[0]
    xhat = _act(group_norm(xf, gn1_scale, gn1_bias, gn_num_groups(xf.shape[1]),
                           eps), silu)
    h1 = torch.einsum("bkhw,ck->bchw", xhat, wexp.reshape(chid, -1).to(dt))
    h2 = _act(group_norm_film(h1, gn2_scale, gn2_bias, film_scale, film_shift,
                              gn_num_groups(chid), eps), silu)
    return _irb_tail(h2, xf, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip,
                     silu, use_se).to(x.dtype)


def irb_args(block) -> dict:
    """The weights and settings of a port ``InvertedResidualBlock`` as
    keyword arguments of :func:`fused_irb_v2_plain` and
    :func:`fused_irb_v1_plain` (all but x and FiLM).
    Counterpart of ``irb_params_from_flax`` (``pallas_irb.py:356-374``)."""
    args = dict(
        wexp=block.expand.weight[:, :, 0, 0],
        wdw=block.depthwise.weight[:, 0],
        wproj=block.project.weight[:, :, 0, 0],
        gn1_scale=block.norm1.weight, gn1_bias=block.norm1.bias,
        gn2_scale=block.norm2.weight, gn2_bias=block.norm2.bias,
        eps=block.norm1.eps, silu=not block.quantization_friendly,
        use_se=block.se is not None)
    if block.se is not None:
        args.update(se_w1=block.se.fc1.weight[:, :, 0, 0],
                    se_b1=block.se.fc1.bias,
                    se_w2=block.se.fc2.weight[:, :, 0, 0],
                    se_b2=block.se.fc2.bias)
    if block.skip is not None:
        args["wskip"] = block.skip.weight[:, :, 0, 0]
    return args
