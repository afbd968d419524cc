"""Attention over flattened spatial tokens, in plain PyTorch: linear and
softmax.

Counterpart of ``cv_diffusion_tpu/ops/attention.py``:

    linear:  out = φ(Q)·(φ(K)ᵀV) / (φ(Q)·Σφ(K) + eps),   φ = elu + 1
    softmax: out = softmax(Q·Kᵀ·scale)·V

Token layout is the JAX package's ``[B, N, heads, dim]``.
:func:`linear_attention_plain` and :func:`linear_attention_backward_plain`
are the plain versions of the hand-written CUDA kernels in
:mod:`.linear_attention_kernel`, and ``linear_attention_{kv, apply,
bwd_partial, bwd_finish}_plain`` those of its token-sharded entries, :func:`softmax_attention_plain` and
:func:`softmax_attention_backward_rows` those of the flash-attention
kernels in :mod:`.flash_attention_kernel`; the CPU tests hold them against
the JAX package, and ``chip_smoke.py`` holds the kernels against them on
the card. :func:`linear_attention` and :func:`softmax_attention` are what
the model calls: the kernels' autograd functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import upcast


def elu_plus_one(x: torch.Tensor) -> torch.Tensor:
    """φ feature map for linear attention."""
    return F.elu(x) + 1.0


def linear_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """Two contractions and a normaliser, accumulated in float32; the output
    has q's dtype. Counterpart of JAX ``linear_attention_xla``.

    q, k, v: [B, N, H, D]. Returns [B, N, H, D].
    """
    qf = elu_plus_one(upcast(q))
    kf = elu_plus_one(upcast(k))
    vf = upcast(v)
    k_sum = kf.sum(dim=1)                                   # [B, H, D]
    kv = torch.einsum("bnhd,bnhe->bhde", kf, vf)            # [B, H, D, D]
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)           # [B, N, H, D]
    den = torch.einsum("bnhd,bhd->bnh", qf, k_sum)          # [B, N, H]
    return (num / (den[..., None] + eps)).to(q.dtype)


def elu_plus_one_grad(x: torch.Tensor) -> torch.Tensor:
    """φ′(x): 1 for x > 0, else e^min(x, 0) (no overflow for large x)."""
    return torch.where(x > 0, torch.ones_like(x), torch.exp(x.clamp(max=0.0)))


def linear_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, g: torch.Tensor,
                                    eps: float = 1e-6):
    """(dq, dk, dv) of :func:`linear_attention_plain` for the upstream
    gradient ``g``, in closed form, recomputed from q, k, v in at least
    float32; each result has its input's dtype. Counterpart of JAX
    ``_trainable_bwd`` (``pallas_attention.py:202-236``); the plain version
    of the backward kernel in :mod:`.linear_attention_kernel`."""
    qf, kf = elu_plus_one(upcast(q)), elu_plus_one(upcast(k))
    vf, gf = upcast(v), upcast(g)
    k_sum = kf.sum(dim=1)                                         # [B,H,D]
    kv = torch.einsum("bnhd,bnhe->bhde", kf, vf)                  # [B,H,D,E]
    den = torch.einsum("bnhd,bhd->bnh", qf, k_sum) + eps          # [B,N,H]
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)                 # [B,N,H,E]
    d_num = gf / den[..., None]
    d_den = -torch.einsum("bnhe,bnhe->bnh", gf, num) / (den * den)
    d_phiq = (torch.einsum("bnhe,bhde->bnhd", d_num, kv)
              + d_den[..., None] * k_sum[:, None])
    d_kv = torch.einsum("bnhd,bnhe->bhde", qf, d_num)
    d_ksum = torch.einsum("bnhd,bnh->bhd", qf, d_den)
    d_phik = torch.einsum("bhde,bnhe->bnhd", d_kv, vf) + d_ksum[:, None]
    d_v = torch.einsum("bnhd,bhde->bnhe", kf, d_kv)
    d_q = d_phiq * elu_plus_one_grad(upcast(q))
    d_k = d_phik * elu_plus_one_grad(upcast(k))
    return d_q.to(q.dtype), d_k.to(k.dtype), d_v.to(v.dtype)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) linear attention, differentiable, through the hand-written CUDA
    kernels (forward and backward), which run their plain versions for
    tensors on the CPU and launch or raise for tensors on the card."""
    from .linear_attention_kernel import linear_attention_trainable
    return linear_attention_trainable(q, k, v, eps)


def _split_sums(sums: torch.Tensor, dim: int):
    """[B, H, D (D + 1)] → (the [B, H, D, D] matrix, the [B, H, D] vector)."""
    return (sums[..., :dim * dim].unflatten(-1, (dim, dim)), sums[..., dim * dim:])


def linear_attention_kv_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """φ(K)ᵀV and Σφ(K) over the tokens of k, v [B, N, H, D], in at least
    float32, as one [B, H, D (D + 1)] tensor (the matrix row-major, then
    the vector): the plain version of the ``kv`` entry of the token-sharded
    kernels (:mod:`.linear_attention_kernel`)."""
    kf = elu_plus_one(upcast(k))
    kv = torch.einsum("bnhd,bnhe->bhde", kf, upcast(v))
    return torch.cat([kv.flatten(2), kf.sum(dim=1)], dim=-1).contiguous()


def linear_attention_apply_plain(q: torch.Tensor, kvs: torch.Tensor,
                                 eps: float = 1e-6) -> torch.Tensor:
    """φ(Q)·kv / (φ(Q)·ksum + eps) from the reduced ``kvs`` of
    :func:`linear_attention_kv_plain`, in q's dtype: the plain version of
    the ``apply`` entry."""
    qf = elu_plus_one(upcast(q))
    kv, k_sum = _split_sums(kvs.to(qf.dtype), q.shape[-1])
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)
    den = torch.einsum("bnhd,bhd->bnh", qf, k_sum)
    return (num / (den[..., None] + eps)).to(q.dtype)


def linear_attention_bwd_partial_plain(q: torch.Tensor, g: torch.Tensor,
                                       kvs: torch.Tensor, eps: float = 1e-6):
    """(dq, d_kvs) for the upstream gradient ``g`` of this process's tokens
    from the reduced ``kvs``: dq in q's dtype, and d_kv = Σ φ(q)ᵀ d_num and
    d_ksum = Σ φ(q) d_den over these tokens in the layout of ``kvs``. The
    plain version of the ``bwd_partial`` entry (the arithmetic of
    :func:`linear_attention_backward_plain`)."""
    d = q.shape[-1]
    qf, gf = elu_plus_one(upcast(q)), upcast(g)
    kv, k_sum = _split_sums(kvs.to(qf.dtype), d)
    den = torch.einsum("bnhd,bhd->bnh", qf, k_sum) + eps
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)
    d_num = gf / den[..., None]
    d_den = -torch.einsum("bnhe,bnhe->bnh", gf, num) / (den * den)
    d_phiq = (torch.einsum("bnhe,bhde->bnhd", d_num, kv)
              + d_den[..., None] * k_sum[:, None])
    d_kv = torch.einsum("bnhd,bnhe->bhde", qf, d_num)
    d_ksum = torch.einsum("bnhd,bnh->bhd", qf, d_den)
    dq = (d_phiq * elu_plus_one_grad(upcast(q))).to(q.dtype)
    return dq, torch.cat([d_kv.flatten(2), d_ksum], dim=-1).contiguous()


def linear_attention_bwd_finish_plain(k: torch.Tensor, v: torch.Tensor,
                                      dkvs: torch.Tensor):
    """(dk, dv) of this process's tokens from the reduced ``dkvs``, each in
    its input's dtype: the plain version of the ``bwd_finish`` entry."""
    kf, vf = elu_plus_one(upcast(k)), upcast(v)
    d_kv, d_ksum = _split_sums(dkvs.to(kf.dtype), k.shape[-1])
    d_phik = torch.einsum("bhde,bnhe->bnhd", d_kv, vf) + d_ksum[:, None]
    d_v = torch.einsum("bnhd,bhde->bnhe", kf, d_kv)
    return ((d_phik * elu_plus_one_grad(upcast(k))).to(k.dtype),
            d_v.to(v.dtype))


def linear_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mesh, axis: str = "spatial",
                             eps: float = 1e-6) -> torch.Tensor:
    """Token-sharded linear attention over a process group (JAX
    ``linear_attention_sharded``, ``ops/attention.py:100-136``),
    differentiable.

    ``q``, ``k``, ``v`` are this process's tokens [B, N/n, H, D] of a
    sequence split over the ``n`` ranks of ``mesh``'s ``axis`` (a
    ``parallel.Mesh``; or a ``parallel.mesh.SpatialShard``, whose group is
    taken): rank i holds tokens [i·N/n, (i+1)·N/n). Each process forms
    φ(K)ᵀV [B, H, D, D] and Σφ(K) [B, H, D] over its tokens in float32, one
    ``all_reduce`` sums them over the group, and each process applies them
    to its own rows of φ(Q): the output is its tokens of the whole
    sequence's linear attention, in q's dtype. The backward forms dq and
    its tokens' share of d_kv and d_ksum, sums those over the group, and
    forms dk and dv. All four steps run through the hand-written kernels
    (:class:`.linear_attention_kernel.LinearAttentionShardedFunction`),
    whose plain versions are above."""
    from ..parallel.mesh import SpatialShard
    from .linear_attention_kernel import linear_attention_sharded_trainable

    group = mesh.group if isinstance(mesh, SpatialShard) else mesh.group(axis)
    return linear_attention_sharded_trainable(q, k, v, group, eps)


def _round_like(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """p rounded to ``like``'s dtype where that is narrower (bf16), kept in
    p's dtype: the stock flash kernel's ``p.astype(v.dtype)`` before a
    product."""
    if like.dtype.itemsize >= p.dtype.itemsize:
        return p
    return p.to(like.dtype).to(p.dtype)


def softmax_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, return_lse: bool = False):
    """softmax(q·kᵀ·scale)·v, accumulated in at least float32; the output has
    q's dtype. Counterpart of JAX ``standard_attention``
    (``cv_diffusion_tpu/ops/attention.py:81-97``) and the plain version of
    the flash forward kernel in :mod:`.flash_attention_kernel`.

    In bf16 it follows the stock Pallas flash kernel's rounding: the
    unnormalised probabilities are rounded to v's dtype before P·V
    (``flash_attention.py:471``); the row sums are taken before that
    rounding. With ``return_lse`` it also returns each row's log-sum-exp
    [B, H, N] (float32, float64 for float64 inputs), which the backward
    recomputes P from.

    q, k, v: [B, N, H, D]. Returns [B, N, H, D] (and lse).
    """
    qf, kf, vf = upcast(q), upcast(k), upcast(v)
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                           # [B, H, N, 1]
    o = torch.einsum("bhnm,bmhd->bnhd", _round_like(p, v), vf)
    out = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o ∘ dO in at least float32, [B, H, N]: the one row reduction
    the stock VJP computes in XLA between its kernels
    (``flash_attention.py:272-275``)."""
    return (upcast(o) * upcast(do)).sum(dim=-1).transpose(1, 2).contiguous()


def softmax_attention_backward_rows(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, do: torch.Tensor,
                                    lse: torch.Tensor, di: torch.Tensor,
                                    scale: float):
    """(dq, dk, dv) of :func:`softmax_attention_plain` for the upstream
    gradient ``do``, in closed form from the rows' log-sum-exp ``lse`` and
    ``di`` = :func:`row_dot` (o, do), both [B, H, N]: P = exp(q·kᵀ·scale −
    lse), dV = Pᵀ·dO, dS = P ∘ (dO·Vᵀ − di)·scale, dQ = dS·K, dK = dSᵀ·Q.
    Each result has its input's dtype. The plain version of the dK/dV and dQ
    kernels, which take the same inputs; the counterpart of the stock flash
    kernel's VJP (``flash_attention.py:256-322``), with its bf16 roundings:
    P and dS are rounded to dO's (k's) dtype before their products
    (``:900``, ``:918``, ``:1258``)."""
    qf, kf, vf, dof = upcast(q), upcast(k), upcast(v), upcast(do)
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", _round_like(p, do), dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = (dp - di.to(s.dtype)[..., None]) * p * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", _round_like(ds, k), kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", _round_like(ds, do), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """O(N²) softmax attention, differentiable, through the hand-written
    flash-attention kernels (a forward, a dK/dV and a dQ backward), which run
    their plain versions for tensors on the CPU and launch or raise for
    tensors on the card."""
    from .flash_attention_kernel import softmax_attention_trainable
    return softmax_attention_trainable(q, k, v, scale)
