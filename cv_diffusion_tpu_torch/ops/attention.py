"""Linear attention over flattened spatial tokens, in plain PyTorch.

Counterpart of ``cv_diffusion_tpu/ops/attention.py``:

    out = φ(Q)·(φ(K)ᵀV) / (φ(Q)·Σφ(K) + eps),   φ = elu + 1

Token layout is the JAX package's ``[B, N, heads, dim]``.
:func:`linear_attention_plain` and :func:`linear_attention_backward_plain`
are the plain versions of the hand-written CUDA kernels in
:mod:`.linear_attention_kernel`; the CPU tests hold them against the JAX
package, and ``chip_smoke.py`` holds the kernels against them on the card.
:func:`linear_attention` is what the model calls: the kernels' autograd
function.
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
