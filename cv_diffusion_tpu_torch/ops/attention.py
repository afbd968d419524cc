"""Linear attention over flattened spatial tokens, in plain PyTorch.

Counterpart of ``cv_diffusion_tpu/ops/attention.py``:

    out = φ(Q)·(φ(K)ᵀV) / (φ(Q)·Σφ(K) + eps),   φ = elu + 1

Token layout is the JAX package's ``[B, N, heads, dim]``.
:func:`linear_attention_plain` is the plain version of the hand-written CUDA
kernel in :mod:`.linear_attention_kernel`; the CPU tests hold it against the
JAX package, and ``chip_smoke.py`` holds the kernel against it on the card.
:func:`linear_attention` is what the model calls: the kernel's wrapper.
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


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) linear attention through the hand-written CUDA kernel, which
    runs its plain version for tensors on the CPU and launches or raises for
    tensors on the card."""
    from .linear_attention_kernel import linear_attention_kernel
    return linear_attention_kernel(q, k, v, eps)
