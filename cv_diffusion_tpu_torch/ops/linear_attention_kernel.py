"""Wrappers of the hand-written CUDA linear-attention kernels.

The kernels (``csrc/linear_attention.cu``) replace the TPU kernel
``linear_attention_pallas`` (``cv_diffusion_tpu/ops/pallas_attention.py:82``)
and the backward of its trainable form ``linear_attention_pallas_trainable``
(``:180``, ``_trainable_bwd`` ``:202-236``). They are built from the
package's own sources with one ``nvcc`` call into a shared library with a
plain C interface, loaded through ``ctypes``, at first use
(:mod:`.cuda_build`).

:func:`linear_attention_kernel` (forward) and
:func:`linear_attention_backward_kernel` launch them for CUDA tensors and
count each launch in their ``launches``. For tensors on the CPU they run the
plain versions (:mod:`.attention`); for CUDA tensors they launch the kernel
or raise. :class:`LinearAttentionFunction` pairs the two as one
``torch.autograd.Function``, as the JAX ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .attention import (linear_attention_backward_plain,
                        linear_attention_plain)

SOURCE = cuda_build.source("linear_attention.cu")
HEAD_DIMS = (32, 64, 128)

# Reduce pass: aim for two blocks per SM of an H100 (132 SMs), with at least
# this many tokens in a chunk.
_TARGET_BLOCKS = 264
_MIN_CHUNK = 64


def build() -> cuda_build.Built:
    """Compile the kernel library unless this source and these flags were
    built before; returns where it is."""
    return cuda_build.build(SOURCE)


def _declare(lib) -> None:
    ptr = ctypes.c_void_p
    for name in ("linear_attention_f32", "linear_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    for name in ("linear_attention_bwd_f32", "linear_attention_bwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    lib.linear_attention_error_string.argtypes = [ctypes.c_int]
    lib.linear_attention_error_string.restype = ctypes.c_char_p


def reduce_chunks(batch: int, tokens: int, heads: int) -> tuple:
    """(S, chunk): how many blocks the reduce pass splits N into, and the
    tokens each takes. A function of the shape alone, so reruns sum the
    partials in the same order."""
    s = max(1, min(math.ceil(tokens / _MIN_CHUNK),
                   math.ceil(_TARGET_BLOCKS / (batch * heads))))
    chunk = math.ceil(tokens / s)
    return math.ceil(tokens / chunk), chunk


def _check(*ts: torch.Tensor) -> None:
    """q, k, v (and g for the backward): one shape, dtype and device."""
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError("q, k, v (and g) must all be [B, N, H, D] of one "
                         f"shape; got {[tuple(t.shape) for t in ts]}")
    if (any(t.dtype != q.dtype for t in ts)
            or q.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError("the kernel takes q, k, v (and g) all float32 or all "
                        f"bfloat16; got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v (and g) must lie on one device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous q, k, v (and g)")
    if q.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.linear_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def linear_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """Linear attention through the CUDA kernel; q, k, v [B, N, H, D], f32 or
    bf16, contiguous. Returns [B, N, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, eps)
    if q.device.type != "cuda":
        raise ValueError(f"no linear-attention kernel for device {q.device}")
    _check(q, k, v)
    b, n, h, d = q.shape
    s, chunk = reduce_chunks(b, n, h)
    lib = cuda_build.load(SOURCE, _declare)
    out = torch.empty_like(q)
    scratch = torch.empty((b, h, s, d, d + 1), dtype=torch.float32,
                          device=q.device)
    fn = (lib.linear_attention_f32 if q.dtype == torch.float32
          else lib.linear_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, n, h, d, s, chunk, float(eps), stream)
    _raise_on(lib, err, "linear-attention")
    linear_attention_kernel.launches += 1
    return out


linear_attention_kernel.launches = 0


def linear_attention_backward_kernel(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, g: torch.Tensor,
                                     eps: float = 1e-6):
    """(dq, dk, dv) of linear attention for the upstream gradient ``g``
    through the CUDA backward kernel; q, k, v, g [B, N, H, D], all f32 or all
    bf16, contiguous. Each result has its input's dtype."""
    if q.device.type == "cpu":
        return linear_attention_backward_plain(q, k, v, g, eps)
    if q.device.type != "cuda":
        raise ValueError(f"no linear-attention kernel for device {q.device}")
    _check(q, k, v, g)
    b, n, h, d = q.shape
    s, chunk = reduce_chunks(b, n, h)
    lib = cuda_build.load(SOURCE, _declare)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # the reduce's partials (then d_kv's), kv and d_kv, each [D, D+1] a head
    scratch = torch.empty((b * h * (s + 2), d, d + 1), dtype=torch.float32,
                          device=q.device)
    fn = (lib.linear_attention_bwd_f32 if q.dtype == torch.float32
          else lib.linear_attention_bwd_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, g, dq, dk, dv, scratch)),
                 b, n, h, d, s, chunk, float(eps), stream)
    _raise_on(lib, err, "linear-attention backward")
    linear_attention_backward_kernel.launches += 1
    return dq, dk, dv


linear_attention_backward_kernel.launches = 0


class LinearAttentionFunction(torch.autograd.Function):
    """Linear attention whose forward is :func:`linear_attention_kernel` and
    whose backward is :func:`linear_attention_backward_kernel`; it saves q,
    k, v and recomputes the rest, as the JAX ``custom_vjp`` does
    (``pallas_attention.py:179-239``)."""

    @staticmethod
    def forward(ctx, q, k, v, eps):
        ctx.save_for_backward(q, k, v)
        ctx.eps = eps
        return linear_attention_kernel(q, k, v, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = linear_attention_backward_kernel(q, k, v, g.contiguous(),
                                                      ctx.eps)
        return dq, dk, dv, None


def linear_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, eps: float = 1e-6
                               ) -> torch.Tensor:
    """Differentiable linear attention through both kernels."""
    return LinearAttentionFunction.apply(q, k, v, eps)
