"""Wrapper of the hand-written CUDA linear-attention kernel.

The kernel (``csrc/linear_attention.cu``) replaces the TPU kernel
``linear_attention_pallas`` (``cv_diffusion_tpu/ops/pallas_attention.py:82``).
It is built from the package's own sources with one ``nvcc`` call into a
shared library with a plain C interface, loaded through ``ctypes``, at first
use (:mod:`.cuda_build`).

:func:`linear_attention_kernel` launches it for CUDA tensors and counts each
launch in ``linear_attention_kernel.launches``. For tensors on the CPU it
runs the plain version (:func:`.attention.linear_attention_plain`); for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .attention import linear_attention_plain

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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must all be [B, N, H, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                              torch.bfloat16):
        raise TypeError("the kernel takes q, k, v all float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    if q.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")


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
    if err != 0:
        msg = lib.linear_attention_error_string(err).decode()
        raise RuntimeError(f"linear-attention kernel launch failed: {msg} ({err})")
    linear_attention_kernel.launches += 1
    return out


linear_attention_kernel.launches = 0
