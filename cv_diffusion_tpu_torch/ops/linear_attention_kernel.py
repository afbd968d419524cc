"""Wrappers of the hand-written CUDA linear-attention kernels.

The kernels (``csrc/linear_attention.cu``) replace the TPU kernel
``linear_attention_pallas`` (``cv_diffusion_tpu/ops/pallas_attention.py:82``)
and the backward of its trainable form ``linear_attention_pallas_trainable``
(``:180``, ``_trainable_bwd`` ``:202-236``). Each is one launch: the blocks of
one (batch, head) form a thread-block cluster that reduces kv over all tokens
in distributed shared memory (:func:`plan` sizes it). They are built from the
package's own sources with one ``nvcc`` call into a shared library with a
plain C interface, loaded through ``ctypes``, at first use
(:mod:`.cuda_build`).

:func:`linear_attention_kernel` (forward) and
:func:`linear_attention_backward_kernel` launch them for CUDA tensors and
count each launch in their ``launches``; they allocate only their outputs.
For tensors on the CPU they run the plain versions (:mod:`.attention`); for
CUDA tensors they launch the kernel or raise. :class:`LinearAttentionFunction`
pairs the two as one ``torch.autograd.Function``, as the JAX ``custom_vjp``
does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build
from .attention import (linear_attention_backward_plain,
                        linear_attention_plain)

SOURCE = cuda_build.source("linear_attention.cu")
HEAD_DIMS = (32, 64, 128)

# Mirrors of the source's constants (tests/test_torch_port_attention.py reads
# them there): threads a block, floats after each staged row, the largest
# cluster a launch takes, the mbarriers' room, and the rows of a staged tile
# by head dim, (forward, backward), with the short tile that ranks of at most
# that many tokens take (``Tiles<D>``).
THREADS = 256
PAD = 4
KERNEL_MAX_CLUSTER = 16
BARRIER_FLOATS = 8
TILE_ROWS = {32: (128, 128), 64: (64, 64), 128: (32, 16)}
SHORT_ROWS = {32: 64}
SMEM_LIMIT = 232_448       # bytes of shared memory a block can have (H100)
# C, the blocks of a cluster: a power of two, small enough that each rank
# keeps at least MIN_ROWS tokens, and at most the portable 8 -- or the
# non-portable 16 where the whole grid still has one block per SM of the
# H100 (SMS): a small grid is bound by each rank's serial work, which 16
# ranks halve, a full one by the SMs. A rank's tokens are a multiple of 8, so
# that on a full rank the 4 token groups of the kv reduction at D = 32 take
# equal shares; the last rank takes the rest.
MAX_CLUSTER = 8
SMS = 132
MIN_ROWS = 32
ROW_MULTIPLE = 8


class Plan(NamedTuple):
    cluster: int      # C: blocks of a cluster, one cluster per (batch, head)
    rows: int         # tokens of a rank: rank r takes [r·rows, (r+1)·rows) ∩ [0, N)
    tile_rows: int    # rows of q, k, v (and g) staged in shared memory at a time
    smem_bytes: int   # dynamic shared memory of a block
    blocks: int       # the grid: B·H·C


def tile_rows(dim: int, rows: int, backward: bool) -> int:
    """The rows of the tiles a rank of ``rows`` tokens is staged in."""
    short = SHORT_ROWS.get(dim, 0)
    return short if rows <= short else TILE_ROWS[dim][backward]


def smem_bytes(dim: int, tile: int, backward: bool) -> int:
    """Dynamic shared memory of one block with tiles of ``tile`` rows, as the
    source lays it out: two mbarriers, the staged tiles (forward φ(k), v,
    φ(q); backward also g, and d_den), what the ranks push to this one (a
    [D, D+1] buffer and room for uneven slices), the reduced [D, D+1]
    buffer, and in the backward its transpose."""
    kv = dim * (dim + 1)
    recv = kv + 4 * KERNEL_MAX_CLUSTER
    if not backward:
        return 4 * (BARRIER_FLOATS + 3 * tile * (dim + PAD) + recv + kv)
    return 4 * (BARRIER_FLOATS + 4 * tile * (dim + PAD) + tile + recv + kv
                + dim * dim)


@functools.lru_cache(maxsize=None)
def plan(batch: int, tokens: int, heads: int, dim: int, dtype: torch.dtype,
         backward: bool = False) -> Plan:
    """How a call of this shape is launched. A pure function of the shape:
    reruns sum the partials in the same order."""
    if dim not in HEAD_DIMS:
        raise ValueError(f"head dim {dim} not in {HEAD_DIMS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if min(batch, tokens, heads) < 1:
        raise ValueError(f"empty shape {(batch, tokens, heads, dim)}")
    c = 1
    while (tokens >= 2 * c * MIN_ROWS
           and (c < MAX_CLUSTER
                or (c < KERNEL_MAX_CLUSTER and batch * heads * 2 * c <= SMS))):
        c *= 2
    rows = ROW_MULTIPLE * math.ceil(math.ceil(tokens / c) / ROW_MULTIPLE)
    tile = tile_rows(dim, rows, backward)
    return Plan(c, rows, tile, smem_bytes(dim, tile, backward),
                batch * heads * c)


def build() -> cuda_build.Built:
    """Compile the kernel library unless this source and these flags were
    built before; returns where it is."""
    return cuda_build.build(SOURCE)


def _declare(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("linear_attention_f32", "linear_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
        fn.restype = i32
    for name in ("linear_attention_bwd_f32", "linear_attention_bwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ctypes.c_float, ptr]
        fn.restype = i32
    lib.linear_attention_smem_bytes.argtypes = [i32, i32, i32]
    lib.linear_attention_smem_bytes.restype = i32
    lib.linear_attention_error_string.argtypes = [i32]
    lib.linear_attention_error_string.restype = ctypes.c_char_p


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
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel takes q, k, v (and g) on 16-byte "
                         "boundaries (it loads 16 bytes at a time)")
    if q.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")


def _raise_on(lib, err: int, what: str, p: Plan) -> None:
    if err != 0:
        msg = lib.linear_attention_error_string(err).decode()
        raise RuntimeError(
            f"{what} kernel launch failed: {msg} ({err}); clusters of "
            f"{p.cluster} blocks with {p.smem_bytes} bytes of shared memory each")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_forward(lib, stream, q, k, v, eps: float):
    """One launch of the forward kernel on ``stream`` for q, k, v as they
    are (no device check here); returns the output, the one allocation."""
    b, n, h, d = q.shape
    p = plan(b, n, h, d, q.dtype)
    out = torch.empty_like(q)
    fn = (lib.linear_attention_f32 if q.dtype == torch.float32
          else lib.linear_attention_bf16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, n, h, d, p.cluster, p.rows, float(eps), stream)
    _raise_on(lib, err, "linear-attention", p)
    return out


def _launch_backward(lib, stream, q, k, v, g, eps: float):
    """One launch of the backward kernel; returns (dq, dk, dv), its only
    allocations."""
    b, n, h, d = q.shape
    p = plan(b, n, h, d, q.dtype, backward=True)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    fn = (lib.linear_attention_bwd_f32 if q.dtype == torch.float32
          else lib.linear_attention_bwd_bf16)
    err = fn(*(t.data_ptr() for t in (q, k, v, g) + grads),
             b, n, h, d, p.cluster, p.rows, float(eps), stream)
    _raise_on(lib, err, "linear-attention backward", p)
    return grads


def _on_device(q: torch.Tensor, launch, *args):
    """Run ``launch(lib, stream, *args)`` with q's device current."""
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(q.device):
        return launch(lib, _stream(q.device), *args)


def linear_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """Linear attention through the CUDA kernel; q, k, v [B, N, H, D], f32 or
    bf16, contiguous. Returns [B, N, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, eps)
    if q.device.type != "cuda":
        raise ValueError(f"no linear-attention kernel for device {q.device}")
    _check(q, k, v)
    out = _on_device(q, _launch_forward, q, k, v, eps)
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
    grads = _on_device(q, _launch_backward, q, k, v, g, eps)
    linear_attention_backward_kernel.launches += 1
    return grads


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
