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

The token-sharded entries (a sequence split over a process group, as a
spatially sharded UNet splits its tokens) stop each reduction at device
memory, so that the group's ``all_reduce`` can run between two launches:
:func:`linear_attention_kv_kernel` (φ(K)ᵀV and Σφ(K) over this process's
tokens), :func:`linear_attention_apply_kernel` (the output from the reduced
sums), :func:`linear_attention_bwd_partial_kernel` (dq, and this process's
d_kv and d_ksum) and :func:`linear_attention_bwd_finish_kernel` (dk and dv
from the reduced ones). :class:`LinearAttentionShardedFunction` runs kv →
all_reduce → apply, and partial → all_reduce → finish in the backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

import torch.distributed as dist

from . import cuda_build
from .attention import (linear_attention_apply_plain,
                        linear_attention_backward_plain,
                        linear_attention_bwd_finish_plain,
                        linear_attention_bwd_partial_plain,
                        linear_attention_kv_plain, linear_attention_plain)

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
# the token-sharded entries, and whether each takes the backward's plan
SHARDED_ENTRIES = ("kv", "apply", "bwd_partial", "bwd_finish")
SHARDED_BACKWARD = {"kv": False, "apply": False, "bwd_partial": True,
                    "bwd_finish": True}


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
    for dt in ("f32", "bf16"):
        getattr(lib, f"linear_attention_kv_{dt}").argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        getattr(lib, f"linear_attention_apply_{dt}").argtypes = (
            [ptr] * 3 + [i32] * 6 + [ctypes.c_float, ptr])
        getattr(lib, f"linear_attention_bwd_partial_{dt}").argtypes = (
            [ptr] * 5 + [i32] * 6 + [ctypes.c_float, ptr])
        getattr(lib, f"linear_attention_bwd_finish_{dt}").argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        for entry in SHARDED_ENTRIES:
            getattr(lib, f"linear_attention_{entry}_{dt}").restype = i32
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


def _check_sums(sums: torch.Tensor, q: torch.Tensor) -> None:
    """The reduced sums of a token-sharded call: float32 [B, H, D (D + 1)],
    contiguous, on q's device."""
    b, _, h, d = q.shape
    if (sums.shape != (b, h, d * (d + 1)) or sums.dtype != torch.float32
            or sums.device != q.device or not sums.is_contiguous()):
        raise ValueError(f"the sums must be float32 [{b}, {h}, {d * (d + 1)}], "
                         f"contiguous, on {q.device}; got {sums.dtype} "
                         f"{tuple(sums.shape)} on {sums.device}")


def _launch_sharded(lib, stream, entry: str, tokens: torch.Tensor, inputs,
                    outputs, eps: Optional[float] = None) -> None:
    """One launch of a token-sharded entry on ``stream``, planned on
    ``tokens``' shape and dtype (no device check here)."""
    b, n, h, d = tokens.shape
    p = plan(b, n, h, d, tokens.dtype, backward=SHARDED_BACKWARD[entry])
    dt = "f32" if tokens.dtype == torch.float32 else "bf16"
    tail = ([] if eps is None else [float(eps)]) + [stream]
    err = getattr(lib, f"linear_attention_{entry}_{dt}")(
        *(t.data_ptr() for t in tuple(inputs) + tuple(outputs)),
        b, n, h, d, p.cluster, p.rows, *tail)
    if err != 0:
        raise RuntimeError(
            f"linear-attention {entry} kernel launch failed: "
            f"{lib.linear_attention_error_string(err).decode()} ({err}); "
            f"{p.cluster} blocks a (batch, head) of {p.rows} tokens each")


def _sharded_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no linear-attention kernel for device {t.device}")
    return True


def linear_attention_kv_kernel(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """φ(K)ᵀV and Σφ(K) over the tokens of k, v [B, N, H, D] (f32 or bf16,
    contiguous) through the ``kv`` entry: float32 [B, H, D (D + 1)]."""
    if not _sharded_device(k):
        return linear_attention_kv_plain(k, v)
    _check(k, v)
    b, _, h, d = k.shape
    kvs = torch.empty((b, h, d * (d + 1)), device=k.device, dtype=torch.float32)
    _on_device(k, _launch_sharded, "kv", k, (k, v), (kvs,))
    linear_attention_kv_kernel.launches += 1
    return kvs


linear_attention_kv_kernel.launches = 0


def linear_attention_apply_kernel(q: torch.Tensor, kvs: torch.Tensor,
                                  eps: float = 1e-6) -> torch.Tensor:
    """The output of q's tokens from the reduced sums ``kvs`` through the
    ``apply`` entry, in q's dtype."""
    if not _sharded_device(q):
        return linear_attention_apply_plain(q, kvs, eps)
    _check(q)
    _check_sums(kvs, q)
    out = torch.empty_like(q)
    _on_device(q, _launch_sharded, "apply", q, (q, kvs), (out,), eps)
    linear_attention_apply_kernel.launches += 1
    return out


linear_attention_apply_kernel.launches = 0


def linear_attention_bwd_partial_kernel(q: torch.Tensor, g: torch.Tensor,
                                        kvs: torch.Tensor, eps: float = 1e-6):
    """(dq, d_kvs): dq of q's tokens and their share of d_kv and d_ksum
    (float32 [B, H, D (D + 1)]) for the upstream gradient ``g``, from the
    reduced ``kvs``, through the ``bwd_partial`` entry."""
    if not _sharded_device(q):
        return linear_attention_bwd_partial_plain(q, g, kvs, eps)
    _check(q, g)
    _check_sums(kvs, q)
    dq = torch.empty_like(q)
    dkvs = torch.empty_like(kvs)
    _on_device(q, _launch_sharded, "bwd_partial", q, (q, g, kvs), (dq, dkvs), eps)
    linear_attention_bwd_partial_kernel.launches += 1
    return dq, dkvs


linear_attention_bwd_partial_kernel.launches = 0


def linear_attention_bwd_finish_kernel(k: torch.Tensor, v: torch.Tensor,
                                       dkvs: torch.Tensor):
    """(dk, dv) of k's tokens from the reduced ``dkvs`` through the
    ``bwd_finish`` entry, each in its input's dtype."""
    if not _sharded_device(k):
        return linear_attention_bwd_finish_plain(k, v, dkvs)
    _check(k, v)
    _check_sums(dkvs, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _on_device(k, _launch_sharded, "bwd_finish", k, (k, v, dkvs), (dk, dv))
    linear_attention_bwd_finish_kernel.launches += 1
    return dk, dv


linear_attention_bwd_finish_kernel.launches = 0


def sharded_launches() -> dict:
    """The token-sharded entries' launch counts, by entry."""
    return {f"linear_attention_{e}": globals()[f"linear_attention_{e}_kernel"].launches
            for e in SHARDED_ENTRIES}


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class LinearAttentionShardedFunction(torch.autograd.Function):
    """Token-sharded linear attention over a process group: the forward is
    :func:`linear_attention_kv_kernel`, an ``all_reduce`` of its sums over
    ``group`` and :func:`linear_attention_apply_kernel`; it saves q, k, v
    and the reduced sums. The backward is
    :func:`linear_attention_bwd_partial_kernel`, an ``all_reduce`` of
    d_kv and d_ksum, and :func:`linear_attention_bwd_finish_kernel`. Every
    process of the group calls it at the same point (the collectives)."""

    @staticmethod
    def forward(ctx, q, k, v, group, eps):
        q, k, v = (t.contiguous() for t in (q, k, v))
        kvs = _all_reduce(linear_attention_kv_kernel(k, v), group)
        ctx.save_for_backward(q, k, v, kvs)
        ctx.group, ctx.eps = group, eps
        return linear_attention_apply_kernel(q, kvs, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, kvs = ctx.saved_tensors
        dq, dkvs = linear_attention_bwd_partial_kernel(q, g.contiguous(), kvs, ctx.eps)
        dk, dv = linear_attention_bwd_finish_kernel(k, v, _all_reduce(dkvs, ctx.group))
        return dq, dk, dv, None, None


def linear_attention_sharded_trainable(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, group,
                                       eps: float = 1e-6) -> torch.Tensor:
    """Differentiable token-sharded linear attention over ``group`` (None:
    a group of one) through the four sharded entries."""
    return LinearAttentionShardedFunction.apply(q, k, v, group, eps)


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
