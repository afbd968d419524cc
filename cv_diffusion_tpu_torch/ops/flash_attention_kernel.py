"""Wrappers of the hand-written CUDA flash-attention kernels.

The kernels (``csrc/flash_attention.cu``) replace JAX's stock Pallas TPU
flash attention, which the JAX package reaches through
``standard_attention_flash`` (``cv_diffusion_tpu/ops/attention.py:139``):
its forward (``jax/experimental/pallas/ops/tpu/flash_attention.py:589``,
``pallas_call`` ``:758``), its dK/dV backward (``:941``, ``:1121``) and its
dQ backward (``:1287``, ``:1456``), tied together by a ``custom_vjp``
(``:204-322``). They are built from the package's own source with one
``nvcc`` call into a shared library with a plain C interface, loaded through
``ctypes``, at first use (:mod:`.cuda_build`).

:func:`flash_attention_forward`, :func:`flash_attention_backward_dkv` and
:func:`flash_attention_backward_dq` launch them for CUDA tensors and count
each launch in their ``launches``; they allocate only their outputs, on the
current stream, so the forward captures into the serving graphs. For
tensors on the CPU they run the plain versions (:mod:`.attention`); for
CUDA tensors they launch the kernel or raise. :class:`SoftmaxAttentionFunction`
pairs them as one ``torch.autograd.Function`` that saves q, k, v, the
output and the row log-sum-exp (never the [N, N] probabilities), as the
stock ``custom_vjp`` saves its residuals. Its backward runs the dQ kernel
first, which also forms the rows' di = Σ o ∘ dO (the stock VJP's one row
reduction between its kernels), then the dK/dV kernel on that di. All
three run on the tensor cores. Each kernel's launch (rows a block, warps on
each 16 rows, grid, shared memory) is planned by the library itself, by one
rule for the forward and the backward: :func:`plan`; the library's
``flash_fwd_planned`` and ``flash_bwd_planned`` launch under any plan it
takes (``scripts/torch_port_flash_ab.py --sweep`` times them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .attention import (row_dot, softmax_attention_backward_rows,
                        softmax_attention_plain)

SOURCE = cuda_build.source("flash_attention.cu")
HEAD_DIMS = (32, 64, 128)
KERNELS = ("forward", "dkv", "dq")   # the library's kernel index in its plan queries


class Plan(NamedTuple):
    """One kernel's launch as the library plans it (``flash_attention_plan``
    in the source, where the layout lives), the forward's as the
    backward's: rows of its own side a block (queries in the forward and
    dQ, keys in dK/dV), warps on each 16 of them (``split``), rows of a
    staged tile of the other side, warps a block, the grid and the dynamic
    shared memory."""
    rows: int
    split: int
    cols: int
    warps: int
    grid: tuple
    smem_bytes: int


def build() -> cuda_build.Built:
    """Compile the kernel library unless this source and these flags were
    built before; returns where it is."""
    return cuda_build.build(SOURCE)


def _declare(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("flash_fwd_f32", "flash_fwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [f32, ptr]
        fn.restype = i32
    for name in ("flash_bwd_dkv_f32", "flash_bwd_dkv_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        fn.restype = i32
    for name in ("flash_bwd_dq_f32", "flash_bwd_dq_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        fn.restype = i32
    lib.flash_fwd_planned.argtypes = [i32] * 3 + [ptr] * 5 + [i32] * 4 + [f32, ptr]
    lib.flash_fwd_planned.restype = i32
    lib.flash_bwd_planned.argtypes = [i32] * 4 + [ptr] * 9 + [i32] * 4 + [f32, ptr]
    lib.flash_bwd_planned.restype = i32
    lib.flash_attention_plan.argtypes = [i32] * 8 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_plan.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _check(*ts: torch.Tensor) -> None:
    """q, k, v (and dO, o): one shape, dtype and device, as the kernels take
    them."""
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError("q, k, v (and dO) must all be [B, N, H, D] of one "
                         f"shape; got {[tuple(t.shape) for t in ts]}")
    if (any(t.dtype != q.dtype for t in ts)
            or q.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError("the kernel takes q, k, v (and dO) all float32 or all "
                        f"bfloat16; got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v (and dO) must lie on one device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous q, k, v (and dO)")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel takes q, k, v (and dO) on 16-byte "
                         "boundaries (it loads 16 bytes at a time)")
    if q.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and di: float32 [B, H, N], contiguous, on q's device."""
    b, n, h, _ = q.shape
    for t in rows:
        if (tuple(t.shape) != (b, h, n) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"lse and di must be contiguous float32 {(b, h, n)} "
                             f"on {q.device}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def plan(lib, kernel: str, shape, dtype: torch.dtype, rows: int = 0,
         split: int = 0):
    """The library's :class:`Plan` of ``kernel`` (one of :data:`KERNELS`) at
    ``shape`` [B, N, H, D] in ``dtype``; ``rows`` and ``split`` 0 for its
    default, else that launch. None where the kernel does not take it."""
    b, n, h, d = shape
    out = (ctypes.c_int * 8)()
    if lib.flash_attention_plan(KERNELS.index(kernel), b, n, h, d,
                                int(dtype == torch.bfloat16), rows, split, out):
        return None
    return Plan(out[0], out[1], out[2], out[3], (out[4], out[5], out[6]), out[7])


def _raise_on(lib, err: int, kernel: str, q: torch.Tensor) -> None:
    """Raise the library's error of a launch, with the plan the source chose
    for it."""
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash-attention {kernel} kernel launch failed: {msg} "
                           f"({err}); {plan(lib, kernel, q.shape, q.dtype)}")


def _entry(lib, name: str, dtype: torch.dtype):
    return getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")


def _on_device(q: torch.Tensor, launch, *args):
    """Run ``launch(lib, stream, *args)`` with q's device current, on its
    current stream."""
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(q.device):
        return launch(lib, torch.cuda.current_stream(q.device).cuda_stream, *args)


def _launch_forward(lib, stream, q, k, v, scale: float, with_lse: bool):
    b, n, h, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _entry(lib, "flash_fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n, h, d, float(scale), stream)
    _raise_on(lib, err, "forward", q)
    return out, lse


def _launch_dkv(lib, stream, q, k, v, do, lse, di, scale: float):
    b, n, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _entry(lib, "flash_bwd_dkv", q.dtype)(
        *(t.data_ptr() for t in (q, k, v, do, lse, di, dk, dv)),
        b, n, h, d, float(scale), stream)
    _raise_on(lib, err, "dkv", q)
    return dk, dv


def _launch_dq(lib, stream, q, k, v, do, lse, out, scale: float):
    b, n, h, d = q.shape
    dq = torch.empty_like(q)
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _entry(lib, "flash_bwd_dq", q.dtype)(
        *(t.data_ptr() for t in (q, k, v, do, out, lse, di, dq)),
        b, n, h, d, float(scale), stream)
    _raise_on(lib, err, "dq", q)
    return dq, di


def _device(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, with_lse: bool = False):
    """(out, lse): softmax attention through the forward kernel; q, k, v
    [B, N, H, D], all f32 or all bf16, contiguous. ``out`` has q's dtype;
    ``lse`` is each row's float32 log-sum-exp [B, H, N] when ``with_lse``,
    else None (and not computed)."""
    if q.device.type == "cpu":
        out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
        return out, (lse if with_lse else None)
    _device(q)
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"the forward kernel takes scale > 0; got {scale}")
    res = _on_device(q, _launch_forward, q, k, v, scale, with_lse)
    flash_attention_forward.launches += 1
    return res


flash_attention_forward.launches = 0


def flash_attention_backward_dkv(q, k, v, do, lse, di, scale: float):
    """(dk, dv) through the dK/dV kernel, from q, k, v, dO [B, N, H, D] and
    the rows' lse and di = :func:`~.attention.row_dot` (o, dO) (float32
    [B, H, N])."""
    if q.device.type == "cpu":
        return softmax_attention_backward_rows(q, k, v, do, lse, di, scale)[1:]
    _device(q)
    _check(q, k, v, do)
    _check_rows(q, lse, di)
    grads = _on_device(q, _launch_dkv, q, k, v, do, lse, di, scale)
    flash_attention_backward_dkv.launches += 1
    return grads


flash_attention_backward_dkv.launches = 0


def flash_attention_backward_dq(q, k, v, do, lse, out, scale: float):
    """(dq, di) through the dQ kernel, from q, k, v, dO, the forward's
    output ``out`` [B, N, H, D] and the rows' lse: the kernel also forms
    di = :func:`~.attention.row_dot` (out, dO) (float32 [B, H, N]), which
    the dK/dV kernel takes next."""
    if q.device.type == "cpu":
        di = row_dot(out, do)
        return softmax_attention_backward_rows(q, k, v, do, lse, di, scale)[0], di
    _device(q)
    _check(q, k, v, do, out)
    _check_rows(q, lse)
    grads = _on_device(q, _launch_dq, q, k, v, do, lse, out, scale)
    flash_attention_backward_dq.launches += 1
    return grads


flash_attention_backward_dq.launches = 0


class SoftmaxAttentionFunction(torch.autograd.Function):
    """Softmax attention whose forward is :func:`flash_attention_forward`
    and whose backward is :func:`flash_attention_backward_dq` (which also
    forms di) then :func:`flash_attention_backward_dkv`; it saves q, k, v,
    the output and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, di = flash_attention_backward_dq(q, k, v, do, lse, out, ctx.scale)
        dk, dv = flash_attention_backward_dkv(q, k, v, do, lse, di, ctx.scale)
        return dq, dk, dv, None


def softmax_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: float) -> torch.Tensor:
    """Differentiable softmax attention through the three kernels. Without a
    gradient to record it is the forward kernel alone, which then computes
    no lse."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_forward(q, k, v, scale)[0]
    return SoftmaxAttentionFunction.apply(q, k, v, scale)
