"""Wrappers of the hand-written int8 convolution kernels.

The kernels (``csrc/qconv.cu``) replace XLA's int8 ``conv_general_dilated``
with int32 accumulation that the JAX package's ``QConv`` runs on its int8
path (``cv_diffusion_tpu/ops/qconv.py:104-110, 174``); there is no Pallas
kernel of it, and PyTorch's convolutions take no int8 on the card. Three
entries, each with a float32 and a bfloat16 instance:

* :func:`quantize`: x [N, C, H, W] → int8 [N, H, W, Cp] (pixel-major, the
  channels padded with zeros to a multiple of 4), transposed in the same
  pass;
* :func:`int8_conv`: the dense 1×1 and 3×3 convolutions, stride 1 or 2;
* :func:`int8_depthwise`: the 3×3 depthwise convolution, stride 1 or 2;

both convolutions sum int8 × int8 exactly in int32 and apply the dequant
and bias in their epilogue, writing NCHW in the compute dtype. They are
built from the package's own source with one ``nvcc`` call and loaded
through ``ctypes`` at first use (:mod:`.cuda_build`). Each wrapper runs the
plain version (:mod:`.qconv`) for CPU tensors; for CUDA tensors it launches
its kernel, counted in its ``launches``, or raises. All three equal their
plain versions bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .qconv import (int8_conv_plain, int8_depthwise_plain, padded_channels,
                    quantize_plain)

SOURCE = cuda_build.source("qconv.cu")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def build() -> cuda_build.Built:
    """Compile the kernel library unless this source and these flags were
    built before; returns where it is."""
    return cuda_build.build(SOURCE)


def _declare(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPES.values():
        fn = getattr(lib, f"qconv_quantize_{dt}")   # x, amax, out, N, C, HW, Cp, stream
        fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        fn.restype = i32
        # xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH, OW, stream
        fn = getattr(lib, f"qconv_dense_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * 10 + [ptr]
        fn.restype = i32
        # xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW, stream
        fn = getattr(lib, f"qconv_depthwise_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        fn.restype = i32
    lib.qconv_error_string.argtypes = [i32]
    lib.qconv_error_string.restype = ctypes.c_char_p


def _lib():
    return cuda_build.load(SOURCE, _declare)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.qconv_error_string(err).decode()} ({err})")


def _check_cuda(what: str, *ts: Optional[torch.Tensor]) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    for t in ts:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{what}: the kernel takes fewer than 2**31 elements")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _amax(amax_eff: torch.Tensor) -> torch.Tensor:
    if amax_eff.dtype != torch.float32 or amax_eff.numel() != 1:
        raise TypeError("amax_eff: one float32 value on the device")
    return amax_eff.contiguous()


def quantize(x: torch.Tensor, amax_eff: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W], float32 or bfloat16 → int8 [N, H, W, Cp],
    ``clip(round(x / s_x), -127, 127)`` with ``s_x`` from the device scalar
    ``amax_eff`` (:func:`.qconv.act_scale`)."""
    if x.device.type == "cpu":
        return quantize_plain(x, amax_eff)
    dev = _check_cuda("quantize", x, amax_eff)
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"quantize takes float32 or bfloat16 NCHW, not {x.dtype} "
                        f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    out = torch.empty((n, h, w, padded_channels(c)), dtype=torch.int8, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, f"qconv_quantize_{_DTYPES[x.dtype]}")(
            x.data_ptr(), _amax(amax_eff).data_ptr(), out.data_ptr(),
            n, c, h * w, out.shape[-1], _stream(dev))
    _raise_on(lib, err, "int8 quantize")
    quantize.launches += 1
    return out


quantize.launches = 0


def _epilogue_args(what, out_dtype, s_w, bias, channels):
    if out_dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel writes float32 or bfloat16, not {out_dtype}")
    if s_w.dtype != torch.float32 or s_w.shape != (channels,):
        raise ValueError(f"{what}: s_w must be float32 [{channels}]")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (channels,)):
        raise ValueError(f"{what}: bias must be {out_dtype} [{channels}]")


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, amax_eff: torch.Tensor,
              s_w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
              padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The dense int8 convolution: xq int8 [N, H, W, Cp], wq int8 [O, K, K,
    Cp] (K 1 or 3), the activation's amax on the device, s_w float32 [O],
    bias [O] in ``out_dtype`` or None → [N, O, OH, OW] in ``out_dtype``
    (:func:`.qconv.int8_conv_plain`)."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, amax_eff, s_w, bias, stride, padding, out_dtype)
    dev = _check_cuda("int8_conv", xq, wq, amax_eff, s_w, bias)
    o, k, k2, cp = wq.shape
    n, h, w, cpx = xq.shape
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("int8_conv takes int8 activations and weights")
    if k != k2 or k not in (1, 3) or cp != cpx or cp % 4 or stride not in (1, 2):
        raise ValueError(f"int8_conv: weights {tuple(wq.shape)} and activations "
                         f"{tuple(xq.shape)}, stride {stride}")
    _epilogue_args("int8_conv", out_dtype, s_w, bias, o)
    oh = (h + 2 * padding - k) // stride + 1
    ow = (w + 2 * padding - k) // stride + 1
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, f"qconv_dense_{_DTYPES[out_dtype]}")(
            xq.data_ptr(), wq.data_ptr(), _amax(amax_eff).data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, h, w, cp, o, k, stride, padding, oh, ow, _stream(dev))
    _raise_on(lib, err, "int8 dense convolution")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def int8_depthwise(xq: torch.Tensor, wq: torch.Tensor, channels: int,
                   amax_eff: torch.Tensor, s_w: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The 3×3 depthwise int8 convolution, padding 1: xq int8 [N, H, W, Cp],
    wq int8 [9, Cp] → [N, channels, OH, OW] in ``out_dtype``
    (:func:`.qconv.int8_depthwise_plain`)."""
    if xq.device.type == "cpu":
        return int8_depthwise_plain(xq, wq, channels, amax_eff, s_w, bias, stride,
                                    out_dtype)
    dev = _check_cuda("int8_depthwise", xq, wq, amax_eff, s_w, bias)
    n, h, w, cp = xq.shape
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("int8_depthwise takes int8 activations and weights")
    if wq.shape != (9, cp) or cp % 4 or channels > cp or stride not in (1, 2):
        raise ValueError(f"int8_depthwise: weights {tuple(wq.shape)}, activations "
                         f"{tuple(xq.shape)}, {channels} channels, stride {stride}")
    _epilogue_args("int8_depthwise", out_dtype, s_w, bias, channels)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((n, channels, oh, ow), dtype=out_dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, f"qconv_depthwise_{_DTYPES[out_dtype]}")(
            xq.data_ptr(), wq.data_ptr(), _amax(amax_eff).data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, h, w, channels, cp, stride, oh, ow, _stream(dev))
    _raise_on(lib, err, "int8 depthwise convolution")
    int8_depthwise.launches += 1
    return out


int8_depthwise.launches = 0
