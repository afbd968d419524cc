"""Wrappers of the hand-written int8 convolution kernels.

The kernels (``csrc/qconv.cu``) replace XLA's int8 ``conv_general_dilated``
with int32 accumulation that the JAX package's ``QConv`` runs on its int8
path (``cv_diffusion_tpu/ops/qconv.py:104-110, 174``); there is no Pallas
kernel of it, and PyTorch's convolutions take no int8 on the card. Four
entries, each with a float32 and a bfloat16 instance but the first:

* :func:`quantize_weight`: a conv weight → its int8 values in the layout
  the convolution reads and the per-channel scales, in one launch
  (``cv_diffusion_tpu/ops/qconv.py:169-172`` and the port's layout);
* :func:`quantize`: x [N, C, H, W] → int8 [N, H, W, Cp] (pixel-major, the
  channels padded with zeros to a multiple of 32), transposed in registers
  in the same pass (:func:`quantize_launch`);
* :func:`int8_conv`: the dense 1×1 and 3×3 convolutions, stride 1 or 2, an
  implicit GEMM on the tensor cores, tiled per shape by :func:`plan_dense`;
* :func:`int8_depthwise`: the 3×3 depthwise convolution, stride 1 or 2, in
  bands of output rows staged in shared memory (:func:`plan_depthwise`);

both convolutions sum int8 × int8 exactly in int32 and apply the dequant
and bias in their epilogue, writing NCHW in the compute dtype. They are
built from the package's own source with one ``nvcc`` call and loaded
through ``ctypes`` at first use (:mod:`.cuda_build`). Each wrapper runs the
plain version (:mod:`.qconv`) for CPU tensors; for CUDA tensors it launches
its kernel, counted in its ``launches``, or raises. All four equal their
plain versions bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .qconv import (CHANNEL_MULTIPLE, dense_weight_layout, depthwise_weight_layout,
                    int8_conv_plain, int8_depthwise_plain, padded_channels, quantize_plain)
from .qconv import quantize_weight as quantize_weight_plain

SOURCE = cuda_build.source("qconv.cu")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448          # dynamic shared memory a block may take
# the dense entry (csrc/qconv.cu): a K step of BK bytes, STAGES steps in the
# cp.async ring, and its tiles (BM pixels, BN channels, warps along M and N)
# in the order of the source's Tile0..Tile3
BK = 64
STAGES = 4
DENSE_TILES = ((128, 128, 2, 4), (128, 64, 2, 2), (64, 64, 2, 2), (128, 32, 4, 1))
# the depthwise entry: 32 channels a block, bands of output rows (a power of
# two, at most DW_MAX_ROWS) at most DW_MAX_COLS columns wide, their staged
# input at most DW_SMEM_MAX bytes (two blocks share an SM, as their
# registers allow)
SLAB = 32
DW_SMEM_MAX = 100 * 1024
DW_MAX_COLS = 256
DW_MAX_ROWS = 16


# the activation quantize: QUANTIZE_THREADS threads a block, each warp its
# own tile of one 32-channel slab × QUANTIZE_TILE pixels; a lane takes
# QUANTIZE_LANE_ELEMS elements, one 16-byte vector of pixels of each of its
# channels, so a warp's 32 lanes cover QUANTIZE_LANE_ELEMS pixels
QUANTIZE_THREADS = 128
QUANTIZE_LANE_ELEMS = 32
QUANTIZE_TILE = QUANTIZE_LANE_ELEMS
# the weight pass: WEIGHT_THREADS threads a block, a block an output channel
# (dense), a warp a 32-channel slab (depthwise)
WEIGHT_THREADS = 256


def _out_hw(h: int, w: int, k: int, stride: int, padding: int) -> Tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


class DensePlan(NamedTuple):
    tile: int                       # index into DENSE_TILES
    bm: int
    bn: int
    threads: int
    steps: int                      # BK-byte steps of K
    grid: Tuple[int, int]           # (M tiles, O tiles)
    smem_bytes: int


def dense_smem_bytes(tile: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a dense block, as the source lays it out:
    the cp.async ring, reused by the epilogue's [BN][BM + pad] output tile."""
    bm, bn = DENSE_TILES[tile][:2]
    es = torch.tensor([], dtype=dtype).element_size()
    return max(STAGES * (bm + bn) * BK, bn * (bm + 16 // es) * es)


@functools.lru_cache(maxsize=None)
def plan_dense(n: int, h: int, w: int, cp: int, o: int, k: int, stride: int,
               padding: int, dtype: torch.dtype) -> DensePlan:
    """How a dense call of this shape is launched: of the tiles that suit
    its output channels, the largest that still gives a wave of blocks (one
    per SM), else the smallest. A pure function of the shape."""
    if dtype not in _DTYPES:
        raise TypeError(f"the kernel writes float32 or bfloat16, not {dtype}")
    if cp % CHANNEL_MULTIPLE or min(n, h, w, cp, o) < 1:
        raise ValueError(f"dense plan: {(n, h, w, cp, o)}")
    oh, ow = _out_hw(h, w, k, stride, padding)
    m = n * oh * ow

    def tiles(t):
        bm, bn = DENSE_TILES[t][:2]
        return -(-m // bm) * -(-o // bn)

    candidates = (3,) if o <= 32 else (1, 2) if o <= 64 else (0, 2)
    tile = next((t for t in candidates if tiles(t) >= SMS), candidates[-1])
    return dense_launch(n, h, w, cp, o, k, stride, padding, dtype, tile)


def dense_launch(n: int, h: int, w: int, cp: int, o: int, k: int, stride: int,
                 padding: int, dtype: torch.dtype, tile: int) -> DensePlan:
    """The launch of a dense call of this shape with ``tile``."""
    oh, ow = _out_hw(h, w, k, stride, padding)
    bm, bn, wm, wn = DENSE_TILES[tile]
    return DensePlan(tile, bm, bn, 32 * wm * wn, -(-k * k * cp // BK),
                     (-(-n * oh * ow // bm), -(-o // bn)), dense_smem_bytes(tile, dtype))


class DepthwisePlan(NamedTuple):
    rows: int                       # output rows a block
    cols: int                       # output columns a block
    grid: Tuple[int, int, int]      # (column tiles, row bands, N · Cp / 32)
    smem_bytes: int


def depthwise_smem_bytes(rows: int, cols: int, stride: int) -> int:
    """Dynamic shared memory of a depthwise block, as the source lays it
    out: the input rows of the band with their halo, 32 bytes a pixel, as
    wide as its quads of 4 output pixels need, in whole groups of 4."""
    in_cols = -(-((-(-cols // 4) * 4 - 1) * stride + 3) // 4) * 4
    return ((rows - 1) * stride + 3) * in_cols * SLAB


@functools.lru_cache(maxsize=None)
def plan_depthwise(n: int, h: int, w: int, cp: int, stride: int) -> DepthwisePlan:
    """How a depthwise call of this shape is launched: bands of output rows
    (at most ``DW_MAX_COLS`` columns), the tallest power of two that the
    staged input allows while the grid keeps one and a half blocks for each
    SM. A pure function of the shape (the output dtype does not enter)."""
    if cp % CHANNEL_MULTIPLE or min(n, h, w, cp) < 1 or stride not in (1, 2):
        raise ValueError(f"depthwise plan: {(n, h, w, cp)}, stride {stride}")
    oh, ow = _out_hw(h, w, 3, stride, 1)
    cols = min(ow, DW_MAX_COLS)

    def blocks(r):
        return n * (cp // SLAB) * -(-oh // r) * -(-ow // cols)

    rows = 1
    while (rows < min(oh, DW_MAX_ROWS) and 2 * blocks(2 * rows) >= 3 * SMS
           and depthwise_smem_bytes(2 * rows, cols, stride) <= DW_SMEM_MAX):
        rows *= 2
    return depthwise_launch(n, h, w, cp, stride, rows, cols)


def depthwise_launch(n: int, h: int, w: int, cp: int, stride: int, rows: int,
                     cols: int) -> DepthwisePlan:
    """The launch of a depthwise call of this shape in bands of ``rows`` ×
    ``cols`` output pixels."""
    oh, ow = _out_hw(h, w, 3, stride, 1)
    grid = (-(-ow // cols), -(-oh // rows), n * (cp // SLAB))
    return DepthwisePlan(rows, cols, grid, depthwise_smem_bytes(rows, cols, stride))


class QuantizePlan(NamedTuple):
    vec: int                        # pixels a 16-byte load: 4 float32, 8 bfloat16
    lane_channels: int              # channels a lane: QUANTIZE_LANE_ELEMS / vec
    chunks: int                     # tiles of QUANTIZE_TILE pixels along a channel row
    units: int                      # warp tiles: N · Cp / 32 · chunks
    grid: int                       # blocks
    vectorized: bool                # 16-byte loads, else element by element


def quantize_launch(n: int, c: int, hw: int, dtype: torch.dtype,
                    aligned: bool = True) -> QuantizePlan:
    """How the source launches the activation quantize of x [n, c, hw] (it
    chooses this itself: its C signature carries no plan). ``aligned``:
    x's data starts on 16 bytes; rows load 16 bytes at a time only where
    every channel row does."""
    if dtype not in _DTYPES:
        raise TypeError(f"quantize takes float32 or bfloat16, not {dtype}")
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    chunks = -(-hw // QUANTIZE_TILE)
    units = n * padded_channels(c) // CHANNEL_MULTIPLE * chunks
    return QuantizePlan(vec, QUANTIZE_LANE_ELEMS // vec, chunks, units,
                        -(-units // (QUANTIZE_THREADS // 32)), hw % vec == 0 and aligned)


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
        # xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH, OW,
        # tile, stream
        fn = getattr(lib, f"qconv_dense_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * 11 + [ptr]
        fn.restype = i32
        # xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW, rows,
        # cols, stream
        fn = getattr(lib, f"qconv_depthwise_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * 10 + [ptr]
        fn.restype = i32
    # w, s_w, out, O, I, K, Cp, depthwise, stream
    lib.qconv_quantize_weight_f32.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    lib.qconv_quantize_weight_f32.restype = i32
    lib.qconv_dense_smem_bytes.argtypes = [i32, i32]
    lib.qconv_dense_smem_bytes.restype = i32
    lib.qconv_depthwise_smem_bytes.argtypes = [i32] * 3
    lib.qconv_depthwise_smem_bytes.restype = i32
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


def quantize_weight(weight: torch.Tensor, depthwise: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """A QConv's weight [O, I, K, K] → (its int8 values in the layout the
    convolution reads, s_w [O]): ``clip(round(w / s_w), -127, 127)`` per
    output channel, laid out [O, K, K, Cp] (dense, Cp = I padded) or [9, Cp]
    (``depthwise``, I = 1, K = 3, Cp = O padded), the padding 0. Its plain
    version is :func:`.qconv.quantize_weight` followed by
    :func:`.qconv.dense_weight_layout` or :func:`.qconv.depthwise_weight_layout`
    (float64 for a float64 weight); the kernel takes float32."""
    w = weight.detach()
    if w.device.type == "cpu":
        wq, s_w = quantize_weight_plain(w)
        return (depthwise_weight_layout if depthwise else dense_weight_layout)(wq), s_w
    dev = _check_cuda("quantize_weight", w)
    if w.dtype != torch.float32 or w.dim() != 4:
        raise TypeError(f"quantize_weight takes a float32 [O, I, K, K] weight, not {w.dtype} "
                        f"{tuple(w.shape)}")
    o, i, k, k2 = w.shape
    if k != k2 or k not in (1, 3) or (depthwise and (i, k) != (1, 3)):
        raise ValueError(f"quantize_weight: weight {tuple(w.shape)}, depthwise {depthwise}")
    if depthwise:
        wl = torch.empty((9, padded_channels(o)), dtype=torch.int8, device=dev)
    else:
        wl = torch.empty((o, k, k, padded_channels(i)), dtype=torch.int8, device=dev)
    s_w = torch.empty((o,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.qconv_quantize_weight_f32(w.data_ptr(), s_w.data_ptr(), wl.data_ptr(),
                                            o, i, k, wl.shape[-1], int(depthwise), _stream(dev))
    _raise_on(lib, err, "int8 weight quantize")
    quantize_weight.launches += 1
    return wl, s_w


quantize_weight.launches = 0


def _epilogue_args(what, out_dtype, s_w, bias, channels):
    if out_dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel writes float32 or bfloat16, not {out_dtype}")
    if s_w.dtype != torch.float32 or s_w.shape != (channels,):
        raise ValueError(f"{what}: s_w must be float32 [{channels}]")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (channels,)):
        raise ValueError(f"{what}: bias must be {out_dtype} [{channels}]")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dense(lib, xq, wq, amax_eff, s_w, bias, stride, padding, out_dtype, stream, plan=None):
    """One launch of the dense entry of ``lib`` on ``xq``'s device, as
    ``plan`` (by default :func:`plan_dense`) lays it out; the output
    allocated there."""
    o, k, _, cp = wq.shape
    n, h, w, _ = xq.shape
    p = plan or plan_dense(n, h, w, cp, o, k, stride, padding, out_dtype)
    oh, ow = _out_hw(h, w, k, stride, padding)
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=xq.device)
    err = getattr(lib, f"qconv_dense_{_DTYPES[out_dtype]}")(
        xq.data_ptr(), wq.data_ptr(), amax_eff.data_ptr(), s_w.data_ptr(), _ptr(bias),
        out.data_ptr(), n, h, w, cp, o, k, stride, padding, oh, ow, p.tile, stream)
    _raise_on(lib, err, "int8 dense convolution")
    return out


def _depthwise(lib, xq, wq, channels, amax_eff, s_w, bias, stride, out_dtype, stream,
               plan=None):
    """One launch of the depthwise entry of ``lib`` on ``xq``'s device, as
    ``plan`` (by default :func:`plan_depthwise`) lays it out."""
    n, h, w, cp = xq.shape
    p = plan or plan_depthwise(n, h, w, cp, stride)
    oh, ow = _out_hw(h, w, 3, stride, 1)
    out = torch.empty((n, channels, oh, ow), dtype=out_dtype, device=xq.device)
    err = getattr(lib, f"qconv_depthwise_{_DTYPES[out_dtype]}")(
        xq.data_ptr(), wq.data_ptr(), amax_eff.data_ptr(), s_w.data_ptr(), _ptr(bias),
        out.data_ptr(), n, h, w, channels, cp, stride, oh, ow, p.rows, p.cols, stream)
    _raise_on(lib, err, "int8 depthwise convolution")
    return out


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
    if (k != k2 or k not in (1, 3) or cp != cpx or cp % CHANNEL_MULTIPLE
            or stride not in (1, 2)):
        raise ValueError(f"int8_conv: weights {tuple(wq.shape)} and activations "
                         f"{tuple(xq.shape)}, stride {stride}")
    _epilogue_args("int8_conv", out_dtype, s_w, bias, o)
    lib = _lib()
    with torch.cuda.device(dev):
        out = _dense(lib, xq, wq, _amax(amax_eff), s_w, bias, stride, padding, out_dtype,
                     _stream(dev))
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
    if (wq.shape != (9, cp) or cp % CHANNEL_MULTIPLE or channels > cp
            or stride not in (1, 2)):
        raise ValueError(f"int8_depthwise: weights {tuple(wq.shape)}, activations "
                         f"{tuple(xq.shape)}, {channels} channels, stride {stride}")
    _epilogue_args("int8_depthwise", out_dtype, s_w, bias, channels)
    lib = _lib()
    with torch.cuda.device(dev):
        out = _depthwise(lib, xq, wq, channels, _amax(amax_eff), s_w, bias, stride,
                         out_dtype, _stream(dev))
    int8_depthwise.launches += 1
    return out


int8_depthwise.launches = 0
