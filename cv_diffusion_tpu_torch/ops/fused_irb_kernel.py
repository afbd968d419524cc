"""Wrappers of the hand-written CUDA fused-IRB kernel.

The kernel library (``csrc/fused_irb.cu``) replaces the TPU kernels
``fused_irb_v2`` (``cv_diffusion_tpu/ops/pallas_irb.py:607``) and
``fused_irb`` (v1, ``pallas_irb.py:241``), one pair of entry points each. It
is built from the package's own sources with one ``nvcc`` call and loaded
through ``ctypes`` at first use (:mod:`.cuda_build`).

:func:`fused_irb_v2` takes the arguments of :func:`.fused_irb.
fused_irb_v2_plain`. For tensors on the CPU it runs that plain version; for
CUDA tensors it folds the GroupNorms with :func:`.fused_irb.folded_gn_scales`
(tensor ops, as the JAX package does in XLA), launches the kernel, and counts
the call in ``fused_irb_v2.launches``; it raises if the kernel cannot be
built or launched.

:func:`fused_irb_v1` takes the arguments of :func:`.fused_irb.
fused_irb_v1_plain` and runs that plain version for CPU tensors. For CUDA
tensors the kernel takes both GroupNorms' statistics itself: the wrapper
only allocates the output and scratch and launches (counted in
``fused_irb_v1.launches``). No model path calls it, in the port as in the
JAX package; it is a public entry point of its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import cuda_build
from .fused_irb import (check_tile_h, folded_gn_scales, fused_irb_v1_plain,
                        fused_irb_v2_plain)
from .norms import gn_num_groups

SOURCE = cuda_build.source("fused_irb.cu")

# Output tile (rows, columns) and hidden chunk of the output pass, by the
# output channels padded to 32, 64, 128 or 256 (wider outputs: blocks of
# 256); the same table as OutCfg in the source, which the launcher checks.
OUT_TILES = {32: (16, 16, 24), 64: (16, 16, 24), 128: (8, 16, 40),
             256: (8, 8, 80)}
POOL_TILE, POOL_CHUNK = 16, 32       # the SE pool pass: 16×16 pixels × 32 channels
# Eight blocks of 256 output channels, four times the widest IRB output of
# any variant (large: 512); each block recomputes its tile's expand.
MAX_COUT = 2048
# Two blocks of the output pass fit on each of an H100's 132 SMs; split the
# hidden channels over blocks only while the tiles alone leave SMs idle.
_TARGET_BLOCKS = 264
_MAX_POOL_GROUPS = 64
_STAT_PIXELS = 256    # v1's GN1 statistics: at least this many pixels a block

# Order of the pointer and int arrays the entry points take (enum Ptr and
# enum Dim in the source).
# The last eight pointers and five ints are v1's alone (its a1 .. b2 are
# scratch that the kernel writes).
_PTRS = ("x", "a1", "b1", "a2", "b2", "wexp", "wdw", "wproj", "wskip",
         "se_w1", "se_b1", "se_w2", "se_b2", "out", "pool", "pooled",
         "squeezed", "gate", "part", "gn1_scale", "gn1_bias", "gn2_scale",
         "gn2_bias", "film_scale", "film_shift", "stats1", "stats2")
_DIMS = ("batch", "cin", "chid", "cout", "csq", "height", "width", "silu",
         "use_se", "tile_h", "tile_w", "chunk", "groups", "chunks_per_group",
         "pool_groups", "stat_groups", "g1", "g2", "fs_stride", "fb_stride")


class Plan(NamedTuple):
    """How the launches split the work; a function of the shape alone, so
    reruns sum the partials in the same order."""
    tile_h: int
    tile_w: int
    chunk: int             # hidden channels per step of the output pass
    groups: int            # blocks over the hidden channels of one tile
    chunks_per_group: int
    pool_groups: int       # blocks over the pixels in the SE pool pass
                           # (and in v1's GN2 statistics)
    co_blocks: int         # blocks over the output channels (256 each)
    stat_groups: int       # blocks over the pixels in v1's GN1 statistics


def plan(batch: int, chid: int, cout: int, height: int, width: int) -> Plan:
    if not 0 < cout <= MAX_COUT:
        raise ValueError(f"the kernel takes 1 to {MAX_COUT} output channels, "
                         f"not {cout}")
    co_pad = next((c for c in sorted(OUT_TILES) if cout <= c), max(OUT_TILES))
    co_blocks = math.ceil(cout / co_pad)
    th, tw, cc = OUT_TILES[co_pad]
    blocks = math.ceil(height / th) * math.ceil(width / tw) * batch * co_blocks
    chunks = math.ceil(chid / cc)
    want = min(chunks, max(1, _TARGET_BLOCKS // blocks))
    per_group = math.ceil(chunks / want)
    pool_tiles = math.ceil(height / POOL_TILE) * math.ceil(width / POOL_TILE)
    pool_groups = min(pool_tiles, _MAX_POOL_GROUPS,
                      max(1, _TARGET_BLOCKS
                          // (math.ceil(chid / POOL_CHUNK) * batch)))
    stat_groups = max(1, min(math.ceil(height * width / _STAT_PIXELS),
                             _TARGET_BLOCKS // batch))
    return Plan(th, tw, cc, math.ceil(chunks / per_group), per_group,
                pool_groups, co_blocks, stat_groups)


def build() -> cuda_build.Built:
    """Compile the kernel library unless this source and these flags were
    built before; returns where it is."""
    return cuda_build.build(SOURCE)


def _declare(lib) -> None:
    if (lib.fused_irb_num_ptrs() != len(_PTRS)
            or lib.fused_irb_num_dims() != len(_DIMS)):
        raise RuntimeError(f"{SOURCE} takes another argument layout than "
                           "this wrapper")
    arrays = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    for name in ("fused_irb_f32", "fused_irb_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = arrays + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("fused_irb_v1_f32", "fused_irb_v1_bf16"):   # (…, eps, stream)
        fn = getattr(lib, name)
        fn.argtypes = arrays + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_irb_error_string.argtypes = [ctypes.c_int]
    lib.fused_irb_error_string.restype = ctypes.c_char_p


def _f32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """t as a contiguous float32 tensor on ``device``: t itself when it is
    one already (the served model's parameters), so nothing is copied."""
    if t is None:
        return None
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def fused_irb_v2(x: torch.Tensor, wexp: torch.Tensor, wdw: torch.Tensor,
                 wproj: torch.Tensor, gn1_scale: torch.Tensor,
                 gn1_bias: torch.Tensor, gn2_scale: torch.Tensor,
                 gn2_bias: torch.Tensor, film_scale: torch.Tensor,
                 film_shift: torch.Tensor,
                 se_w1: Optional[torch.Tensor] = None,
                 se_b1: Optional[torch.Tensor] = None,
                 se_w2: Optional[torch.Tensor] = None,
                 se_b2: Optional[torch.Tensor] = None,
                 wskip: Optional[torch.Tensor] = None,
                 eps: float = 1e-5, silu: bool = False,
                 use_se: bool = True) -> torch.Tensor:
    """The stride-1 IRB forward through the CUDA kernel: x [B, Cin, H, W]
    float32 or bfloat16, contiguous → [B, Cout, H, W] in x's dtype; weights
    as :func:`.fused_irb.fused_irb_v2_plain` takes them."""
    if x.device.type == "cpu":
        return fused_irb_v2_plain(x, wexp, wdw, wproj, gn1_scale, gn1_bias,
                                  gn2_scale, gn2_bias, film_scale, film_shift,
                                  se_w1, se_b1, se_w2, se_b2, wskip, eps, silu,
                                  use_se)
    _check(x, wexp, wproj, wskip, use_se, se_w1, se_b1, se_w2, se_b2)
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        out = _launch(lib, torch.cuda.current_stream(x.device).cuda_stream, x,
                      wexp, wdw, wproj, gn1_scale, gn1_bias, gn2_scale,
                      gn2_bias, film_scale, film_shift, se_w1, se_b1, se_w2,
                      se_b2, wskip, eps, silu, use_se)
    fused_irb_v2.launches += 1
    return out


fused_irb_v2.launches = 0


def _check(x, wexp, wproj, wskip, use_se, se_w1, se_b1, se_w2, se_b2) -> None:
    """Raise unless the kernel takes these arguments (x on a CUDA device)."""
    if x.device.type != "cuda":
        raise ValueError(f"no fused-IRB kernel for device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous NCHW x, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16 x, not {x.dtype}")
    b, cin, height, width = x.shape
    chid, cout = wexp.shape[0], wproj.shape[0]
    if wexp.shape[-1] != cin or wproj.shape[-1] != chid:
        raise ValueError(f"weights {tuple(wexp.shape)}, {tuple(wproj.shape)} "
                         f"do not fit {cin} input channels")
    if wskip is None and cin != cout:
        raise ValueError(f"{cin} → {cout} channels needs wskip")
    if use_se and any(t is None for t in (se_w1, se_b1, se_w2, se_b2)):
        raise ValueError("use_se needs se_w1, se_b1, se_w2 and se_b2")
    if x.numel() >= 2 ** 31 or b * cout * height * width >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements a tensor")


def fused_irb_v1(x: torch.Tensor, wexp: torch.Tensor, wdw: torch.Tensor,
                 wproj: torch.Tensor, gn1_scale: torch.Tensor,
                 gn1_bias: torch.Tensor, gn2_scale: torch.Tensor,
                 gn2_bias: torch.Tensor, film_scale: torch.Tensor,
                 film_shift: torch.Tensor,
                 se_w1: Optional[torch.Tensor] = None,
                 se_b1: Optional[torch.Tensor] = None,
                 se_w2: Optional[torch.Tensor] = None,
                 se_b2: Optional[torch.Tensor] = None,
                 wskip: Optional[torch.Tensor] = None,
                 eps: float = 1e-5, silu: bool = False,
                 use_se: bool = True, tile_h: int = 16) -> torch.Tensor:
    """``fused_irb`` (v1) through the CUDA kernel, both GroupNorms' statistics
    taken in the kernel: x [B, Cin, H, W] float32 or bfloat16, contiguous →
    [B, Cout, H, W] in x's dtype, every product with float32 operands; the
    arguments of :func:`.fused_irb.fused_irb_v1_plain`. ``tile_h`` is checked
    as the TPU kernel checks it and does not change the result. Given float32
    weights on x's device (the modules' own) and FiLM rows with unit stride
    (``time_mlp``'s output split in two), nothing runs on the card between
    the input and the output but the kernel: no copy, no fold."""
    check_tile_h(x.shape[2], tile_h)
    if x.device.type == "cpu":
        return fused_irb_v1_plain(x, wexp, wdw, wproj, gn1_scale, gn1_bias,
                                  gn2_scale, gn2_bias, film_scale, film_shift,
                                  se_w1, se_b1, se_w2, se_b2, wskip, eps, silu,
                                  use_se, tile_h)
    _check(x, wexp, wproj, wskip, use_se, se_w1, se_b1, se_w2, se_b2)
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        t = _launch_v1(lib, torch.cuda.current_stream(x.device).cuda_stream,
                       x, wexp, wdw, wproj, gn1_scale, gn1_bias, gn2_scale,
                       gn2_bias, film_scale, film_shift, se_w1, se_b1, se_w2,
                       se_b2, wskip, eps, silu, use_se)
    fused_irb_v1.launches += 1
    return t["out"]


fused_irb_v1.launches = 0


def _launch(lib, stream, x, wexp, wdw, wproj, gn1_scale, gn1_bias, gn2_scale,
            gn2_bias, film_scale, film_shift, se_w1, se_b1, se_w2, se_b2,
            wskip, eps, silu, use_se) -> torch.Tensor:
    """Fold the GroupNorms, lay the tensors out as the kernel takes them, and
    launch it on ``stream``; raises if a launch fails. The library and the
    stream are arguments, so that a build of the same source for another
    target can be driven through the same layout."""
    dev = x.device
    (a1, b1), (a2, b2), _ = folded_gn_scales(
        x, wexp.to(dev), gn1_scale.to(dev), gn1_bias.to(dev),
        gn2_scale.to(dev), gn2_bias.to(dev), film_scale.to(dev),
        film_shift.to(dev), eps, silu)
    t, dims = _layout(x, wexp, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip,
                      silu, use_se)
    t.update(a1=_f32(a1, dev), b1=_f32(b1, dev), a2=_f32(a2, dev),
             b2=_f32(b2, dev))
    fn = lib.fused_irb_f32 if x.dtype == torch.float32 else lib.fused_irb_bf16
    _call(lib, fn, t, dims, stream)
    return t["out"]


def _launch_v1(lib, stream, x, wexp, wdw, wproj, gn1_scale, gn1_bias,
               gn2_scale, gn2_bias, film_scale, film_shift, se_w1=None,
               se_b1=None, se_w2=None, se_b2=None, wskip=None, eps=1e-5,
               silu=False, use_se=True) -> dict:
    """v1's launch: the norms' parameters and FiLM go to the kernel as they
    are, with scratch for the statistics and the affines it writes. Returns
    every tensor it handed the kernel, by name: ``out``, and the affines
    (a1, b1) [B, Cin] and (a2, b2) [B, Chid] that the kernel computed."""
    b, cin, height, width = x.shape
    chid = wexp.shape[0]
    dev = x.device
    t, dims = _layout(x, wexp, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip,
                      silu, use_se)
    fs, fb = _f32_rows(film_scale, dev), _f32_rows(film_shift, dev)
    if fs.shape != (b, chid) or fb.shape != (b, chid):
        raise ValueError(f"FiLM {tuple(fs.shape)}, {tuple(fb.shape)} is not "
                         f"[{b}, {chid}]")
    t.update(gn1_scale=_f32(gn1_scale, dev), gn1_bias=_f32(gn1_bias, dev),
             gn2_scale=_f32(gn2_scale, dev), gn2_bias=_f32(gn2_bias, dev),
             film_scale=fs, film_shift=fb)
    for k, shape in (("a1", (b, cin)), ("b1", (b, cin)), ("a2", (b, chid)),
                     ("b2", (b, chid)),
                     ("stats1", (b, dims["stat_groups"], 2, cin)),
                     ("stats2", (b, dims["pool_groups"], 2, chid))):
        t[k] = torch.empty(shape, dtype=torch.float32, device=dev)
    # a batch of one never steps a row
    dims.update(fs_stride=fs.stride(0) if b > 1 else chid,
                fb_stride=fb.stride(0) if b > 1 else chid)
    fn = (lib.fused_irb_v1_f32 if x.dtype == torch.float32
          else lib.fused_irb_v1_bf16)
    _call(lib, fn, t, dims, stream, eps)
    return t


def _f32_rows(t: torch.Tensor, device) -> torch.Tensor:
    """t [B, C] as float32 on ``device`` with unit stride along C: t itself
    when it is one already (each half of ``time_mlp``'s output is, with a
    row stride of 2·C), so nothing is copied."""
    t = t.detach().to(device=device, dtype=torch.float32)
    return t if t.dim() == 2 and t.stride(1) == 1 else t.contiguous()


def _layout(x, wexp, wdw, wproj, se_w1, se_b1, se_w2, se_b2, wskip, silu,
            use_se):
    """The tensors both versions hand the kernel (x, the weights in the
    modules' own layouts, the output and the SE and combine scratch) and
    the ints, by name."""
    b, cin, height, width = x.shape
    chid, cout = wexp.shape[0], wproj.shape[0]
    pl = plan(b, chid, cout, height, width)
    dev = x.device
    csq = se_w1.shape[0] if use_se else 0
    # the weights in the modules' own layouts (the kernel indexes them so)
    t = dict(x=x, wexp=_f32(wexp.reshape(chid, cin), dev),
             wdw=_f32(wdw.reshape(chid, 9), dev),
             wproj=_f32(wproj.reshape(cout, chid), dev),
             wskip=_f32(None if wskip is None else wskip.reshape(cout, cin), dev),
             out=torch.empty((b, cout, height, width), dtype=x.dtype, device=dev))
    if use_se:
        t.update(se_w1=_f32(se_w1.reshape(csq, chid), dev),
                 se_b1=_f32(se_b1, dev),
                 se_w2=_f32(se_w2.reshape(chid, csq), dev),
                 se_b2=_f32(se_b2, dev),
                 pool=torch.empty((b, pl.pool_groups, 9, chid),
                                  dtype=torch.float32, device=dev),
                 pooled=torch.empty((b, chid), dtype=torch.float32, device=dev),
                 squeezed=torch.empty((b, csq), dtype=torch.float32, device=dev),
                 gate=torch.empty((b, chid), dtype=torch.float32, device=dev))
    if pl.groups > 1:
        t["part"] = torch.empty((pl.groups, b, cout, height, width),
                                dtype=torch.float32, device=dev)
    dims = dict(batch=b, cin=cin, chid=chid, cout=cout, csq=csq,
                height=height, width=width, silu=int(silu), use_se=int(use_se),
                g1=gn_num_groups(cin), g2=gn_num_groups(chid), fs_stride=0,
                fb_stride=0, **pl._asdict())
    return t, dims


def _call(lib, fn, t, dims, stream, *scalars) -> None:
    """Call entry point ``fn`` with the pointer and int arrays in the
    source's order (and any float scalars before the stream); raises if it
    returns an error."""
    ptrs = (ctypes.c_void_p * len(_PTRS))(
        *(t[k].data_ptr() if t.get(k) is not None else None for k in _PTRS))
    ints = (ctypes.c_int * len(_DIMS))(*(dims[k] for k in _DIMS))
    err = fn(ptrs, ints, *scalars, stream)
    if err != 0:
        msg = lib.fused_irb_error_string(err).decode()
        raise RuntimeError(f"fused-IRB kernel launch failed: {msg} ({err})")
