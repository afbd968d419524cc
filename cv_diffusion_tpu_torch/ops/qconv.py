"""The quantizing convolution: a float convolution with an optional int8
activation × weight compute path.

Counterpart of ``cv_diffusion_tpu/ops/qconv.py``. :class:`Conv2d` is its
float path, ``nn.Conv2d`` with a compute dtype; :class:`QConv` adds
``act_quant``:

* ``False``: the float path.
* ``True``, the int8 path (JAX ``_int8_conv``, ``:145-176``): the input is
  quantized to int8 with the scale ``s_x`` of an effective amax (the static
  bound, the calibrated amax, or, for a module still at 0, the batch's own
  max |x|), the kernel per output channel with ``s_w``, the product summed
  exactly in int32, then ``y = float(acc) · (s_x · s_w)``, cast to the
  compute dtype, ``+ bias`` in it. Four hand-written CUDA entries compute
  it on the card (``ops/qconv_kernel.py``: the weight pass, the activation
  quantize, the dense and the depthwise convolution); their plain versions
  are here.
* ``"fake"``, activation-aware QAT (JAX ``_fake_quant_conv``,
  ``:116-143``): the input quantized and dequantized in float with the int8
  path's scale rules (a per-batch amax is stop-gradient'ed), straight-through
  rounding, a float32 convolution, cast to the compute dtype after.

A module's amax is a non-persistent buffer: the state dict is that of the
float model (JAX's params tree is the same with and without ``act_quant``),
so every weights file loads into either. While ``calibrating`` (set by
``export.quantization.calibrate_act_scales``), a module without a static
bound records ``max(amax, max|x|)`` and runs the float path; a bound module
runs the int8 path, as in JAX (``:149-158``).

The JAX code writes the scales as ``max(amax, 1e-6) / 127`` and
``max(absmax / 127, 1e-12)``; XLA compiles the division by the constant 127
into a multiplication by float32(1/127) (``0.00787401572``; the compiled
HLO of ``QConv``), and that is what runs. The port multiplies by the same
constant, so its int8 path equals JAX's bit for bit. The divisions by the
scales themselves (``x / s_x``, ``w / s_w``) are IEEE divisions on both
sides, and rounding is half to even; only where the scale is a compile-time
constant (the fake path's static bound) does XLA multiply by its
reciprocal instead, in the forward and the gradient, and so does the
port there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import halo_rows
from ..parallel.mesh import current_spatial
from . import upcast

# float(1/127) as JAX's compiled scales use it (see the module docstring)
INV_127 = 1.0 / 127.0
ACT_SCALE_FLOOR = 1e-6       # s_x = max(amax, 1e-6) / 127   (qconv.py:165)
WEIGHT_SCALE_FLOOR = 1e-12   # s_w = max(absmax / 127, 1e-12) (qconv.py:170-171)
QMAX = 127.0
# the quantized activations' channels are padded to a multiple of this: the
# CUDA kernels copy 16-byte chunks along channels, the dense entry's K steps
# are 32-byte runs of one tap, and a depthwise block takes 32 channels
CHANNEL_MULTIPLE = 32


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


class _SteRound(torch.autograd.Function):
    """round half to even, gradient passed straight through (JAX
    ``_ste_round``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


class _Clip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)`` with JAX's gradient: 1 strictly inside, 0
    outside, and 0.5 at a bound (``jnp.clip`` is ``minimum(maximum(x, lo),
    hi)``, and JAX splits the gradient of a tie evenly; ``torch.clamp``
    passes all of it)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(g.dtype)
        tie = ((x == ctx.lo) | (x == ctx.hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _Clip.apply(x, lo, hi)


def act_scale(amax_eff: torch.Tensor) -> torch.Tensor:
    """``s_x = max(amax, 1e-6) · float(1/127)``, in amax's dtype."""
    return torch.clamp_min(amax_eff, ACT_SCALE_FLOOR) * INV_127


def quantize_weight(weight: torch.Tensor):
    """(int8 kernel, scales [O]) of a conv weight [O, I/g, kh, kw], per
    output channel (JAX ``:169-172``), the scales float32 (float64 for a
    float64 weight)."""
    w = upcast(weight.detach())
    absmax = w.abs().amax(dim=(1, 2, 3))
    s_w = torch.clamp_min(absmax * INV_127, WEIGHT_SCALE_FLOOR)
    q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -QMAX, QMAX)
    return q.to(torch.int8), s_w


def dense_weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """int8 [O, I, kh, kw] → [O, kh, kw, Ip], Ip the channels padded with
    zeros to a multiple of ``CHANNEL_MULTIPLE``: the layout the dense entry
    reads."""
    o, i, kh, kw = wq.shape
    out = wq.new_zeros((o, kh, kw, padded_channels(i)))
    out[..., :i] = wq.permute(0, 2, 3, 1)
    return out


def depthwise_weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """int8 [C, 1, 3, 3] → [9, Cp], tap-major, the channels padded with
    zeros: the layout the depthwise entry reads."""
    c = wq.shape[0]
    out = wq.new_zeros((9, padded_channels(c)))
    out[:, :c] = wq.reshape(c, 9).t()
    return out


# --- the plain versions of the three CUDA entries -----------------------------

def quantize_plain(x: torch.Tensor, amax_eff: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W] (float32 or bfloat16) → int8 [N, H, W, Cp], pixel-major,
    ``clip(round(x_f32 / s_x), -127, 127)``, the padding channels 0 (a
    float64 x and amax, as in a reference computation, in float64)."""
    n, c, h, w = x.shape
    s_x = act_scale(amax_eff)
    q = torch.clamp(torch.round(upcast(x) / s_x), -QMAX, QMAX).to(torch.int8)
    out = q.new_zeros((n, h, w, padded_channels(c)))
    out[..., :c] = q.permute(0, 2, 3, 1)
    return out


def _epilogue(acc: torch.Tensor, amax_eff: torch.Tensor, s_w: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """int32 acc [N, O, OH, OW] → ``float(acc) · (s_x · s_w)`` cast to
    ``out_dtype``, then ``+ bias`` in it (JAX ``:175`` and ``:95-96``); in
    the scales' dtype, float32 (float64 in a reference computation)."""
    scale = act_scale(amax_eff) * s_w
    y = (acc.to(scale.dtype) * scale[None, :, None, None]).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[None, :, None, None]
    return y


def int8_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """The int32 accumulators [N, O, OH, OW] of the dense int8 convolution
    of xq int8 [N, H, W, Cp] by wq int8 [O, kh, kw, Cp]: the int8 × int8
    products summed in float64, where every partial sum is an integer below
    2⁵³ and so exact, whatever the order."""
    o, kh, kw, cp = wq.shape
    x = xq.permute(0, 3, 1, 2).double()
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)  # [N, Cp·kh·kw, L]
    w = wq.permute(0, 3, 1, 2).reshape(o, -1).double()
    acc = torch.matmul(w, cols)
    oh = (xq.shape[1] + 2 * padding - kh) // stride + 1
    ow = (xq.shape[2] + 2 * padding - kw) // stride + 1
    return acc.reshape(xq.shape[0], o, oh, ow).to(torch.int32)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, amax_eff: torch.Tensor,
                    s_w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                    padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The dense int8 convolution: xq int8 [N, H, W, Cp] (``quantize``'s
    output), wq int8 [O, kh, kw, Cp] (:func:`dense_weight_layout`) → [N, O,
    OH, OW] in ``out_dtype``: :func:`int8_acc_plain`, then the epilogue."""
    return _epilogue(int8_acc_plain(xq, wq, stride, padding), amax_eff, s_w, bias,
                     out_dtype)


def int8_depthwise_plain(xq: torch.Tensor, wq: torch.Tensor, channels: int,
                         amax_eff: torch.Tensor, s_w: torch.Tensor,
                         bias: Optional[torch.Tensor], stride: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """The 3×3 depthwise int8 convolution, padding 1: xq int8 [N, H, W, Cp],
    wq int8 [9, Cp] (:func:`depthwise_weight_layout`) → [N, C, OH, OW] in
    ``out_dtype``: :func:`int8_depthwise_acc_plain`, then the epilogue."""
    return _epilogue(int8_depthwise_acc_plain(xq, wq, channels, stride), amax_eff, s_w,
                     bias, out_dtype)


def int8_depthwise_acc_plain(xq: torch.Tensor, wq: torch.Tensor, channels: int,
                             stride: int) -> torch.Tensor:
    """The int32 accumulators [N, C, OH, OW] of the 3×3 depthwise int8
    convolution, padding 1, summed in float64 as :func:`int8_acc_plain`."""
    n, h, w, cp = xq.shape
    x = xq.permute(0, 3, 1, 2).double()
    cols = F.unfold(x, 3, padding=1, stride=stride).reshape(n, cp, 9, -1)
    acc = (cols * wq.t().double()[None, :, :, None]).sum(dim=2)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    return acc[:, :channels].reshape(n, channels, oh, ow).to(torch.int32)


# --- the modules ----------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype (JAX ``QConv``'s float path): with
    ``compute_dtype`` set, the input and the weight are cast to it, the
    convolution's output has it, and the bias is added in it after that
    rounding.

    Under a spatial shard (``parallel.mesh.spatial_scope``) the input is
    this rank's strip of image rows, and a 3×3 convolution with padding 1
    takes its halo from the neighbouring strips (``parallel.halo.
    halo_rows``, zeros at the image's border, in the compute dtype) and pads
    W only: one row on each side at stride 1; at stride 2, where the strip
    has an even number of rows starting at an even row, one row above and
    none below. A 1×1 needs nothing."""

    compute_dtype: Optional[torch.dtype] = None

    def _conv_forward(self, input: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        shard = current_spatial()
        if shard is None or self.kernel_size[0] == 1:
            return super()._conv_forward(input, weight, bias)
        if (self.kernel_size[0], self.padding[0]) != (3, 1) or self.stride[0] not in (1, 2):
            raise ValueError(f"spatial sharding takes 3×3 convolutions with padding 1 "
                             f"at stride 1 or 2, not {self}")
        if self.stride[0] == 2 and input.shape[2] % 2:
            raise ValueError(f"a stride-2 convolution of a strip of {input.shape[2]} rows")
        x = halo_rows(input, 1, 1 if self.stride[0] == 1 else 0, "zero", shard)
        return F.conv2d(x, weight, bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class QConv(Conv2d):
    """:class:`Conv2d` with JAX ``QConv``'s ``act_quant`` (False, True or
    ``"fake"``) and ``act_bound`` (a known static input bound, e.g. 6.0
    after ReLU6; None: calibrated). Square kernels of 1 or 3, stride 1 or 2;
    groups 1, or depthwise at 3×3."""

    def __init__(self, *args, act_quant=False, act_bound: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.act_quant = act_quant
        self.act_bound = act_bound
        # set by export.quantization.calibrate_act_scales
        self.calibrating = False
        self.register_buffer(
            "amax", torch.tensor(0.0 if act_bound is None else float(act_bound)),
            persistent=False)
        # a host copy of amax > 0, kept by set_amax: where it holds, the int8
        # path takes amax as it is and skips the dynamic fallback's max |x|
        self.amax_positive = act_bound is not None and act_bound > 0

    @torch.no_grad()
    def set_amax(self, value) -> None:
        """Set the activation amax (the bound, or a loaded or calibrated
        scale): used as it is where > 0, else the dynamic fallback."""
        value = torch.as_tensor(value).detach().reshape(())
        self.amax.copy_(value.to(self.amax.device, self.amax.dtype))
        self.amax_positive = bool(self.amax > 0)

    @property
    def depthwise(self) -> bool:
        return self.groups > 1

    def out_dtype(self) -> torch.dtype:
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.act_quant:
            return super().forward(x)
        if self.act_quant == "fake":
            return self._fake_quant_conv(x)
        if self.calibrating and self.act_bound is None:
            with torch.no_grad():
                self.amax.copy_(torch.maximum(
                    self.amax, upcast(x.detach()).abs().amax().to(self.amax.dtype)))
            return super().forward(x)
        return self._int8_conv(x)

    def amax_eff(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 path's amax on the device, float32 (float64 in a float64
        model): the bound or the calibrated amax, or where a module is still
        at 0, max |x| over the whole batch (``:163-164``). No host sync."""
        amax = upcast(self.amax)
        if self.amax_positive:
            return amax
        return torch.where(amax > 0, amax, upcast(x.detach()).abs().amax())

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        from . import qconv_kernel

        if self.kernel_size[0] != self.kernel_size[1] or self.kernel_size[0] not in (1, 3):
            raise ValueError(f"int8 path: kernel {self.kernel_size}, not 1×1 or 3×3")
        if self.depthwise and (self.groups != self.in_channels or self.groups != self.out_channels
                               or self.kernel_size[0] != 3 or self.padding[0] != 1):
            raise ValueError("int8 path: grouped convolutions are 3×3 depthwise, "
                             "padding 1, only")
        amax = self.amax_eff(x)
        # the weight quantized on every call, as in JAX (:169-172), in the
        # layout the convolution reads
        wl, s_w = qconv_kernel.quantize_weight(self.weight, self.depthwise)
        bias = None if self.bias is None else self.bias.detach().to(self.out_dtype())
        xq = qconv_kernel.quantize(x.detach().contiguous(), amax)
        if self.depthwise:
            return qconv_kernel.int8_depthwise(xq, wl, self.out_channels, amax, s_w, bias,
                                               self.stride[0], self.out_dtype())
        return qconv_kernel.int8_conv(xq, wl, amax, s_w, bias, self.stride[0],
                                      self.padding[0], self.out_dtype())

    def _fake_quant_conv(self, x: torch.Tensor) -> torch.Tensor:
        xf = upcast(x)
        if self.act_bound is not None:
            # a constant scale: compiled, JAX divides by it as a
            # multiplication by its reciprocal (XLA's rewrite of x / c), and
            # the gradient likewise
            s_x = act_scale(xf.new_full((), float(self.act_bound)))
            scaled = xf * (1.0 / s_x)
        else:
            s_x = act_scale(xf.detach().abs().amax())
            scaled = xf / s_x
        xq = clip(ste_round(scaled), -QMAX, QMAX) * s_x
        # the convolution in float32 (or float64) whatever the compute dtype:
        # in bf16 the dequantized grid points would be rounded again
        y = self._conv_forward(xq, self.weight.to(xf.dtype), None)
        y = y.to(self.out_dtype())
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]
