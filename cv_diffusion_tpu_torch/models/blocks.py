"""EfficientUNet building blocks as ``nn.Module``s, NCHW.

Counterpart of ``cv_diffusion_tpu/models/blocks.py``, with its
convolutions as :class:`~..ops.qconv.QConv` where JAX has one (float, int8
or fake-quant compute, ``act_quant``). Module and
parameter names are those of the reference torch EfficientUNet, which the
JAX package's ``export_unet_state_dict`` emits, so a state dict from either
loads with ``strict=True``.

Compute dtype, as flax's ``dtype``: the parameters are float32, and a
:class:`Conv2d` or :class:`Linear` whose ``compute_dtype`` is bfloat16 casts
its input and its weight to bf16 at each use, returns a bf16 output and adds
its bias in bf16 after that rounding (``ops/qconv.py:90-115``, flax
``Dense``); with ``compute_dtype`` None it is the torch module itself.
:func:`set_compute_dtype` sets it on every such module of a model. What
flax keeps in float32 stays so here: GroupNorm's statistics and affine, the
sinusoidal embedding, the SE sigmoid and the bilinear resize, each cast
back to its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_irb_kernel, upcast
from ..ops.attention import (linear_attention, linear_attention_sharded,
                             softmax_attention)
from ..ops.fused_irb import irb_args
from ..ops.norms import (concat_group_norm_parts, gn2_film_affine_gram,
                         gn_num_groups, group_norm, group_norm_film)
from ..ops.qconv import Conv2d, QConv
from ..parallel.halo import gather_rows, halo_rows, scatter_rows, spatial_sum
from ..parallel.mesh import current_spatial
from . import rows


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x·Wᵀ + b`` in the compute dtype ``dtype`` (None: torch's own
    ``F.linear``): input and weight cast to it, then the bias added in it
    after the product's rounding, as flax's ``Dense(dtype=...)``."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A 1×1 convolution without bias on an explicit weight (a slice of a
    module's), in the compute dtype ``dtype`` (None: the operands' own), as
    the JAX package's ``_conv1x1`` on ``kernel.astype(self.dtype)``."""
    if dtype is not None:
        x, weight = x.to(dtype), weight.to(dtype)
    return F.conv2d(x, weight)


class DenseConv(Conv2d):
    """A 1×1 :class:`Conv2d` that a module applies as a dense layer to [B, C]
    (:func:`dense` on its flattened weight): the SE block's ``fc1``/``fc2``,
    which are flax ``Dense`` layers in the JAX package. A module of its own
    call, so that a forward hook sees its output."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.flatten(1), self.bias, self.compute_dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype, as flax's ``Dense`` (:func:`dense`)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """A config's ``dtype`` as the modules' ``compute_dtype``: None for
    float32 (the parameters' own dtype, so a float64 reference model stays
    float64), torch.bfloat16 for bfloat16."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"UNet dtype {name!r}: the port computes in float32 or "
                     "bfloat16")


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set ``compute_dtype`` on every :class:`Conv2d` (:class:`QConv`
    included) and :class:`Linear` inside ``module``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x): ``F.silu`` in float32; in bfloat16 the op sequence the JAX
    package's ``jax.nn.silu`` runs, x·(1/(1 + e^−x)) with each operation
    rounded to bf16 (so the result equals XLA's bit for bit on the CPU,
    where ``F.silu``, rounding once, differs in ~4 of 10 values)."""
    if x.dtype == torch.bfloat16:
        return x * (1.0 / (1.0 + torch.exp(-x)))
    return F.silu(x)


class SiLU(nn.Module):
    """:func:`silu` as a module."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


def activation(x: torch.Tensor, quantization_friendly: bool) -> torch.Tensor:
    """ReLU6 when quantization friendly, SiLU otherwise."""
    if quantization_friendly:
        return x.clamp(0.0, 6.0)
    return silu(x)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, max_period: int = 10000,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding in ``[cos, sin]`` order; t [B] →
    [B, dim], computed in ``dtype`` (float32, as the JAX package)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dtype, device=t.device) / half)
    args = t.to(dtype)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training-mode dropout as flax's ``nn.Dropout``: each element kept with
    probability 1 − rate and scaled by 1/(1 − rate), the mask drawn from
    ``generator`` (the train step's), never from torch's global RNG."""
    if generator is None:
        raise ValueError("dropout in training needs the train step's "
                         "torch.Generator (generator=...)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = rows.draw(lambda s: torch.rand(s, generator=generator,
                                          device=x.device), x.shape, hdim=2) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's group rule and float32 statistics."""

    def __init__(self, channels: int, max_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = gn_num_groups(channels, max_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return sinusoidal_pos_emb(t, self.dim, dtype=dtype)


class TimeEmbedding(nn.Sequential):
    """SinPosEmb(base_ch) → Linear(time_dim) → SiLU → Linear(time_dim). The
    embedding is computed in at least float32 and cast to the layers' dtype,
    as flax's ``Dense`` casts its input."""

    def __init__(self, base_channels: int, time_embed_dim: int):
        super().__init__(SinusoidalPosEmb(base_channels),
                         Linear(base_channels, time_embed_dim), SiLU(),
                         Linear(time_embed_dim, time_embed_dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dtype = self[1].weight.dtype
        emb = self[0](t, torch.promote_types(dtype, torch.float32)).to(dtype)
        return self[3](self[2](self[1](emb)))


class SqueezeExcitation(nn.Module):
    """Mean pool → 1×1 squeeze → act → 1×1 expand → sigmoid (in f32) gate."""

    def __init__(self, channels: int, ratio: float = 0.25,
                 quantization_friendly: bool = True):
        super().__init__()
        squeezed = max(1, int(channels * ratio))
        self.quantization_friendly = quantization_friendly
        self.fc1 = DenseConv(channels, squeezed, 1)
        self.fc2 = DenseConv(squeezed, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current_spatial()
        if shard is None:
            pooled = x.mean(dim=(2, 3))
        else:   # the strips' sums over the group, over the image's pixels
            count = x.shape[2] * x.shape[3] * shard.size
            pooled = (spatial_sum(upcast(x).sum(dim=(2, 3)), shard) / count).to(x.dtype)
        s = self.fc1(pooled)
        s = activation(s, self.quantization_friendly)
        s = self.fc2(s)
        s = torch.sigmoid(upcast(s)).to(x.dtype)
        return x * s[:, :, None, None]


class InvertedResidualBlock(nn.Module):
    """GN → act → 1×1 expand → GN ⊕ FiLM(time) → act → 3×3 depthwise → SE →
    1×1 project → dropout (training only, mask from the ``generator`` given
    to ``forward``) → residual (1×1 skip conv when the channel count changes;
    no residual at all for stride ≠ 1 with equal counts, as in the
    reference).

    Two inference rewrites of the JAX block, both off in training mode and
    neither changing the parameters: ``use_pallas_irb`` runs a stride-1 block
    as one call of the fused-IRB kernel's wrapper (the CUDA kernel for CUDA
    tensors, its plain version on the CPU), and raises where a gradient
    would have to pass through it (the kernel has no backward; a regression
    student's sampler runs in eval mode with grad enabled); ``fold_gn``
    keeps the separate convs but applies GN2 ⊕ FiLM as the affine folded
    from the Gram of x̂, so the expand output needs no statistics pass.

    ``act_quant`` (``ops/qconv.py``) makes expand, depthwise, project and
    skip :class:`QConv`s of that mode, expand and depthwise with the static
    bound 6 of their ReLU6 inputs when ``quantization_friendly`` (JAX
    ``blocks.py:266-311``); the block then takes the unfused route whatever
    ``use_pallas_irb`` and ``fold_gn`` say, as JAX does (``:211-212, 260``).

    ``skip_input`` (the decoder's ``split_skip`` entry) is the second part of
    the block's input, which is then ``cat([x, skip_input], dim=1)``
    without that concatenation being formed: GN1's statistics come from the
    two parts (:func:`~..ops.norms.concat_group_norm_parts`), and the expand
    and the 1×1 residual conv each run as the sum of two convs on their
    weights' two slices. The block takes that route where JAX does
    (``blocks.py:177-185``, in training too): stride 1, no ``act_quant``,
    ``use_pallas_irb`` or ``fold_gn``, and a concatenation of another width
    than the output; otherwise it concatenates. The parameters are the same
    either way."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_embed_dim: int, expansion_ratio: int = 4,
                 stride: int = 1, use_se: bool = True, se_ratio: float = 0.25,
                 quantization_friendly: bool = True, dropout: float = 0.0,
                 use_pallas_irb: bool = False, fold_gn: bool = False,
                 act_quant=False):
        super().__init__()
        hidden = int(in_channels * expansion_ratio)
        bound6 = 6.0 if quantization_friendly else None
        self.quantization_friendly = quantization_friendly
        self.dropout = dropout
        self.stride = stride
        self.act_quant = act_quant
        self.use_pallas_irb = use_pallas_irb and not act_quant
        self.fold_gn = fold_gn and not act_quant
        self.use_residual = stride == 1 and in_channels == out_channels
        self.norm1 = GroupNorm(in_channels)
        self.expand = QConv(in_channels, hidden, 1, bias=False,
                            act_quant=act_quant, act_bound=bound6)
        self.norm2 = GroupNorm(hidden)
        self.time_mlp = nn.Sequential(SiLU(),
                                      Linear(time_embed_dim, hidden * 2))
        self.depthwise = QConv(hidden, hidden, 3, stride=stride, padding=1,
                               groups=hidden, bias=False, act_quant=act_quant,
                               act_bound=bound6)
        self.se = (SqueezeExcitation(hidden, se_ratio, quantization_friendly)
                   if use_se else None)
        self.project = QConv(hidden, out_channels, 1, bias=False,
                             act_quant=act_quant)
        self.skip = (QConv(in_channels, out_channels, 1, stride=stride,
                           bias=False, act_quant=act_quant)
                     if in_channels != out_channels else None)

    def splits(self, in_channels: int) -> bool:
        """Whether a ``skip_input`` runs split (JAX ``split_ok``,
        ``blocks.py:177-181``) for a block input of ``in_channels`` in all."""
        return (self.stride == 1 and not self.act_quant
                and not self.use_pallas_irb and not self.fold_gn
                and in_channels != self.project.out_channels)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                skip_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip_input is not None and not self.splits(x.shape[1] + skip_input.shape[1]):
            x, skip_input = torch.cat([x, skip_input.to(x.dtype)], dim=1), None
        film_scale, film_shift = self.time_mlp(time_emb).chunk(2, dim=-1)
        if skip_input is not None:
            return self._split_forward(x, skip_input, film_scale, film_shift,
                                       generator)
        if self.use_pallas_irb and self.stride == 1 and not self.training:
            if torch.is_grad_enabled() and (
                    x.requires_grad or time_emb.requires_grad
                    or any(p.requires_grad for p in self.parameters())):
                raise RuntimeError(
                    "use_pallas_irb: the fused IRB kernel has no backward, so "
                    "a gradient cannot pass through an IRB in eval mode with "
                    "grad enabled (as the JAX package's Pallas kernel cannot "
                    "be differentiated either); build the differentiated "
                    "model without use_pallas_irb, or run it under no_grad")
            shard = current_spatial()
            if shard is None:
                return fused_irb_kernel.fused_irb_v2(
                    x, film_scale=film_scale, film_shift=film_shift,
                    **irb_args(self))
            # the kernel holds three reductions over the image and a
            # depthwise 3×3: it runs on the whole image, gathered
            whole = gather_rows(x, 2, shard).contiguous()
            return scatter_rows(fused_irb_kernel.fused_irb_v2(
                whole, film_scale=film_scale, film_shift=film_shift,
                **irb_args(self)), 2, shard).contiguous()
        h = activation(self.norm1(x), self.quantization_friendly)
        if self.fold_gn and not self.training:
            a2, b2 = gn2_film_affine_gram(
                h, self.expand.weight, self.norm2.weight, self.norm2.bias,
                film_scale, film_shift, self.norm2.num_groups, self.norm2.eps)
            h = self.expand(h)
            h = (upcast(h) * a2[:, :, None, None]
                 + b2[:, :, None, None]).to(h.dtype)
        else:
            h = self.expand(h)
            h = group_norm_film(h, self.norm2.weight, self.norm2.bias,
                                film_scale, film_shift, self.norm2.num_groups,
                                self.norm2.eps)
        h = self._tail(h, generator)
        if self.skip is not None:
            return h + self.skip(x)
        if self.use_residual:
            return h + x
        return h

    def _tail(self, h: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """act → depthwise → SE → project → dropout, after GN2 ⊕ FiLM."""
        h = activation(h, self.quantization_friendly)
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        if self.dropout > 0 and self.training:
            h = dropout(h, self.dropout, generator)
        return h

    def _split_forward(self, u: torch.Tensor, s: torch.Tensor,
                       film_scale: torch.Tensor, film_shift: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The block on ``cat([u, s], dim=1)`` without the concatenation
        (JAX ``blocks.py:233-249, 300-306``): each 1×1 conv over it is the
        sum of the convs of its weight's two slices, in the convs' compute
        dtype."""
        cu = u.shape[1]
        u_hat, s_hat = concat_group_norm_parts(
            u, s, self.norm1.weight, self.norm1.bias, self.norm1.num_groups,
            self.norm1.eps)
        u_hat = activation(u_hat, self.quantization_friendly)
        s_hat = activation(s_hat, self.quantization_friendly)
        dt, w = self.expand.compute_dtype, self.expand.weight
        h = conv1x1(u_hat, w[:, :cu], dt) + conv1x1(s_hat, w[:, cu:], dt)
        h = group_norm_film(h, self.norm2.weight, self.norm2.bias, film_scale,
                            film_shift, self.norm2.num_groups, self.norm2.eps)
        h = self._tail(h, generator)
        w = self.skip.weight
        return h + (conv1x1(u, w[:, :cu], dt) + conv1x1(s, w[:, cu:], dt))


class LinearAttention(nn.Module):
    """The attention op of :class:`LinearAttentionBlock` on q, k, v
    [B, N, heads, dim]. A module of its own, without parameters, so that a
    forward hook can see its inputs. Under a spatial shard the tokens are
    this rank's of the h-major sequence, and it runs token-sharded
    (``ops.attention.linear_attention_sharded``)."""

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        shard = current_spatial()
        if shard is None:
            return linear_attention(q, k, v)
        return linear_attention_sharded(q, k, v, shard)


class SoftmaxAttention(nn.Module):
    """The attention op of :class:`StandardAttentionBlock`: softmax(q·kᵀ·
    scale)·v on q, k, v [B, N, heads, dim] through the flash-attention
    kernels (``ops/flash_attention_kernel.py``) at every N. A module of its
    own, without parameters, so that a forward hook can see its inputs."""

    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        shard = current_spatial()
        if shard is None:
            return softmax_attention(q, k, v, self.scale)
        # every query sees every key: the kernels run on the whole sequence
        # (one shape for q, k and v), and this rank keeps its queries' rows
        whole = [gather_rows(t, 1, shard).contiguous() for t in (q, k, v)]
        return scatter_rows(softmax_attention(*whole, self.scale), 1,
                            shard).contiguous()


class _AttentionBlock(nn.Module):
    """GN → 1×1 qkv (a :class:`QConv` of ``act_quant``'s mode) → ``attn`` →
    ``to_out`` → +residual; a subclass sets ``attn`` and ``to_out``."""

    def __init__(self, channels: int, num_heads: int, dim_head: int,
                 act_quant):
        super().__init__()
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.norm = GroupNorm(channels)
        self.to_qkv = QConv(channels, num_heads * dim_head * 3, 1, bias=False,
                            act_quant=act_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hgt, wid = x.shape
        qkv = self.to_qkv(self.norm(x))
        # NHWC token order, split as (b, N, 3, heads, dh) like the JAX
        # blocks; one copy makes q, k and v each contiguous.
        qkv = (qkv.permute(0, 2, 3, 1)
               .reshape(b, hgt * wid, 3, self.num_heads, self.dim_head)
               .permute(2, 0, 1, 3, 4).contiguous())
        out = self.attn(qkv[0], qkv[1], qkv[2])
        out = out.reshape(b, hgt, wid, -1).permute(0, 3, 1, 2)
        return self.to_out(out) + x


class LinearAttentionBlock(_AttentionBlock):
    """GN → 1×1 qkv → φ-linear attention → 1×1 out → GN → +residual; the
    two 1×1s are :class:`QConv`s of ``act_quant``'s mode."""

    def __init__(self, channels: int, num_heads: int = 4, dim_head: int = 32,
                 act_quant=False):
        super().__init__(channels, num_heads, dim_head, act_quant)
        self.attn = LinearAttention()
        self.to_out = nn.Sequential(QConv(num_heads * dim_head, channels, 1,
                                          bias=False, act_quant=act_quant),
                                    GroupNorm(channels))


class StandardAttentionBlock(_AttentionBlock):
    """GN → 1×1 qkv → softmax attention (scale dim^-½) → 1×1 out →
    +residual, with no output GroupNorm (JAX ``StandardAttentionBlock``,
    ``cv_diffusion_tpu/models/blocks.py:353-390``); the two 1×1s are
    :class:`QConv`s of ``act_quant``'s mode.

    JAX runs the stock Pallas flash kernel with ``use_pallas`` where it
    tiles (N ≥ 128 and N a multiple of 128) and ``standard_attention``
    otherwise; both compute this function, and the port's kernels compute it
    at any N, so the block has no ``use_pallas``."""

    def __init__(self, channels: int, num_heads: int = 4, dim_head: int = 32,
                 act_quant=False):
        super().__init__(channels, num_heads, dim_head, act_quant)
        self.attn = SoftmaxAttention(dim_head ** -0.5)
        self.to_out = QConv(num_heads * dim_head, channels, 1, bias=False,
                            act_quant=act_quant)


class Downsample(nn.Module):
    """3×3 stride-2 conv, padding 1 (a :class:`QConv`). Under a spatial
    shard its strip has an even number of rows starting at an even row, so
    the conv takes one halo row from above and none from below
    (:class:`~..ops.qconv.Conv2d`)."""

    def __init__(self, channels: int, act_quant=False):
        super().__init__()
        self.down = QConv(channels, channels, 3, stride=2, padding=1,
                          act_quant=act_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


# (channels, height, width) of an Upsample conv's float32 input → the smallest
# batch at which cuDNN (9.2, PyTorch 2.11, H100) runs that 3×3 conv as an FFT:
# at the small UNet's upsamplers.1 (128 channels at 128²) from batch 5 on,
# holding ~9 GB of workspace for 8.9-13.0 ms where PyTorch's own convolution
# (im2col and a GEMM) holds 75 MB for 0.9-1.5 ms. At every other Upsample
# shape of small@256, and in bf16, cuDNN takes an implicit GEMM at batches 1-8
# and is as fast or faster (``scripts/torch_port_conv_workspace.py --sweep``).
CUDNN_FFT_FROM_BATCH = {(128, 128, 128): 5}


class Upsample(nn.Module):
    """Bilinear ×2 in float32 with half-pixel centres, then a 3×3 conv.

    On the card, a float32 conv that cuDNN would run as an FFT
    (:data:`CUDNN_FFT_FROM_BATCH`, keyed on the shape the conv is given:
    under a spatial shard a strip, which that table does not name) runs
    with cuDNN off, as PyTorch's own convolution.

    Under a spatial shard the strip of L rows takes one halo row on each
    side, copies of the edge row at the image's border (the clamp of JAX's
    ``jax.image.resize``, as of ``F.interpolate``), and output rows [2,
    2L + 2) of the 2L + 4 that the resize makes of the L + 2 are this
    rank's: each of them reads rows of the padded strip only."""

    def __init__(self, channels: int, act_quant=False):
        super().__init__()
        self.conv = QConv(channels, channels, 3, padding=1, act_quant=act_quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current_spatial()
        xf = upcast(x if shard is None else halo_rows(x, 1, 1, "replicate", shard))
        up = F.interpolate(xf, scale_factor=2, mode="bilinear",
                           align_corners=False, antialias=False)
        if shard is not None:
            up = up[:, :, 2:up.shape[2] - 2]
        up = up.to(x.dtype)
        if (self.conv.compute_dtype is None and up.is_cuda
                and up.shape[0] >= CUDNN_FFT_FROM_BATCH.get(tuple(up.shape[1:]),
                                                             math.inf)):
            cudnn = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = False
            try:
                return self.conv(up)
            finally:
                torch.backends.cudnn.enabled = cudnn
        return self.conv(up)
