"""EfficientUNet — 4-level time-conditioned UNet, NCHW.

Counterpart of ``cv_diffusion_tpu/models/unet.py`` with the same topology:
per encoder level ``num_res_blocks`` IRBs (each followed by linear attention
when the level's resolution is in ``attention_resolutions``), the skip pushed
before the stride-2 downsample; middle IRB → attention → IRB; per decoder
level an upsample (after the first), the concat ``[h, skip]`` and
``num_res_blocks + 1`` IRBs; then GN → SiLU → 3×3 conv. At 256² the only
attention is ``mid_attn``. Module names are the reference torch ones
(``encoder_blocks.{l}.{i}``, ``downsamplers.{l}.down``, ``time_mlp.1``, …).

``config.dtype`` is the compute dtype (float32 parameters cast at each use,
``blocks.set_compute_dtype``): the input is cast to it, and the output has
it. ``config.act_quant`` makes every convolution of JAX's ``QConv`` sites
(the IRBs' four, attention's two, the Down/Upsample convs, ``init_conv``
and ``final_conv``) compute in its mode (``ops/qconv.py``): int8
(``True``) or fake-quant (``"fake"``). ``config.remat`` rematerialises the IRBs and attention blocks in the
backward (``torch.utils.checkpoint``, non-reentrant), those of
``remat_scope`` ``"all"`` or ``"decoder"`` (the JAX names starting ``mid``
or ``dec``: the middle and decoder blocks), saving nothing (``remat_policy
"full"``) or only the convolutions' outputs (``"conv"``), as
``cv_diffusion_tpu/models/unet.py:51-104``. It acts only where a gradient
is being recorded; a forward without one runs the blocks as they are.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import UNetConfig
from ..ops.qconv import QConv
from .blocks import (Downsample, GroupNorm, InvertedResidualBlock,
                     LinearAttentionBlock, TimeEmbedding, Upsample,
                     compute_dtype, set_compute_dtype, silu)

_UNPORTED = (
    ("split_skip", "the split_skip graph rewrite (ROADMAP queue 1 item 7)"),
)
ACT_QUANT_MODES = (False, True, "fake")
REMAT_POLICIES = ("full", "conv")
REMAT_SCOPES = ("all", "decoder")


def check_ported(config: UNetConfig) -> None:
    """Raise ``NotImplementedError`` for any path the port does not have
    yet (it never runs another path in its place), and ``ValueError`` for a
    dtype other than float32 and bfloat16, an ``act_quant`` other than
    False, True and ``"fake"`` or, with remat, an unknown scope or policy
    (the JAX package's messages)."""
    for name, what in _UNPORTED:
        if getattr(config, name):
            raise NotImplementedError(f"UNetConfig.{name}: {what} is not ported")
    if config.act_quant not in ACT_QUANT_MODES:
        raise ValueError(f"UNetConfig.act_quant={config.act_quant!r}: one of "
                         f"{ACT_QUANT_MODES}")
    if not config.use_linear_attention:
        raise NotImplementedError(
            "standard softmax attention is not ported (ROADMAP queue 1 item 7)")
    compute_dtype(config.dtype)
    if config.remat:
        if config.remat_scope not in REMAT_SCOPES:
            raise ValueError(f"Unknown remat_scope: {config.remat_scope!r}")
        if config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Unknown remat_policy: {config.remat_policy!r}")


def _save_conv_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="conv"``: keep every convolution's output, recompute
    the rest (JAX ``save_only_these_names("conv_out")`` over the tagged
    QConv outputs, ``ops/qconv.py:93-98``)."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def rematerialised(block: nn.Module, args: Tuple, policy: str,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``block(*args)`` whose activations are recomputed in the backward
    (``policy`` ``"full"``: nothing kept; ``"conv"``: the convolutions'
    outputs kept). Dropout draws from ``generator``, an explicit generator
    that ``preserve_rng_state`` does not cover: the recompute starts it
    where the forward did, so it draws the same masks, and hands it back
    where it was."""
    fn = block
    if generator is not None:
        start, calls = generator.get_state(), []

        def fn(*a):
            now = generator.get_state() if calls else None
            if now is not None:
                generator.set_state(start)
            calls.append(None)
            try:
                return block(*a)
            finally:
                if now is not None:
                    generator.set_state(now)
    kwargs = {}
    if policy == "conv":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_conv_outputs)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=True,
                      **kwargs)


class EfficientUNet(nn.Module):
    """``forward(x [B, C, H, W], timestep [B]) → [B, out_channels, H, W]``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        check_ported(config)
        self.config = config
        self.compute_dtype = compute_dtype(config.dtype)
        ch = config.channels
        tdim = config.time_embed_dim
        aq = config.act_quant

        def irb(cin, cout):
            return InvertedResidualBlock(
                cin, cout, tdim, expansion_ratio=config.expansion_ratio,
                use_se=config.use_se, se_ratio=config.se_ratio,
                quantization_friendly=config.quantization_friendly,
                dropout=config.dropout, use_pallas_irb=config.use_pallas_irb,
                fold_gn=config.fold_gn, act_quant=aq)

        def attention(c):
            return LinearAttentionBlock(c, config.num_attention_heads,
                                        config.attention_head_dim, act_quant=aq)

        self.time_mlp = TimeEmbedding(config.base_channels, tdim)
        self.init_conv = QConv(config.in_channels, ch[0], 3, padding=1,
                               act_quant=aq)

        res = config.image_size
        cur = ch[0]
        skip_channels = []
        self.encoder_blocks = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        for level, out_ch in enumerate(ch):
            blocks = nn.ModuleList()
            for _ in range(config.num_res_blocks):
                blocks.append(irb(cur, out_ch))
                cur = out_ch
                if res in config.attention_resolutions:
                    blocks.append(attention(cur))
            self.encoder_blocks.append(blocks)
            skip_channels.append(cur)
            if level < len(ch) - 1:
                self.downsamplers.append(Downsample(cur, act_quant=aq))
                res //= 2

        self.mid_block1 = irb(cur, ch[-1])
        self.mid_attn = attention(ch[-1])
        self.mid_block2 = irb(ch[-1], ch[-1])
        cur = ch[-1]

        self.decoder_blocks = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        for level, out_ch in enumerate(reversed(ch)):
            blocks = nn.ModuleList()
            cin = cur + skip_channels.pop()
            for _ in range(config.num_res_blocks + 1):
                blocks.append(irb(cin, out_ch))
                cin = out_ch
                if res in config.attention_resolutions:
                    blocks.append(attention(out_ch))
            self.decoder_blocks.append(blocks)
            cur = out_ch
            if level < len(ch) - 1:
                self.upsamplers.append(Upsample(cur, act_quant=aq))
                res *= 2

        self.final_norm = GroupNorm(cur)
        self.final_conv = QConv(cur, config.out_channels, 3, padding=1,
                                act_quant=aq)
        set_compute_dtype(self, self.compute_dtype)
        # remat by JAX block name: the encoder's only under scope "all"
        self.remat_encoder = config.remat and config.remat_scope == "all"
        self.remat_decoder = config.remat

    def _run(self, blocks, h: torch.Tensor, t_emb: torch.Tensor,
             generator: Optional[torch.Generator], remat: bool) -> torch.Tensor:
        """The IRBs and attention blocks ``blocks`` in order, each
        rematerialised when ``remat`` and a gradient is being recorded."""
        remat = remat and torch.is_grad_enabled()
        for block in blocks:
            irb = isinstance(block, InvertedResidualBlock)
            args = (h, t_emb, generator) if irb else (h,)
            if not remat:
                h = block(*args)
            else:
                h = rematerialised(block, args, self.config.remat_policy,
                                   generator if irb and block.dropout > 0 else None)
        return h

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        t_emb = self.time_mlp(timestep)
        h = self.init_conv(x)
        skips = []
        for level, blocks in enumerate(self.encoder_blocks):
            h = self._run(blocks, h, t_emb, generator, self.remat_encoder)
            skips.append(h)
            if level < len(self.downsamplers):
                h = self.downsamplers[level](h)

        h = self._run((self.mid_block1, self.mid_attn, self.mid_block2), h,
                      t_emb, generator, self.remat_decoder)

        for level, blocks in enumerate(self.decoder_blocks):
            if level > 0:
                h = self.upsamplers[level - 1](h)
            h = torch.cat([h, skips.pop()], dim=1)
            h = self._run(blocks, h, t_emb, generator, self.remat_decoder)

        h = silu(self.final_norm(h))
        return self.final_conv(h)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
