"""EfficientUNet — 4-level time-conditioned UNet, NCHW.

Counterpart of ``cv_diffusion_tpu/models/unet.py`` with the same topology:
per encoder level ``num_res_blocks`` IRBs (each followed by linear attention
when the level's resolution is in ``attention_resolutions``), the skip pushed
before the stride-2 downsample; middle IRB → attention → IRB; per decoder
level an upsample (after the first), the concat ``[h, skip]`` and
``num_res_blocks + 1`` IRBs; then GN → SiLU → 3×3 conv. At 256² the only
attention is ``mid_attn``. Module names are the reference torch ones
(``encoder_blocks.{l}.{i}``, ``downsamplers.{l}.down``, ``time_mlp.1``, …).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import UNetConfig
from .blocks import (Downsample, GroupNorm, InvertedResidualBlock,
                     LinearAttentionBlock, TimeEmbedding, Upsample)

_UNPORTED = (
    ("split_skip", "the split_skip graph rewrite (ROADMAP queue 1 item 7)"),
    ("act_quant", "int8 activation compute (ROADMAP queue 1 item 6)"),
    ("remat", "rematerialisation for training (ROADMAP queue 1 item 4)"),
)


def check_ported(config: UNetConfig) -> None:
    """Raise ``NotImplementedError`` for any path the port does not have
    yet; it never runs another path in its place."""
    for name, what in _UNPORTED:
        if getattr(config, name):
            raise NotImplementedError(f"UNetConfig.{name}: {what} is not ported")
    if not config.use_linear_attention:
        raise NotImplementedError(
            "standard softmax attention is not ported (ROADMAP queue 1 item 7)")
    if config.dtype != "float32":
        raise NotImplementedError(
            f"UNet dtype {config.dtype!r}: only float32 is ported; bf16 "
            "compute comes with the codecs (ROADMAP queue 1 item 3)")


class EfficientUNet(nn.Module):
    """``forward(x [B, C, H, W], timestep [B]) → [B, out_channels, H, W]``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        check_ported(config)
        self.config = config
        ch = config.channels
        tdim = config.time_embed_dim

        def irb(cin, cout):
            return InvertedResidualBlock(
                cin, cout, tdim, expansion_ratio=config.expansion_ratio,
                use_se=config.use_se, se_ratio=config.se_ratio,
                quantization_friendly=config.quantization_friendly,
                dropout=config.dropout, use_pallas_irb=config.use_pallas_irb,
                fold_gn=config.fold_gn)

        def attention(c):
            return LinearAttentionBlock(c, config.num_attention_heads,
                                        config.attention_head_dim)

        self.time_mlp = TimeEmbedding(config.base_channels, tdim)
        self.init_conv = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)

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
                self.downsamplers.append(Downsample(cur))
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
                self.upsamplers.append(Upsample(cur))
                res *= 2

        self.final_norm = GroupNorm(cur)
        self.final_conv = nn.Conv2d(cur, config.out_channels, 3, padding=1)

    @staticmethod
    def _run(blocks: nn.ModuleList, h: torch.Tensor, t_emb: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        for block in blocks:
            if isinstance(block, InvertedResidualBlock):
                h = block(h, t_emb, generator)
            else:
                h = block(h)
        return h

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        t_emb = self.time_mlp(timestep)
        h = self.init_conv(x)
        skips = []
        for level, blocks in enumerate(self.encoder_blocks):
            h = self._run(blocks, h, t_emb, generator)
            skips.append(h)
            if level < len(self.downsamplers):
                h = self.downsamplers[level](h)

        h = self.mid_block1(h, t_emb, generator)
        h = self.mid_attn(h)
        h = self.mid_block2(h, t_emb, generator)

        for level, blocks in enumerate(self.decoder_blocks):
            if level > 0:
                h = self.upsamplers[level - 1](h)
            h = torch.cat([h, skips.pop()], dim=1)
            h = self._run(blocks, h, t_emb, generator)

        h = F.silu(self.final_norm(h))
        return self.final_conv(h)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
