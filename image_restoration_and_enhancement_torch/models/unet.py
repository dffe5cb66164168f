"""UNet2DCondition — the SD-v1.5 denoising UNet (4- or 9-channel), in PyTorch.

Counterpart of the JAX package's ``models/unet.py`` (859,520,964 parameters at
the SD15 preset, 859,535,364 at SD15_INPAINT: ``conv_in`` takes the 9-channel
inpaint input and stays a plain conv, never quantized). ``forward`` takes and returns NHWC tensors like the JAX
module; inside, activations are NCHW-shaped in the channels_last format (see
``layers.py``). The output is fp32. ``attention_backend`` reaches every
cross-attention site, as in the JAX module; the quantized layers carry their
flax paths as sites (``layers.assign_sites``). The SDXL ``text_time``
conditioning, the linear-projection transformer and the CFG prefix dedup are
not ported yet.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from ..config import UNetConfig
from .layers import (
    Downsample2D,
    FusedGroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    assign_sites,
    from_nhwc,
    timestep_embedding,
    to_nhwc,
)


class CrossAttnDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: UNetConfig, level: int,
                 add_downsample: bool, attention_backend: Optional[str] = None):
        super().__init__()
        n, temb = cfg.layers_per_block, cfg.time_embed_dim
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                          cfg.norm_num_groups, cfg.norm_eps, temb)
            for i in range(n)
        )
        heads = cfg.heads_at(level)
        self.attentions = nn.ModuleList(
            Transformer2D(out_channels, heads, out_channels // heads,
                          cfg.cross_attention_dim, cfg.tx_depth_at(level),
                          cfg.norm_num_groups, attention_backend)
            for _ in range(n)
        ) if cfg.attn_levels[level] else None
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels)]) if add_downsample else None
        )

    def forward(self, x, t_emb, context, skips: List[torch.Tensor]):
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, t_emb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x


class UNetMidBlock(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, attention_backend: Optional[str] = None):
        super().__init__()
        level = len(cfg.block_out_channels) - 1
        heads = cfg.heads_at(level)
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, cfg.norm_num_groups, cfg.norm_eps,
                          cfg.time_embed_dim)
            for _ in range(2)
        )
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, channels // heads, cfg.cross_attention_dim,
                          cfg.tx_depth_at(level), cfg.norm_num_groups, attention_backend)
        ])

    def forward(self, x, t_emb, context):
        x = self.resnets[0](x, t_emb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, t_emb)


class CrossAttnUpBlock(nn.Module):
    def __init__(self, in_channels: int, skip_channels: List[int], out_channels: int,
                 cfg: UNetConfig, level: int, add_upsample: bool,
                 attention_backend: Optional[str] = None):
        super().__init__()
        temb = cfg.time_embed_dim
        chans = [in_channels] + [out_channels] * (len(skip_channels) - 1)
        self.resnets = nn.ModuleList(
            ResnetBlock2D(c + s, out_channels, cfg.norm_num_groups, cfg.norm_eps, temb)
            for c, s in zip(chans, skip_channels)
        )
        heads = cfg.heads_at(level)
        self.attentions = nn.ModuleList(
            Transformer2D(out_channels, heads, out_channels // heads,
                          cfg.cross_attention_dim, cfg.tx_depth_at(level),
                          cfg.norm_num_groups, attention_backend)
            for _ in skip_channels
        ) if cfg.attn_levels[level] else None
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, skips: List[torch.Tensor], t_emb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), t_emb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DCondition(nn.Module):
    """epsilon-prediction UNet conditioned on timestep + text embeddings.

    forward(sample [B, H, W, Cin], timesteps [B] or scalar, context [B, 77, D])
      -> eps [B, H, W, Cout] in fp32.
    """

    def __init__(self, config: UNetConfig, attention_backend: Optional[str] = None):
        super().__init__()
        if config.addition_embed_type is not None or config.use_linear_projection:
            raise NotImplementedError(
                "SDXL UNets (text_time conditioning, linear projections) are "
                "ROADMAP item M13 and not ported yet"
            )
        cfg = self.config = config
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)

        n_levels = len(ch)
        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, out_ch in enumerate(ch):
            self.down_blocks.append(
                CrossAttnDownBlock(prev, out_ch, cfg, i, add_downsample=i < n_levels - 1,
                                   attention_backend=attention_backend))
            skip_ch += [out_ch] * (cfg.layers_per_block + (1 if i < n_levels - 1 else 0))
            prev = out_ch
        self.mid_block = UNetMidBlock(ch[-1], cfg, attention_backend)

        self.up_blocks = nn.ModuleList()
        n_up = cfg.layers_per_block + 1
        for i, out_ch in enumerate(reversed(ch)):
            level = n_levels - 1 - i
            blk_skips = list(reversed(skip_ch[-n_up:]))
            del skip_ch[-n_up:]
            self.up_blocks.append(CrossAttnUpBlock(
                prev, blk_skips, out_ch, cfg, level, add_upsample=i < n_levels - 1,
                attention_backend=attention_backend))
            prev = out_ch
        self.conv_norm_out = FusedGroupNorm(ch[0], cfg.norm_num_groups, cfg.norm_eps,
                                            act="silu")
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        assign_sites(self)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        t_emb = self.time_embedding(t_emb.to(dtype))

        x = self.conv_in(from_nhwc(sample.to(dtype).contiguous()))
        skips = [x]
        for block in self.down_blocks:
            x = block(x, t_emb, context, skips)
        x = self.mid_block(x, t_emb, context)
        for block in self.up_blocks:
            x = block(x, skips, t_emb, context)
        if skips:
            raise RuntimeError("skip connection bookkeeping mismatch")
        x = self.conv_out(self.conv_norm_out(x))
        return to_nhwc(x).float()
