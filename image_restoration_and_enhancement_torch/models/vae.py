"""AutoencoderKL — the SD VAE, in PyTorch.

Counterpart of the JAX package's ``models/vae.py``: the diffusers encoder and
decoder with an asymmetric (0, 1)-pad VALID stride-2 downsample, quant convs,
logvar clipped to [-30, 20], and GroupNorm eps 1e-6 throughout. ``encode`` and
``decode`` take and return NHWC tensors like the JAX module; scaling by
``scaling_factor`` is the caller's job. The resnet convs and upsamplers are
quantized layers (sites ``encoder/...``, ``decoder/...``); the IO convs, the
asymmetric downsample, the quant convs and the mid-block attention stay full
precision, as in the JAX module. Under a height-sharding policy
(``parallel/spatial.py``) ``encode`` takes this rank's rows of the request's
image height and ``decode`` of its latent height, and each returns its rows of
the output's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VAEConfig
from ..parallel import spatial
from .layers import (
    Conv2d,
    FusedGroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAEAttentionBlock,
    assign_sites,
    from_nhwc,
    to_nhwc,
)


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, with the standard-normal ``noise`` given by the caller."""
        return self.mean + torch.exp(0.5 * self.logvar) * noise

    @property
    def mode(self) -> torch.Tensor:
        return self.mean


class _VAEDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.active() is not None:
            return spatial.conv(self.conv, x, vae_pad=True)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownEncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, groups: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, groups, 1e-6)
            for i in range(num_layers)
        )
        self.downsamplers = nn.ModuleList([_VAEDownsample(out_ch)]) if add_downsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class _UpDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, groups: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, groups, 1e-6)
            for i in range(num_layers)
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, add_attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, groups, 1e-6) for _ in range(2))
        self.attentions = (
            nn.ModuleList([VAEAttentionBlock(channels, groups)]) if add_attention else None
        )

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _DownEncoderBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block,
                              cfg.norm_num_groups, add_downsample=i < len(ch) - 1)
            for i, c in enumerate(ch)
        )
        self.mid_block = _MidBlock(ch[-1], cfg.norm_num_groups, cfg.mid_block_add_attention)
        self.conv_norm_out = FusedGroupNorm(ch[-1], cfg.norm_num_groups, 1e-6, act="silu")
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], cfg.norm_num_groups, cfg.mid_block_add_attention)
        self.up_blocks = nn.ModuleList(
            _UpDecoderBlock(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1,
                            cfg.norm_num_groups, add_upsample=i < len(rev) - 1)
            for i, c in enumerate(rev)
        )
        self.conv_norm_out = FusedGroupNorm(rev[-1], cfg.norm_num_groups, 1e-6, act="silu")
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """KL VAE with quant convs, diffusers-compatible semantics (NHWC in and out)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        assign_sites(self)

    def encode(self, images: torch.Tensor) -> DiagonalGaussian:
        """images [B, H, W, 3] in [-1, 1] -> posterior with fp32 NHWC mean/logvar."""
        spatial.begin("image")
        x = from_nhwc(images.to(self.quant_conv.weight.dtype).contiguous())
        moments = to_nhwc(self.quant_conv(self.encoder(x))).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, torch.clamp(logvar, -30.0, 20.0))

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in fp32."""
        spatial.begin("latent")
        z = from_nhwc(latents.to(self.post_quant_conv.weight.dtype).contiguous())
        return to_nhwc(self.decoder(self.post_quant_conv(z))).float()
