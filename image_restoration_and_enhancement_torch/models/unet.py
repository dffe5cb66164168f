"""UNet2DCondition — the SD-1.5 (4- or 9-channel) and SDXL denoising UNet, in PyTorch.

Counterpart of the JAX package's ``models/unet.py`` (859,520,964 parameters at
the SD15 preset, 859,535,364 at SD15_INPAINT: ``conv_in`` takes the 9-channel
inpaint input and stays a plain conv, never quantized; 2,567,463,684 at SDXL).
``forward`` takes and returns NHWC tensors like the JAX module; inside,
activations are NCHW-shaped in the channels_last format (see ``layers.py``).
The output is fp32. ``attention_backend`` reaches every cross-attention site,
as in the JAX module; the quantized layers carry their flax paths as sites
(``layers.assign_sites``).

SDXL is the same module under another ``UNetConfig``: per-level heads and
transformer depths (``heads_at``, ``tx_depth_at``), no attention at level 0,
Linear spatial projections (``use_linear_projection``) and the ``text_time``
added conditioning (``add_embedding``: the pooled text concatenated with the
sinusoidal embedding of the six micro-conditioning ids, added to the time
embedding). ``cfg_dedup`` runs the CFG halves' shared prefix once (see
``forward``). Under autograd the down, mid and up blocks run under activation
checkpointing, as the JAX module's ``remat`` (``_run_block``); serving, under
``inference_mode``, runs them plainly. Under a height-sharding policy
(``parallel/spatial.py``) ``sample`` holds this rank's rows of the request's
latent height, and so does the output.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..config import UNetConfig
from ..parallel import spatial
from .layers import (
    Conv2d,
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
                          cfg.norm_num_groups, attention_backend, cfg.use_linear_projection)
            for _ in range(n)
        ) if cfg.attn_levels[level] else None
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels)]) if add_downsample else None
        )

    def forward(self, x, t_emb, context, cfg_dedup: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Returns (x, this block's skip connections in order). ``cfg_dedup``:
        ``x`` arrives at half the batch of ``t_emb`` and ``context``; the
        first resnet and self-attention run on it, and the first transformer
        block duplicates it."""
        half = x.shape[0]
        skips = []
        for i, resnet in enumerate(self.resnets):
            dedup_here = cfg_dedup and i == 0
            x = resnet(x, t_emb[:half] if dedup_here else t_emb)
            if self.attentions is not None:
                x = self.attentions[i](x, context, dedup_here)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, tuple(skips)


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
                          cfg.tx_depth_at(level), cfg.norm_num_groups, attention_backend,
                          cfg.use_linear_projection)
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
                          cfg.norm_num_groups, attention_backend, cfg.use_linear_projection)
            for _ in skip_channels
        ) if cfg.attn_levels[level] else None
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, skips: Tuple[torch.Tensor, ...], t_emb, context):
        """``skips``: this block's skip connections, deepest last (taken in
        reverse). A tuple, not a list the block pops: a checkpointed block
        runs twice, and the recompute must see the same skips."""
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-1 - i]], dim=1), t_emb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DCondition(nn.Module):
    """epsilon-prediction UNet conditioned on timestep + text embeddings.

    forward(sample [B, H, W, Cin], timesteps [B] or scalar, context [B, 77, D],
            added_cond=None, cfg_dedup=False) -> eps [B, H, W, Cout] in fp32.
    """

    def __init__(self, config: UNetConfig, attention_backend: Optional[str] = None):
        super().__init__()
        if config.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unknown addition_embed_type {config.addition_embed_type!r}")
        cfg = self.config = config
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.add_embedding = (
            TimestepEmbedding(cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)
            if cfg.addition_embed_type == "text_time" else None)

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
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        assign_sites(self)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, added_cond: Optional[dict] = None,
                cfg_dedup: bool = False) -> torch.Tensor:
        """``added_cond`` (SDXL only): {"text_embeds": [B, pooled], "time_ids":
        [B, 6]}.

        ``cfg_dedup``: the classifier-free-guidance prefix dedup. ``sample``
        and ``timesteps`` arrive at half the context batch; the uncond and
        cond halves are identical through ``conv_in``, the first level-0
        resnet and its self-attention (only the text context differs), so
        that prefix runs once and the batch is duplicated as [x; x] at the
        first cross-attention. The output has the context's batch. It needs
        attention at level 0 and no ``text_time`` conditioning (the pooled
        text feeds the time embedding that the prefix takes)."""
        cfg = self.config
        if cfg_dedup and cfg.addition_embed_type == "text_time":
            raise ValueError("cfg_dedup is unsupported with SDXL text_time conditioning")
        if cfg_dedup and not cfg.attn_levels[0]:
            raise ValueError("cfg_dedup needs cross-attention in down level 0")
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        t_emb = self.time_embedding(t_emb.to(dtype))
        if self.add_embedding is not None:
            if added_cond is None:
                raise ValueError("an SDXL UNet needs added_cond")
            time_ids = added_cond["time_ids"].to(t_emb.device)
            b, n_ids = time_ids.shape
            id_emb = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                        cfg.flip_sin_to_cos, cfg.freq_shift)
            add_emb = torch.cat([added_cond["text_embeds"].to(t_emb.device).float(),
                                 id_emb.reshape(b, n_ids * cfg.addition_time_embed_dim)], -1)
            t_emb = t_emb + self.add_embedding(add_emb.to(dtype))

        spatial.begin("latent")
        x = self.conv_in(from_nhwc(sample.to(dtype).contiguous()))
        if cfg_dedup:
            # the up path takes this skip at the full batch; t_emb's rows are
            # equal across the halves (one timestep)
            skips = (torch.cat([x, x], dim=0),)
            t_emb = torch.cat([t_emb, t_emb], dim=0)
        else:
            skips = (x,)
        run = self._run_block
        for i, block in enumerate(self.down_blocks):
            x, new_skips = run(block, x, t_emb, context, cfg_dedup and i == 0)
            skips += new_skips
        x = run(self.mid_block, x, t_emb, context)
        for block in self.up_blocks:
            n = len(block.resnets)
            x = run(block, x, skips[-n:], t_emb, context)
            skips = skips[:-n]
        if skips:
            raise RuntimeError("skip connection bookkeeping mismatch")
        x = self.conv_out(self.conv_norm_out(x))
        return to_nhwc(x).float()

    def _run_block(self, block: nn.Module, *args):
        """``block(*args)``; while autograd records, under activation
        checkpointing (the JAX module's ``nn.remat`` of the down, mid and up
        blocks, which its trainer always turns on): the block keeps only its
        inputs, and the backward pass runs it again."""
        if torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)
