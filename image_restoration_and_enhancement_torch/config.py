"""Model / scheduler configuration dataclasses (the PyTorch port's own copy).

Field for field the same presets as the JAX package's ``config.py``: the
SD-v1.5 UNet (block_out 320/640/1280/1280, 8 heads, cross dim 768), the
AutoencoderKL (block_out 128/256/512/512, scaling 0.18215), the CLIP ViT-L/14
text encoder, the scheduler defaults, SDXL, and the ``TINY_*`` variants the
CPU tests use. Kept as a copy so the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Config for the conditional UNet (reference: denoising/best/unet/config.json;
    SDXL variant per the reference trainer's SDXL branch, train_denoising.py:531-594)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Diffusers SD1.5 quirk: `attention_head_dim: 8` actually means 8 *heads*
    # per attention layer (head_dim = channels // 8 = 40/80/160). SDXL uses
    # a per-level tuple (5, 10, 20) with head_dim 64.
    num_attention_heads: int | Tuple[int, ...] = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    # transformer depth per cross-attn level; SD1.5: 1, SDXL: (1, 2, 10)
    transformer_layers_per_block: int | Tuple[int, ...] = 1
    # Which resolution levels carry cross-attention transformers. SD1.5:
    # down = (CrossAttn, CrossAttn, CrossAttn, Plain), up mirrored.
    # SDXL: (Plain, CrossAttn, CrossAttn).
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    sample_size: int = 64
    # SDXL additive conditioning: pooled text embeds + micro-conditioning
    # time ids, projected and added to the timestep embedding.
    addition_embed_type: Optional[str] = None  # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    # SDXL Transformer2D uses Dense spatial projections instead of 1x1 convs
    use_linear_projection: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_at(self, level: int) -> int:
        if isinstance(self.num_attention_heads, tuple):
            return self.num_attention_heads[level]
        return self.num_attention_heads

    def tx_depth_at(self, level: int) -> int:
        if isinstance(self.transformer_layers_per_block, tuple):
            return self.transformer_layers_per_block[level]
        return self.transformer_layers_per_block


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Config for AutoencoderKL (reference: denoising/best/vae/config.json)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    mid_block_add_attention: bool = True
    sample_size: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Config for the CLIP text encoder (reference: best/text_encoder/config.json)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    pad_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Noise schedule config shared by DDPM/DDIM/PLMS.

    Values mirror the reference's committed scheduler configs
    (scaled_linear betas 0.00085 -> 0.012, 1000 train steps, epsilon
    prediction, steps_offset 1, "leading" spacing, set_alpha_to_one False).
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    set_alpha_to_one: bool = False


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

SD15_UNET = UNetConfig()
SD15_INPAINT_UNET = dataclasses.replace(SD15_UNET, in_channels=9)
SD15_VAE = VAEConfig()
CLIP_VIT_L_TEXT = CLIPTextConfig()
SD15_SCHEDULER = SchedulerConfig()

# SDXL base: the reference trainer's --base_model SDXL branch
# (train_denoising.py:531-594). 3 levels, transformer depth (1,2,10),
# head_dim 64 (heads 5/10/20), dual-text cross dim 2048, text_time
# additive conditioning (pooled 1280 + 6x256 time ids -> 2816).
SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    layers_per_block=2,
    num_attention_heads=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    attn_levels=(False, True, True),
    cross_attention_dim=2048,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
    use_linear_projection=True,
    sample_size=128,
)
# OpenCLIP ViT-bigG/14 text tower (SDXL's second encoder)
OPENCLIP_BIGG_TEXT = CLIPTextConfig(
    vocab_size=49408,
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
)

# Tiny configs for CPU tests: same topology, minimal widths.
TINY_UNET = UNetConfig(
    block_out_channels=(8, 16, 16, 16),
    layers_per_block=1,
    num_attention_heads=2,
    cross_attention_dim=16,
    norm_num_groups=4,
    sample_size=8,
)
TINY_INPAINT_UNET = dataclasses.replace(TINY_UNET, in_channels=9)
TINY_VAE = VAEConfig(
    block_out_channels=(8, 8, 16, 16),
    layers_per_block=1,
    norm_num_groups=4,
    sample_size=32,
)
TINY_SDXL_UNET = UNetConfig(
    block_out_channels=(8, 16, 16),
    layers_per_block=1,
    num_attention_heads=(2, 2, 2),
    transformer_layers_per_block=(1, 1, 2),
    attn_levels=(False, True, True),
    cross_attention_dim=16,
    norm_num_groups=4,
    addition_embed_type="text_time",
    addition_time_embed_dim=4,
    projection_class_embeddings_input_dim=8 + 6 * 4,  # pooled 8 + 6 ids x 4
    use_linear_projection=True,
    sample_size=8,
)
TINY_CLIP_TEXT = CLIPTextConfig(
    vocab_size=128,
    hidden_size=16,
    intermediate_size=32,
    num_hidden_layers=2,
    num_attention_heads=2,
    max_position_embeddings=77,
    bos_token_id=0,
    eos_token_id=2,
    pad_token_id=1,
)


@dataclasses.dataclass(frozen=True)
class SDModelConfig:
    """Bundle of the full Stable-Diffusion model stack for one task.

    text_encoder_2 is the SDXL dual-tower second encoder (OpenCLIP bigG);
    None for SD1.x stacks."""

    unet: UNetConfig = SD15_UNET
    vae: VAEConfig = SD15_VAE
    text_encoder: CLIPTextConfig = CLIP_VIT_L_TEXT
    scheduler: SchedulerConfig = SD15_SCHEDULER
    text_encoder_2: Optional[CLIPTextConfig] = None


SD15 = SDModelConfig()
SD15_INPAINT = SDModelConfig(unet=SD15_INPAINT_UNET)
SDXL_VAE = dataclasses.replace(SD15_VAE, scaling_factor=0.13025)
SDXL = SDModelConfig(
    unet=SDXL_UNET,
    vae=SDXL_VAE,
    text_encoder=CLIP_VIT_L_TEXT,
    text_encoder_2=OPENCLIP_BIGG_TEXT,
)
TINY_SD = SDModelConfig(unet=TINY_UNET, vae=TINY_VAE, text_encoder=TINY_CLIP_TEXT)
TINY_SD_INPAINT = SDModelConfig(
    unet=TINY_INPAINT_UNET, vae=TINY_VAE, text_encoder=TINY_CLIP_TEXT
)
TINY_SDXL_TEXT2 = dataclasses.replace(TINY_CLIP_TEXT, hidden_size=8, num_attention_heads=2, intermediate_size=16)
TINY_SDXL = SDModelConfig(
    unet=TINY_SDXL_UNET, vae=TINY_VAE,
    # context dim = 8 (L tower penultimate) + 8 (bigG penultimate) = 16
    text_encoder=TINY_SDXL_TEXT2, text_encoder_2=TINY_SDXL_TEXT2,
)

# Named presets for CLI/config surfaces (e.g. RestorationPipeline's
# per-task "model_config" key, scripts/_train_cli.py --base_model).
PRESETS = {
    "sd15": SD15,
    "sd15_inpaint": SD15_INPAINT,
    "sdxl": SDXL,
    "tiny_sd": TINY_SD,
    "tiny_sd_inpaint": TINY_SD_INPAINT,
    "tiny_sdxl": TINY_SDXL,
}


def _dataclass_from_dict(cls, d):
    """Rebuild a (frozen) config dataclass from its asdict() form; lists
    come back from JSON where tuples were, so coerce."""
    if d is None:
        return None
    if isinstance(d, cls):
        return d
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


def model_config_from_dict(d: dict) -> SDModelConfig:
    """Rebuild an SDModelConfig from `dataclasses.asdict(cfg)` (as stored in
    a pipeline checkpoint's model_index.json) — makes checkpoints
    self-describing so RestorationPipeline can serve e.g. an SDXL fine-tune
    without per-task config."""
    return SDModelConfig(
        unet=_dataclass_from_dict(UNetConfig, d.get("unet")) or SD15_UNET,
        vae=_dataclass_from_dict(VAEConfig, d.get("vae")) or SD15_VAE,
        text_encoder=_dataclass_from_dict(CLIPTextConfig, d.get("text_encoder"))
        or CLIP_VIT_L_TEXT,
        scheduler=_dataclass_from_dict(SchedulerConfig, d.get("scheduler"))
        or SD15_SCHEDULER,
        text_encoder_2=_dataclass_from_dict(
            CLIPTextConfig, d.get("text_encoder_2")
        ),
    )
