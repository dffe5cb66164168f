"""The four-task registry: prompts, sampler defaults, conditioning (the port's copy).

A copy of the JAX package's ``tasks/registry.py``: default prompts and sampler
settings per task (denoise / sr_x4 / colorize / inpaint), the reference's task
aliases, and the soft-conditioning latent blend on torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..config import SD15, SD15_INPAINT, SDModelConfig


@dataclasses.dataclass(frozen=True)
class SamplerDefaults:
    strength: float
    num_inference_steps: int
    guidance_scale: float
    sampler: str  # "plms" | "ddim"


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Static description of one restoration task."""

    name: str
    pair_dir: str  # data/pairs/<pair_dir>/{split}/...
    model_dir: str  # outputs/models/<model_dir>/best
    prompt: str
    sampler: SamplerDefaults
    model_config: SDModelConfig
    uses_mask: bool = False
    # validation-time sampler settings (the trainers validate with different
    # knobs than inference defaults; e.g. train_denoising.py:399-406)
    val_sampler: Optional[SamplerDefaults] = None
    # metric extras
    with_y_metrics: bool = False
    with_color_metrics: bool = False


TASKS: Dict[str, TaskSpec] = {
    "denoise": TaskSpec(
        name="denoise",
        pair_dir="denoise",
        model_dir="denoising",
        prompt="clean high quality photo, no noise, sharp details",
        sampler=SamplerDefaults(0.5, 20, 5.0, "plms"),
        val_sampler=SamplerDefaults(0.3, 20, 5.0, "plms"),
        model_config=SD15,
        with_y_metrics=True,
    ),
    "sr_x4": TaskSpec(
        name="sr_x4",
        pair_dir="sr_x4",
        model_dir="super_resolution",
        prompt="high quality, detailed, sharp",
        # diffusers img2img default strength 0.8; the reference passes none.
        sampler=SamplerDefaults(0.8, 20, 0.0, "plms"),
        val_sampler=SamplerDefaults(0.3, 25, 3.5, "plms"),
        model_config=SD15,
        with_y_metrics=True,
    ),
    "colorize": TaskSpec(
        name="colorize",
        pair_dir="colorize",
        model_dir="colorization",
        prompt=(
            "vibrant realistic natural colors, colorful, high quality photo, "
            "detailed, full color, rich colors"
        ),
        sampler=SamplerDefaults(0.75, 30, 7.5, "plms"),
        val_sampler=SamplerDefaults(0.6, 20, 7.0, "plms"),
        model_config=SD15,
        with_color_metrics=True,
    ),
    "inpaint": TaskSpec(
        name="inpaint",
        pair_dir="inpaint",
        model_dir="inpainting",
        prompt="high quality detailed photo",
        sampler=SamplerDefaults(0.6, 30, 5.0, "ddim"),
        val_sampler=SamplerDefaults(0.75, 20, 7.0, "ddim"),
        model_config=SD15_INPAINT,
        uses_mask=True,
    ),
}

# Reference alias: the inference layer calls SR "sr" (src/inference.py:86-91)
# while the data layout calls it "sr_x4". Accept both.
ALIASES = {"sr": "sr_x4", "superres": "sr_x4", "super_resolution": "sr_x4",
           "denoising": "denoise", "colorization": "colorize",
           "inpainting": "inpaint"}


def get_task(name: str) -> TaskSpec:
    return TASKS[ALIASES.get(name, name)]


def soft_conditioning_blend(
    input_latents: torch.Tensor,
    noisy_gt_latents: torch.Tensor,
    timesteps: torch.Tensor,
    num_train_timesteps: int = 1000,
) -> torch.Tensor:
    """The training blend shared by the four trainers:

      alpha = t / T;  model_input = (1-alpha) * degraded + alpha * noisy_clean
    """
    alpha = (timesteps.float() / num_train_timesteps)[:, None, None, None]
    return (1.0 - alpha) * input_latents + alpha * noisy_gt_latents
