"""Stable-Diffusion img2img and inpaint sampling in PyTorch (SD-1.5 and SDXL).

Counterpart of the JAX package's ``core/sampling.py`` for the img2img path:
CLIP encode -> VAE encode (posterior sample) -> ``add_noise`` at the
timestep the strength truncates to -> a PLMS or DDIM loop with classifier-free
guidance as one batched UNet call over [uncond; cond] ("halves" layout),
skipped when guidance_scale <= 1 -> VAE decode. The inpaint function runs the
same loop on the 9-channel UNet input [latents, mask, masked-image latents].
An SDXL stack (``SDModules.is_sdxl``) takes (context, pooled) pairs from
``encode_text_sdxl`` and adds the ``text_time`` conditioning at every step.

Two opt-in modes of the JAX loop, both off by default:
- the CFG prefix dedup (``IRET_CFG_DEDUP=1``, read when a sampling function
  is built): the UNet takes the half batch and duplicates it at the first
  cross-attention (``UNet2DCondition.forward``); exact. Off for SDXL.
- the CFG cache (``cfg_cache_interval`` k > 1): the full CFG pair runs only
  at the plan rows i with i % k == 0 and at the last row; between them the
  UNet runs the cond half alone and the last uncond eps is reused. An
  approximation. Off under the dedup, and never taken by the calibration
  function (which builds its img2img function with k = 1).

PyTorch runs the loop eagerly, one UNet call per step. JAX draws the posterior
and add_noise noise inside the function from ``jax.random.split(key)``; here
the caller passes a ``torch.Generator`` or, for parity tests, the noise
tensors. Images and latents are NHWC, as in the JAX package.

Int8 serving: ``SDModules.set_quant`` hands a ``QuantState`` (``ops/quant.py``)
to the UNet's and VAE's quantized layers; ``make_calib_img2img_fn`` runs the
img2img function under dynamic int8 and returns the per-site activation absmax
that mode ``"int8_static"`` loads as its table.

CFG layouts (``cfg_layout``): "halves" (the default, [all uncond; all cond],
as diffusers) or "interleaved" ([img0 uncond, img0 cond, img1 uncond, ...]),
which the sharded factories use so that each image's CFG pair stays on the
rank that holds the image. Both compute the same function.

Multi-device serving (``make_sharded_img2img_fn``, ``make_sharded_inpaint_fn``):
every rank of a ``parallel/mesh.Mesh`` runs the same function on its share of
the request: its rows of the batch over the data axis, its slices of the UNet's
projections over the model axis (``parallel/sharding_rules.py``) and its rows of
the image height over the spatial axis (``parallel/spatial.py``). Every rank
draws the same global noise and slices it, so the output does not depend on the
mesh; every rank returns the whole [B, H, W, 3] image.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

import torch.nn.functional as F

from ..config import SDModelConfig
from ..device import DeviceLike, resolve_device
from ..models.clip_text import CLIPTextModel
from ..models import layers
from ..models.layers import CL
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..ops import quant, token_merge
from ..parallel import collectives, sharding_rules, spatial
from ..parallel.mesh import Mesh, shard_batch
from . import schedulers as sched

# encode_text's context, or encode_text_sdxl's (context, pooled) pair
Conditioning = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class SDModules:
    """The modules of one SD stack, on one device and in one dtype, and the
    quantization state their quantized layers follow (None: full precision)."""

    config: SDModelConfig
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    text_encoder_2: Optional[CLIPTextModel] = None  # SDXL's bigG tower
    quant: Optional[quant.QuantState] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def is_sdxl(self) -> bool:
        return self.config.unet.addition_embed_type == "text_time"

    def components(self):
        out = {"unet": self.unet, "vae": self.vae, "text_encoder": self.text_encoder}
        if self.text_encoder_2 is not None:
            out["text_encoder_2"] = self.text_encoder_2
        return out

    def set_quant(self, state: Optional[quant.QuantState]) -> None:
        """Serve the UNet and VAE under ``state`` (the CLIP text encoder stays
        full precision, as in the JAX package). An active mode quantizes every
        weight now, once; the bf16 parameters are left as they are."""
        self.quant = state
        for module in (self.unet, self.vae):
            layers.set_quant(module, state)

    def set_tome(self, state: Optional[token_merge.TomeState]) -> None:
        """Serve the UNet's self-attention under the ToMe policy ``state``
        (None: exact)."""
        layers.set_tome(self.unet, state)

    def set_attn_int8(self, min_tokens: int = 0) -> None:
        """Serve the UNet's and the VAE's default-backend attention with Nq and
        Nk >= ``min_tokens`` by the plain s8 attention (0: off;
        ``models/layers.set_attn_int8``)."""
        for module in (self.unet, self.vae):
            layers.set_attn_int8(module, min_tokens)

    def freeze_all_but_unet(self) -> None:
        """Training: the UNet's parameters require grad, the VAE's and the text
        encoders' do not (they stay frozen, as in the JAX trainer)."""
        for name, module in self.components().items():
            module.requires_grad_(name == "unet")

    @classmethod
    def create(cls, config: SDModelConfig, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None,
               attention_backend: Optional[str] = None) -> "SDModules":
        """Allocate the stack on ``device`` (``cuda`` unless ``"cpu"`` is asked for)
        with uninitialised weights: load a state dict or call ``init_random_``.
        ``attention_backend`` reaches every UNet attention site
        (``ops/attention.py``); the VAE's attention is always exact. Under
        autograd the UNet checkpoints its blocks (``models/unet.py``)."""
        dev = resolve_device(device)
        with torch.device("meta"):
            unet = UNet2DCondition(config.unet, attention_backend).to(dtype, memory_format=CL)
            vae = AutoencoderKL(config.vae).to(dtype, memory_format=CL)
            te = CLIPTextModel(config.text_encoder).to(dtype)
            te2 = (CLIPTextModel(config.text_encoder_2, with_projection=True).to(dtype)
                   if config.text_encoder_2 is not None else None)
        unet, vae, te = (m.to_empty(device=dev).eval() for m in (unet, vae, te))
        return cls(config, unet, vae, te,
                   te2.to_empty(device=dev).eval() if te2 is not None else None)


def encode_text(modules: SDModules, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids [B, 77] -> conditioning [B, 77, hidden] (fp32)."""
    return modules.text_encoder(input_ids.to(modules.device))


def encode_text_sdxl(modules: SDModules, input_ids: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDXL's two towers on the same ids: (both penultimate hidden states
    concatenated [B, 77, d1 + d2], the bigG tower's projected pooled output
    [B, d2]), fp32."""
    ids = input_ids.to(modules.device)
    out1 = modules.text_encoder(ids, return_dict=True)
    out2 = modules.text_encoder_2(ids, return_dict=True)
    context = torch.cat([out1["penultimate_hidden_state"],
                         out2["penultimate_hidden_state"]], dim=-1)
    return context, out2["pooled"]


def sdxl_time_ids(batch: int, size: int, device=None) -> torch.Tensor:
    """Micro-conditioning ids [batch, 6] (fp32): (orig_h, orig_w, crop_top,
    crop_left, target_h, target_w) of a square ``size`` image, uncropped."""
    row = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32, device=device)
    return row.expand(batch, 6)


def cfg_dedup_from_env() -> bool:
    """``IRET_CFG_DEDUP=1``, read when a sampling function is built."""
    return os.environ.get("IRET_CFG_DEDUP") == "1"


def encode_image(modules: SDModules, image: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image [-1, 1] NHWC -> scaled latents; the posterior mean when noise is None."""
    dist = modules.vae.encode(image)
    z = dist.mode if noise is None else dist.sample(noise)
    return z * modules.config.vae.scaling_factor


def decode_latents(modules: SDModules, latents: torch.Tensor) -> torch.Tensor:
    img = modules.vae.decode(latents / modules.config.vae.scaling_factor)
    return torch.clamp(img, -1.0, 1.0)


def mask_to_latents(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, 1] mask -> [B, h, w, 1] as jax.image.resize's "nearest", which
    samples at the cells' centres: "nearest-exact", not "nearest" (the
    top-left pixel of each cell)."""
    return F.interpolate(mask.permute(0, 3, 1, 2), size=hw,
                         mode="nearest-exact").permute(0, 2, 3, 1)


def _denoise_loop(modules: SDModules, latents: torch.Tensor, context: torch.Tensor,
                  uncond_context: Optional[torch.Tensor], plan: sched.StepPlan,
                  guidance_scale: float, sampler: str,
                  extra_channels: Optional[torch.Tensor] = None,
                  added_cond: Optional[Dict[str, torch.Tensor]] = None,
                  cfg_dedup: bool = False, cfg_cache_interval: int = 1,
                  cfg_layout: str = "halves") -> torch.Tensor:
    """The sampling loop: one (CFG-batched) UNet call per plan row.
    ``extra_channels`` (the inpaint mask and masked-image latents) ride along
    un-noised, concatenated to the latents before the CFG duplication.
    ``added_cond`` (SDXL) is broadcast to the batch and duplicated under CFG.
    ``cfg_dedup`` asks for the CFG prefix dedup (taken under CFG, not for
    SDXL, only with attention at level 0 and in the "halves" layout);
    ``cfg_cache_interval`` k > 1 for the CFG cache (taken under CFG without
    the dedup); ``cfg_layout`` "halves" or "interleaved": see the module
    docstring."""
    if cfg_layout not in ("halves", "interleaved"):
        raise ValueError(f"unknown cfg_layout {cfg_layout!r}")
    interleaved = cfg_layout == "interleaved"
    cfg = modules.config.scheduler
    ac = sched.alphas_cumprod_tensor(cfg, latents.device)
    fa = sched.final_alpha_cumprod(cfg)
    do_cfg = guidance_scale > 1.0 and uncond_context is not None

    b = latents.shape[0]
    context = context.expand((b,) + context.shape[1:])
    if do_cfg:
        uncond = uncond_context.expand((b,) + uncond_context.shape[1:])
        ctx_all = (torch.stack([uncond, context], dim=1).reshape((2 * b,) + context.shape[1:])
                   if interleaved else torch.cat([uncond, context], dim=0))
    else:
        ctx_all = context
    pair_up = ((lambda v: v.repeat_interleave(2, dim=0)) if interleaved
               else (lambda v: torch.cat([v, v], dim=0)))
    cond_rows = (lambda v: v[1::2]) if interleaved else (lambda v: v[b:])
    added_all = None
    if added_cond is not None:
        added_all = {k: v.expand((b,) + v.shape[1:]) for k, v in added_cond.items()}
        if do_cfg:
            added_all = {k: pair_up(v) for k, v in added_all.items()}
    dedup = (cfg_dedup and do_cfg and not modules.is_sdxl and not interleaved
             and modules.config.unet.attn_levels[0])
    cache = int(cfg_cache_interval) > 1 and do_cfg and not dedup

    def call(lat: torch.Tensor, t: int, ctx: torch.Tensor, added, pair: bool = False,
             dedup_call: bool = False) -> torch.Tensor:
        """The UNet on the latents (with the extra channels), duplicated for
        the CFG pair when ``pair``."""
        model_in = lat if extra_channels is None else torch.cat([lat, extra_channels], dim=-1)
        if pair:
            model_in = pair_up(model_in)
        ts = torch.full((model_in.shape[0],), int(t), dtype=torch.int32, device=lat.device)
        return modules.unet(model_in, ts, ctx, added, cfg_dedup=dedup_call)

    def unet_eps(lat: torch.Tensor, t: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(guided eps, uncond eps or None) of one full step."""
        eps = call(lat, t, ctx_all, added_all, pair=do_cfg and not dedup, dedup_call=dedup)
        if not do_cfg:
            return eps, None
        eps_u, eps_c = (eps[0::2], eps[1::2]) if interleaved else eps.chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u), eps_u

    n_rows = len(plan.timesteps)
    full = np.ones(n_rows, bool)
    if cache:
        full = np.arange(n_rows) % int(cfg_cache_interval) == 0
        full[-1] = True  # the last step always refreshes the guidance
    added_c = None if added_all is None else {k: cond_rows(v) for k, v in added_all.items()}
    eps_u_prev = None

    def eps_at(i: int, lat: torch.Tensor, t: int) -> torch.Tensor:
        nonlocal eps_u_prev
        if full[i]:
            eps, eps_u = unet_eps(lat, t)
            if cache:  # both branches in fp32, as the JAX cache's lax.cond
                eps, eps_u_prev = eps.float(), eps_u.float()
            return eps
        eps_c = call(lat, t, cond_rows(ctx_all), added_c).float()
        return eps_u_prev + guidance_scale * (eps_c - eps_u_prev)

    lat = latents.float()
    rows = enumerate(zip(plan.timesteps.tolist(), plan.prev_timesteps.tolist(),
                         plan.order_codes.tolist(), plan.append.tolist()))
    if sampler == "plms":
        carry = sched.plms_init_carry(lat)
        for i, (t, prev_t, code, append) in rows:
            carry, lat = sched.plms_step(ac, fa, carry, lat, eps_at(i, lat, t), t, prev_t,
                                         code, append)
    elif sampler == "ddim":
        for i, (t, prev_t, _, _) in rows:
            lat = sched.ddim_step(ac, fa, lat, eps_at(i, lat, t), t, prev_t)
    else:
        raise ValueError(f"Unknown sampler: {sampler}")
    return lat


def latent_shape(modules: SDModules, image_shape) -> Tuple[int, int, int, int]:
    """[B, H, W, 3] image -> [B, H/f, W/f, latent_channels] latents."""
    f = 2 ** (len(modules.config.vae.block_out_channels) - 1)
    b, h, w = image_shape[:3]
    return (b, h // f, w // f, modules.config.vae.latent_channels)


def _noise(modules: SDModules, image: torch.Tensor, generator: Optional[torch.Generator],
           noise: Optional[Tuple[torch.Tensor, ...]], count: int = 2):
    """``count`` latent-shaped noise tensors: the given ones on the modules'
    device, or all drawn (fp32, standard normal, in order) from ``generator``."""
    dev = modules.device
    if noise is None:
        shape = latent_shape(modules, image.shape)
        noise = tuple(torch.randn(shape, generator=generator, device=dev,
                                  dtype=torch.float32) for _ in range(count))
    if len(noise) != count:
        raise ValueError(f"expected {count} noise tensors, got {len(noise)}")
    return tuple(n.to(dev, torch.float32) for n in noise)


def make_img2img_fn(modules: SDModules, num_inference_steps: int, strength: float,
                    guidance_scale: float, sampler: str = "plms",
                    cfg_cache_interval: int = 1, cfg_layout: str = "halves") -> Callable:
    """Build fn(image, prompt_ctx, uncond_ctx, generator=None, noise=None) -> image.

    ``image`` is NHWC in [-1, 1]. The contexts come from ``encode_text``, or
    for an SDXL stack are (context, pooled) pairs from ``encode_text_sdxl``:
    under CFG both halves then take the cond pooled embedding and the time
    ids of the image's height (as in the JAX function; the halves differ
    only by their context). ``noise`` = (posterior noise, add_noise noise),
    each shaped like the latents; without it both are drawn (fp32, standard
    normal, posterior first) from ``generator``. ``cfg_cache_interval`` > 1
    turns on the CFG cache; ``IRET_CFG_DEDUP=1`` (read now) the dedup;
    ``cfg_layout`` orders the CFG batch. Returns the decoded image, NHWC fp32
    in [-1, 1]. Under a height-sharding policy (``parallel/spatial.py``) the
    inputs are whole, each rank computes on its rows of them and the image is
    gathered whole.
    """
    cfg = modules.config.scheduler
    plan_fn = sched.plms_step_plan if sampler == "plms" else sched.ddim_step_plan
    plan = plan_fn(cfg, num_inference_steps, strength)
    dedup = cfg_dedup_from_env()

    @torch.inference_mode()
    def fn(image: torch.Tensor, prompt_ctx: Conditioning, uncond_ctx: Optional[Conditioning],
           generator: Optional[torch.Generator] = None,
           noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        dev = modules.device
        image = image.to(dev)
        added = None
        if modules.is_sdxl:
            prompt_ctx, pooled = prompt_ctx
            if uncond_ctx is not None:
                uncond_ctx, _ = uncond_ctx
            added = {"text_embeds": pooled.to(dev),
                     "time_ids": sdxl_time_ids(pooled.shape[0], image.shape[1], dev)}
        enc_noise, step_noise = _noise(modules, image, generator, noise)
        spatial.request(image.shape[1], enc_noise.shape[1])
        enc_noise, step_noise = spatial.scatter_rows(enc_noise), spatial.scatter_rows(step_noise)
        latents0 = encode_image(modules, spatial.scatter_rows(image), enc_noise)
        ac = sched.alphas_cumprod_tensor(cfg, dev)
        latents = sched.add_noise(ac, latents0, step_noise, plan.init_timestep)
        latents = _denoise_loop(modules, latents, prompt_ctx.to(dev),
                                None if uncond_ctx is None else uncond_ctx.to(dev),
                                plan, guidance_scale, sampler, added_cond=added,
                                cfg_dedup=dedup, cfg_cache_interval=cfg_cache_interval,
                                cfg_layout=cfg_layout)
        return spatial.gather_rows(decode_latents(modules, latents), image.shape[1])

    return fn


def make_inpaint_fn(modules: SDModules, num_inference_steps: int, strength: float,
                    guidance_scale: float, sampler: str = "ddim",
                    cfg_cache_interval: int = 1, cfg_layout: str = "halves") -> Callable:
    """Build fn(image, mask, prompt_ctx, uncond_ctx, generator=None, noise=None) -> image.

    The diffusers 9-channel layout at every step: [latents (4), mask (1),
    masked-image latents (4)]. ``image`` is NHWC in [-1, 1]; ``mask`` NHWC
    [B, H, W, 1] in {0, 1}, 1 = the hole to fill. ``noise`` = (image posterior
    noise, masked-image posterior noise, add_noise noise), each shaped like
    the latents; without it all three are drawn in that order from
    ``generator``. ``cfg_cache_interval``, ``cfg_layout``, ``IRET_CFG_DEDUP``
    and height sharding as in ``make_img2img_fn``. An SD-1.5(-inpaint) stack
    only, as in the JAX package. Returns the decoded image, NHWC fp32 in
    [-1, 1].
    """
    if modules.is_sdxl:
        raise ValueError("the inpaint function takes an SD-1.5 stack, not SDXL")
    cfg = modules.config.scheduler
    plan_fn = sched.plms_step_plan if sampler == "plms" else sched.ddim_step_plan
    plan = plan_fn(cfg, num_inference_steps, strength)
    dedup = cfg_dedup_from_env()

    @torch.inference_mode()
    def fn(image: torch.Tensor, mask: torch.Tensor, prompt_ctx: torch.Tensor,
           uncond_ctx: Optional[torch.Tensor], generator: Optional[torch.Generator] = None,
           noise: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
           ) -> torch.Tensor:
        dev = modules.device
        image = image.to(dev, torch.float32)
        mask = mask.to(dev, torch.float32)
        enc_noise, mask_enc_noise, step_noise = (
            spatial.scatter_rows(n) for n in _noise(modules, image, generator, noise, 3))
        lat_hw = latent_shape(modules, image.shape)[1:3]
        spatial.request(image.shape[1], lat_hw[0])
        latents0 = encode_image(modules, spatial.scatter_rows(image), enc_noise)
        masked_latents = encode_image(modules, spatial.scatter_rows(image * (1.0 - mask)),
                                      mask_enc_noise)
        mask_lat = spatial.scatter_rows(mask_to_latents(mask, lat_hw))
        ac = sched.alphas_cumprod_tensor(cfg, dev)
        latents = sched.add_noise(ac, latents0, step_noise, plan.init_timestep)
        latents = _denoise_loop(modules, latents, prompt_ctx.to(dev),
                                None if uncond_ctx is None else uncond_ctx.to(dev),
                                plan, guidance_scale, sampler,
                                extra_channels=torch.cat([mask_lat, masked_latents], dim=-1),
                                cfg_dedup=dedup, cfg_cache_interval=cfg_cache_interval,
                                cfg_layout=cfg_layout)
        return spatial.gather_rows(decode_latents(modules, latents), image.shape[1])

    return fn


def make_calib_img2img_fn(modules: SDModules, num_inference_steps: int, strength: float,
                          guidance_scale: float, sampler: str = "plms") -> Callable:
    """Calibration twin of ``make_img2img_fn`` for the int8_static mode.

    Builds fn(image, prompt_ctx, uncond_ctx, generator=None, noise=None) ->
    (image, {site: activation absmax}): the same img2img run under dynamic
    int8 quantization, with the absmax of every quantized conv and Linear
    input maxed over the VAE encode, every UNet call and the VAE decode.
    Take the elementwise max over several inputs and load the result as the
    ``QuantState`` table of mode "int8_static". The modules' own state is put
    back when fn returns.
    """
    img2img = make_img2img_fn(modules, num_inference_steps, strength, guidance_scale, sampler)

    def fn(image: torch.Tensor, prompt_ctx: torch.Tensor, uncond_ctx: Optional[torch.Tensor],
           generator: Optional[torch.Generator] = None,
           noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Dict[str, float]]:
        prev = modules.quant
        state = quant.QuantState("int8")
        modules.set_quant(state)
        try:
            with state.collect() as stats:
                out = img2img(image, prompt_ctx, uncond_ctx, generator, noise)
        finally:
            modules.set_quant(prev)
        names = sorted(stats)
        values = torch.stack([stats[n] for n in names]).tolist() if names else []
        return out, dict(zip(names, values))

    return fn


def make_sharded_img2img_fn(modules: SDModules, mesh: Mesh, num_inference_steps: int,
                            strength: float, guidance_scale: float, sampler: str = "plms",
                            data_axis: Optional[str] = "data",
                            model_axis: Optional[str] = None,
                            spatial_axis: Optional[str] = None,
                            cfg_cache_interval: int = 1):
    """Multi-device serving: ``make_img2img_fn`` run by every rank of ``mesh``.

    ``data_axis`` shards the image batch (and per-image contexts) over that
    axis; None replicates it (one image served by a spatial or model mesh).
    The loop uses the "interleaved" CFG layout, so each image's pair stays on
    its rank and pure data parallelism calls no collective inside the loop.
    ``model_axis`` makes the UNet's projections tensor parallel over it
    (Megatron-style, ``parallel/sharding_rules.py``; the collectives are the
    row-parallel products' all-reduces). ``spatial_axis`` shards the image
    height over it under the level-gated policy of ``parallel/spatial.py``
    (halo rows, global GroupNorm statistics, gathered K/V); the image height
    must divide by its size. Under int8 (``SDModules.set_quant``) every
    dynamic scale is the unsharded function's, maxed over the axes its
    tensor is sharded on (``ops/quant.py``); ToMe (``set_tome``) runs under
    the data and model axes (its merges are per image, and its input is
    replicated over the model axis) and not under a spatial one.

    Returns (fn, shard_params_fn): call ``shard_params_fn()`` once (it makes
    ``modules`` this rank's part, in place, and returns them), then
    ``fn(image, prompt_ctx, uncond_ctx, generator=None, noise=None)`` on every
    rank with the global batch (divisible by the data-axis size) and the same
    generator state or noise; it returns the whole [B, H, W, 3] image on every
    rank.
    """
    inner = make_img2img_fn(modules, num_inference_steps, strength, guidance_scale, sampler,
                            cfg_cache_interval=cfg_cache_interval, cfg_layout="interleaved")
    return _shard_serving_fn(modules, mesh, inner, data_axis, model_axis, spatial_axis,
                             n_spatial_args=1, n_noise=2)


def make_sharded_inpaint_fn(modules: SDModules, mesh: Mesh, num_inference_steps: int,
                            strength: float, guidance_scale: float, sampler: str = "ddim",
                            data_axis: Optional[str] = "data",
                            model_axis: Optional[str] = None,
                            spatial_axis: Optional[str] = None,
                            cfg_cache_interval: int = 1):
    """Multi-device inpaint serving: ``make_inpaint_fn`` over ``mesh``, with the
    layout contract of ``make_sharded_img2img_fn``; the mask shards like the
    image. Returns (fn, shard_params_fn) with
    ``fn(image, mask, prompt_ctx, uncond_ctx, generator=None, noise=None)``."""
    inner = make_inpaint_fn(modules, num_inference_steps, strength, guidance_scale, sampler,
                            cfg_cache_interval=cfg_cache_interval, cfg_layout="interleaved")
    return _shard_serving_fn(modules, mesh, inner, data_axis, model_axis, spatial_axis,
                             n_spatial_args=2, n_noise=3)


def _check_mesh_modes(modules: SDModules, spatial_axis: Optional[str]) -> None:
    if spatial_axis is not None and any(getattr(m, "tome", None) is not None and m.tome.active
                                        for m in modules.unet.modules()):
        raise ValueError("token merging does not run under spatial sharding: its matching "
                         "takes the whole token grid, which the height axis shards")


def _shard_serving_fn(modules: SDModules, mesh: Mesh, inner: Callable,
                      data_axis: Optional[str], model_axis: Optional[str],
                      spatial_axis: Optional[str], n_spatial_args: int, n_noise: int):
    """The sharding wrapper the serving factories share. ``inner(*spatial_args,
    prompt_ctx, uncond_ctx, noise=...)``: the first ``n_spatial_args`` tensors
    are [B, H, ...] and shard over (data_axis, spatial_axis), the contexts over
    data_axis; ``n_noise`` latent-shaped noise tensors."""
    _check_mesh_modes(modules, spatial_axis)
    sp_size = mesh.size(spatial_axis)
    data_group = mesh.group(data_axis) if data_axis is not None else None

    def shard_params_fn() -> SDModules:
        if model_axis is not None:
            sharding_rules.shard_module(modules.unet, mesh, model_axis)
        return modules

    def local_ctx(ctx, batch: int):
        if ctx is None or data_axis is None:
            return ctx
        if isinstance(ctx, tuple):
            return tuple(local_ctx(c, batch) for c in ctx)
        return shard_batch(ctx, mesh, data_axis) if ctx.shape[0] == batch else ctx

    def fn(*args, generator: Optional[torch.Generator] = None,
           noise: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
        spatial_args = args[:n_spatial_args]
        prompt_ctx, uncond_ctx = args[n_spatial_args:]
        image = spatial_args[0]
        if sp_size > 1 and image.shape[1] % sp_size:
            raise ValueError(f"spatial sharding: image height {image.shape[1]} must divide by "
                             f"the {spatial_axis!r} axis size {sp_size} (uneven input shards)")
        batch = image.shape[0]
        noise = _noise(modules, image, generator, noise, n_noise)
        spatial_args = tuple(shard_batch(a, mesh, data_axis) for a in spatial_args)
        noise = tuple(shard_batch(n, mesh, data_axis) for n in noise)
        ctxs = local_ctx(prompt_ctx, batch), local_ctx(uncond_ctx, batch)
        sp_group = mesh.group(spatial_axis) if spatial_axis is not None else None
        with collectives.sharded_over(data_group, sp_group):
            if spatial_axis is None:
                out = inner(*spatial_args, *ctxs, noise=noise)
            else:
                with spatial.spatial_sharding(mesh, spatial_axis):
                    out = inner(*spatial_args, *ctxs, noise=noise)
        return collectives.all_gather(out, data_group, 0)

    return fn, shard_params_fn
