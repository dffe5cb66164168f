"""RestorationPipeline — the four restoration tasks over the SD-1.5 or SDXL stack, in PyTorch.

Counterpart of the JAX package's ``infer/pipeline.py``: ``process(image,
tasks)`` and the per-task methods ``denoise``, ``super_resolve`` (LANCZOS x4
pre-upscale, then img2img; without an SD stack RRDBNet, then LANCZOS),
``colorize`` (skips a colour image) and ``inpaint`` (the 9-channel stack;
the auto mask when none is given), with the same checkpoint discovery under
``outputs/models/{task}/best`` (or a pipeline directory given as
``fine_tuned_dir``), the same pretrained search (``pretrained_dir``, then
``$IRET_PRETRAINED_ROOT/<pretrained_id>``; the JAX pipeline layout or a
diffusers directory, imported), the same 64-px bucketing of the input size,
prompt-context caching and the fixed seed. A checkpoint's ``model_index.json``,
or a per-task ``"model_config"``, may name an SDXL stack: its contexts are
``encode_text_sdxl``'s (context, pooled) pairs, both towers on the stack's
tokenizer's ids. The opt-in serving modes of the JAX pipeline are here too:
``cfg_cache_interval`` (the CFG cache; part of the sampling function's cache
key), ``tome_ratio`` (token merging, ``ops/token_merge.py``) and
``IRET_CFG_DEDUP=1`` (the exact CFG prefix dedup, read when a sampling
function is built).

Differences from the JAX pipeline:
- a failed SD run is logged ("SD denoise failed; OpenCV fallback") and served
  by the next backend only on a CPU pipeline. On the card every failure
  raises: a kernel that did not build or launch (``KernelError``), a device
  error, running out of memory. The work never moves to the CPU unseen. A
  checkpoint directory that cannot be loaded raises on either device.
- images come back as numpy uint8 HWC arrays, not ``PIL.Image``; a PIL image is
  still accepted as input. The resizes, greyscale and mask morphology are
  the port's own numpy versions of PIL's and cv2's (``imaging.py``), so the
  card's machine needs neither; cv2 is imported only by the classical
  denoise and colorize fallbacks.
- ``device`` replaces the JAX device: ``cuda`` unless ``"cpu"`` is asked for.
- quantized serving (``quant="int8"`` or ``"int8_static"`` with
  ``quant_calib``, ``attention_backend="int8"``) keeps its mode and table in
  a ``QuantState`` owned by this pipeline and handed to its models, not in a
  process-global read at trace time; ``quant=None`` reads ``IRET_QUANT`` once,
  here. Under ``IRET_QUANT_STRICT`` a request that reached a site missing
  from the table raises ``StrictQuantError`` (never served by a fallback).
- the ToMe policy is a ``TomeState`` owned by this pipeline and handed to its
  UNets, likewise: ``tome_ratio``, or when it is not given ``IRET_TOME`` (and
  ``IRET_TOME_MIN``), read once, here; not a process global read at trace
  time.
- mesh serving (``mesh=``, a ``parallel/mesh.Mesh``, with ``model_axis=``
  and ``spatial_axis=``): every rank of the mesh builds the same pipeline and
  serves the same requests through the sharded sampling factories (the batch
  of one is replicated: ``data_axis=None``), each computing its share and
  returning the whole image. Unlike the JAX pipeline, spatial sharding keeps
  the attention backend it is given: the port's attention shards by query
  rows (K and V gathered), where a Pallas call has no partitioning rule for
  GSPMD. Under ``spatial_axis`` ToMe is turned off for this pipeline, with the
  JAX pipeline's warning. int8 (``quant``) is served under every mesh, with
  the unsharded function's scales, and ToMe under ``model_axis``; a failed
  request raises on every device (a rank that served a fallback would leave
  the others waiting in a collective).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config as C
from ..core import checkpoint as ckpt
from ..core import sampling
from ..device import DeviceLike, resolve_device
from ..models import rrdbnet
from ..models.tokenizer import load_tokenizer
from ..ops import quant as quant_ops
from ..ops import token_merge
from ..ops._build import KernelError
from ..ops.attention import check_backend
from ..tasks.registry import ALIASES, TASKS, get_task
from . import fallbacks, imaging

logger = logging.getLogger(__name__)

DEFAULT_MODEL_ROOT = "outputs/models"


class StrictQuantError(RuntimeError):
    """Raised under IRET_QUANT_STRICT=1 when int8_static serving reached a site
    missing from its calibration table. Never caught by the per-task fallback:
    strict mode exists to fail loudly."""


def load_quant_table(path: str) -> Dict[str, float]:
    """A calibration JSON: ``{"sites": {site: absmax}, ...}`` (as written by
    ``calibrate_quant``) or a flat ``{site: absmax}``."""
    with open(path) as f:
        loaded = json.load(f)
    return loaded.get("sites", loaded)


def _is_pil(image) -> bool:
    return type(image).__module__.startswith("PIL.")


def _to_uint8(image) -> np.ndarray:
    if _is_pil(image):
        return np.array(image.convert("RGB"))
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img


def _bucket_hw(h: int, w: int, multiple: int = 64, max_size: int = 1024) -> Tuple[int, int]:
    """Round spatial dims to 64-px buckets, preserving aspect, capped at max_size."""
    scale = min(1.0, max_size / max(h, w))
    h2 = max(multiple, int(round(h * scale / multiple)) * multiple)
    w2 = max(multiple, int(round(w * scale / multiple)) * multiple)
    return min(h2, max_size), min(w2, max_size)


class RestorationPipeline:
    """Multi-task restoration over the PyTorch SD stack."""

    def __init__(
        self,
        config: Optional[Dict[str, Dict[str, Any]]] = None,
        models_root: str = DEFAULT_MODEL_ROOT,
        seed: int = 42,
        dtype: torch.dtype = torch.bfloat16,
        max_size: int = 1024,
        device: DeviceLike = None,
        attention_backend: Optional[str] = None,
        quant: Optional[str] = None,
        quant_calib: Optional[str] = None,
        cfg_cache_interval: int = 1,
        tome_ratio: float = 0.0,
        mesh=None,
        model_axis: Optional[str] = None,
        spatial_axis: Optional[str] = None,
    ):
        self.mesh, self.model_axis, self.spatial_axis = mesh, model_axis, spatial_axis
        self.device = resolve_device(device) if mesh is None else mesh.device
        check_backend(attention_backend)
        self.attention_backend = attention_backend
        # quant=None defers to IRET_QUANT; "int8" = dynamic w8a8, "int8_static"
        # = calibrated scales from quant_calib (a site missing from the table
        # is quantized dynamically and reported, see _check_static_misses).
        self.quant = quant_ops.QuantState(
            quant_ops.mode_from_env(quant),
            load_quant_table(quant_calib) if quant_calib else {})
        self._warned_misses: set = set()
        # > 1: the CFG cache, an approximation (core/sampling.py); off by default
        self.cfg_cache_interval = int(cfg_cache_interval)
        # > 0: token merging, an approximation (ops/token_merge.py); a ratio
        # of 0 defers to IRET_TOME, read here once
        self.tome = token_merge.state_from_env(tome_ratio)
        if mesh is not None and spatial_axis is not None:
            if self.tome.active:
                logger.warning("token merging disabled: incompatible with spatial "
                               "sharding (sharded token dim)")
            self.tome = token_merge.TomeState(0.0)
        self.seed = seed
        self.dtype = dtype
        self.max_size = max_size
        self.models_root = models_root
        self.config: Dict[str, Dict[str, Any]] = {}
        for name, spec in TASKS.items():
            task_cfg = {
                "fine_tuned_dir": f"{models_root}/{spec.model_dir}/best",
                "pretrained_id": (
                    "runwayml/stable-diffusion-inpainting" if spec.name == "inpaint"
                    else "sd-legacy/stable-diffusion-v1-5"
                ),
                "pretrained_dir": None,
                "default_backend": "auto",  # auto | diffusion | classical
                "model_config": None,
            }
            if config:
                task_cfg.update(config.get(name, {}) or config.get(spec.name, {}))
            self.config[name] = task_cfg
        self.prompts = {name: spec.prompt for name, spec in TASKS.items()}
        self._stacks: Dict[str, Optional[Dict[str, Any]]] = {}
        self._fn_cache: Dict[tuple, Any] = {}
        self._ctx_cache: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------------
    # model loading
    # ------------------------------------------------------------------

    def _find_weights(self, task_name: str) -> Optional[str]:
        """The directory to load for a task, or None: the fine-tuned
        checkpoint, else the first pretrained candidate that holds a pipeline
        (``pretrained_dir``, then ``$IRET_PRETRAINED_ROOT/<pretrained_id>``
        and ``<pretrained_id with / as -->``)."""
        cfg = self.config[task_name]
        ft_dir = cfg["fine_tuned_dir"]
        if ft_dir and ft_dir != "nonexistent":
            if ft_dir.endswith("/best"):
                found = ckpt.find_latest_checkpoint(ft_dir.rsplit("/best", 1)[0])
            elif ckpt.pipeline_exists(ft_dir):
                found = ft_dir
            else:
                found = ckpt.find_latest_checkpoint(ft_dir)
            if found:
                return found
        # Pretrained mode: a local directory in the pipeline layout or a
        # diffusers directory (model_index.json marks both).
        candidates = [cfg["pretrained_dir"]] if cfg.get("pretrained_dir") else []
        root, pid = os.environ.get("IRET_PRETRAINED_ROOT"), cfg.get("pretrained_id")
        if root and pid:
            candidates += [os.path.join(root, pid), os.path.join(root, pid.replace("/", "--"))]
        for cand in candidates:
            if ckpt.pipeline_exists(cand):
                return cand
        return None

    def _load_stack(self, task_name: str) -> Optional[Dict[str, Any]]:
        """Lazy-load the SD stack for a task; None -> use the classical fallback."""
        if task_name in self._stacks:
            return self._stacks[task_name]
        spec = get_task(task_name)
        cfg = self.config[task_name]
        backend = cfg.get("default_backend", "auto")
        if backend == "classical":
            self._stacks[task_name] = None
            return None
        src_dir = self._find_weights(task_name)
        if src_dir is None:
            if backend != "diffusion":
                logger.info("No %s checkpoint found; using classical fallback", task_name)
                self._stacks[task_name] = None
                return None
            raise RuntimeError(
                f"default_backend='diffusion' for task {task_name!r} but no weights found: "
                f"fine_tuned_dir={cfg['fine_tuned_dir']!r}, pretrained_dir="
                f"{cfg.get('pretrained_dir')!r}, pretrained_id={cfg.get('pretrained_id')!r}"
            )
        layout = "pipeline" if ckpt.is_pipeline_layout(src_dir) else "diffusers"
        logger.info("Loading %s stack from %s (%s layout)", task_name, src_dir, layout)
        # An explicit model config wins, else the checkpoint's own
        # (model_index.json; a diffusers directory has none), else the task's.
        mc = cfg.get("model_config")
        if isinstance(mc, str):
            mc = C.PRESETS[mc]
        if mc is None:
            mc = ckpt.load_pipeline_model_config(src_dir)
        if mc is not None:
            spec = dataclasses.replace(spec, model_config=mc)
        modules = sampling.SDModules.create(spec.model_config, dtype=self.dtype,
                                            device=self.device,
                                            attention_backend=self.attention_backend)
        states = ckpt.load_state_dicts(src_dir)
        for comp, module in modules.components().items():
            if comp not in states:
                raise FileNotFoundError(f"{src_dir} has no {comp} weights")
            module.load_state_dict(states.pop(comp), strict=True)
        if self.quant.active:
            modules.set_quant(self.quant)
        if self.tome.active:
            modules.set_tome(self.tome)
        tokenizer = load_tokenizer(src_dir, vocab_size=spec.model_config.text_encoder.vocab_size)
        stack = {"modules": modules, "tokenizer": tokenizer, "spec": spec}
        self._stacks[task_name] = stack
        return stack

    def _context(self, stack, prompt: str) -> sampling.Conditioning:
        """Text conditioning, cached per (task, prompt): a context, or for an
        SDXL stack the (context, pooled) pair."""
        key = (stack["spec"].name, prompt)
        if key not in self._ctx_cache:
            modules = stack["modules"]
            ids = torch.as_tensor(stack["tokenizer"]([prompt]))
            encode = sampling.encode_text_sdxl if modules.is_sdxl else sampling.encode_text
            with torch.inference_mode():
                self._ctx_cache[key] = encode(modules, ids)
        return self._ctx_cache[key]

    def _sampler_fn(self, stack, kind: str, steps: int, strength: float, gs: float,
                    sampler: str):
        """The sampling function of ``kind`` ("img2img" or "inpaint"), cached."""
        key = (stack["spec"].name, kind, steps, round(strength, 4), round(gs, 4), sampler,
               self.cfg_cache_interval)
        if key not in self._fn_cache:
            kw = dict(num_inference_steps=steps, strength=strength, guidance_scale=gs,
                      sampler=sampler, cfg_cache_interval=self.cfg_cache_interval)
            if self.mesh is None:
                maker = (sampling.make_inpaint_fn if kind == "inpaint"
                         else sampling.make_img2img_fn)
                self._fn_cache[key] = maker(stack["modules"], **kw)
            else:
                maker = (sampling.make_sharded_inpaint_fn if kind == "inpaint"
                         else sampling.make_sharded_img2img_fn)
                fn, shard_params = maker(stack["modules"], self.mesh, data_axis=None,
                                         model_axis=self.model_axis,
                                         spatial_axis=self.spatial_axis, **kw)
                if not stack.get("sharded"):
                    shard_params()
                    stack["sharded"] = True
                self._fn_cache[key] = fn
        return self._fn_cache[key]

    # ------------------------------------------------------------------
    # shared SD run helper
    # ------------------------------------------------------------------

    def _run_sd(self, stack, img_u8: np.ndarray, prompt: str, steps: int,
                strength: float, gs: float, sampler: str,
                mask_u8: Optional[np.ndarray] = None) -> np.ndarray:
        """One img2img run, or inpaint when ``mask_u8`` (white = the hole) is
        given, at the 64-px bucket of the image's size."""
        h, w = img_u8.shape[:2]
        bh, bw = _bucket_hw(h, w, max_size=self.max_size)
        img_u8 = imaging.resize_lanczos_pil(img_u8, (bh, bw))
        x = torch.from_numpy(img_u8.astype(np.float32) / 127.5 - 1.0)[None]
        ctx = self._context(stack, prompt)
        uncond = self._context(stack, "") if gs > 1.0 else None
        fn = self._sampler_fn(stack, "inpaint" if mask_u8 is not None else "img2img",
                              steps, strength, gs, sampler)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        if mask_u8 is not None:
            m = imaging.resize_nearest_pil(mask_u8, (bh, bw)) > 127
            m = torch.from_numpy(m.astype(np.float32))[None, :, :, None]
            out = fn(x, m, ctx, uncond, generator=gen)
        else:
            out = fn(x, ctx, uncond, generator=gen)
        out = out[0].cpu().numpy()
        self._check_static_misses()
        out_u8 = ((out + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        return imaging.resize_lanczos_pil(out_u8, (h, w))

    def _check_static_misses(self) -> None:
        """Calibration/serving drift detector: under int8_static a quantized site
        missing from the table is quantized dynamically: correct, but off the
        calibrated path. Warns once per site; IRET_QUANT_STRICT=1 raises on
        every request that reached such a site."""
        if self.quant.mode != "int8_static":
            return
        new = self.quant.misses - self._warned_misses
        if not new:
            return
        msg = (f"int8_static: {len(new)} quantized site(s) missing from the "
               f"calibration table fell back to dynamic quantization (stale or "
               f"mismatched calib JSON?), e.g. {sorted(new)[:3]}")
        if os.environ.get("IRET_QUANT_STRICT"):
            raise StrictQuantError(msg)
        self._warned_misses |= new
        logger.warning(msg)

    def _fallback_allowed(self, err: Exception) -> bool:
        """Whether a failed SD run may be served by the classical fallback:
        only on a CPU pipeline without a mesh, never for a kernel failure or a
        strict-mode calibration miss."""
        return (self.device.type == "cpu" and self.mesh is None
                and not isinstance(err, (KernelError, StrictQuantError)))

    # ------------------------------------------------------------------
    # per-task methods
    # ------------------------------------------------------------------

    def denoise(self, image, strength: float = 0.5, prompt: Optional[str] = None,
                guidance: Optional[float] = None, **kwargs) -> np.ndarray:
        """``guidance`` overrides the task's CFG scale; gs <= 1 drops the uncond
        branch and serves at half the CFG compute."""
        img = _to_uint8(image)
        stack = self._load_stack("denoise")
        if stack is not None:
            try:
                spec = stack["spec"]
                gs = spec.sampler.guidance_scale if guidance is None else guidance
                return self._run_sd(stack, img, prompt or self.prompts["denoise"],
                                    spec.sampler.num_inference_steps, strength, gs,
                                    spec.sampler.sampler)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("SD denoise failed; OpenCV fallback")
        return fallbacks.denoise_opencv(img, strength)

    def _run_task(self, stack, task: str, img: np.ndarray, prompt: Optional[str],
                  mask_u8: Optional[np.ndarray] = None) -> np.ndarray:
        """``_run_sd`` with the task's prompt and sampler defaults."""
        sd = stack["spec"].sampler
        return self._run_sd(stack, img, prompt or self.prompts[task], sd.num_inference_steps,
                            sd.strength, sd.guidance_scale, sd.sampler, mask_u8=mask_u8)

    def super_resolve(self, image, scale: int = 4, prompt: Optional[str] = None,
                      **kwargs) -> np.ndarray:
        """LANCZOS x``scale`` first (the way the SR model is trained), then
        img2img. Without an SD stack: RRDBNet at ``scale == 4`` when its
        weights exist, else LANCZOS."""
        img = _to_uint8(image)
        stack = self._load_stack("sr_x4")
        if stack is not None:
            try:
                up = fallbacks.sr_lanczos(img, scale) if scale > 1 else img
                return self._run_task(stack, "sr_x4", up, prompt)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("SD super-resolution failed; next backend")
        if scale == 4 and rrdbnet.weights_available():
            try:
                out01 = rrdbnet.upscale_x4(img.astype(np.float32) / 255.0, self.device)
                return (out01 * 255).astype(np.uint8)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("RRDBNet upscaling failed; LANCZOS fallback")
        return fallbacks.sr_lanczos(img, scale)

    def colorize(self, image, prompt: Optional[str] = None, **kwargs) -> np.ndarray:
        img = _to_uint8(image)
        if fallbacks.is_color_image(img):
            logger.info("Image already has color; skipping colorization")
            return img
        img = fallbacks.gray_to_rgb(img)
        stack = self._load_stack("colorize")
        if stack is not None:
            try:
                return self._run_task(stack, "colorize", img, prompt)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("SD colorize failed; LAB fallback")
        return fallbacks.colorize_lab(img)

    def inpaint(self, image, mask=None, prompt: Optional[str] = None,
                **kwargs) -> np.ndarray:
        """``mask``: white (255) = the hole, HW or HWC (first channel), resized
        to the image and inverted when under 10% of it is white. With no mask,
        the very dark and very bright regions; none -> the image unchanged."""
        img = _to_uint8(image)
        if mask is None:
            mask_np = fallbacks.auto_mask_from_image(img)
            if mask_np is None:
                logger.info("No damage detected; skipping inpainting")
                return img
        else:
            mask_np = _to_uint8(mask)[..., 0] if np.asarray(mask).ndim == 3 else np.asarray(mask)
        mask_np = fallbacks.normalize_mask(np.asarray(mask_np), img.shape[:2])
        stack = self._load_stack("inpaint")
        if stack is not None:
            try:
                return self._run_task(stack, "inpaint", img, prompt, mask_u8=mask_np)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("SD inpaint failed; returning original")
        return img  # no classical inpaint fallback (as in the JAX pipeline)

    # ------------------------------------------------------------------
    # multi-task sequencing
    # ------------------------------------------------------------------

    def process(self, image, tasks: List[str], **kwargs) -> Dict[str, np.ndarray]:
        """Apply ``tasks`` in order to the running image; the result holds
        ``original``, ``final`` and ``denoised``, ``super_resolved``,
        ``colorized`` or ``inpainted`` for each task run. On a CPU pipeline a
        task that fails is logged and skipped; on the card it raises."""
        original = _to_uint8(image)
        results: Dict[str, np.ndarray] = {"original": original, "final": original}
        current = original
        for task in tasks:
            canon = ALIASES.get(task, task)
            try:
                if canon == "denoise":
                    current = self.denoise(
                        current, strength=kwargs.get("denoise_strength", 0.5),
                        prompt=kwargs.get("denoise_prompt"),
                        guidance=kwargs.get("denoise_guidance"),
                    )
                    results["denoised"] = current
                elif canon == "sr_x4":
                    current = self.super_resolve(current, scale=kwargs.get("sr_scale", 4),
                                                 prompt=kwargs.get("sr_prompt"))
                    results["super_resolved"] = current
                elif canon == "colorize":
                    current = self.colorize(current, prompt=kwargs.get("colorize_prompt"))
                    results["colorized"] = current
                elif canon == "inpaint":
                    current = self.inpaint(current, mask=kwargs.get("mask"),
                                           prompt=kwargs.get("inpaint_prompt"))
                    results["inpainted"] = current
                else:
                    logger.warning("Unknown task %r skipped", task)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("Error processing task %s", task)
                continue
        results["final"] = current
        return results
