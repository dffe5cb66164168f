"""RestorationPipeline — the denoise task's img2img serve, in PyTorch.

Counterpart of the JAX package's ``infer/pipeline.py`` for the path this port
covers: ``process(image, ["denoise"])`` and ``denoise``, with the same
checkpoint discovery under ``outputs/models/{task}/best`` (or a pipeline
directory given as ``fine_tuned_dir``), the same 64-px bucketing of the input
size, prompt-context caching and the fixed seed.

Differences from the JAX pipeline:
- a failed SD run is logged ("SD denoise failed; OpenCV fallback") and served
  by the classical fallback only on a CPU pipeline. On the card every failure
  raises: a kernel that did not build or launch (``KernelError``), a device
  error, running out of memory. The work never moves to the CPU unseen.
- images come back as numpy uint8 HWC arrays, not ``PIL.Image``; a PIL image is
  still accepted as input. PIL is imported only when an input is a PIL image
  or the size is off the 64-px buckets (LANCZOS resizing); cv2 only when a
  fallback runs.
- ``device`` replaces the JAX device: ``cuda`` unless ``"cpu"`` is asked for.
- quantized serving (``quant="int8"`` or ``"int8_static"`` with
  ``quant_calib``, ``attention_backend="int8"``) keeps its mode and table in
  a ``QuantState`` owned by this pipeline and handed to its models, not in a
  process-global read at trace time; ``quant=None`` reads ``IRET_QUANT`` once,
  here. Under ``IRET_QUANT_STRICT`` a request that reached a site missing
  from the table raises ``StrictQuantError`` (never served by a fallback).
- the super-resolution, colorize and inpaint tasks, ToMe, the CFG cache and
  mesh serving, and the attention backends ``"flash"`` and
  ``"pallas_packed"``, are not ported yet (see ROADMAP.md).
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
from ..models.tokenizer import load_tokenizer
from ..ops import quant as quant_ops
from ..ops._build import KernelError
from ..ops.attention import check_backend
from ..tasks.registry import ALIASES, TASKS, get_task
from . import fallbacks

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


def _resize_lanczos(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img_u8).resize((hw[1], hw[0]), Image.LANCZOS))


def _bucket_hw(h: int, w: int, multiple: int = 64, max_size: int = 1024) -> Tuple[int, int]:
    """Round spatial dims to 64-px buckets, preserving aspect, capped at max_size."""
    scale = min(1.0, max_size / max(h, w))
    h2 = max(multiple, int(round(h * scale / multiple)) * multiple)
    w2 = max(multiple, int(round(w * scale / multiple)) * multiple)
    return min(h2, max_size), min(w2, max_size)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


class RestorationPipeline:
    """Multi-task restoration over the PyTorch SD stack (denoise ported so far)."""

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
    ):
        self.device = resolve_device(device)
        check_backend(attention_backend)
        self.attention_backend = attention_backend
        # quant=None defers to IRET_QUANT; "int8" = dynamic w8a8, "int8_static"
        # = calibrated scales from quant_calib (a site missing from the table
        # is quantized dynamically and reported, see _check_static_misses).
        self.quant = quant_ops.QuantState(
            quant_ops.mode_from_env(quant),
            load_quant_table(quant_calib) if quant_calib else {})
        self._warned_misses: set = set()
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
        """The pipeline directory to load for a task, or None."""
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
        # Pretrained mode: a local directory in the pipeline layout, named by
        # "pretrained_dir" or found under $IRET_PRETRAINED_ROOT/<pretrained_id>.
        candidates = [cfg["pretrained_dir"]] if cfg.get("pretrained_dir") else []
        root, pid = os.environ.get("IRET_PRETRAINED_ROOT"), cfg.get("pretrained_id")
        if root and pid:
            candidates += [os.path.join(root, pid), os.path.join(root, pid.replace("/", "--"))]
        for cand in candidates:
            if ckpt.pipeline_exists(cand):
                return cand
            if os.path.isdir(cand):
                logger.warning("%s is not in the pipeline layout; importing diffusers "
                               "directories is not ported yet", cand)
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
        logger.info("Loading %s stack from %s", task_name, src_dir)
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
        params = ckpt.load_pipeline(src_dir)
        for comp, module in modules.components().items():
            if comp not in params:
                raise FileNotFoundError(f"{src_dir} has no {comp} weights")
            module.load_state_dict(ckpt.params_from_flax(params.pop(comp)), strict=True)
        if self.quant.active:
            modules.set_quant(self.quant)
        tokenizer = load_tokenizer(src_dir, vocab_size=spec.model_config.text_encoder.vocab_size)
        stack = {"modules": modules, "tokenizer": tokenizer, "spec": spec}
        self._stacks[task_name] = stack
        return stack

    def _context(self, stack, prompt: str) -> torch.Tensor:
        """Text conditioning, cached per (task, prompt)."""
        key = (stack["spec"].name, prompt)
        if key not in self._ctx_cache:
            ids = torch.as_tensor(stack["tokenizer"]([prompt]))
            with torch.inference_mode():
                self._ctx_cache[key] = sampling.encode_text(stack["modules"], ids)
        return self._ctx_cache[key]

    def _sampler_fn(self, stack, steps: int, strength: float, gs: float, sampler: str):
        key = (stack["spec"].name, steps, round(strength, 4), round(gs, 4), sampler)
        if key not in self._fn_cache:
            self._fn_cache[key] = sampling.make_img2img_fn(
                stack["modules"], num_inference_steps=steps, strength=strength,
                guidance_scale=gs, sampler=sampler)
        return self._fn_cache[key]

    # ------------------------------------------------------------------
    # shared SD run helper
    # ------------------------------------------------------------------

    def _run_sd(self, stack, img_u8: np.ndarray, prompt: str, steps: int,
                strength: float, gs: float, sampler: str) -> np.ndarray:
        h, w = img_u8.shape[:2]
        bh, bw = _bucket_hw(h, w, max_size=self.max_size)
        if (bh, bw) != (h, w):
            img_u8 = _resize_lanczos(img_u8, (bh, bw))
        x = torch.from_numpy(img_u8.astype(np.float32) / 127.5 - 1.0)[None]
        ctx = self._context(stack, prompt)
        uncond = self._context(stack, "") if gs > 1.0 else None
        fn = self._sampler_fn(stack, steps, strength, gs, sampler)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        out = fn(x, ctx, uncond, generator=gen)[0].cpu().numpy()
        self._check_static_misses()
        out_u8 = ((out + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        if (bh, bw) != (h, w):
            out_u8 = _resize_lanczos(out_u8, (h, w))
        return out_u8

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
        only on a CPU pipeline, never for a kernel failure or a strict-mode
        calibration miss."""
        return self.device.type == "cpu" and not isinstance(err, (KernelError,
                                                                  StrictQuantError))

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

    def super_resolve(self, image, scale: int = 4, prompt: Optional[str] = None, **kwargs):
        _not_ported("super_resolve", "M10")

    def colorize(self, image, prompt: Optional[str] = None, **kwargs):
        _not_ported("colorize", "M10")

    def inpaint(self, image, mask=None, prompt: Optional[str] = None, **kwargs):
        _not_ported("inpaint", "M10")

    # ------------------------------------------------------------------
    # multi-task sequencing
    # ------------------------------------------------------------------

    def process(self, image, tasks: List[str], **kwargs) -> Dict[str, np.ndarray]:
        """Apply ``tasks`` in order to the running image. On a CPU pipeline a
        task that fails is logged and skipped; on the card it raises, and so
        does a task that is not ported yet."""
        original = _to_uint8(image)
        results: Dict[str, np.ndarray] = {"original": original, "final": original}
        current = original
        for task in tasks:
            canon = ALIASES.get(task, task)
            if canon in ("sr_x4", "colorize", "inpaint"):
                _not_ported(canon, "M10")
            try:
                if canon == "denoise":
                    current = self.denoise(
                        current, strength=kwargs.get("denoise_strength", 0.5),
                        prompt=kwargs.get("denoise_prompt"),
                        guidance=kwargs.get("denoise_guidance"),
                    )
                    results["denoised"] = current
                else:
                    logger.warning("Unknown task %r skipped", task)
            except Exception as e:
                if not self._fallback_allowed(e):
                    raise
                logger.exception("Error processing task %s", task)
                continue
        results["final"] = current
        return results
