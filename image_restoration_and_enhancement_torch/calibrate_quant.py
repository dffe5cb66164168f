"""Calibrate per-layer int8 activation scales for the int8_static serving mode.

The port's counterpart of the JAX package's ``scripts/calibrate_quant.py``,
writing the same JSON: ``{"sites": {site: absmax}, "meta": {...}}``, where a
site is a quantized layer's flax module path. It runs the img2img function
under dynamic int8 (``core.sampling.make_calib_img2img_fn``) on one batch per
seed and keeps, for every site, the largest activation absmax seen over the
VAE encode, every UNet call, the VAE decode and all seeds.

    python -m image_restoration_and_enhancement_torch.calibrate_quant \\
        --out outputs/quant_calib.json [--checkpoint DIR] [--images DIR] \\
        [--size 512] [--batch 8] [--steps 20] [--prompts "a photo" ...]

Without ``--checkpoint`` the SD-1.5 stack is initialised at random from
seed 0; without ``--images`` the inputs are uniform in [-1, 1]
(enough to calibrate a random stack; calibrate a trained checkpoint on real
task inputs). ``RestorationPipeline(quant="int8_static", quant_calib=OUT)``
loads the result. The stack runs in bf16, as it serves, on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import config as C
from .core import checkpoint as ckpt
from .core import sampling
from .device import resolve_device
from .models.layers import init_random_
from .models.tokenizer import load_tokenizer

# The attention of the int8 serve (K4), so the table sees the activations it will serve.
ATTENTION_BACKEND = "int8"


def _load_images(path: str, size: int, batch: int) -> torch.Tensor:
    from PIL import Image

    files = sorted(f for ext in ("*.png", "*.jpg", "*.jpeg")
                   for f in glob.glob(os.path.join(path, ext)))[:batch]
    if not files:
        raise SystemExit(f"no images under {path}")
    ims = [np.asarray(Image.open(f).convert("RGB").resize((size, size), Image.BICUBIC),
                      np.float32) / 127.5 - 1.0 for f in files]
    ims += [ims[-1]] * (batch - len(ims))
    return torch.from_numpy(np.stack(ims))


def _modules(args, device, dtype) -> sampling.SDModules:
    if not args.checkpoint:
        modules = sampling.SDModules.create(C.SD15, dtype, device, ATTENTION_BACKEND)
        gen = torch.Generator(device=device).manual_seed(0)
        for m in modules.components().values():
            init_random_(m, gen)
        return modules
    config = ckpt.load_pipeline_model_config(args.checkpoint) or C.SD15
    modules = sampling.SDModules.create(config, dtype, device, ATTENTION_BACKEND)
    params = ckpt.load_pipeline(args.checkpoint)
    for comp, module in modules.components().items():
        module.load_state_dict(ckpt.params_from_flax(params[comp]), strict=True)
    return modules


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs/quant_calib.json")
    ap.add_argument("--checkpoint", default=None,
                    help="pipeline directory; a random SD-1.5 stack if unset")
    ap.add_argument("--images", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--strength", type=float, default=1.0)
    ap.add_argument("--guidance_scale", type=float, default=5.0)
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "plms"])
    ap.add_argument("--prompts", nargs="*", default=["a high quality photo"])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    modules = _modules(args, device, torch.bfloat16)
    tok = load_tokenizer(args.checkpoint,
                         vocab_size=modules.config.text_encoder.vocab_size)
    ids = torch.as_tensor(tok([args.prompts[i % len(args.prompts)]
                               for i in range(args.batch)]))
    with torch.inference_mode():
        ctx = sampling.encode_text(modules, ids)
        uncond = sampling.encode_text(modules, torch.as_tensor(tok([""] * args.batch)))
    calib = sampling.make_calib_img2img_fn(modules, args.steps, args.strength,
                                           args.guidance_scale, sampler=args.sampler)
    table = {}
    for seed in args.seeds:
        gen = torch.Generator(device=device).manual_seed(seed)
        if args.images:
            image = _load_images(args.images, args.size, args.batch)
        else:
            image = torch.rand((args.batch, args.size, args.size, 3), generator=gen,
                               device=device) * 2.0 - 1.0
        _, stats = calib(image, ctx, uncond, generator=gen)
        for site, value in stats.items():
            table[site] = max(table.get(site, 0.0), value)
        print(f"seed {seed}: {len(stats)} sites")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"sites": table,
                   "meta": {"size": args.size, "steps": args.steps, "sampler": args.sampler,
                            "checkpoint": args.checkpoint or "random-init"}},
                  f, indent=1, sort_keys=True)
    print(f"wrote {len(table)} site scales -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
