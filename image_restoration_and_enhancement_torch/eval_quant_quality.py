"""Quality gate for the int8 serving path and the approximate serving modes.

The port's counterpart of the JAX package's ``scripts/eval_quant_quality.py``,
with its flags plus ``--device``: runs the SAME weights through the img2img
(or inpaint) function with quantization off and on, on real val pairs, and
reports (a) PSNR/SSIM of each mode against the ground truth and (b) PSNR
between the two outputs (the int8-induced delta), then the same for the CFG
cache (``turbo(k=K)``), token merging (``tome(r)``) and both together, each
over the shipping base mode (int8_static for img2img tasks, exact for
inpaint).

    python -m image_restoration_and_enhancement_torch.eval_quant_quality \\
        --checkpoint outputs/models/denoising_realrun/best \\
        --pairs data/pairs/denoise/val --n 8 --size 256 [--device cpu]

Runs on the GPU unless ``--device cpu``. The calibration of mode
int8_static runs once per settings key (``make_calib_img2img_fn`` on the
first chunk) and its table serves every int8_static run of the gate, in one
``QuantState`` per run. ``--attn_int8_min N`` sends the default-backend
attention with Nq and Nk >= N to the plain s8 Q.K^T / P.V function in the
quantized runs only (``ops/attention.py``); the calibration and the bf16
reference run stay exact. Inputs are resized with PIL's BICUBIC (masks
NEAREST), as the JAX script's ``Image.resize`` does, by the port's own
versions (``infer/imaging.py``).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import checkpoint as ckpt
from .core import sampling
from .data.png import load_image
from .device import resolve_device
from .infer.imaging import resize_bicubic_pil, resize_nearest_pil
from .metrics import functional as F
from .models.tokenizer import load_tokenizer
from .ops import quant, token_merge
from .tasks.registry import get_task


def load_batch(pairs_dir: str, n: int, size: int, with_mask: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(inputs, ground truths) [n, size, size, 3] in [-1, 1] and, with
    ``with_mask``, masks [n, size, size, 1] in {0, 1}; CPU tensors."""
    in_dir, gt_dir = os.path.join(pairs_dir, "input"), os.path.join(pairs_dir, "gt")
    names = sorted(os.listdir(in_dir))[:n]

    def rd(d, name):
        img = resize_bicubic_pil(load_image(os.path.join(d, name), "RGB"), (size, size))
        return img.astype(np.float32) / 127.5 - 1.0

    x = np.stack([rd(in_dir, m) for m in names])
    g = np.stack([rd(gt_dir, m) for m in names])
    mask = None
    if with_mask:
        mask_dir = os.path.join(pairs_dir, "mask")

        def rdm(name):
            img = resize_nearest_pil(load_image(os.path.join(mask_dir, name), "L"), (size, size))
            return (img.astype(np.float32) / 255.0 > 0.5).astype(np.float32)

        mask = torch.from_numpy(np.stack([rdm(m) for m in names])[..., None])
    return torch.from_numpy(x), torch.from_numpy(g), mask


def run(modules: sampling.SDModules, ctx, un, x: torch.Tensor, steps: int, strength: float,
        gs: float, sampler: str, mode: Optional[str], cfg_cache: int = 1,
        attn_int8_min: int = 0, tome: float = 0.0, batch: int = 0,
        mask: Optional[torch.Tensor] = None,
        tables: Optional[Dict[tuple, Dict[str, float]]] = None) -> np.ndarray:
    """Serve x through the sampling function in the given mode; chunks of
    ``batch`` (0 = all at once), chunk i's noise from a generator seeded
    42 + i on the modules' device. ``tables`` caches the int8_static
    calibration by settings key across the runs of one gate (None:
    calibrate in this call). The modules' quantization, ToMe and attention
    settings are put back to off when the run returns."""
    dev = modules.device
    b = batch or len(x)
    table: Dict[str, float] = {}
    if mode == "int8_static":
        if mask is not None:
            raise ValueError("int8_static gate has no inpaint calib twin; "
                             "gate inpaint with --modes '' (bf16/tome/turbo)")
        # calibrate on the first chunk (one dynamic-int8 pass), with the
        # attention-quantization knob off; the scales depend only on (weights,
        # inputs, sampler settings), so the turbo / tome / combo runs of one
        # gate reuse them
        tables = {} if tables is None else tables
        ck = (steps, strength, gs, sampler, (b,) + tuple(x.shape[1:]))
        if ck not in tables:
            calib = sampling.make_calib_img2img_fn(modules, steps, strength, gs,
                                                   sampler=sampler)
            gen = torch.Generator(device=dev).manual_seed(42)
            _, tables[ck] = calib(x[:b], ctx, un, gen)
        table = tables[ck]
    modules.set_quant(quant.QuantState(mode, table) if mode else None)
    # ToMe only where the run asks for it (IRET_TOME, the serving switch, is
    # not read): JAX's token_merge.tome_mode(None) forces the ratio to 0
    modules.set_tome(token_merge.state_from_env(tome) if tome else None)
    modules.set_attn_int8(attn_int8_min)
    try:
        if mask is not None:
            fn = sampling.make_inpaint_fn(modules, steps, strength, gs, sampler,
                                          cfg_cache_interval=cfg_cache)
        else:
            fn = sampling.make_img2img_fn(modules, steps, strength, gs, sampler,
                                          cfg_cache_interval=cfg_cache)
        outs = []
        for i in range(0, len(x), b):
            gen = torch.Generator(device=dev).manual_seed(42 + i)
            if mask is not None:
                out = fn(x[i:i + b], mask[i:i + b], ctx, un, gen)
            else:
                out = fn(x[i:i + b], ctx, un, gen)
            outs.append(out.float().cpu().numpy())
    finally:
        modules.set_quant(None)
        modules.set_tome(None)
        modules.set_attn_int8(0)
    return np.concatenate(outs)


def metrics_vs(a01: np.ndarray, b01: np.ndarray) -> Tuple[float, float]:
    """Mean PSNR and SSIM over the pairs of two [N, H, W, 3] arrays in [0, 1]."""
    ps, ss = [], []
    for p, g in zip(a01, b01):
        p, g = torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(g))
        ps.append(float(F.psnr(p, g)))
        ss.append(float(F.ssim(p, g)))
    return float(np.mean(ps)), float(np.mean(ss))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default="outputs/models/denoising_realrun/best")
    p.add_argument("--pairs", default="data/pairs/denoise/val")
    p.add_argument("--task", default="denoise")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=8,
                   help="serve in chunks of this batch (0 = one batch of n)")
    p.add_argument("--strength", type=float, default=None,
                   help="override the task's serving strength (the wide "
                        "gate runs each task at >=2 strengths)")
    p.add_argument("--modes", default="int8,int8_static",
                   help="comma list; '' skips straight to the approximate-"
                        "mode gates (inpaint has no int8_static calib twin)")
    p.add_argument("--cfg_cache", type=int, default=1,
                   help="also gate the approximate turbo mode: int8_static "
                        "with cfg_cache_interval=K (core/sampling.py)")
    p.add_argument("--tome", type=float, default=0.0,
                   help="also gate the approximate token-merge mode: "
                        "int8_static with this merge ratio at the N>=4096 "
                        "self-attention sites (ops/token_merge.py)")
    p.add_argument("--attn_int8_min", type=int, default=0,
                   help="gate the quantized-attention path: route "
                        "attention with Nq and Nk >= this through s8 QK/PV "
                        "in the quantized runs; the bf16 reference run stays exact")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = get_task(args.task)
    modules = sampling.SDModules.create(spec.model_config, dtype=torch.bfloat16, device=dev)
    for comp, state in ckpt.load_state_dicts(args.checkpoint).items():
        modules.components()[comp].load_state_dict(state, strict=True)
    tok = load_tokenizer(args.checkpoint,
                         vocab_size=spec.model_config.text_encoder.vocab_size)
    ctx = sampling.encode_text(modules, torch.as_tensor(tok([spec.prompt])))
    s = spec.sampler
    strength = args.strength if args.strength is not None else s.strength
    un = (sampling.encode_text(modules, torch.as_tensor(tok([""])))
          if s.guidance_scale > 1.0 else None)
    uses_mask = spec.uses_mask
    x, gt, mask = load_batch(args.pairs, args.n, args.size, with_mask=uses_mask)
    # tome/turbo gates compose over the shipping base mode: int8_static for
    # img2img tasks, exact bf16 for inpaint (no static calib twin there)
    base_mode = None if uses_mask else "int8_static"
    common = dict(batch=args.batch, mask=mask, tables={})
    print(f"gate: task={args.task} n={len(x)} size={args.size} "
          f"strength={strength:g} batch={args.batch or len(x)}")

    out_bf16 = run(modules, ctx, un, x, s.num_inference_steps,
                   strength, s.guidance_scale, s.sampler, mode=None, **common)
    b01 = (out_bf16 + 1) / 2
    g01 = (gt.numpy() + 1) / 2
    p_b, s_b = metrics_vs(b01, g01)
    print(f"bf16        vs gt   : psnr {p_b:7.3f}  ssim {s_b:.4f}")

    def report(out, lbl):
        o01 = (out + 1) / 2
        p_q, s_q = metrics_vs(o01, g01)
        p_x, s_x = metrics_vs(o01, b01)
        print(f"{lbl:11s} vs gt   : psnr {p_q:7.3f}  ssim {s_q:.4f}")
        print(f"{lbl:11s} vs bf16 : psnr {p_x:7.3f}  ssim {s_x:.4f}")
        # repo-wide sign convention: mode - exact, positive = mode better
        print(f"gt-psnr delta ({lbl} - bf16): {p_q - p_b:+.4f} dB")

    for mode in filter(None, args.modes.split(",")):
        report(run(modules, ctx, un, x, s.num_inference_steps,
                   strength, s.guidance_scale, s.sampler, mode=mode,
                   attn_int8_min=args.attn_int8_min, **common), mode)
    if args.cfg_cache > 1:
        report(run(modules, ctx, un, x, s.num_inference_steps,
                   strength, s.guidance_scale, s.sampler, mode=base_mode,
                   cfg_cache=args.cfg_cache, attn_int8_min=args.attn_int8_min,
                   **common), f"turbo(k={args.cfg_cache})")
    if args.tome > 0.0:
        report(run(modules, ctx, un, x, s.num_inference_steps,
                   strength, s.guidance_scale, s.sampler, mode=base_mode,
                   tome=args.tome, attn_int8_min=args.attn_int8_min, **common),
               f"tome({args.tome:g})")
    if args.cfg_cache > 1 and args.tome > 0.0:
        # the combined fast-serving candidate: every approximate knob on at
        # once (int8_static + CFG cache + token merge), gated as shipped
        report(run(modules, ctx, un, x, s.num_inference_steps,
                   strength, s.guidance_scale, s.sampler, mode=base_mode,
                   cfg_cache=args.cfg_cache, tome=args.tome,
                   attn_int8_min=args.attn_int8_min, **common),
               f"combo(k{args.cfg_cache}+t{args.tome:g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
