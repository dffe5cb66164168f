"""Serving-protocol sweep for the restoration-learning demo's checkpoint.

The port's counterpart of the JAX package's ``scripts/demo_eval_sweep.py``
(its flags and defaults; ``--device``: ``cuda`` unless ``cpu`` is asked for;
``--artifact_dir`` defaults to ``{out}/artifacts``). Run after
``demo_restoration_learning``. On the trained ``{out}/model/best`` and the
val pairs it measures:

- the frozen VAE's round trip of the noisy input (posterior mean, no
  sampling): the zero-model control the diffusion points must beat;
- PLMS img2img without CFG at each of ``--strengths`` (seed 42);
- a ``--ensemble``-seed self-ensemble (the mean of samples from seeds 100,
  101, ...) at the best strength;

each as mean PSNR/SSIM over the images, and adds them to ``summary.json``
(``serving_sweep``, ``best_serving_psnr``, ``vae_roundtrip_psnr``,
``beats_do_nothing_served``, ``beats_vae_roundtrip``).

    python -m image_restoration_and_enhancement_torch.demo_eval_sweep \\
        [--out outputs/demo_learning] [--strengths 0.1,0.2] [--ensemble 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import checkpoint as ckpt
from .core import sampling
from .data.png import load_image
from .demo_restoration_learning import demo_model_config
from .device import DeviceLike, resolve_device
from .metrics import functional as F
from .models.tokenizer import load_tokenizer
from .tasks.registry import get_task


def load_val(out: str) -> Tuple[np.ndarray, np.ndarray]:
    """(input, gt) of the demo's val pairs, [n, H, W, 3] float32 in [-1, 1]."""
    vdir = os.path.join(out, "pairs", "denoise", "val")
    names = sorted(os.listdir(os.path.join(vdir, "gt")))

    def read(kind):
        return np.stack([load_image(os.path.join(vdir, kind, n)).astype(np.float32)
                         / 127.5 - 1 for n in names])

    return read("input"), read("gt")


def load_stack(checkpoint: str, device: DeviceLike = None) -> sampling.SDModules:
    """The demo's stack in fp32 with the checkpoint's weights."""
    modules = sampling.SDModules.create(demo_model_config(), dtype=torch.float32,
                                        device=resolve_device(device))
    states = ckpt.load_state_dicts(checkpoint)
    for comp, module in modules.components().items():
        module.load_state_dict(states[comp], strict=True)
    return modules


@torch.no_grad()
def task_context(modules: sampling.SDModules, checkpoint: str, batch: int) -> torch.Tensor:
    """The denoise prompt's context, broadcast to ``batch``: the checkpoint's
    tokenizer, else the hash tokenizer the trainer used."""
    tok = load_tokenizer(checkpoint, vocab_size=modules.config.text_encoder.vocab_size)
    ctx = sampling.encode_text(modules, torch.as_tensor(tok([get_task("denoise").prompt])))
    return ctx.expand((batch,) + ctx.shape[1:])


def metrics(out: torch.Tensor, gt: np.ndarray) -> Tuple[float, float]:
    """Mean PSNR and SSIM over images of a [-1, 1] output against the gt."""
    o01 = (out.float().cpu() + 1) / 2
    g01 = (torch.from_numpy(gt) + 1) / 2
    return float(np.mean(F.psnr(o01, g01).tolist())), float(np.mean(F.ssim(o01, g01).tolist()))


@torch.inference_mode()
def roundtrip(modules: sampling.SDModules, x: np.ndarray) -> torch.Tensor:
    image = torch.from_numpy(x).to(modules.device)
    return sampling.decode_latents(modules, sampling.encode_image(modules, image))


def serve(modules: sampling.SDModules, x: np.ndarray, ctx: torch.Tensor, strength: float,
          steps: int, seed: int,
          noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """PLMS img2img at ``strength`` without CFG, its noise drawn from ``seed``
    on the modules' device (or given)."""
    fn = sampling.make_img2img_fn(modules, num_inference_steps=steps, strength=strength,
                                  guidance_scale=0.0, sampler="plms")
    gen = torch.Generator(device=modules.device).manual_seed(seed)
    return fn(torch.from_numpy(x), ctx, None, generator=gen, noise=noise)


def sweep(modules: sampling.SDModules, x: np.ndarray, gt: np.ndarray, ctx: torch.Tensor,
          strengths: List[float], steps: int, ensemble: int) -> Dict[str, Dict[str, float]]:
    results = {}
    ps, ss = metrics(roundtrip(modules, x), gt)
    results["vae_roundtrip"] = {"psnr": round(ps, 4), "ssim": round(ss, 4)}
    print(f"vae_roundtrip: psnr {ps:7.3f}  ssim {ss:.4f}")

    best_s, best_p = None, -1e9
    for s in strengths:
        ps, ss = metrics(serve(modules, x, ctx, s, steps, 42), gt)
        results[f"strength_{s:g}"] = {"psnr": round(ps, 4), "ssim": round(ss, 4)}
        print(f"strength {s:4.2f}: psnr {ps:7.3f}  ssim {ss:.4f}")
        if ps > best_p:
            best_s, best_p = s, ps

    acc = None
    for k in range(ensemble):
        out = serve(modules, x, ctx, best_s, steps, 100 + k).float()
        acc = out if acc is None else acc + out
    ps, ss = metrics(acc / ensemble, gt)
    results[f"ensemble_{ensemble}_strength_{best_s:g}"] = {"psnr": round(ps, 4),
                                                           "ssim": round(ss, 4)}
    print(f"ensemble x{ensemble} @ strength {best_s:g}: psnr {ps:7.3f}  ssim {ss:.4f}")
    return results


def update_summary(path: str, results: Dict[str, Dict[str, float]]) -> dict:
    summary = {}
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    summary["serving_sweep"] = results
    diffusion_best = max(v["psnr"] for k, v in results.items() if k != "vae_roundtrip")
    summary["best_serving_psnr"] = round(diffusion_best, 4)
    summary["vae_roundtrip_psnr"] = results["vae_roundtrip"]["psnr"]
    summary["beats_do_nothing_served"] = bool(
        diffusion_best > summary.get("input_baseline_psnr", 1e9))
    summary["beats_vae_roundtrip"] = bool(diffusion_best > results["vae_roundtrip"]["psnr"])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "demo_learning"))
    p.add_argument("--strengths", default="0.3,0.45,0.6,0.75,0.9")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--ensemble", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--artifact_dir", default=None, help="default: {out}/artifacts")
    args = p.parse_args(argv)

    best = os.path.join(args.out, "model", "best")
    modules = load_stack(best, args.device)
    x, gt = load_val(args.out)
    ctx = task_context(modules, best, x.shape[0])
    results = sweep(modules, x, gt, ctx, [float(v) for v in args.strengths.split(",")],
                    args.steps, args.ensemble)
    summary = update_summary(
        os.path.join(args.artifact_dir or os.path.join(args.out, "artifacts"), "summary.json"),
        results)
    print(json.dumps({k: summary[k] for k in ("best_serving_psnr", "beats_do_nothing_served")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
