"""Measured proof that the training loop learns restoration: a small SD stack
trained from scratch on a low-dimensional procedural image family under heavy
noise, then served, against the do-nothing input baseline.

The port's counterpart of the JAX package's
``scripts/demo_restoration_learning.py``, with its flags, defaults and
stages, on ``--device`` (``cuda`` unless ``cpu`` is asked for; JAX's
``--platform``):

1. data: ~9-dof smooth sinusoid fields (``demo_image``) and their
   sigma-``--sigma`` noisy copies, the same pixels as the JAX script's for a
   seed, as PNG under ``{out}/clean/{split}`` and
   ``{out}/pairs/denoise/{split}/{input,gt}`` (skipped when the val gt exists);
2. ``pretrain_vae`` on the clean images (``--vae_data mixed``: on clean and
   noisy ones), skipped when ``{out}/vae_pretrained/best`` exists;
3. ``train_task("denoise")`` from random init with the frozen VAE seeded from
   stage 2, fp32, the demo's task spec (validation: PLMS, strength 0.6, 20
   steps, no CFG), resuming from its train state;
4. ``summary.json`` (the input baseline against the validation curve), the
   metrics CSVs, the training log and the first and last validation strips in
   ``--artifact_dir``. The CSV is appended across runs: the summary reads the
   last run's rows only.

``--artifact_dir`` defaults to ``{out}/artifacts`` (the JAX script's default
is the committed JAX record, which the port never writes over).

    python -m image_restoration_and_enhancement_torch.demo_restoration_learning \\
        [--out outputs/demo_learning] [--vae_epochs 24 --epochs 48] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from . import config as C
from .core import checkpoint as ckpt
from .data.png import load_image, save_image
from .device import DeviceLike, resolve_device
from .metrics import functional as F
from .tasks.registry import SamplerDefaults, TaskSpec, get_task
from .train import trainer, vae_pretrain
from .train.loop import TrainConfig


def demo_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """One smooth low-dimensional RGB field in uint8 (~9 random dof)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    chans = []
    for _ in range(3):
        fx, fy = rng.uniform(0.3, 1.5), rng.uniform(0.3, 1.5)
        ph = rng.uniform(0, 1)
        chans.append(0.5 + 0.45 * np.sin(2 * np.pi * (fx * x + fy * y + ph)))
    img = np.stack(chans, axis=-1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def gen_data(out: str, size: int, sigma: float, n_train: int, n_val: int,
             seed: int) -> None:
    """Clean images and sigma-noise pairs as PNG, one generator for all draws."""
    rng = np.random.default_rng(seed)
    for split, n in [("train", n_train), ("val", n_val)]:
        clean_dir = os.path.join(out, "clean", split)
        in_dir = os.path.join(out, "pairs", "denoise", split, "input")
        gt_dir = os.path.join(out, "pairs", "denoise", split, "gt")
        for d in (clean_dir, in_dir, gt_dir):
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            img = demo_image(rng, size)
            noisy = np.clip(
                img.astype(np.float32) + rng.normal(0, sigma, img.shape),
                0, 255,
            ).astype(np.uint8)
            save_image(os.path.join(clean_dir, f"i{i:04d}.png"), img)
            save_image(os.path.join(gt_dir, f"i{i:04d}.png"), img)
            save_image(os.path.join(in_dir, f"i{i:04d}.png"), noisy)


def demo_model_config() -> C.SDModelConfig:
    """The demo's small (not tiny) stack: TINY_UNET at (32, 64, 64, 64) with 4
    heads, TINY_VAE at (16, 32, 32, 32), TINY_CLIP_TEXT."""
    unet = dataclasses.replace(C.TINY_UNET, block_out_channels=(32, 64, 64, 64),
                               num_attention_heads=4)
    vae = dataclasses.replace(C.TINY_VAE, block_out_channels=(16, 32, 32, 32))
    return C.SDModelConfig(unet=unet, vae=vae, text_encoder=C.TINY_CLIP_TEXT)


def demo_task_spec(model_config: C.SDModelConfig) -> TaskSpec:
    """The denoise task with the heavy-noise validation protocol (no CFG: one
    constant prompt makes guidance pure overhead here)."""
    return dataclasses.replace(get_task("denoise"),
                               val_sampler=SamplerDefaults(0.6, 20, 0.0, "plms"),
                               model_config=model_config)


def input_baseline(val_dir: str, device: DeviceLike = "cpu") -> float:
    """The do-nothing score: mean PSNR of the val inputs against their gt, as
    run_validation logs it."""
    dev = torch.device(device)
    base = []
    for f in sorted(os.listdir(os.path.join(val_dir, "gt"))):
        g = load_image(os.path.join(val_dir, "gt", f)).astype(np.float32) / 255
        i = load_image(os.path.join(val_dir, "input", f)).astype(np.float32) / 255
        base.append(float(F.psnr(torch.from_numpy(i).to(dev), torch.from_numpy(g).to(dev))))
    return float(np.mean(base))


def last_run_rows(csv_path: str) -> List[Dict[str, str]]:
    """The rows of the last run in an append-mode metrics CSV: a rerun restarts
    the epoch counter at 1."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    start = 0
    for i in range(1, len(rows)):
        if int(float(rows[i]["epoch"])) <= int(float(rows[i - 1]["epoch"])):
            start = i
    return rows[start:]


def summarize(out: str, sigma: float, n_train: int, device: DeviceLike = "cpu") -> dict:
    rows = last_run_rows(os.path.join(out, "model", "metrics_denoise.csv"))
    psnrs = [float(r["psnr"]) for r in rows]
    epochs = [int(float(r["epoch"])) for r in rows]
    base = input_baseline(os.path.join(out, "pairs", "denoise", "val"), device)
    return {
        "input_baseline_psnr": round(base, 4),
        "epoch1_psnr": round(psnrs[0], 4),
        "best_psnr": round(max(psnrs), 4),
        "best_epoch": epochs[int(np.argmax(psnrs))],
        "final_psnr": round(psnrs[-1], 4),
        "rising_curve": bool(max(psnrs) > psnrs[0]),
        "beats_do_nothing": bool(max(psnrs) > base),
        "epochs": len(psnrs),
        "sigma": sigma,
        "n_train": n_train,
    }


def _mixed_vae_data(out: str) -> str:
    """A clean + noisy corpus for the VAE (copies, named by kind), so the
    autoencoder learns to reconstruct degradations instead of projecting them
    away."""
    root = os.path.join(out, "vae_mix")
    for split in ("train", "val"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for kind, sub in (("clean", os.path.join(out, "clean", split)),
                          ("noisy", os.path.join(out, "pairs", "denoise", split, "input"))):
            for f in os.listdir(sub):
                dst = os.path.join(d, f"{kind}_{f}")
                if not os.path.exists(dst):
                    shutil.copy(os.path.join(sub, f), dst)
    return root


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("outputs", "demo_learning"))
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--sigma", type=float, default=80.0)
    p.add_argument("--n_train", type=int, default=128)
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--vae_epochs", type=int, default=24)
    p.add_argument("--epochs", type=int, default=48)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--artifact_dir", default=None, help="default: {out}/artifacts")
    p.add_argument("--vae_data", default="clean", choices=["clean", "mixed"],
                   help="mixed = pretrain the VAE on clean AND noisy images, so its "
                        "round trip is no free denoiser")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    artifact_dir = args.artifact_dir or os.path.join(args.out, "artifacts")
    model_config = demo_model_config()

    # stage 1: data (idempotent)
    marker = os.path.join(args.out, "pairs", "denoise", "val", "gt")
    if not os.path.isdir(marker) or not os.listdir(marker):
        print("== stage 1: generating demo data")
        gen_data(args.out, args.size, args.sigma, args.n_train, args.n_val, args.seed)

    # stage 2: frozen-VAE pretrain (idempotent)
    vae_data_root = (_mixed_vae_data(args.out) if args.vae_data == "mixed"
                     else os.path.join(args.out, "clean"))
    vae_dir = os.path.join(args.out, "vae_pretrained")
    if not ckpt.pipeline_exists(os.path.join(vae_dir, "best")):
        print(f"== stage 2: VAE reconstruction pretrain ({args.vae_data})")
        m = vae_pretrain.pretrain_vae(
            data_root=vae_data_root, output_dir=vae_dir,
            cfg=vae_pretrain.VAEPretrainConfig(num_epochs=args.vae_epochs, batch_size=args.batch_size,
                                  learning_rate=1e-3, image_size=args.size, seed=args.seed),
            model_config=model_config, use_mesh=False, dtype=torch.float32, device=dev)
        print("vae:", {k: round(float(v), 4) for k, v in m.items()})

    # stage 3: the denoise task under the heavy-noise demo spec
    print("== stage 3: train_task denoise (heavy-noise demo spec)")
    metrics = trainer.train_task(
        "denoise", data_root=os.path.join(args.out, "pairs"),
        output_dir=os.path.join(args.out, "model"),
        cfg=TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                        gradient_accumulation_steps=1, learning_rate=args.learning_rate,
                        image_size=args.size, save_steps=-1, state_save_epochs=0,
                        seed=args.seed),
        vae_init=os.path.join(vae_dir, "best"), use_mesh=False, dtype=torch.float32,
        resume=True, task_spec=demo_task_spec(model_config), device=dev)
    print("final val:", {k: round(float(v), 4) for k, v in metrics.items()})

    # stage 4: summary and evidence
    summary = summarize(args.out, args.sigma, args.n_train, dev)
    print(json.dumps(summary))
    os.makedirs(artifact_dir, exist_ok=True)
    with open(os.path.join(artifact_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for src in ("model/metrics_denoise.csv", "model/training_denoise.log",
                "vae_pretrained/metrics_vae.csv"):
        sp = os.path.join(args.out, src)
        if os.path.exists(sp):
            shutil.copy(sp, artifact_dir)
    strips = os.path.join(args.out, "model", "val_samples")
    if os.path.isdir(strips):
        names = sorted(os.listdir(strips), key=lambda n: int(n.split("_")[1].split(".")[0]))
        for n in {names[0], names[-1]}:
            shutil.copy(os.path.join(strips, n), artifact_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
