"""The command line shared by the four task trainers (the port's counterpart of
the JAX package's ``scripts/_train_cli.py``, with its flags).

    python -m image_restoration_and_enhancement_torch.train_denoising \\
        --data_root data/pairs --output_dir outputs/models/denoising [--device cpu]

``train_super_resolution``, ``train_colorization`` and ``train_inpainting``
take the same flags. Trains on the GPU unless ``--device cpu``. With N > 1
CUDA cards and a ``--batch_size`` that divides by N the run trains over a
data mesh of N ranks, one card each (the JAX trainer's rule; the log says
when it trains on one device instead): started alone, the process starts the
N ranks itself; under ``torchrun --nproc_per_node N`` it is one of them.
``--no_mesh`` trains on one device whatever the machine has.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


def build_parser(task: str, default_output: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"Fine-tune Stable Diffusion for {task}")
    p.add_argument("--data_root", default="data/pairs",
                   help="root of the pair layout data/pairs/{task}/{split}")
    p.add_argument("--output_dir", default=default_output)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--lambda_img", type=float, default=0.05)
    p.add_argument("--gradient_accumulation_steps", type=int, default=8)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--resume", action="store_true",
                   help="resume from output_dir/train_state (exact, optimizer state included)")
    p.add_argument("--init_from", default=None,
                   help="pipeline checkpoint or diffusers directory to start the weights from")
    p.add_argument("--vae_init", default=None,
                   help="pipeline checkpoint whose VAE / text towers seed the frozen "
                        "components (e.g. pretrain_vae's best/)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--max_val_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_mesh", action="store_true",
                   help="train on one device; without it, a batch that divides by the "
                        "number of cards trains over all of them (data parallel)")
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    p.add_argument("--nan_guard", default="apply_if_finite",
                   choices=["apply_if_finite", "zero_grads"])
    p.add_argument("--state_save_epochs", type=int, default=5,
                   help="train-state cadence in epochs (the last is always saved); "
                        "0 = last only, -1 = never")
    p.add_argument("--val_strength", type=float, default=None,
                   help="override the task's validation sampler strength")
    p.add_argument("--val_steps", type=int, default=None,
                   help="override the task's validation sampler step count")
    p.add_argument("--val_guidance", type=float, default=None,
                   help="override the task's validation guidance scale")
    p.add_argument("--base_model", default="sd15",
                   choices=["sd15", "sdxl", "tiny_sd", "tiny_sdxl"],
                   help="model stack to fine-tune (tiny_* are the test configs); the "
                        "inpaint task takes the 9-channel SD-1.5 inpaint UNet under sd15")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def resolve_model_config(base_model: str, task: str):
    """--base_model -> an SDModelConfig (None: the task's own, SD-1.5)."""
    from . import config as C

    if base_model == "sd15":
        return None
    return {"sdxl": C.SDXL, "tiny_sd": C.TINY_SD, "tiny_sdxl": C.TINY_SDXL}[base_model]


def run(task: str, default_output: str, argv: Optional[List[str]] = None) -> int:
    args = build_parser(task, default_output).parse_args(argv)

    from .tasks.registry import get_task
    from .train.loop import TrainConfig
    from .train.trainer import train_task

    task_spec = None
    if any(v is not None for v in (args.val_strength, args.val_steps, args.val_guidance)):
        spec = get_task(task)
        vs = spec.val_sampler or spec.sampler
        vs = dataclasses.replace(
            vs,
            strength=vs.strength if args.val_strength is None else args.val_strength,
            num_inference_steps=(vs.num_inference_steps if args.val_steps is None
                                 else args.val_steps),
            guidance_scale=(vs.guidance_scale if args.val_guidance is None
                            else args.val_guidance))
        task_spec = dataclasses.replace(spec, val_sampler=vs)
    cfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lambda_img=args.lambda_img, image_size=args.image_size, seed=args.seed,
        save_steps=args.save_steps, optimizer=args.optimizer, nan_guard=args.nan_guard,
        state_save_epochs=args.state_save_epochs)
    metrics = train_task(
        task, data_root=args.data_root, output_dir=args.output_dir, cfg=cfg,
        init_from=args.init_from, vae_init=args.vae_init,
        max_train_samples=args.max_train_samples, max_val_samples=args.max_val_samples,
        use_mesh=not args.no_mesh, resume=args.resume,
        model_config=resolve_model_config(args.base_model, task), task_spec=task_spec,
        device=args.device)
    print({k: round(v, 4) for k, v in metrics.items()})
    return 0
