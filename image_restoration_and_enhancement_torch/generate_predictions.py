"""Run the RestorationPipeline over a test split and save the final outputs.

The port's counterpart of the JAX package's ``scripts/generate_predictions.py``,
with the same flags and layout: the stacks under
``<models_root>/<model_dir>/best``, the inputs (and inpaint masks) under
``<data_root>/<pair_dir>/<split>/{input,mask}``, each prediction written to
``<out_root>/<pair_dir>/`` under its input's file name, for
``evaluate_model``. A ``.png`` name is written by the port's PNG codec; any
other name in its own format through PIL (JPEG at PIL's default quality 75,
as the JAX script's ``Image.save`` does), which raises where PIL is missing.

    python -m image_restoration_and_enhancement_torch.generate_predictions \\
        --data_root data/pairs --models_root outputs/models \\
        --out_root outputs/predictions [--tasks denoise ...] [--device cuda]

Runs on the GPU unless ``--device cpu``, in bf16 unless ``--dtype float32``.
``--spatial_shards N`` (N > 1) serves each image with its height sharded over N
ranks, an ``("sp",)`` mesh (``parallel/``): under ``torchrun`` with WORLD_SIZE
= N it uses that world; started alone it spawns N ranks
(``parallel/launch.py``): NCCL with one card a rank on ``--device cuda`` (more
ranks than cards raises), gloo on ``--device cpu``. Every rank serves every
image; rank 0 alone writes the files.

    torchrun --nproc_per_node 4 -m image_restoration_and_enhancement_torch.generate_predictions \\
        --spatial_shards 4 --max_size 2048 ...
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from .data.png import load_image, save_image
from .infer.pipeline import RestorationPipeline
from .tasks.registry import TASKS


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", default="data/pairs")
    p.add_argument("--out_root", default="outputs/predictions")
    p.add_argument("--models_root", default="outputs/models")
    p.add_argument("--tasks", nargs="+", default=list(TASKS), choices=list(TASKS))
    p.add_argument("--split", default="test")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--max_size", type=int, default=1024,
                   help="resolution cap (the reference's >1MP guard)")
    p.add_argument("--spatial_shards", type=int, default=0,
                   help="shard each image's height over this many ranks (one device each)")
    p.add_argument("--quant", default=None, choices=["none", "int8", "int8_static"])
    p.add_argument("--quant_calib", default=None,
                   help="calibration JSON from calibrate_quant (required for int8_static)")
    p.add_argument("--cfg_cache", type=int, default=1)
    p.add_argument("--tome", type=float, default=0.0)
    p.add_argument("--denoise_guidance", type=float, default=None,
                   help="override the denoise CFG scale (gs<=1 disables the uncond branch)")
    p.add_argument("--denoise_strength", type=float, default=0.5,
                   help="serving strength for the denoise task")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="the SD stacks' compute dtype")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.spatial_shards <= 1:
        return _generate(args)
    backend = "nccl" if args.device == "cuda" else "gloo"
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        from .parallel.launch import launch

        return max(launch(_rank_main, args.spatial_shards, backend, (argv,)))
    if int(world) != args.spatial_shards:
        raise ValueError(f"--spatial_shards {args.spatial_shards} under a world of {world} ranks")
    from .parallel.mesh import init_from_env

    init_from_env(backend)
    return _generate(args, sharded=True)


def _rank_main(argv: Optional[List[str]]) -> int:
    """One spawned rank: the same run, on its share of each image."""
    return _generate(_parser().parse_args(argv), sharded=True)


def _generate(args, sharded: bool = False) -> int:
    mesh_kw, writer = {}, True
    if sharded:
        import torch.distributed as dist

        from .parallel.mesh import make_mesh

        mesh_kw = {"mesh": make_mesh((args.spatial_shards,), ("sp",)), "spatial_axis": "sp"}
        writer = dist.get_rank() == 0
    pipeline = RestorationPipeline(models_root=args.models_root, max_size=args.max_size,
                                   quant=args.quant, quant_calib=args.quant_calib,
                                   cfg_cache_interval=args.cfg_cache, tome_ratio=args.tome,
                                   device=args.device, dtype=getattr(torch, args.dtype),
                                   **mesh_kw)
    for task in args.tasks:
        spec = TASKS[task]
        in_dir = os.path.join(args.data_root, spec.pair_dir, args.split, "input")
        mask_dir = os.path.join(args.data_root, spec.pair_dir, args.split, "mask")
        out_dir = os.path.join(args.out_root, spec.pair_dir)
        if writer:
            os.makedirs(out_dir, exist_ok=True)
        if not os.path.isdir(in_dir):
            if writer:
                print(f"[{task}] no inputs at {in_dir}, skipping")
            continue
        names = sorted(os.listdir(in_dir))[: args.max_images]
        if writer:
            print(f"[{task}] {len(names)} images")
        for name in names:
            img = load_image(os.path.join(in_dir, name), "RGB")
            kwargs = {"denoise_strength": args.denoise_strength,
                      "denoise_guidance": args.denoise_guidance}
            if spec.uses_mask:
                mpath = os.path.join(mask_dir, name)
                if os.path.exists(mpath):
                    kwargs["mask"] = load_image(mpath, "L")
            result = pipeline.process(img, [task], **kwargs)
            if writer:
                save_image(os.path.join(out_dir, name), result["final"])
    if writer:
        print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
