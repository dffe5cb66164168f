"""Generate synthetic degraded/clean training pairs for all four tasks.

The port's counterpart of the JAX package's ``scripts/make_synthetic_pairs.py``,
with the same flags, layout and file names: reads
``<clean_root>/{train,val,test}``, writes
``<out_root>/{task}/{split}/{input,gt[,mask]}`` with the degradations of
``data/host_degradations.py``, drawn in the JAX script's order from
``np.random.default_rng(seed + hash(split) % 1000)``.

    python -m image_restoration_and_enhancement_torch.make_synthetic_pairs \\
        --clean_root data/clean --out_root data/pairs [--splits val ...]

A host job in numpy: nothing runs on a device. Images are read and written
by the port's PNG codec (``data/png.py``; other formats through PIL). Python
salts ``hash`` per process, so the per-split seed, and with it the pairs,
differ between runs of either package unless ``PYTHONHASHSEED`` is fixed.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from .data import host_degradations as hd
from .data.datasets import IMG_EXTS
from .data.png import load_image, save_image

ALL_TASKS = ["denoise", "sr", "colorize", "inpaint"]


def process_split(clean_dir, out_root, split, args):
    src = os.path.join(clean_dir, split)
    if not os.path.isdir(src):
        print(f"WARNING: no clean images at {src}")
        return
    names = sorted(
        n for n in os.listdir(src) if os.path.splitext(n)[1].lower() in IMG_EXTS
    )
    print(f"[{split}] {len(names)} images")
    rng = np.random.default_rng(args.seed + hash(split) % 1000)

    def outdir(task, kind):
        d = os.path.join(out_root, task, split, kind)
        os.makedirs(d, exist_ok=True)
        return d

    for name in names:
        img = load_image(os.path.join(src, name), "RGB")
        img = hd.resize_to_max_size(img, args.max_size)
        stem = os.path.splitext(name)[0]

        if "denoise" in args.tasks:
            noisy = hd.degrade_denoise(rng, img, args.denoise_with_artifacts,
                                       tuple(args.denoise_sigma))
            save_image(os.path.join(outdir("denoise", "input"), name), noisy)
            save_image(os.path.join(outdir("denoise", "gt"), name), img)

        if "sr" in args.tasks:
            task = f"sr_x{args.sr_scale}"
            lr = hd.degrade_sr(rng, img, args.sr_scale, args.sr_with_jpeg,
                               args.sr_with_motion_blur)
            save_image(os.path.join(outdir(task, "input"), name), lr)
            save_image(os.path.join(outdir(task, "gt"), name), img)

        if "colorize" in args.tasks:
            gray = hd.to_grayscale(img)
            save_image(os.path.join(outdir("colorize", "input"), stem + ".png"), gray)
            save_image(os.path.join(outdir("colorize", "gt"), name), img)

        if "inpaint" in args.tasks:
            masked, mask = hd.inpaint_pair(rng, img, args.inpaint_easy_ratio)
            save_image(os.path.join(outdir("inpaint", "input"), name), masked)
            save_image(os.path.join(outdir("inpaint", "mask"), name), mask)
            save_image(os.path.join(outdir("inpaint", "gt"), name), img)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clean_root", default="data/clean")
    p.add_argument("--out_root", default="data/pairs")
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--tasks", nargs="+", default=ALL_TASKS, choices=ALL_TASKS)
    p.add_argument("--sr_scale", type=int, default=4)
    p.add_argument("--max_size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--denoise_with_artifacts", action="store_true")
    p.add_argument("--denoise_sigma", type=float, nargs=2, default=[5.0, 8.0],
                   metavar=("MIN", "MAX"),
                   help="Gaussian noise sigma range for the denoise family "
                        "(reference [5,8]; >=40 = the hard family whose "
                        "do-nothing baseline is actually beatable)")
    p.add_argument("--sr_with_jpeg", action="store_true")
    p.add_argument("--sr_with_motion_blur", action="store_true")
    p.add_argument("--inpaint_easy_ratio", type=float, default=0.7)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    for split in args.splits:
        process_split(args.clean_root, args.out_root, split, args)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
