"""Generate procedural "clean" photos into data/clean/{train,val,test}.

The port's counterpart of the JAX package's ``scripts/make_procedural_clean.py``:
an offline stand-in for a downloaded photo subset. Diverse procedural images
(gradient fields + blobs + stripes + vignettes) in the layout that
``make_synthetic_pairs`` reads, so the train -> predict -> evaluate workflow
runs end to end without the network. The same images bit for bit (numpy, one
generator from ``--seed``), the same split sizes and file names, written as
JPEG at quality 95. JPEG goes through PIL: where PIL is missing (the GPU
machine) writing raises an error that names it (``data/png.py``); such a
machine takes ``procedural_image``'s arrays and writes them as PNG itself. A
host job in numpy: nothing runs on a device.

    python -m image_restoration_and_enhancement_torch.make_procedural_clean [--out_root data/clean]
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from .data.png import save_image


def procedural_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """One diverse procedural RGB image in uint8: smooth gradients, texture
    and hard edges (the training signal of denoise and super-resolution)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    # base: random low-frequency color field
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 4) * x
                                        + rng.uniform(0.5, 4) * y
                                        + rng.uniform(0, 1))),
        0.5 + 0.5 * np.cos(2 * np.pi * (rng.uniform(0.5, 4) * y
                                        + rng.uniform(0, 1))),
        0.5 + 0.5 * np.sin(2 * np.pi * (x * y * rng.uniform(1, 6)
                                        + rng.uniform(0, 1))),
    ], axis=-1)
    # gaussian blobs
    for _ in range(rng.integers(3, 9)):
        cy, cx = rng.uniform(0, size, 2)
        r = rng.uniform(size * 0.03, size * 0.25)
        d2 = (np.mgrid[0:size, 0:size][0] - cy) ** 2 \
            + (np.mgrid[0:size, 0:size][1] - cx) ** 2
        blob = np.exp(-d2 / (2 * r * r))[..., None].astype(np.float32)
        img = img * (1 - 0.8 * blob) + 0.8 * blob * rng.uniform(0, 1, 3)
    # hard-edged rectangles (sharp structure for SR/denoise)
    for _ in range(rng.integers(1, 5)):
        y0, x0 = rng.integers(0, size - 8, 2)
        h, w = rng.integers(6, max(8, size // 3), 2)
        img[y0:y0 + h, x0:x0 + w] = (
            0.5 * img[y0:y0 + h, x0:x0 + w] + 0.5 * rng.uniform(0, 1, 3))
    # oriented stripes (texture)
    if rng.uniform() < 0.7:
        freq = rng.uniform(8, 40)
        ang = rng.uniform(0, np.pi)
        stripes = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (x * np.cos(ang) + y * np.sin(ang)))
        img = img * (1 - 0.25) + 0.25 * stripes[..., None]
    # vignette
    if rng.uniform() < 0.5:
        d = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
        img *= (1 - rng.uniform(0.2, 0.6) * d)[..., None]
    # mild photographic grain so "clean" isn't mathematically flat
    img += rng.normal(0, 0.004, img.shape).astype(np.float32)
    return (img.clip(0, 1) * 255).astype(np.uint8)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_root", default=os.path.join("data", "clean"))
    p.add_argument("--num_train", type=int, default=2000)
    p.add_argument("--num_val", type=int, default=200)
    p.add_argument("--num_test", type=int, default=100)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    for split, n in (("train", args.num_train), ("val", args.num_val),
                     ("test", args.num_test)):
        out = os.path.join(args.out_root, split)
        os.makedirs(out, exist_ok=True)
        for i in range(n):
            img = procedural_image(rng, args.size)
            save_image(os.path.join(out, f"{split}_{i:06d}.jpg"), img, quality=95)
        print(f"{split}: {n} images -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
