"""Generate synthetic demo images + masks under data/demo (procedural images,
so the repository stays self-contained; the app shows them as examples).

The port's counterpart of the JAX package's ``scripts/make_demo_data.py``:
the same images, degradations and file names, written as PNG by the port's
codec. A host job in numpy: nothing runs on a device.

    python -m image_restoration_and_enhancement_torch.make_demo_data [--out_root data/demo]
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from .data import host_degradations as hd
from .data.png import save_image


def _procedural_image(seed: int, size: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (3 * x + rng.uniform(0, 1))),
        0.5 + 0.5 * np.cos(2 * np.pi * (2 * y + rng.uniform(0, 1))),
        0.5 + 0.5 * np.sin(2 * np.pi * (x * y * 4 + rng.uniform(0, 1))),
    ], axis=-1)
    for _ in range(6):  # some blobs
        cy, cx = rng.uniform(0, size, 2)
        r = rng.uniform(10, 50)
        d2 = (np.mgrid[0:size, 0:size][0] - cy) ** 2 + (np.mgrid[0:size, 0:size][1] - cx) ** 2
        blob = np.exp(-d2 / (2 * r * r))[..., None]
        color = rng.uniform(0, 1, 3)
        img = img * (1 - 0.7 * blob) + 0.7 * blob * color
    return (img.clip(0, 1) * 255).astype(np.uint8)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_root", default=os.path.join("data", "demo"))
    args = p.parse_args(argv)
    out_img = os.path.join(args.out_root, "images")
    out_mask = os.path.join(args.out_root, "mask")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_mask, exist_ok=True)
    rng = np.random.default_rng(42)
    for i in range(4):
        img = _procedural_image(i)
        name = f"demo_{i}.png"
        if i == 0:  # noisy
            img = hd.add_gaussian_noise(rng, img, (10.0, 12.0))
        elif i == 1:  # low-res look
            img = hd.degrade_sr(rng, img, 4)
        elif i == 2:  # grayscale
            g = hd.to_grayscale(img)
            img = np.stack([g] * 3, axis=-1)
        else:  # damaged + mask
            img, mask = hd.inpaint_pair(rng, img)
            save_image(os.path.join(out_mask, name), mask)
        save_image(os.path.join(out_img, name), img)
    print(f"wrote demo data under {args.out_root}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
