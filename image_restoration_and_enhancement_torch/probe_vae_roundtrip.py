"""Measure a frozen VAE's round-trip quality on a pairs split: the ceiling on
any serve's output quality, since everything the pipeline emits passes
through the decoder.

The port's counterpart of the JAX package's ``scripts/probe_vae_roundtrip.py``
(its flags and defaults; ``--device``: ``cuda`` unless ``cpu`` is asked for).
For the first ``--n`` input/gt pairs, each resized to ``--size`` with PIL's
LANCZOS where it differs (``infer/imaging.py``), it prints one JSON line with
the PSNR of:

  rt_input_vs_gt     decode(encode(input)) vs gt: the ceiling of a
                     near-passthrough (low-strength) serve
  rt_input_vs_input  decode(encode(input)) vs input: reconstruction of the
                     degraded (off-manifold) inputs
  rt_gt_vs_gt        decode(encode(gt)) vs gt: reconstruction of clean images
  input_vs_gt        the do-nothing baseline to beat

The round trip decodes the posterior mean, unclamped, as the JAX script does.
On the GPU machine (no PIL) the pairs must be PNG.

    python -m image_restoration_and_enhancement_torch.probe_vae_roundtrip \\
        --checkpoint outputs/demo_learning/vae_pretrained/best \\
        --pairs outputs/demo_learning/pairs/denoise/val --size 64 --dtype float32
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import config as C
from .core import checkpoint as ckpt
from .data.png import load_image
from .device import DeviceLike, resolve_device
from .infer.imaging import resize_lanczos_pil
from .metrics import functional as F
from .models.layers import CL
from .models.vae import AutoencoderKL


def load_dir(directory: str, n: int, size: int) -> np.ndarray:
    """The first ``n`` images of ``directory`` (sorted) as [n, size, size, 3]
    float32 in [-1, 1]."""
    out = []
    for f in sorted(os.listdir(directory))[:n]:
        img = load_image(os.path.join(directory, f), "RGB")
        if img.shape[:2] != (size, size):
            img = resize_lanczos_pil(img, (size, size))
        out.append(img.astype(np.float32) / 127.5 - 1.0)
    return np.stack(out)


def load_vae(checkpoint: str, dtype: torch.dtype, device: torch.device) -> AutoencoderKL:
    """The checkpoint's VAE (its own config, else SD-1.5's) in ``dtype``."""
    cfg = ckpt.load_pipeline_model_config(checkpoint) or C.SD15
    with torch.device("meta"):
        vae = AutoencoderKL(cfg.vae).to(dtype, memory_format=CL)
    vae = vae.to_empty(device=device).eval()
    vae.load_state_dict(ckpt.load_state_dicts(checkpoint)["vae"], strict=True)
    return vae


def mean_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean over images of the PSNR of two [-1, 1] batches, to 3 decimals."""
    vals = F.psnr(torch.from_numpy((a + 1) / 2), torch.from_numpy((b + 1) / 2))
    return round(float(np.mean(vals.tolist())), 3)


def probe(checkpoint: str, pairs: str, n: int = 32, size: int = 256, batch: int = 8,
          dtype: str = "bfloat16", device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    vae = load_vae(checkpoint, getattr(torch, dtype), dev)

    @torch.inference_mode()
    def rt(x: np.ndarray) -> np.ndarray:
        outs = []
        for i in range(0, len(x), batch):
            xb = torch.from_numpy(x[i:i + batch]).to(dev, getattr(torch, dtype))
            y = vae.decode(vae.encode(xb).mean)
            outs.append(y.float().cpu().numpy())
        return np.concatenate(outs)

    inp = load_dir(os.path.join(pairs, "input"), n, size)
    gt = load_dir(os.path.join(pairs, "gt"), n, size)
    rt_inp, rt_gt = rt(inp), rt(gt)
    return {
        "checkpoint": checkpoint,
        "pairs": pairs,
        "n": len(inp),
        "dtype": dtype,
        "device": str(dev),
        "rt_input_vs_gt": mean_psnr(rt_inp, gt),
        "rt_input_vs_input": mean_psnr(rt_inp, inp),
        "rt_gt_vs_gt": mean_psnr(rt_gt, gt),
        "input_vs_gt": mean_psnr(inp, gt),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="Pipeline dir with a vae component")
    p.add_argument("--pairs", default=os.path.join("data", "pairs_hard", "denoise", "val"))
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(probe(args.checkpoint, args.pairs, args.n, args.size, args.batch,
                           args.dtype, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
