"""Synthetic pairs degraded on the card (the port's copy of the JAX package's
``data/synthetic.py``).

Clean images are loaded once and cached on the host; each batch's
degradations are drawn and applied on the loader's device by the batched
functions of ``data/degradations.py``: fresh degradations every epoch and no
disk. A batch is ``draw_batch`` (the random draws, from a generator seeded by
(seed, epoch, batch index)) followed by ``degrade_batch`` (a deterministic
function of the clean batch and the draws), so a batch made on the card can be
recomputed on the CPU from the same draws.

    loader = SyntheticPairLoader("denoise", clean_paths, image_size=256,
                                 batch_size=8)
    for batch in loader.epoch(epoch_idx):   # dict of tensors on the device
        ...

Batches are dicts of [B, H, W, C] float32 tensors in [-1, 1] (``input``,
``gt``, and for inpaint ``mask`` in {0, 1}), the ``PairDataset`` contract.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.image import resize
from ..tasks.registry import get_task
from . import degradations as deg
from . import native
from .datasets import IMG_EXTS
from .png import load_image


def list_clean_images(directory: str) -> List[str]:
    return [
        os.path.join(directory, n)
        for n in sorted(os.listdir(directory))
        if os.path.splitext(n)[1].lower() in IMG_EXTS
    ]


def draw_batch(task: str, gen: torch.Generator, batch: int, image_size: int,
               device=None) -> deg.Draws:
    """The random draws of one batch of ``task`` (``degrade_batch``'s input)."""
    name = get_task(task).name
    hw = (image_size, image_size)
    if name == "denoise":
        return deg.draw_denoise(gen, (batch, image_size, image_size, 3), device=device)
    if name == "sr_x4":
        return deg.draw_sr(gen, batch, device=device)
    if name == "colorize":
        return {}
    if name == "inpaint":
        return deg.draw_inpaint(gen, batch, hw, device=device)
    raise ValueError(name)


def degrade_batch(task: str, clean: torch.Tensor, draws: deg.Draws,
                  sr_scale: int = 4) -> Dict[str, torch.Tensor]:
    """clean [B, H, W, 3] in [0, 1] -> the batch dict in [-1, 1]."""
    name = get_task(task).name
    if name == "denoise":
        inp = deg.degrade_denoise(clean, draws)
    elif name == "sr_x4":
        lr = deg.degrade_sr(clean, draws["ksize"], scale=sr_scale)
        # bicubic back up: the SR training conditioning
        inp = resize(lr, clean.shape[-3:-1], method="bicubic").clamp(0.0, 1.0)
    elif name == "colorize":
        inp = deg.degrade_colorize(clean)
    elif name == "inpaint":
        inp, mask = deg.degrade_inpaint(clean, draws)
        return {"input": inp * 2 - 1, "gt": clean * 2 - 1, "mask": mask}
    else:
        raise ValueError(name)
    return {"input": inp * 2 - 1, "gt": clean * 2 - 1}


def _batch_seed(seed: int, epoch_idx: int, batch_idx: int) -> int:
    """The generator seed of one batch: independent streams per (seed, epoch,
    batch), as JAX folds the epoch and the batch index into its key."""
    return int(np.random.SeedSequence([seed, epoch_idx, batch_idx]).generate_state(1)[0])


class SyntheticPairLoader:
    """Loads clean images once (host, resized with ``native.resize_bicubic``),
    then yields freshly degraded batches on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""

    def __init__(
        self,
        task: str,
        clean_paths: Sequence[str],
        image_size: int = 256,
        batch_size: int = 8,
        seed: int = 0,
        sr_scale: int = 4,
        cache_in_memory: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.task = get_task(task).name
        self.image_size = image_size
        self.batch_size = batch_size
        self.seed = seed
        self.sr_scale = sr_scale
        self.paths = list(clean_paths)
        if not self.paths:
            raise ValueError("no clean images given")
        self._cache: Optional[np.ndarray] = None
        if cache_in_memory:
            self._cache = np.stack([self._load(p) for p in self.paths])

    def _load(self, path: str) -> np.ndarray:
        img = load_image(path, "RGB").astype(np.float32)
        if img.shape[:2] != (self.image_size, self.image_size):
            img = native.resize_bicubic(img, (self.image_size, self.image_size))
        return np.clip(img / 255.0, 0.0, 1.0)

    def __len__(self) -> int:
        return len(self.paths) // self.batch_size

    def _clean_batch(self, idxs) -> torch.Tensor:
        clean = self._cache[idxs] if self._cache is not None else \
            np.stack([self._load(self.paths[i]) for i in idxs])
        return torch.from_numpy(clean).to(self.device)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.arange(len(self.paths))
        np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        for bi in range(len(self)):
            idxs = order[bi * self.batch_size: (bi + 1) * self.batch_size]
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_batch_seed(self.seed, epoch_idx, bi))
            draws = draw_batch(self.task, gen, len(idxs), self.image_size, self.device)
            yield degrade_batch(self.task, self._clean_batch(idxs), draws, self.sr_scale)
