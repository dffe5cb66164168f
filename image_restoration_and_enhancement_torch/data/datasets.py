"""Pair datasets and a prefetching batch loader (the port's copy of the JAX
package's ``data/datasets.py``).

One task-parameterized dataset over the directory convention

    data/pairs/{task}/{split}/{input,gt[,mask]}

- pairs matched by filename stem across extensions (colorize inputs are .png)
- images resized to ``image_size`` and normalized to [-1, 1]
- SR inputs bicubic-upsampled to the GT size (``native.resize_bicubic``)
- inpaint masks NEAREST-resized (PIL's NEAREST, ``infer.imaging``), polarity
  auto-fixed (>50% white means inverted), binarized {0,1}
- the optional noise level of a ``_sigma<float>`` stem suffix
- ``max_samples`` smoke-test knob

Items are numpy arrays on the host, as in the JAX package; PNG files are read
by the port's codec, other formats through PIL (``data/png.py``).
``BatchLoader`` shuffles with ``np.random.default_rng(seed + epoch)``, so its
batches are the JAX loader's index for index, and prefetches one batch on a
background thread.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..infer.imaging import resize_nearest_pil
from ..tasks.registry import get_task
from . import native
from .png import load_image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _list_stems(directory: str) -> Dict[str, str]:
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        stem, ext = os.path.splitext(name)
        if ext.lower() in IMG_EXTS:
            out[stem] = os.path.join(directory, name)
    return out


class PairDataset:
    """Input/GT(-mask) pairs for one task+split, normalized to [-1,1] HWC."""

    def __init__(
        self,
        task: str,
        root: str = "data/pairs",
        split: str = "train",
        image_size: int = 256,
        max_samples: Optional[int] = None,
        sr_upscale: bool = True,
    ):
        self.spec = get_task(task)
        self.image_size = image_size
        self.sr_upscale = sr_upscale and self.spec.name == "sr_x4"
        base = os.path.join(root, self.spec.pair_dir, split)
        inputs = _list_stems(os.path.join(base, "input"))
        gts = _list_stems(os.path.join(base, "gt"))
        masks = _list_stems(os.path.join(base, "mask")) if self.spec.uses_mask else {}
        stems = sorted(set(inputs) & set(gts))
        if self.spec.uses_mask:
            stems = [s for s in stems if s in masks]
        if max_samples is not None:
            stems = stems[:max_samples]
        self.items: List[Tuple[str, str, Optional[str]]] = [
            (inputs[s], gts[s], masks.get(s)) for s in stems
        ]
        if not self.items:
            raise FileNotFoundError(f"No pairs under {base}")
        # optional noise level from a `_sigma<float>` stem suffix; None when absent
        self.sigmas: List[Optional[float]] = []
        for s in stems:
            sigma = None
            if "_sigma" in s:
                try:
                    sigma = float(s.split("_sigma")[-1])
                except ValueError:
                    pass
            self.sigmas.append(sigma)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        inp_path, gt_path, mask_path = self.items[idx]
        size = self.image_size

        def prep(path: str) -> np.ndarray:
            u8 = load_image(path, "RGB")
            if u8.shape[:2] != (size, size):
                # SR: bicubic-upsample LR to target; other tasks resize to the
                # train resolution. clip: bicubic overshoots [0, 255] slightly.
                f = native.resize_bicubic(u8.astype(np.float32), (size, size))
                return np.clip(f / 127.5 - 1.0, -1.0, 1.0).astype(np.float32)
            return native.to_pm1(u8)

        out = {"input": prep(inp_path), "gt": prep(gt_path)}
        if mask_path is not None:
            m = load_image(mask_path, "L")
            m = resize_nearest_pil(m, (size, size)).astype(np.float32) / 255.0
            m = (m > 0.5).astype(np.float32)
            if m.mean() > 0.5:  # polarity auto-fix
                m = 1.0 - m
            out["mask"] = m[..., None]
        return out


class BatchLoader:
    """Shuffling, epoch-based batcher with one-batch background prefetch."""

    def __init__(
        self,
        dataset: PairDataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: bool = True,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, idxs) -> Dict[str, np.ndarray]:
        samples = [self.ds[i] for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        stop = len(order) - (self.batch_size - 1 if self.drop_last else 0)
        batches = [order[i: i + self.batch_size] for i in range(0, stop, self.batch_size)]
        if not self.prefetch:
            for idxs in batches:
                yield self._collate(idxs)
            return

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def worker():
            for idxs in batches:
                q.put(self._collate(idxs))
            q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
