"""MetricsCalculator: the reference's object API over the port's metrics (the
port's copy of the JAX package's ``metrics/calculator.py``).

Construct once with use_lpips / use_fid, then ``calculate_psnr/ssim/lpips/
delta_e(pred, gt)`` on uint8 (or float [0, 1]) RGB numpy arrays and
``calculate_all(pred, gt) -> dict``. A prediction whose shape differs from
its ground truth is resized to it with PIL's LANCZOS
(``infer.imaging.resize_lanczos_pil``), as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..infer.imaging import resize_lanczos_pil
from . import functional as F
from . import perceptual


def _to01(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def _match(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if pred.shape != gt.shape:
        u8 = pred if pred.dtype == np.uint8 else (np.clip(pred, 0, 1) * 255).astype(np.uint8)
        pred = resize_lanczos_pil(u8, gt.shape[:2])
    return pred


class MetricsCalculator:
    """Per-image metric bundle on ``device`` (``cuda`` unless ``"cpu"``).
    LPIPS and FID need their weights and are disabled without them."""

    def __init__(self, use_lpips: bool = True, use_fid: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.use_lpips = use_lpips and perceptual.lpips_available()
        self.use_fid = use_fid and perceptual.fid_available()

    def _pair(self, pred, gt):
        pred = _match(np.asarray(pred), np.asarray(gt))
        return (torch.from_numpy(_to01(pred)).to(self.device),
                torch.from_numpy(_to01(gt)).to(self.device))

    def calculate_psnr(self, pred, gt) -> float:
        return float(F.psnr(*self._pair(pred, gt)))

    def calculate_ssim(self, pred, gt) -> float:
        return float(F.ssim(*self._pair(pred, gt)))

    def calculate_delta_e(self, pred, gt, use_delta_e2000: bool = False) -> float:
        """ΔE in LAB. The reference's use_delta_e2000 branch computes the same
        ΔE76 distance (its ΔE2000 is unimplemented); the argument is kept for
        call-site parity."""
        return float(F.delta_e76(*self._pair(pred, gt)))

    def calculate_lpips(self, pred, gt) -> Optional[float]:
        if not self.use_lpips:
            return None
        pred = _match(np.asarray(pred), np.asarray(gt))
        return perceptual.lpips_pairs([_to01(pred)], [_to01(gt)], self.device)[0]

    def calculate_fid(self, preds, gts) -> Optional[float]:
        """Dataset-level FID over sequences of images."""
        if not self.use_fid:
            return None
        return perceptual.fid([_to01(p) for p in preds], [_to01(g) for g in gts],
                              self.device)

    def calculate_all(self, pred, gt) -> Dict[str, Optional[float]]:
        out = {"psnr": self.calculate_psnr(pred, gt), "ssim": self.calculate_ssim(pred, gt)}
        if self.use_lpips:
            out["lpips"] = self.calculate_lpips(pred, gt)
        return out
