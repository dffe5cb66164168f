"""Classical-CV fallback chain + mask utilities (the port's copy).

A copy of the JAX package's ``infer/fallbacks.py``: every task degrades
gracefully from diffusion to a classical method (denoise -> NlMeans +
bilateral/median, sr -> LANCZOS, colorize -> a LAB tint, inpaint -> the
original), plus mask normalisation and the auto-mask. The functions the
card's serves reach (``sr_lanczos``, ``gray_to_rgb``, ``normalize_mask``,
``auto_mask_from_image``) compute cv2's results in numpy (``imaging.py``);
only the classical fallbacks ``denoise_opencv`` and ``colorize_lab`` import
cv2, inside the function. Images are uint8 RGB numpy arrays (HWC).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import imaging


def denoise_opencv(img: np.ndarray, strength: float = 0.5) -> np.ndarray:
    """NlMeans-based denoise; strength in [0,1] maps to filter h."""
    import cv2

    h = float(np.clip(strength, 0.1, 1.0))
    h_value = h * 10 if h < 0.6 else 20
    out = cv2.fastNlMeansDenoisingColored(
        img, None, h=h_value, hColor=h_value, templateWindowSize=7, searchWindowSize=21
    )
    if strength > 0.6:
        out = cv2.bilateralFilter(out, 9, 75, 75)
    if strength > 0.8:
        out = cv2.medianBlur(out, 5)
    return out


def sr_lanczos(img: np.ndarray, scale: int = 4) -> np.ndarray:
    h, w = img.shape[:2]
    return imaging.resize_lanczos4_cv2(img, (h * scale, w * scale))


def colorize_lab(img: np.ndarray) -> np.ndarray:
    """Classical colorization placeholder: slight luminance-based tint."""
    import cv2

    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    l_channel = lab[:, :, 0]
    a_channel = np.clip(l_channel * 0.1 - 10, -127, 127).astype(np.int8)
    b_channel = np.clip(l_channel * 0.1 - 5, -127, 127).astype(np.int8)
    lab_colored = np.stack([l_channel, a_channel, b_channel], axis=2)
    return cv2.cvtColor(lab_colored.astype(np.uint8), cv2.COLOR_LAB2RGB)


def is_color_image(img: np.ndarray, threshold: float = 10.0) -> bool:
    """Mean inter-channel difference test (reference: inference.py:613-630)."""
    if img.ndim != 3 or img.shape[2] != 3:
        return False
    r = img[:, :, 0].astype(np.float32)
    g = img[:, :, 1].astype(np.float32)
    b = img[:, :, 2].astype(np.float32)
    mean_diff = (
        np.mean(np.abs(r - g)) + np.mean(np.abs(g - b)) + np.mean(np.abs(r - b))
    ) / 3.0
    return mean_diff > threshold


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """Expand gray(-ish) input to clean 3-channel RGB via the first channel."""
    gray = img if img.ndim == 2 else img[:, :, 0]
    return np.repeat(gray[:, :, None], 3, axis=2)


def normalize_mask(mask: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Resize to target and fix polarity: white (255) = inpaint region.
    Auto-inverts when <10% of pixels are white."""
    if mask.ndim == 3:
        mask = imaging.rgb_to_gray_cv2(mask)
    th, tw = target_hw
    if mask.shape[:2] != (th, tw):
        mask = imaging.resize_lanczos4_cv2(mask, (th, tw))
    white_ratio = np.sum(mask > 128) / mask.size
    if white_ratio < 0.1:
        mask = 255 - mask
    return mask


def auto_mask_from_image(img: np.ndarray) -> Optional[np.ndarray]:
    """Threshold very dark/bright regions + morphology clean-up; None when
    less than 1% of the image is flagged."""
    gray = imaging.rgb_to_gray_cv2(img)
    mask = imaging.threshold(gray, 30, inverse=True) | imaging.threshold(gray, 225)
    mask = imaging.morph_open(imaging.morph_close(mask))
    if np.sum(mask > 0) / mask.size < 0.01:
        return None
    return mask
