"""Classical-CV fallback chain + mask utilities (the port's copy; host-side cv2/numpy).

A copy of the JAX package's ``infer/fallbacks.py``: every task degrades
gracefully from diffusion to a classical method (denoise -> NlMeans +
bilateral/median, sr -> LANCZOS, colorize -> a LAB tint, inpaint -> the
original), plus mask normalisation and the auto-mask. cv2 is imported inside
each function that needs it, so importing this module needs only numpy.
Images are uint8 RGB numpy arrays (HWC).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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
    import cv2

    h, w = img.shape[:2]
    return cv2.resize(img, (w * scale, h * scale), interpolation=cv2.INTER_LANCZOS4)


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
    import cv2

    if img.ndim == 2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    return cv2.cvtColor(img[:, :, 0], cv2.COLOR_GRAY2RGB)


def normalize_mask(mask: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Resize to target and fix polarity: white (255) = inpaint region.
    Auto-inverts when <10% of pixels are white."""
    import cv2

    if mask.ndim == 3:
        mask = cv2.cvtColor(mask, cv2.COLOR_RGB2GRAY)
    th, tw = target_hw
    if mask.shape[:2] != (th, tw):
        mask = cv2.resize(mask, (tw, th), interpolation=cv2.INTER_LANCZOS4)
    white_ratio = np.sum(mask > 128) / mask.size
    if white_ratio < 0.1:
        mask = 255 - mask
    return mask


def auto_mask_from_image(img: np.ndarray) -> Optional[np.ndarray]:
    """Threshold very dark/bright regions + morphology clean-up; None when
    less than 1% of the image is flagged."""
    import cv2

    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    _, mask_dark = cv2.threshold(gray, 30, 255, cv2.THRESH_BINARY_INV)
    _, mask_bright = cv2.threshold(gray, 225, 255, cv2.THRESH_BINARY)
    mask = cv2.bitwise_or(mask_dark, mask_bright)
    kernel = np.ones((5, 5), np.uint8)
    mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    if np.sum(mask > 0) / mask.size < 0.01:
        return None
    return mask
