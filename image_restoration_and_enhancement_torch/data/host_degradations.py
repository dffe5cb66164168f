"""Host-side degradation synthesis for the offline pair factory (the port's
copy of the JAX package's ``data/host_degradations.py``).

The same functions, parameter ranges and ``np.random.Generator`` call order
as the JAX module, so one seed draws the same values in both packages. The
cv2 calls of the JAX module are the port's own numpy versions
(``infer/imaging.py``: GaussianBlur, INTER_CUBIC, INTER_AREA, filter2D;
``data/native.py``: the C++ library's noise and cv2's LAB L), because the
card's machine has no cv2. JPEG encode and decode (``add_jpeg_compression``,
reached only under ``--denoise_with_artifacts`` or ``--sr_with_jpeg``) stays
a cv2 call, imported inside the function as the JAX module imports it at its
top; without cv2 it raises an error that names those flags.

Parameter ranges (the reference generator's): noise sigma 5-8 (3-15 with
artifacts), JPEG quality 30-90, motion-blur kernels 5-15 px, SR blur k in
{3, 5, 7}, stroke masks easy (3-7 strokes, 5-20 px) / hard (8-15, 20-40)
mixed 70/30.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..infer import imaging
from ..ops.image import motion_blur_kernel
from . import native


def add_gaussian_noise(
    rng: np.random.Generator, img_u8: np.ndarray, sigma_range=(5.0, 8.0)
) -> np.ndarray:
    sigma = rng.uniform(*sigma_range)
    return native.add_gaussian_noise_u8(img_u8, sigma, int(rng.integers(1, 2**62)))


def add_jpeg_compression(
    rng: np.random.Generator, img_u8: np.ndarray, quality_range=(30, 90)
) -> np.ndarray:
    quality = int(rng.integers(quality_range[0], quality_range[1] + 1))
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "JPEG degradations (--denoise_with_artifacts, --sr_with_jpeg) encode and "
            "decode with cv2, which is not installed") from e
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        return img_u8
    return cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def add_motion_blur(
    rng: np.random.Generator, img_u8: np.ndarray, kernel_size_range=(5, 15)
) -> np.ndarray:
    size = int(rng.integers(kernel_size_range[0], kernel_size_range[1] + 1))
    angle = rng.uniform(0.0, 360.0)
    return imaging.filter2d_cv2(img_u8, motion_blur_kernel(size, angle))


def degrade_denoise(
    rng: np.random.Generator, img_u8: np.ndarray, with_artifacts: bool = False,
    sigma_range=(5.0, 8.0),
) -> np.ndarray:
    """Reference default sigma in [5, 8]; ``sigma_range`` parameterizes the
    hard-degradation family (sigma >= 40)."""
    if not with_artifacts:
        return add_gaussian_noise(rng, img_u8, sigma_range)
    out = add_gaussian_noise(rng, img_u8, (3.0, 15.0))
    if rng.random() < 0.3:
        out = add_jpeg_compression(rng, out, (40, 85))
    if rng.random() < 0.2:
        out = add_motion_blur(rng, out, (3, 8))
    return out


def degrade_sr(
    rng: np.random.Generator,
    img_u8: np.ndarray,
    scale: int = 4,
    use_jpeg: bool = False,
    use_motion_blur: bool = False,
) -> np.ndarray:
    if use_motion_blur and rng.random() < 0.3:
        blur = add_motion_blur(rng, img_u8, (5, 12))
    else:
        k = int(rng.choice([3, 5, 7]))
        blur = imaging.gaussian_blur_cv2(img_u8, k)
    h, w = blur.shape[:2]
    lr = imaging.resize_cubic_cv2(blur, (h // scale, w // scale))
    if use_jpeg:
        lr = add_jpeg_compression(rng, lr, (40, 85))
    return lr


def to_grayscale(img_u8: np.ndarray) -> np.ndarray:
    """LAB L channel (the reference's colorization input)."""
    return native.rgb_to_lab_l(img_u8)


def resize_to_max_size(img_u8: np.ndarray, max_size: int = 1024) -> np.ndarray:
    h, w = img_u8.shape[:2]
    scale = max_size / max(h, w)
    if scale < 1.0:
        return imaging.resize_area_cv2(img_u8, (int(h * scale), int(w * scale)))
    return img_u8


def free_form_mask(
    rng: np.random.Generator,
    hw: Tuple[int, int],
    num_strokes=(5, 15),
    thickness_range=(10, 40),
) -> np.ndarray:
    """Stroke mask in {0, 255} uint8 via distance-to-segment rasterization."""
    h, w = hw
    mask = np.zeros((h, w), dtype=bool)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(int(rng.integers(num_strokes[0], num_strokes[1] + 1))):
        n_pts = int(rng.integers(4, 9))
        px = rng.uniform(0, w - 1, n_pts).astype(np.float32)
        py = rng.uniform(0, h - 1, n_pts).astype(np.float32)
        half = rng.integers(thickness_range[0], thickness_range[1] + 1) / 2.0
        for i in range(n_pts - 1):
            vx, vy = px[i + 1] - px[i], py[i + 1] - py[i]
            denom = max(vx * vx + vy * vy, 1e-8)
            t = np.clip(((xs - px[i]) * vx + (ys - py[i]) * vy) / denom, 0.0, 1.0)
            d2 = (xs - (px[i] + t * vx)) ** 2 + (ys - (py[i] + t * vy)) ** 2
            mask |= d2 <= half * half
    return mask.astype(np.uint8) * 255


def inpaint_pair(
    rng: np.random.Generator, img_u8: np.ndarray, easy_ratio: float = 0.7
) -> Tuple[np.ndarray, np.ndarray]:
    h, w = img_u8.shape[:2]
    if rng.random() < easy_ratio:
        mask = free_form_mask(rng, (h, w), (3, 7), (5, 20))
    else:
        mask = free_form_mask(rng, (h, w), (8, 15), (20, 40))
    masked = img_u8.copy()
    masked[mask == 255] = 0
    return masked, mask
