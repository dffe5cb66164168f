"""Image resizes, greyscale and mask morphology in plain numpy.

The JAX package's pipeline and fallbacks call PIL and OpenCV for these; the
port computes the same functions itself, so that it needs neither on the
card's machine. Each function follows its library's integer arithmetic:

- ``resize_lanczos_pil``: PIL's ``Image.resize(..., LANCZOS)`` on uint8: a
  separable a = 3 Lanczos window whose support scales with the reduction,
  coefficients normalised to sum 1 and taken in 22-bit fixed point, the
  horizontal pass first and rounded and clipped to uint8 before the vertical.
- ``resize_lanczos4_cv2``: ``cv2.resize(..., INTER_LANCZOS4)`` on uint8: 8
  taps at ``(x + 0.5) * scale - 0.5``, cv2's sin/cos recurrence for the
  coefficients (float32, normalised to sum 1, 11-bit fixed point), clamped
  borders, and one rounding after both passes.
- ``resize_nearest_pil``: PIL's NEAREST, which samples at the pixel centres.
- ``rgb_to_gray_cv2``: cv2's fixed-point ``COLOR_RGB2GRAY`` with the 15-bit
  weights OpenCV 5.0 uses (the 14-bit ones, 4899/9617/1868, differ by one
  on some pixels).
- ``threshold``, ``morph_close``, ``morph_open``: cv2's binary thresholds and
  its 5x5-rectangle closing and opening, whose default border never wins a
  max or a min.

Images are uint8 HW or HWC arrays; sizes are (height, width).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_PIL_BITS = 22  # PIL's PRECISION_BITS for 8-bit images: 32 - 8 - 2
_CV_BITS = 11   # cv2's INTER_RESIZE_COEF_BITS


def _pil_lanczos(x: np.ndarray) -> np.ndarray:
    """sinc(x) * sinc(x / 3) on [-3, 3), 0 elsewhere (PIL's lanczos_filter)."""
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _pil_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index [out], fixed-point weights [out, taps]) of PIL's
    ``precompute_coeffs`` for the LANCZOS filter."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(taps)[None, :]
    w = _pil_lanczos((x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << _PIL_BITS)
    fixed = np.where(scaled < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5))
    return xmin, fixed.astype(np.int64)


def _taps_sum(img: np.ndarray, first: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """sum_t img[first + t] * k[:, t] along ``axis`` in int64, source indices
    clamped to the image (the taps outside it carry weight 0 in PIL and take
    the edge pixel in cv2)."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)           # [in, ...]
    last = src.shape[0] - 1
    acc = np.zeros((k.shape[0],) + src.shape[1:], dtype=np.int64)
    for t in range(k.shape[1]):
        idx = np.clip(first + t, 0, last)
        acc += src[idx] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    return np.moveaxis(acc, 0, axis)


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL resampling pass along ``axis`` of a uint8 array."""
    xmin, k = _pil_coeffs(img.shape[axis], out_size)
    acc = _taps_sum(img, xmin, k, axis) + (1 << (_PIL_BITS - 1))
    return np.clip(acc >> _PIL_BITS, 0, 255).astype(np.uint8)


def resize_lanczos_pil(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.LANCZOS)`` as an array."""
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = hw
    if img.shape[1] != w:
        img = _pil_pass(img, w, axis=1)
    if img.shape[0] != h:
        img = _pil_pass(img, h, axis=0)
    return np.ascontiguousarray(img)


_S45 = 0.70710678118654752440084436210485
_CV_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45],
                   [-1, 0], [_S45, _S45], [0, -1], [-_S45, _S45]], dtype=np.float64)


def _cv_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap's source index [out], fixed-point weights [out, 8]) of cv2's
    ``resize`` setup and ``interpolateLanczos4``."""
    scale = 1.0 / (out_size / in_size)
    fx = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    y0 = -(fx + np.float32(3)).astype(np.float64) * np.pi * 0.25
    s0, c0 = np.sin(y0)[:, None], np.cos(y0)[:, None]
    yi = (fx[:, None] + np.float32(3) - np.arange(8, dtype=np.float32)[None, :]).astype(np.float32)
    y = -yi.astype(np.float64) * np.pi * 0.25
    near0 = np.abs(yi) < np.float32(1e-6)
    safe = np.where(near0, 1.0, y * y)
    coeffs = np.where(near0, np.float32(1e30),
                      ((_CV_CS[:, 0] * s0 + _CV_CS[:, 1] * c0) / safe).astype(np.float32))
    coeffs = coeffs.astype(np.float32)
    total = np.zeros(out_size, dtype=np.float32)
    for i in range(8):  # float32, in tap order, as cv2 sums them
        total = (total + coeffs[:, i]).astype(np.float32)
    coeffs = (coeffs * (np.float32(1.0) / total)[:, None]).astype(np.float32)
    fixed = np.rint(coeffs * np.float32(1 << _CV_BITS)).astype(np.int64)
    return sx - 3, fixed


def resize_lanczos4_cv2(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)``."""
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = hw
    if (h, w) == img.shape[:2]:
        return img.copy()
    acc = _taps_sum(img, *_cv_coeffs(img.shape[1], w), axis=1)
    acc = _taps_sum(acc, *_cv_coeffs(img.shape[0], h), axis=0)
    shift = 2 * _CV_BITS
    return np.clip((acc + (1 << (shift - 1))) >> shift, 0, 255).astype(np.uint8)


def resize_nearest_pil(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.NEAREST)``: the source pixel
    under each output pixel's centre, its position accumulated in float64 as
    PIL's affine scaling does."""
    img = np.asarray(img_u8)

    def index(in_size: int, out_size: int) -> np.ndarray:
        step = in_size / out_size
        pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
        return np.minimum(pos.astype(np.int64), in_size - 1)

    h, w = hw
    return np.ascontiguousarray(img[index(img.shape[0], h)][:, index(img.shape[1], w)])


def rgb_to_gray_cv2(img_u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``: (R*9798 + G*19235 + B*3735 +
    16384) >> 15."""
    rgb = np.asarray(img_u8, dtype=np.int32)
    y = rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


def threshold(gray_u8: np.ndarray, thresh: int, inverse: bool = False) -> np.ndarray:
    """cv2's THRESH_BINARY (255 where > thresh) or THRESH_BINARY_INV."""
    above = np.asarray(gray_u8) > thresh
    return np.where(above != inverse, 255, 0).astype(np.uint8)


def _rank5(mask: np.ndarray, op, pad_value: int) -> np.ndarray:
    """Max or min over each 5x5 window; the border holds ``pad_value``, which
    never wins (cv2's default morphology border)."""
    out = np.asarray(mask)
    for axis in (0, 1):
        widths = [(0, 0)] * out.ndim
        widths[axis] = (2, 2)
        padded = np.pad(out, widths, constant_values=pad_value)
        n = out.shape[axis]
        windows = [np.take(padded, np.arange(i, i + n), axis=axis) for i in range(5)]
        out = op.reduce(np.stack(windows), axis=0)
    return out


def _dilate(mask: np.ndarray) -> np.ndarray:
    return _rank5(mask, np.maximum, 0)


def _erode(mask: np.ndarray) -> np.ndarray:
    return _rank5(mask, np.minimum, 255)


def morph_close(mask_u8: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8))``."""
    return _erode(_dilate(mask_u8))


def morph_open(mask_u8: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(mask, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8))``."""
    return _dilate(_erode(mask_u8))
