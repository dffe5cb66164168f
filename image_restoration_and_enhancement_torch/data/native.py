"""Host preprocessing of the loaders (the port's counterpart of the JAX
package's ``native/``): ``resize_bicubic``, ``to_pm1``, ``from_pm1``.

The JAX package's ``resize_bicubic`` computes one of two functions: with cv2
importable, ``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` on
float32 (Keys cubic with a = -0.75, cv2's sample positions and clamped
borders); without cv2, its C++ loop with a = -0.5 and per-pixel weight
renormalisation. The port computes the first, the function the JAX package
runs where its tests run, in numpy: cv2's float32 coefficients, the
horizontal pass and then the vertical one, each a sum of four float32
products in cv2's order. That is bitwise cv2's own code (OpenCV 5.0 on
x86-64) but for the values past a row's last whole SIMD vector, which cv2
adds in the other order; a cv2 built with
IPP (the default) serves images of 4 or more rows from IPP, whose weights
differ from cv2's by up to ~2e-6 of their size.

``to_pm1`` and ``from_pm1`` compute what the JAX package's C++ library does
(which GCC compiles with fused multiply-adds) in plain numpy: the library
only saved time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_A = np.float32(-0.75)


def _cubic_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source index of the first of four taps [out], float32 weights [out, 4])
    as cv2's ``resize`` setup and ``interpolateCubic`` compute them."""
    scale = 1.0 / (out_size / in_size)
    fx = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx.astype(np.float32)).astype(np.float32)
    one = np.float32(1)
    c0 = ((_A * (x + one) - np.float32(5) * _A) * (x + one) + np.float32(8) * _A) * (x + one) \
        - np.float32(4) * _A
    c1 = ((_A + np.float32(2)) * x - (_A + np.float32(3))) * x * x + one
    c2 = ((_A + np.float32(2)) * (one - x) - (_A + np.float32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return sx - 1, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def _cubic_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of four float32 products per output along ``axis``, summed in
    cv2's order: the first tap's product first along rows (``HResizeCubic``),
    the last tap's first down columns (``VResizeCubicVec_32f``, whose
    multiply-adds do not fuse there)."""
    first, k = _cubic_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0)
    last = src.shape[0] - 1
    shape = (-1,) + (1,) * (src.ndim - 1)
    taps = (0, 1, 2, 3) if axis == 1 else (3, 2, 1, 0)
    acc = None
    for t in taps:
        prod = src[np.clip(first + t, 0, last)] * k[:, t].reshape(shape)
        acc = prod if acc is None else acc + prod
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resize_bicubic(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of a float32
    HWC (or HW) image; no clipping (bicubic overshoots)."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    dh, dw = out_hw
    if img.shape[:2] == (dh, dw):
        return img.copy()
    return np.ascontiguousarray(_cubic_pass(_cubic_pass(img, dw, axis=1), dh, axis=0))


def to_pm1(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [-1, 1]: u8 * (1 / 127.5) - 1 with one rounding (the
    C++ loop's fused multiply-add)."""
    k = np.float64(np.float32(1.0 / 127.5))
    return (np.asarray(img_u8, np.uint8) * k - 1.0).astype(np.float32)


def from_pm1(img: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8: (x + 1) * 127.5 + 0.5 (fused, one rounding),
    clamped to [0, 255] and truncated, as the C++ loop does."""
    v = (np.asarray(img, np.float32) + np.float32(1)).astype(np.float64) * 127.5 + 0.5
    return np.clip(v.astype(np.float32), 0.0, 255.0).astype(np.uint8)
