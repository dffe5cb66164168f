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
- ``resize_bicubic_pil``: PIL's ``Image.resize`` default for RGB and L
  images, BICUBIC (a = -0.5, support 2 scaled with the reduction), through
  the same 22-bit machinery as LANCZOS.
- ``resize_nearest_pil``: PIL's NEAREST, which samples at the pixel centres.
- ``gaussian_blur_cv2``: ``cv2.GaussianBlur(img, (k, k), 0)`` for k in
  {3, 5, 7}: cv2's fixed small kernels (sums of 256) in its bit-exact 8-bit
  path, one rounding half up after both passes, BORDER_REFLECT_101.
- ``resize_cubic_cv2``: ``cv2.resize(..., INTER_CUBIC)`` on uint8. cv2 5.0
  with IPP (its default build) serves images of 4 or more rows from IPP,
  which takes the float32 Keys weights (a = -0.75) unquantized and rounds
  half to even once; the port computes that in float64. Bitwise at integer
  ratios; at other ratios IPP's float32 sums put a value within ~0.003 of a
  half on the other side at about 0.1% of pixels (one step).
- ``resize_area_cv2``: ``cv2.resize(..., INTER_AREA)`` for a reduction on
  uint8. At integer ratios cv2's fast path, bitwise: the block sum, rounded
  half up at 2x2 ((s + 2) >> 2), else times the float32 1 / area and rounded
  half to even. At other ratios cv2's area weights (float32) and its float32
  running sums, the horizontal pass first, rounded half to even. Bitwise.
- ``filter2d_cv2``: ``cv2.filter2D(img, -1, kernel)`` on uint8 with a float
  kernel, BORDER_REFLECT_101: a float32 sum over the kernel's nonzero taps
  in row order, rounded half to even, as cv2's direct filter: fused
  multiply-adds in its vector loop, which takes a row's values (W * C of
  them) four at a time, a product then a sum for the last W * C % 4. cv2
  correlates kernels of 130 or more taps (12x12 and up) through the DFT,
  whose float error decides a sum that lies at a half: one step there.
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


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic_filter (a = -0.5) on [-2, 2], 0 elsewhere."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


_PIL_FILTERS = {"lanczos": (_pil_lanczos, 3.0), "bicubic": (_pil_bicubic, 2.0)}


def _pil_coeffs(in_size: int, out_size: int, kind: str = "lanczos"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index [out], fixed-point weights [out, taps]) of PIL's
    ``precompute_coeffs`` for the LANCZOS or BICUBIC filter."""
    filt, base_support = _PIL_FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(taps)[None, :]
    w = filt((x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
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


def _pil_pass(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One PIL resampling pass along ``axis`` of a uint8 array."""
    xmin, k = _pil_coeffs(img.shape[axis], out_size, kind)
    acc = _taps_sum(img, xmin, k, axis) + (1 << (_PIL_BITS - 1))
    return np.clip(acc >> _PIL_BITS, 0, 255).astype(np.uint8)


def _resize_pil(img_u8: np.ndarray, hw: Tuple[int, int], kind: str) -> np.ndarray:
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = hw
    if img.shape[1] != w:
        img = _pil_pass(img, w, axis=1, kind=kind)
    if img.shape[0] != h:
        img = _pil_pass(img, h, axis=0, kind=kind)
    return np.ascontiguousarray(img)


def resize_lanczos_pil(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.LANCZOS)`` as an array."""
    return _resize_pil(img_u8, hw, "lanczos")


def resize_bicubic_pil(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h))`` (BICUBIC, PIL's default for RGB
    and L images) as an array."""
    return _resize_pil(img_u8, hw, "bicubic")


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


_GAUSS_SMALL = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                7: (8, 28, 56, 72, 56, 28, 8)}   # cv2's small_gaussian_tab x 256


def _reflect101(img: np.ndarray, before: Tuple[int, int], after: Tuple[int, int]) -> np.ndarray:
    """Pad rows and columns by cv2's BORDER_REFLECT_101 (numpy's "reflect")."""
    pad = [(before[0], after[0]), (before[1], after[1])] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="reflect")


def gaussian_blur_cv2(img_u8: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` for ksize 3, 5 or 7: the
    separable 8-bit weights summing to 256, both passes in integers, then
    (sum + 2**15) >> 16."""
    if ksize not in _GAUSS_SMALL:
        raise ValueError(f"ksize {ksize}: the fixed kernels are 3, 5 and 7")
    img = np.asarray(img_u8, dtype=np.uint8)
    r = ksize // 2
    w = _GAUSS_SMALL[ksize]
    p = _reflect101(img.astype(np.int64), (r, r), (r, r))
    h, wd = img.shape[:2]
    rows = sum(w[t] * p[:, t: t + wd] for t in range(ksize))
    acc = sum(w[t] * rows[t: t + h] for t in range(ksize))
    return np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


_A = np.float32(-0.75)   # cv2's Keys cubic


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


def _cubic_pass(img: np.ndarray, out_size: int, axis: int,
                dtype: type = np.float32) -> np.ndarray:
    """One INTER_CUBIC pass along ``axis``: four products per output of cv2's
    float32 weights, clamped borders, summed in ``dtype``. float32 is cv2's
    own code (``data/native.resize_bicubic``), summed in its order: the first
    tap's product first along rows (``HResizeCubic``), the last tap's first
    down columns (``VResizeCubicVec_32f``, whose multiply-adds do not fuse
    there). float64 is IPP's unquantized sum (``resize_cubic_cv2``)."""
    first, k = _cubic_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(dtype, copy=False)
    k = k.astype(dtype, copy=False)
    last = src.shape[0] - 1
    shape = (-1,) + (1,) * (src.ndim - 1)
    taps = (0, 1, 2, 3) if axis == 1 else (3, 2, 1, 0)
    acc = None
    for t in taps:
        prod = src[np.clip(first + t, 0, last)] * k[:, t].reshape(shape)
        acc = prod if acc is None else acc + prod
    return np.moveaxis(acc.astype(dtype, copy=False), 0, axis)


def cubic_sums(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """The float64 values INTER_CUBIC rounds: both passes, no rounding between."""
    h, w = hw
    img = np.asarray(img_u8, np.uint8)
    return _cubic_pass(_cubic_pass(img, w, axis=1, dtype=np.float64), h, axis=0, dtype=np.float64)


def resize_cubic_cv2(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` on uint8:
    ``cubic_sums`` rounded half to even (see the module docstring for the
    one-step limit at non-integer ratios)."""
    img = np.asarray(img_u8, dtype=np.uint8)
    if tuple(hw) == img.shape[:2]:
        return img.copy()
    return np.clip(np.rint(cubic_sums(img, hw)), 0, 255).astype(np.uint8)


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """cv2's ``computeResizeAreaTab`` as a dense [out, in] matrix of float32
    weights."""
    scale = in_size / out_size
    wts = np.zeros((out_size, in_size), np.float32)
    for dx in range(out_size):
        f1 = dx * scale
        f2 = f1 + scale
        s1, s2 = int(np.ceil(f1)), min(int(np.floor(f2)), in_size - 1)
        s1 = min(s1, s2)
        cell = min(scale, in_size - f1)
        if s1 - f1 > 1e-3:
            wts[dx, s1 - 1] = (s1 - f1) / cell
        wts[dx, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            wts[dx, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return wts


def _area_pass(x: np.ndarray, wts: np.ndarray, axis: int) -> np.ndarray:
    """One area pass along ``axis`` in float32, each output the running sum
    of (source x weight) over its source pixels in order, a product then a
    sum (cv2's ``ResizeArea_Invoker``)."""
    taps = max(int((wts != 0).sum(axis=1).max()), 1)
    first = np.argmax(wts != 0, axis=1)
    src = np.moveaxis(x, axis, 0)
    shape = (-1,) + (1,) * (src.ndim - 1)
    acc = None
    for t in range(taps):
        idx = np.minimum(first + t, wts.shape[1] - 1)
        wt = np.where(first + t < wts.shape[1], wts[np.arange(len(first)), idx], 0.0)
        prod = (src[idx] * wt.astype(np.float32).reshape(shape)).astype(np.float32)
        acc = prod if acc is None else (acc + prod).astype(np.float32)
    return np.moveaxis(acc, 0, axis)


def area_sums(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """The float32 weighted means the non-integer INTER_AREA path rounds."""
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = hw
    if h > img.shape[0] or w > img.shape[1]:
        raise ValueError("resize_area_cv2 reduces; cv2's INTER_AREA enlarges bilinearly")
    x = _area_pass(img.astype(np.float32), _area_weights(img.shape[1], w), axis=1)
    return _area_pass(x, _area_weights(img.shape[0], h), axis=0)


def resize_area_cv2(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` for a
    reduction, on uint8 (see the module docstring for its two paths)."""
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = hw
    if (h, w) == img.shape[:2]:
        return img.copy()
    sy, sx = img.shape[0] / h, img.shape[1] / w
    if not (sy.is_integer() and sx.is_integer()):
        return np.clip(np.rint(area_sums(img, hw)), 0, 255).astype(np.uint8)
    sy, sx = int(sy), int(sx)
    blocks = img.astype(np.int64).reshape((h, sy, w, sx) + img.shape[2:]).sum(axis=(1, 3))
    if sy == sx == 2:
        return ((blocks + 2) >> 2).astype(np.uint8)
    mean = blocks.astype(np.float32) * np.float32(1.0 / (sy * sx))
    return np.clip(np.rint(mean), 0, 255).astype(np.uint8)


def filter2d_sums(img_u8: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """The float32 correlation sums ``filter2d_cv2`` rounds."""
    img = np.asarray(img_u8, dtype=np.uint8)
    k = np.asarray(kernel, dtype=np.float32)
    kh, kw = k.shape
    p = _reflect101(img.astype(np.float64), (kh // 2, kw // 2),
                    (kh - 1 - kh // 2, kw - 1 - kw // 2))
    h, w = img.shape[:2]
    fused = np.zeros(img.shape, np.float32)
    split = np.zeros(img.shape, np.float32)
    for y, x in zip(*np.nonzero(k)):
        prod = p[y: y + h, x: x + w] * np.float64(k[y, x])  # exact: a byte x a float32
        fused = (prod + fused).astype(np.float32)
        split = (split + prod.astype(np.float32)).astype(np.float32)
    acc = fused.reshape(h, -1)
    tail = acc.shape[1] // 4 * 4
    acc[:, tail:] = split.reshape(h, -1)[:, tail:]
    return acc.reshape(img.shape)


def filter2d_cv2(img_u8: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8 with a float kernel: the
    correlation anchored at the kernel's centre (k // 2), BORDER_REFLECT_101,
    a float32 sum per nonzero tap in row order (``filter2d_sums``), rounded
    half to even (see the module docstring for the tail of a row and kernels
    of 130 taps and more)."""
    return np.clip(np.rint(filter2d_sums(img_u8, kernel)), 0, 255).astype(np.uint8)


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
