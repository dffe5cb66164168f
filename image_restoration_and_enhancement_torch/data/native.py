"""Host preprocessing of the loaders and the offline pair factory (the port's
counterpart of the JAX package's ``native/``): ``resize_bicubic``,
``to_pm1``, ``from_pm1``, ``add_gaussian_noise_u8`` and ``rgb_to_lab_l``.

The JAX package's ``resize_bicubic`` computes one of two functions: with cv2
importable, ``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` on
float32 (Keys cubic with a = -0.75, cv2's sample positions and clamped
borders); without cv2, its C++ loop with a = -0.5 and per-pixel weight
renormalisation. The port computes the first, the function the JAX package
runs where its tests run, in numpy (``infer/imaging._cubic_pass``): cv2's
float32 coefficients, the horizontal pass and then the vertical one, each a
sum of four float32 products in cv2's order. That is bitwise cv2's own code (OpenCV 5.0 on
x86-64) but for the values past a row's last whole SIMD vector, which cv2
adds in the other order; a cv2 built with
IPP (the default) serves images of 4 or more rows from IPP, whose weights
differ from cv2's by up to ~2e-6 of their size.

``to_pm1`` and ``from_pm1`` compute what the JAX package's C++ library does
(which GCC compiles with fused multiply-adds) in plain numpy: the library
only saved time.

``add_gaussian_noise_u8`` computes the C++ function the JAX package runs
wherever its library builds (``preprocess.cpp``'s loop): one xorshift64
stream, two draws per pair of values, float32 Box-Muller, the noise added
with a fused multiply-add and the sum clamped to [0, 255] and truncated.
xorshift64 is linear over GF(2), so the stream is cut into lanes whose start
states come from a jump-ahead with a 64x64 bit matrix, and all lanes step
at once in numpy. ``logf``, ``sinf`` and ``cosf`` are taken in float64 and
rounded to float32: glibc's float functions are not always correctly
rounded, so a value can land on the other side of a truncation boundary
when it lies within an ulp of an integer (``tests/test_torch_host_degradations.py``
checks where that happens).

``rgb_to_lab_l`` computes what the JAX package computes where cv2 imports,
``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)[..., 0]`` on uint8: cv2's 8-bit path
with its sRGB gamma table (11-bit), its 12-bit fixed-point XYZ row and its
15-bit cube-root table. Bitwise cv2's over all 2**24 colours (OpenCV 5.0).
"""
from __future__ import annotations

import numpy as np

from ..infer.imaging import _cubic_pass

def resize_bicubic(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of a float32
    HWC (or HW) image; no clipping (bicubic overshoots)."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    dh, dw = out_hw
    if img.shape[:2] == (dh, dw):
        return img.copy()
    return np.ascontiguousarray(_cubic_pass(_cubic_pass(img, dw, axis=1), dh, axis=0))


# ---------------------------------------------------------------------------
# Gaussian noise: preprocess.cpp's xorshift64 + Box-Muller loop
# ---------------------------------------------------------------------------

_U64 = np.uint64
_BITS = np.arange(64, dtype=np.uint64)
_LANE_STEPS = 256           # draws each lane takes; the lanes run side by side
_DEFAULT_SEED = 0x9E3779B97F4A7C15


def _xorshift(x: np.ndarray) -> np.ndarray:
    x = x ^ (x << _U64(13))
    x = x ^ (x >> _U64(7))
    return x ^ (x << _U64(17))


def _gf2_apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The 64x64 bit matrix with columns ``cols`` (the images of the unit
    vectors) applied to every state in ``v``."""
    bits = (v[:, None] >> _BITS[None, :]) & _U64(1)
    return np.bitwise_xor.reduce(bits * cols[None, :], axis=1)


def _xorshift_power(n: int) -> np.ndarray:
    """Columns of the matrix that advances an xorshift64 state by ``n`` draws."""
    base = _xorshift(_U64(1) << _BITS)
    out = _U64(1) << _BITS
    while n:
        if n & 1:
            out = _gf2_apply(base, out)
        base = _gf2_apply(base, base)
        n >>= 1
    return out


def xorshift64_stream(seed: int, count: int) -> np.ndarray:
    """The first ``count`` outputs of preprocess.cpp's ``xorshift64`` from
    ``seed`` (0 takes the library's default seed), as uint64."""
    lanes = max(1, -(-count // _LANE_STEPS))
    starts = np.array([seed or _DEFAULT_SEED], dtype=np.uint64)
    jump = _xorshift_power(_LANE_STEPS)
    while len(starts) < lanes:   # lane j starts _LANE_STEPS * j draws in
        starts = np.concatenate([starts, _gf2_apply(jump, starts)])
        jump = _gf2_apply(jump, jump)
    state = starts[:lanes]
    out = np.empty((_LANE_STEPS, lanes), dtype=np.uint64)
    for t in range(_LANE_STEPS):
        state = _xorshift(state)
        out[t] = state
    return out.T.reshape(-1)[:count]


def noisy_values(img_u8: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    """The float32 sums ``add_gaussian_noise_u8`` clamps and truncates: for
    each pair of values u1 = (d0 >> 11 + 1) * 2**-53, u2 = (d1 >> 11) * 2**-53
    in float32, r = sqrt(-2 log u1) * sigma, the pair gets r cos(2 pi u2) and
    r sin(2 pi u2) (an odd last value the first), each added by one fused
    multiply-add."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    flat = img.reshape(-1)
    n = flat.size
    pairs = (n + 1) // 2
    f32 = np.float32
    d = xorshift64_stream(int(seed) & 0xFFFFFFFFFFFFFFFF, 2 * pairs).reshape(pairs, 2)
    u1 = ((d[:, 0] >> _U64(11)).astype(f32) + f32(1)) * f32(2.0 ** -53)
    u2 = (d[:, 1] >> _U64(11)).astype(f32) * f32(2.0 ** -53)
    r = np.sqrt(np.log(u1.astype(np.float64)).astype(f32) * f32(-2)) * f32(sigma)
    angle = (f32(6.28318530718) * u2).astype(np.float64)
    z = np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(f32).reshape(-1)[:n]
    # fma(r, z, img): the product of two float32 is exact in float64
    return (np.repeat(r, 2)[:n].astype(np.float64) * z + flat).astype(f32).reshape(img.shape)


def add_gaussian_noise_u8(img_u8: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    """uint8 image plus N(0, sigma) noise in [0, 255] units, as
    ``preprocess.cpp``'s ``add_gaussian_noise_u8``: ``noisy_values`` clamped
    to [0, 255] and truncated."""
    return np.clip(noisy_values(img_u8, sigma, seed), 0.0, 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# LAB L: cv2's 8-bit RGB2Lab
# ---------------------------------------------------------------------------

_LAB_GAMMA_SHIFT = 3        # gamma table: linear values in 255 * 2**3 steps
_LAB_SHIFT = 12             # XYZ coefficients
_LAB_SHIFT2 = _LAB_SHIFT + _LAB_GAMMA_SHIFT
_LAB_Y_ROW = (0.212671, 0.715160, 0.072169)   # sRGB -> XYZ (D65), the Y row


def _srgb_gamma_table() -> np.ndarray:
    """cv2's ``sRGBGammaTab_b``: round(255 * 8 * linear(i / 255)), its
    constants float32 (0.04045, 12.92, 0.055, 2.4), the power in float64."""
    f32 = np.float32
    x = (np.arange(256, dtype=f32) / f32(255)).astype(np.float64)
    thr, low = float(f32(809) / f32(20000)), float(f32(323) / f32(25))
    power, shift = float(f32(12) / f32(5)), float(f32(11) / f32(200))
    lin = np.where(x <= thr, x / low, ((x + shift) / (1.0 + shift)) ** power).astype(f32)
    return np.rint(lin * f32(255 << _LAB_GAMMA_SHIFT)).astype(np.int64)


def _lab_cbrt_table() -> np.ndarray:
    """cv2's ``LabCbrtTab_b``: round(2**15 * f(i / (255 * 8))), f the CIE
    cube root with its linear segment below (6/29)**3, in float64."""
    x = np.arange(256 * 3 // 2 << _LAB_GAMMA_SHIFT) / float(255 << _LAB_GAMMA_SHIFT)
    thr = float(np.float32(216) / np.float32(24389))
    f = np.where(x < thr, x * (841.0 / 108.0) + 16.0 / 116.0, np.cbrt(x))
    return np.rint(f * (1 << _LAB_SHIFT2)).astype(np.int64)


_GAMMA_TABLE = _srgb_gamma_table()
_CBRT_TABLE = _lab_cbrt_table()


def rgb_to_lab_l(img_u8: np.ndarray) -> np.ndarray:
    """RGB uint8 HWC -> the LAB L channel, uint8 HW:
    ``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)[..., 0]``."""
    gamma, cbrt = _GAMMA_TABLE, _CBRT_TABLE
    rgb = np.asarray(img_u8, dtype=np.uint8)
    coef = [int(round(c * (1 << _LAB_SHIFT))) for c in _LAB_Y_ROW]
    y = sum(gamma[rgb[..., i]] * coef[i] for i in range(3))
    fy = cbrt[(y + (1 << (_LAB_SHIFT - 1))) >> _LAB_SHIFT]
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    lab_l = (l_scale * fy + l_shift + (1 << (_LAB_SHIFT2 - 1))) >> _LAB_SHIFT2
    return np.clip(lab_l, 0, 255).astype(np.uint8)


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
