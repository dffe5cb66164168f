"""Image operations on torch tensors: colour spaces, resizing, blurs (the port's
copy of the JAX package's ``ops/image.py``).

Images are float32 (..., H, W, C) tensors in [0, 1], channels last as in the
JAX package, on any device; every leading dimension is a batch dimension.

Precision: the JAX functions are fp32 (``jax.image.resize`` and
``uniform_filter`` at ``Precision.HIGHEST``). Torch lets cuDNN run fp32
convolutions in TF32 by default, and cuBLAS fp32 products where
``torch.backends.cuda.matmul.allow_tf32`` is set; SSIM takes E[x^2] - E[x]^2
from ``uniform_filter`` and can exceed 1 in TF32. So every fp32 convolution
and product here runs inside ``full_fp32()``, which turns TF32 off for the
block and restores the caller's settings after it, and ``uniform_filter``
sums in float64: the ops own their precision and do not depend on the
caller's flags.

``resize`` is ``jax.image.resize``, not ``F.interpolate``: Keys cubic with
a = -0.5 (``F.interpolate`` takes a = -0.75), a triangle or Lanczos kernel,
and with ``antialias`` the kernel widened by the scale when shrinking. It
builds the same per-axis weight matrices as JAX's ``compute_weight_mat`` (in
float32, as JAX computes them) and applies them as two fp32 products.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions (cuDNN) and matrix products (cuBLAS) in full fp32 for
    the block, whatever the caller's TF32 settings; they are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Color spaces
# ---------------------------------------------------------------------------

# sRGB -> XYZ (D65), rows = X,Y,Z.
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)


def _mix(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """x @ m.T over the last axis as fp32 products and a sum (a 3x3 mix needs
    no matmul, and so cannot take TF32)."""
    return (x.unsqueeze(-2) * torch.as_tensor(m, device=x.device)).sum(-1)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = c.clamp(0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] (..., 3) -> CIE LAB (L in [0,100]). Matches skimage.color.rgb2lab."""
    xyz = _mix(_srgb_to_linear(rgb.float()), _RGB2XYZ)
    xyz = xyz / torch.as_tensor(_D65_WHITE, device=xyz.device)
    eps = (6.0 / 29.0) ** 3
    kappa = 1.0 / (3.0 * (6.0 / 29.0) ** 2)
    # the cube root: torch has no cbrt; pow(1/3) is exact enough where x > eps
    f = torch.where(xyz > eps, xyz.clamp_min(eps) ** (1.0 / 3.0), kappa * xyz + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """CIE LAB -> sRGB [0,1]."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    f = torch.stack([fy + a / 500.0, fy, fy - b / 200.0], dim=-1)
    delta = 6.0 / 29.0
    xyz = torch.where(f > delta, f**3, 3.0 * delta**2 * (f - 4.0 / 29.0))
    xyz = xyz * torch.as_tensor(_D65_WHITE, device=xyz.device)
    return _linear_to_srgb(_mix(xyz, _XYZ2RGB)).clamp(0.0, 1.0)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 full-range YCbCr (the PIL 'YCbCr' convention), in [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def y_channel(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma (...), the channel of the Y-channel PSNR/SSIM."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def rgb_to_grayscale(rgb: torch.Tensor, mode: str = "lab_l") -> torch.Tensor:
    """Grayscale (..., 1): mode "lab_l" is the LAB L channel / 100 (the
    colorization input), "luma" plain BT.601."""
    if mode == "lab_l":
        g = rgb_to_lab(rgb)[..., 0] / 100.0
    elif mode == "luma":
        g = y_channel(rgb)
    else:
        raise ValueError(mode)
    return g.clamp(0.0, 1.0)[..., None]


# ---------------------------------------------------------------------------
# Resizing (jax.image.resize)
# ---------------------------------------------------------------------------


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0))
                   * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out)


def _lanczos(radius: float):
    def kernel(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            y = np.float32(radius) * np.sin(np.float32(np.pi) * x) \
                * np.sin(np.float32(np.pi) * x / np.float32(radius))
            out = np.where(x > 1e-3, y / np.where(x != 0, np.float32(np.pi**2) * x * x,
                                                 np.float32(1)), np.float32(1))
        return np.where(x > radius, np.float32(0), out)
    return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """JAX's ``compute_weight_mat`` [in_size, out_size] in float32, for a
    resize (scale out/in, no translation)."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """jax.image's nearest: floor((i + 0.5) * in / out) in float32, with the
    constant folded as XLA folds it, (i + 0.5) * (in * (1 / out))."""
    step = np.float32(in_size) * (np.float32(1) / np.float32(out_size))
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * step
    return np.floor(pos).astype(np.int64)


def resize(img: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) spatially, as ``jax.image.resize``. Methods:
    nearest | bilinear (linear) | bicubic (cubic) | lanczos3 | lanczos5."""
    x = img.float()
    for axis, out_size in ((-3, out_hw[0]), (-2, out_hw[1])):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        if method == "nearest":
            idx = torch.as_tensor(_nearest_index(in_size, out_size), device=x.device)
            x = x.index_select(x.ndim + axis, idx)
            continue
        w = torch.as_tensor(_resize_weights(in_size, out_size, method, antialias),
                            device=x.device)
        moved = x.movedim(axis, -1)
        with full_fp32():
            x = (moved @ w).movedim(-1, axis)
    return x


def upscale_bicubic(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Bicubic upscale by an integer factor (the SR conditioning transform)."""
    h, w = img.shape[-3], img.shape[-2]
    return resize(img, (h * factor, w * factor), method="bicubic", antialias=False)


# ---------------------------------------------------------------------------
# Blurs (depthwise convs)
# ---------------------------------------------------------------------------


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.sum()).astype(np.float32)


def depthwise_conv(img: torch.Tensor, kernel: torch.Tensor, pad: str = "edge") -> torch.Tensor:
    """One [kh, kw] kernel over every channel of (..., H, W, C) (or of each
    batch's image, with a [B, kh, kw] kernel and img [B, H, W, C]), in fp32:
    ``pad="edge"`` replicates the border (SAME size), ``"valid"`` shrinks."""
    x = img.float()
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)              # [N, C, H, W]
    kernel = kernel.float().to(x.device)
    kh, kw = kernel.shape[-2:]
    if pad == "edge":
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    with full_fp32():
        if kernel.dim() == 2:
            out = F.conv2d(x, kernel.expand(c, 1, kh, kw), groups=c)
        else:   # a kernel per image: the batch folds into the channel groups
            n, _, hp, wp = x.shape
            weight = kernel[:, None, None].expand(n, c, 1, kh, kw).reshape(n * c, 1, kh, kw)
            out = F.conv2d(x.reshape(1, n * c, hp, wp), weight, groups=n * c)
            out = out.reshape(n, c, hp - kh + 1, wp - kw + 1)
    return out.permute(0, 2, 3, 1).reshape(*lead, *out.shape[-2:], c)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W, C), edge-replicated."""
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    k1 = torch.as_tensor(gaussian_kernel1d(sigma, radius))
    return depthwise_conv(depthwise_conv(img, k1[:, None]), k1[None, :])


def box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    k1 = torch.full((size,), 1.0 / size)
    return depthwise_conv(depthwise_conv(img, k1[:, None]), k1[None, :])


def motion_blur_kernel(size: int, angle_deg: float) -> np.ndarray:
    """Linear motion-blur kernel (reference: make_synthetic_pairs.py:46-64)."""
    k = np.zeros((size, size), dtype=np.float32)
    c = (size - 1) / 2.0
    theta = np.deg2rad(angle_deg)
    dx, dy = np.cos(theta), np.sin(theta)
    for i in range(size):
        t = i - c
        x = int(round(c + t * dx))
        y = int(round(c + t * dy))
        if 0 <= x < size and 0 <= y < size:
            k[y, x] = 1.0
    s = k.sum()
    return k / s if s > 0 else k


def motion_blur(img: torch.Tensor, size: int, angle_deg: float) -> torch.Tensor:
    return depthwise_conv(img, torch.as_tensor(motion_blur_kernel(size, angle_deg)))


def uniform_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Valid-region uniform filter: (..., H, W, C) -> (..., H-s+1, W-s+1, C)
    in float32. Each window's mean is summed in float64 and rounded once, so
    no TF32 applies and SSIM's E[x^2] - E[x]^2 starts from the best float32
    means (an fp32 sum of 49 terms errs by up to ~6 ulp, which the
    subtraction magnifies; see the module docstring)."""
    x = img.double()
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    kernel = torch.full((c, 1, size, size), 1.0 / (size * size), dtype=torch.float64,
                        device=x.device)
    out = F.conv2d(x, kernel, groups=c).float()
    return out.permute(0, 2, 3, 1).reshape(*lead, *out.shape[-2:], c)
