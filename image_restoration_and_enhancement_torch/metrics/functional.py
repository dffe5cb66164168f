"""Image-quality metrics on torch tensors (the port's copy of the JAX package's
``metrics/functional.py``).

- PSNR: skimage.metrics.peak_signal_noise_ratio with data_range.
- SSIM: skimage.metrics.structural_similarity defaults (7x7 uniform window,
  K1=0.01, K2=0.03, sample-covariance correction, edge crop, channel mean).
- Delta-E 76: Euclidean distance in CIE LAB.
- Y/L-channel variants (the SR and colorization metrics).

Images are float (..., H, W, C) in [0, 1]; every leading dimension is a batch
dimension and each image gets its own value (the JAX package vmaps one
image; here one call takes the batch). A 2-D input is one grey image.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.image import rgb_to_lab, uniform_filter, y_channel


def _image(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x[..., None] if x.dim() == 2 else x


def psnr(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, one value per image."""
    mse = ((_image(pred) - _image(gt)) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10((data_range**2) / mse.clamp_min(1e-12))


def ssim(
    pred: torch.Tensor,
    gt: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity, skimage-default semantics, one value per image
    (the mean over its valid window positions and channels)."""
    pred, gt = _image(pred), _image(gt)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)  # skimage sample-covariance correction
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ux = uniform_filter(pred, win_size)
    uy = uniform_filter(gt, win_size)
    uxx = uniform_filter(pred * pred, win_size)
    uyy = uniform_filter(gt * gt, win_size)
    uxy = uniform_filter(pred * gt, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    # valid-region filtering already excludes the pad skimage crops
    return ((a1 * a2) / (b1 * b2)).mean(dim=(-3, -2, -1))


def delta_e76(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean CIE76 colour difference per image. Inputs sRGB [0,1] (..., H, W, 3)."""
    d = rgb_to_lab(pred) - rgb_to_lab(gt)
    return torch.sqrt((d**2).sum(dim=-1)).mean(dim=(-2, -1))


def _lab_l(rgb: torch.Tensor) -> torch.Tensor:
    return rgb_to_lab(rgb)[..., :1] / 100.0


def psnr_y(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR on the BT.601 luma channel."""
    return psnr(y_channel(pred)[..., None], y_channel(gt)[..., None])


def ssim_y(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ssim(y_channel(pred)[..., None], y_channel(gt)[..., None])


def psnr_l(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR on the LAB L channel scaled to [0,1] (colorization metric)."""
    return psnr(_lab_l(pred), _lab_l(gt))


def ssim_l(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ssim(_lab_l(pred), _lab_l(gt))


def calculate_all(
    pred: torch.Tensor,
    gt: torch.Tensor,
    with_color: bool = False,
    with_y: bool = False,
) -> Dict[str, torch.Tensor]:
    """Core metric bundle, one value per image under each name (LPIPS and FID
    are model-based; see metrics.perceptual)."""
    out = {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt)}
    if with_y:
        out["psnr_y"] = psnr_y(pred, gt)
        out["ssim_y"] = ssim_y(pred, gt)
    if with_color:
        out["psnr_l"] = psnr_l(pred, gt)
        out["ssim_l"] = ssim_l(pred, gt)
        out["delta_e"] = delta_e76(pred, gt)
    return out
