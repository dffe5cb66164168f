"""Degradation synthesis on torch tensors (the port's copy of the JAX
package's ``data/degradations.py``).

The JAX functions draw from ``jax.random`` keys. Here each degradation is a
deterministic function of its image and explicit draws (noise sigma and
samples, JPEG quality, motion length and angle, the SR blur's kernel size, the
stroke points, counts and thicknesses), and a ``draw_*`` function makes those
draws from a ``torch.Generator`` on the images' device. Given JAX's draws, the
deterministic functions compute JAX's result (the tests feed them JAX's draws,
made with JAX's own key splits).

Everything is batched: images are float32 [B, H, W, C] in [0, 1], draws carry
a leading batch dimension, and no function loops over the batch in Python.
Sigma-like parameters are in [0, 255] units, as in the reference CLI.
The convolutions and the DCT products run in full fp32 (``ops.image``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.image import depthwise_conv, full_fp32, resize, rgb_to_grayscale

Draws = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _randint(gen: torch.Generator, shape, lo: int, hi_inclusive: int, device) -> torch.Tensor:
    return torch.randint(lo, hi_inclusive + 1, shape, generator=gen, device=device)


def _per_image(v: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A [B] draw shaped to broadcast over [B, H, W, C]."""
    return v.reshape(-1, *([1] * (img.dim() - 1)))


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------


def draw_noise(gen: torch.Generator, shape, sigma_range=(5.0, 8.0), device=None) -> Draws:
    """sigma [B] uniform in sigma_range / 255, unit normal samples of ``shape``."""
    return {"sigma": _uniform(gen, shape[:1], sigma_range[0] / 255.0, sigma_range[1] / 255.0,
                              device),
            "noise": torch.randn(shape, generator=gen, device=device)}


def gaussian_noise(img: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Additive Gaussian noise: clip(img + noise * sigma, 0, 1)."""
    return (img.float() + noise * _per_image(sigma, img)).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# JPEG artifacts (8x8 DCT quantization)
# ---------------------------------------------------------------------------

# Standard Annex-K quantization tables.
_JPEG_LUMA_Q = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_JPEG_CHROMA_Q = np.full((8, 8), 99, dtype=np.float32)
_JPEG_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                          [47, 66, 99, 99]]


def _dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix."""
    n = 8
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


_DCT8 = _dct8_matrix()

# Full-range RGB<->YCbCr (JFIF).
_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)
_YCC2RGB = np.linalg.inv(_RGB2YCC).astype(np.float32)


def quant_tables(quality: torch.Tensor) -> torch.Tensor:
    """[B] integer qualities -> the scaled tables [B, 3, 8, 8] (Y, Cb, Cr)."""
    q = quality.float().clamp(1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)[:, None, None, None]
    base = torch.as_tensor(np.stack([_JPEG_LUMA_Q, _JPEG_CHROMA_Q, _JPEG_CHROMA_Q]),
                           device=quality.device)
    return torch.floor((base * scale + 50.0) / 100.0).clamp(1.0, 255.0)


def jpeg_dct(img: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] in [0,1] -> the level-shifted YCbCr DCT coefficients per
    8x8 block, [B, H/8, W/8, 3, 8, 8] (H and W edge-padded to multiples of 8),
    computed in ``dtype``."""
    b, h, w, _ = img.shape
    x = img.to(dtype)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                    mode="replicate").permute(0, 2, 3, 1)
    rgb2ycc = torch.as_tensor(_RGB2YCC, device=x.device).to(dtype)
    ycc = (x.unsqueeze(-2) * rgb2ycc).sum(-1) * 255.0
    ycc = torch.cat([ycc[..., :1] - 128.0, ycc[..., 1:]], dim=-1)
    nh, nw = ycc.shape[1] // 8, ycc.shape[2] // 8
    blocks = ycc.reshape(b, nh, 8, nw, 8, 3).permute(0, 1, 3, 5, 2, 4)
    d = torch.as_tensor(_DCT8, device=x.device).to(dtype)
    with full_fp32():
        return d @ blocks @ d.T


def jpeg_quantize(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG artifacts by DCT quantization at per-image integer ``quality`` [B]."""
    b, h, w, _ = img.shape
    qtab = quant_tables(quality)[:, None, None]                 # [B, 1, 1, 3, 8, 8]
    coefs = torch.round(jpeg_dct(img) / qtab) * qtab           # round half to even, as jnp
    d = torch.as_tensor(_DCT8, device=img.device)
    with full_fp32():
        rec = d.T @ coefs @ d
    nh, nw = rec.shape[1], rec.shape[2]
    rec = rec.permute(0, 1, 4, 2, 5, 3).reshape(b, nh * 8, nw * 8, 3)
    rec = torch.cat([rec[..., :1] + 128.0, rec[..., 1:]], dim=-1)
    ycc2rgb = torch.as_tensor(_YCC2RGB, device=img.device)
    rgb = ((rec / 255.0).unsqueeze(-2) * ycc2rgb).sum(-1)
    return rgb[:, :h, :w].clamp(0.0, 1.0)


def draw_jpeg(gen: torch.Generator, batch: int, quality_range=(30, 90), device=None) -> Draws:
    return {"quality": _randint(gen, (batch,), quality_range[0], quality_range[1], device)}


# ---------------------------------------------------------------------------
# Motion blur
# ---------------------------------------------------------------------------


def line_kernels(length: torch.Tensor, angle_rad: torch.Tensor, max_size: int) -> torch.Tensor:
    """Anti-aliased linear motion kernels [B, S, S] of per-image ``length`` and
    ``angle_rad`` [B] in a static S x S support (distance to the segment)."""
    dev = length.device
    c = (max_size - 1) / 2.0
    r = torch.arange(max_size, dtype=torch.float32, device=dev) - c
    ys, xs = r[:, None], r[None, :]
    dx = torch.cos(angle_rad)[:, None, None]
    dy = torch.sin(angle_rad)[:, None, None]
    half = ((length - 1.0) / 2.0)[:, None, None]
    t = torch.maximum(torch.minimum(xs * dx + ys * dy, half), -half)
    dist = torch.sqrt((xs - t * dx) ** 2 + (ys - t * dy) ** 2)
    k = (1.0 - dist).clamp(0.0, 1.0)
    return k / k.sum(dim=(1, 2), keepdim=True).clamp_min(1e-8)


def draw_motion(gen: torch.Generator, batch: int, kernel_size_range=(5, 15),
                angle_range=(0.0, 360.0), device=None) -> Draws:
    """length [B] uniform in kernel_size_range, angle [B] in radians."""
    length = _uniform(gen, (batch,), float(kernel_size_range[0]), float(kernel_size_range[1]),
                      device)
    angle = _uniform(gen, (batch,), angle_range[0], angle_range[1], device)
    return {"length": length, "angle": torch.deg2rad(angle)}


def motion_blur(img: torch.Tensor, length: torch.Tensor, angle_rad: torch.Tensor,
                kernel_size_range=(5, 15)) -> torch.Tensor:
    """Motion blur with a line kernel per image, edge-replicated."""
    max_size = kernel_size_range[1] | 1  # odd static support, as in JAX
    return depthwise_conv(img, line_kernels(length, angle_rad, max_size))


# ---------------------------------------------------------------------------
# Task degradations
# ---------------------------------------------------------------------------


def draw_denoise(gen: torch.Generator, shape, with_artifacts: bool = False,
                 device=None) -> Draws:
    """The denoise input's draws: noise (sigma 5-8), or with artifacts noise
    (3-15), a JPEG at quality 40-85 with probability 0.3 and a motion blur
    (length 3-8) with probability 0.2."""
    if not with_artifacts:
        return draw_noise(gen, shape, (5.0, 8.0), device)
    b = shape[0]
    return {**draw_noise(gen, shape, (3.0, 15.0), device),
            "use_jpeg": torch.rand((b,), generator=gen, device=device) < 0.3,
            **draw_jpeg(gen, b, (40, 85), device),
            "use_blur": torch.rand((b,), generator=gen, device=device) < 0.2,
            **draw_motion(gen, b, (3, 8), device=device)}


def degrade_denoise(img: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Denoise-task input (reference: make_synthetic_pairs.py:163-172)."""
    out = gaussian_noise(img, draws["sigma"], draws["noise"])
    if "use_jpeg" in draws:
        out = torch.where(_per_image(draws["use_jpeg"], out),
                          jpeg_quantize(out, draws["quality"]), out)
        out = torch.where(_per_image(draws["use_blur"], out),
                          motion_blur(out, draws["length"], draws["angle"], (3, 8)), out)
    return out


def draw_sr(gen: torch.Generator, batch: int, device=None) -> Draws:
    """The SR blur's kernel size [B], one of 3, 5, 7."""
    choice = torch.randint(0, 3, (batch,), generator=gen, device=device)
    return {"ksize": torch.tensor([3, 5, 7], device=device)[choice]}


def degrade_sr(img: torch.Tensor, ksize: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """SR-task LR input: a Gaussian blur (kernel ``ksize`` [B], cv2's sigma from
    k, radius 3), then bicubic /scale with antialias."""
    sigma = 0.3 * ((ksize.float() - 1.0) * 0.5 - 1.0) + 0.8
    x = torch.arange(-3, 4, dtype=torch.float32, device=img.device)
    k1 = torch.exp(-0.5 * (x[None, :] / sigma.clamp_min(1e-6)[:, None]) ** 2)
    k1 = k1 / k1.sum(dim=1, keepdim=True)                          # [B, 7]
    blurred = depthwise_conv(depthwise_conv(img, k1[:, :, None]), k1[:, None, :])
    h, w = img.shape[-3], img.shape[-2]
    return resize(blurred, (h // scale, w // scale), method="bicubic", antialias=True)


def degrade_colorize(img: torch.Tensor) -> torch.Tensor:
    """Colorize-task input: the LAB L channel replicated to 3 channels."""
    return rgb_to_grayscale(img, mode="lab_l").repeat_interleave(3, dim=-1)


# ---------------------------------------------------------------------------
# Free-form masks
# ---------------------------------------------------------------------------


def draw_strokes(gen: torch.Generator, batch: int, hw: Tuple[int, int],
                 num_strokes=(5, 15), thickness_range=(10, 40), max_points: int = 8,
                 device=None) -> Draws:
    """Per image: the stroke count n_strokes [B]; per stroke (num_strokes[1] of
    them): points pts_x, pts_y [B, S, P], their count n_pts [B, S] (4..P) and
    the thickness thick [B, S]."""
    h, w = hw
    s = num_strokes[1]
    return {"n_strokes": _randint(gen, (batch,), num_strokes[0], num_strokes[1], device),
            "pts_x": _uniform(gen, (batch, s, max_points), 0.0, w - 1.0, device),
            "pts_y": _uniform(gen, (batch, s, max_points), 0.0, h - 1.0, device),
            "n_pts": _randint(gen, (batch, s), 4, max_points, device),
            "thick": _randint(gen, (batch, s), thickness_range[0], thickness_range[1], device)}


def _stroke_geometry(hw: Tuple[int, int], strokes: Draws, dtype: torch.dtype):
    """In ``dtype``: d2 [B, S, P-1, H, W], every pixel's squared distance to
    every stroke segment; the squared half thickness [B, S, 1, 1, 1]; and
    which segments are drawn [B, S, P-1, 1, 1] (its stroke's index <
    n_strokes, its end point's index < n_pts)."""
    h, w = hw
    px, py = strokes["pts_x"].to(dtype), strokes["pts_y"].to(dtype)    # [B, S, P]
    dev = px.device
    _, s, p = px.shape
    ys = torch.arange(h, dtype=dtype, device=dev)[:, None]
    xs = torch.arange(w, dtype=dtype, device=dev)[None, :]

    def seg(v):   # [B, S, P-1] -> [B, S, P-1, 1, 1]
        return v[..., None, None]

    x0, y0, x1, y1 = seg(px[..., :-1]), seg(py[..., :-1]), seg(px[..., 1:]), seg(py[..., 1:])
    vx, vy = x1 - x0, y1 - y0
    denom = torch.clamp_min(vx * vx + vy * vy, 1e-8)
    t = (((xs - x0) * vx + (ys - y0) * vy) / denom).clamp(0.0, 1.0)
    d2 = (xs - (x0 + t * vx)) ** 2 + (ys - (y0 + t * vy)) ** 2
    half = seg(strokes["thick"].to(dtype) / 2.0)[:, :, None]
    seg_on = torch.arange(1, p, device=dev) < strokes["n_pts"][..., None]
    active = torch.arange(s, device=dev) < strokes["n_strokes"][:, None]
    return d2, half * half, seg(seg_on & active[..., None])


def free_form_mask(hw: Tuple[int, int], strokes: Draws) -> torch.Tensor:
    """Stroke masks [B, H, W, 1] in {0, 1}: each active stroke (index <
    n_strokes) is a polyline of its first n_pts points, a pixel is in it
    where its squared distance to a segment is <= (thick / 2)^2. Computed
    for every image, stroke and segment at once, in fp32 as JAX does."""
    d2, half2, on = _stroke_geometry(hw, strokes, torch.float32)
    return ((d2 <= half2) & on).any(dim=2).any(dim=1).float()[..., None]


def draw_inpaint(gen: torch.Generator, batch: int, hw: Tuple[int, int], device=None) -> Draws:
    """The easy/hard mask mix's draws: u_mix [B] and both stroke sets."""
    return {"u_mix": torch.rand((batch,), generator=gen, device=device),
            "easy": draw_strokes(gen, batch, hw, (3, 7), (5, 20), device=device),
            "hard": draw_strokes(gen, batch, hw, (8, 15), (20, 40), device=device)}


def inpaint_mask(hw: Tuple[int, int], draws: Draws, easy_ratio: float = 0.7) -> torch.Tensor:
    """Easy/hard mask mix (reference: make_synthetic_pairs.py:186-190): each
    image takes its easy strokes where u_mix < easy_ratio, else its hard ones
    (only the chosen mask is computed; the easy set is padded with inactive
    strokes to the hard set's count)."""
    easy, hard = draws["easy"], draws["hard"]
    pick = draws["u_mix"] < easy_ratio                            # [B]
    extra = hard["pts_x"].shape[1] - easy["pts_x"].shape[1]

    def padded(v):
        return torch.cat([v, v[:, :1].expand(-1, extra, *v.shape[2:])], dim=1) if extra else v

    chosen = {}
    for k in ("pts_x", "pts_y", "n_pts", "thick"):
        sel = pick.reshape(-1, *([1] * (hard[k].dim() - 1)))
        chosen[k] = torch.where(sel, padded(easy[k]), hard[k])
    chosen["n_strokes"] = torch.where(pick, easy["n_strokes"], hard["n_strokes"])
    return free_form_mask(hw, chosen)


def degrade_inpaint(img: torch.Tensor, draws: Draws, easy_ratio: float = 0.7
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked input, mask [B, H, W, 1]); masked pixels are zeroed."""
    mask = inpaint_mask(img.shape[-3:-1], draws, easy_ratio)
    return img * (1.0 - mask), mask


# ---------------------------------------------------------------------------
# Where two correct fp32 computations may disagree (for the parity checks)
# ---------------------------------------------------------------------------


def near_mask_boundary(hw: Tuple[int, int], strokes: Draws, tol: float = 1e-2) -> np.ndarray:
    """[B, H, W] bool: pixels whose squared distance to an active stroke
    segment lies within ``tol`` of (thickness / 2)^2, computed in float64 on
    the host. An fp32 mask may differ there between devices or frameworks
    (d2 near 512^2 carries ~1e-3 of rounding); nowhere else."""
    d2, half2, on = _stroke_geometry(hw, {k: v.cpu() for k, v in strokes.items()},
                                     torch.float64)
    return (((d2 - half2).abs() <= tol) & on).any(dim=2).any(dim=1).numpy()


def near_inpaint_boundary(hw: Tuple[int, int], draws: Draws, easy_ratio: float = 0.7
                          ) -> np.ndarray:
    """``near_mask_boundary`` of the stroke set each image of ``inpaint_mask`` takes."""
    pick = (draws["u_mix"].cpu() < easy_ratio)[:, None, None].numpy()
    return np.where(pick, near_mask_boundary(hw, draws["easy"]),
                    near_mask_boundary(hw, draws["hard"]))


def near_jpeg_midpoint(img: torch.Tensor, quality: torch.Tensor, tol: float = 1e-4
                       ) -> np.ndarray:
    """[B, H, W] bool: the pixels of 8x8 blocks with a DCT coefficient within
    ``tol`` quantization steps of a rounding midpoint, computed in float64 on
    the host. Two fp32 DCTs may round such a coefficient to neighbouring
    steps, which changes its whole block; no other block may differ."""
    h, w = img.shape[1:3]
    steps = jpeg_dct(img.cpu(), torch.float64) / quant_tables(quality.cpu()).double()[:, None, None]
    mid = ((steps - steps.floor() - 0.5).abs() < tol).flatten(3).any(dim=-1)
    return mid.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w].numpy()
