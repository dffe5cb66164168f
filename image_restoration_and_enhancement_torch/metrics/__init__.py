"""Image-quality metrics: PSNR/SSIM/ΔE (``functional``), LPIPS and FID
(``perceptual``, ``inception``), ``MetricsCalculator`` and directory-level
evaluation (``evaluate``)."""
