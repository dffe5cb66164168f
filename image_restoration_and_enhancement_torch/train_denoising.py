"""Fine-tune the denoise task (the JAX package's ``scripts/train_denoising.py``; flags in
``train_cli.py``).

    python -m image_restoration_and_enhancement_torch.train_denoising --help
"""
from .train_cli import run

if __name__ == "__main__":
    raise SystemExit(run("denoise", "outputs/models/denoising"))
