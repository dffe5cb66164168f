"""Fine-tune the inpaint task (the JAX package's ``scripts/train_inpainting.py``; flags in
``train_cli.py``).

    python -m image_restoration_and_enhancement_torch.train_inpainting --help
"""
from .train_cli import run

if __name__ == "__main__":
    raise SystemExit(run("inpaint", "outputs/models/inpainting"))
