"""Fine-tune the colorize task (the JAX package's ``scripts/train_colorization.py``; flags in
``train_cli.py``).

    python -m image_restoration_and_enhancement_torch.train_colorization --help
"""
from .train_cli import run

if __name__ == "__main__":
    raise SystemExit(run("colorize", "outputs/models/colorization"))
