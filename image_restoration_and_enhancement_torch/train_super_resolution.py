"""Fine-tune the sr_x4 task (the JAX package's ``scripts/train_super_resolution.py``; flags in
``train_cli.py``).

    python -m image_restoration_and_enhancement_torch.train_super_resolution --help
"""
from .train_cli import run

if __name__ == "__main__":
    raise SystemExit(run("sr_x4", "outputs/models/super_resolution"))
