"""Pretrain the AutoencoderKL on clean images by reconstruction (the JAX
package's ``scripts/pretrain_vae.py``, with its flags; the objective is in
``train/vae_pretrain.py``). The task trainers take the result through
``--vae_init outputs/models/vae_pretrained/best``.

    python -m image_restoration_and_enhancement_torch.pretrain_vae \\
        --data_root data/clean --output_dir outputs/models/vae_pretrained [--device cpu]

Trains on the GPU unless ``--device cpu``; over every card where the batch
divides by their number, as the task trainers do (``train_cli.py``), and on
one device with ``--no_mesh``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", default="data/clean", help="root with {train,val} image folders")
    p.add_argument("--output_dir", default="outputs/models/vae_pretrained")
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--kl_weight", type=float, default=1e-6)
    p.add_argument("--scale_weight", type=float, default=0.1)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--max_val_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_mesh", action="store_true",
                   help="train on one device; without it, a batch that divides by the "
                        "number of cards trains over all of them (data parallel)")
    p.add_argument("--base_model", default="sd15", choices=["sd15", "tiny_sd"])
    p.add_argument("--init_from", default=None,
                   help="pipeline dir (e.g. an earlier run's best/) to continue from")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from . import config as C
    from .train.vae_pretrain import VAEPretrainConfig, pretrain_vae

    cfg = VAEPretrainConfig(num_epochs=args.num_epochs, batch_size=args.batch_size,
                            learning_rate=args.learning_rate, image_size=args.image_size,
                            kl_weight=args.kl_weight, scale_weight=args.scale_weight,
                            seed=args.seed)
    metrics = pretrain_vae(
        data_root=args.data_root, output_dir=args.output_dir, cfg=cfg,
        model_config={"sd15": C.SD15, "tiny_sd": C.TINY_SD}[args.base_model],
        max_train_samples=args.max_train_samples, max_val_samples=args.max_val_samples,
        use_mesh=not args.no_mesh, init_from=args.init_from, device=args.device)
    print({k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
