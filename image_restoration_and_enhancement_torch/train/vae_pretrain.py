"""VAE reconstruction pretraining (the port's counterpart of the JAX package's
``train/vae_pretrain.py``).

The reference trainers freeze a pretrained SD-1.5 AutoencoderKL. Where no
pretrained weights exist, a random frozen VAE makes the sampled images noise
and validation PSNR meaningless, so this module pretrains the VAE on clean
images and ``train_task(vae_init=...)`` seeds the task trainers with it.

Objective, as in the JAX module: L2 reconstruction of a sampled posterior's
decode + ``scale_weight`` * log(E[(z sf)^2])^2 (pushes the scaled latents to
unit second moment, so the pinned scaling factor is right) + ``kl_weight`` *
the KL to N(0, 1/sf^2). AdamW (weight decay ``weight_decay``) after global-norm
clipping, warmup + cosine learning rate (``train/optim.py``); fp32 masters
beside a compute-dtype module, as the task trainer's UNet. On the card the
encoder's and decoder's mid-block attention is K1 at d = 512 ("sm90_split")
and their largest GroupNorms K2 "twophase", forward under autograd.

Several devices follow the task trainer's rule and roles
(``trainer.data_parallel_ranks``): a ``data`` mesh of N ranks, each taking
its rows of the global batch and of the step's posterior draw, the gradients
averaged over the axis; rank 0 validates and writes.
"""
from __future__ import annotations

import csv
import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config as C
from ..core import checkpoint as ckpt
from ..data import native
from ..data.datasets import IMG_EXTS, BatchLoader
from ..data.png import load_image
from ..device import DeviceLike, resolve_device
from ..metrics import functional as F
from ..models.layers import CL, init_random_
from ..models.vae import AutoencoderKL
from .loop import TrainState, load_masters, make_module_step, shard_rows, step_generator
from .optim import Optimizer, warmup_cosine_decay

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VAEPretrainConfig:
    num_epochs: int = 20
    batch_size: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_frac: float = 0.05
    image_size: int = 256
    seed: int = 42
    kl_weight: float = 1e-6     # keeps the posterior well formed
    scale_weight: float = 0.1   # pushes E[(z sf)^2] -> 1


class ImageFolderDataset:
    """A flat folder of images -> {"image": [-1, 1] HWC float32}. PNG files
    are read by the port's codec, other formats through PIL."""

    def __init__(self, directory: str, image_size: int = 256,
                 max_samples: Optional[int] = None):
        self.image_size = image_size
        names = [n for n in sorted(os.listdir(directory))
                 if os.path.splitext(n)[1].lower() in IMG_EXTS] if os.path.isdir(directory) else []
        if max_samples is not None:
            names = names[:max_samples]
        self.paths = [os.path.join(directory, n) for n in names]
        if not self.paths:
            raise FileNotFoundError(f"No images under {directory}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = load_image(self.paths[idx], "RGB").astype(np.float32)
        size = self.image_size
        if img.shape[:2] != (size, size):
            img = native.resize_bicubic(img, (size, size))
        return {"image": np.clip(img / 127.5 - 1.0, -1.0, 1.0).astype(np.float32)}


def make_vae_optimizer(cfg: VAEPretrainConfig, num_steps: int) -> Optimizer:
    schedule = warmup_cosine_decay(cfg.learning_rate, max(1, int(num_steps * cfg.warmup_frac)),
                                   max(2, num_steps))
    return Optimizer("adamw", schedule, weight_decay=cfg.weight_decay,
                     max_grad_norm=cfg.max_grad_norm)


def make_vae_loss_fn(vae: AutoencoderKL, sf: float, cfg: VAEPretrainConfig):
    """loss(batch, noise) -> (loss, {"loss", "recon_mse", "scaled_msq"});
    ``noise``: the posterior's standard-normal draw, latent-shaped."""

    def loss_fn(batch, noise):
        dev = vae.quant_conv.weight.device
        x = torch.as_tensor(batch["image"]).to(dev, torch.float32)
        post = vae.encode(x)
        z = post.sample(torch.as_tensor(noise).to(dev, torch.float32))
        recon = vae.decode(z)
        recon_mse = torch.mean((recon - x) ** 2)
        second = (post.mean ** 2 + torch.exp(post.logvar)) * sf * sf
        msq = torch.mean(second)
        scale_pen = torch.log(msq) ** 2
        kl = 0.5 * torch.mean(second - 1.0 - post.logvar - 2.0 * float(np.log(sf)))
        loss = recon_mse + cfg.scale_weight * scale_pen + cfg.kl_weight * kl
        return loss, {"loss": loss, "recon_mse": recon_mse, "scaled_msq": msq}

    return loss_fn


def make_vae_train_step(vae: AutoencoderKL, sf: float, cfg: VAEPretrainConfig, num_steps: int,
                        mesh=None):
    """(optimizer, step(state, batch, noise) -> metrics); the state is a
    ``TrainState`` over the VAE (``TrainState.create(vae, optimizer)``).
    With ``mesh``, ``batch`` and ``noise`` are the global ones and the step
    runs on this rank's rows of ``data``."""
    step = make_module_step(vae, make_vae_loss_fn(vae, sf, cfg), mesh)
    if mesh is not None:
        inner = step

        def step(state, batch, noise):
            rows = shard_rows({**batch, "noise": noise}, mesh)
            return inner(state, {k: v for k, v in rows.items() if k != "noise"}, rows["noise"])
    return make_vae_optimizer(cfg, num_steps), step


def draw_posterior_noise(vae: AutoencoderKL, image_shape, generator: torch.Generator
                         ) -> torch.Tensor:
    b, h, w = image_shape[:3]
    f = 2 ** (len(vae.config.block_out_channels) - 1)
    return torch.randn((b, h // f, w // f, vae.config.latent_channels), generator=generator,
                       device=generator.device)


def pretrain_vae(
    data_root: str = "data/clean",
    output_dir: str = "outputs/models/vae_pretrained",
    cfg: VAEPretrainConfig = VAEPretrainConfig(),
    model_config: Optional[C.SDModelConfig] = None,
    max_train_samples: Optional[int] = None,
    max_val_samples: Optional[int] = None,
    use_mesh: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    init_from: Optional[str] = None,
    device: DeviceLike = None,
    num_devices: Optional[int] = None,
) -> Dict[str, float]:
    """Pretrain the AutoencoderKL on data_root/{train,val} on ``device``
    (``cuda`` unless ``"cpu"``), over a data mesh where the task trainer's
    rule says so (``num_devices``: see ``trainer.data_parallel_ranks``).
    Returns the last validation metrics (rank 0's); writes best/ and final/
    pipelines with a ``vae`` component and metrics_vae.csv (epoch, psnr,
    latent_std, train_loss)."""
    from .trainer import _is_main, _setup_logging, _world, data_parallel_ranks, spawn_ranks

    model_config = model_config or C.SD15
    dev = resolve_device(device)
    _world(dev)
    if _is_main():
        os.makedirs(output_dir, exist_ok=True)
    _setup_logging(output_dir, "vae")
    n_ranks = data_parallel_ranks(use_mesh, cfg.batch_size, dev, num_devices)
    mesh = None
    if n_ranks > 1 and not dist.is_initialized():
        from ..parallel import train as parallel_train

        return spawn_ranks(parallel_train.run_pretrain_vae, n_ranks, dev, dict(
            data_root=data_root, output_dir=output_dir, cfg=cfg, model_config=model_config,
            max_train_samples=max_train_samples, max_val_samples=max_val_samples,
            dtype=dtype, init_from=init_from, device=dev.type))["metrics"]
    if n_ranks > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh((n_ranks,), ("data",))
        dev = mesh.device

    sf = model_config.vae.scaling_factor
    with torch.device("meta"):
        vae = AutoencoderKL(model_config.vae).to(dtype, memory_format=CL)
    vae = vae.to_empty(device=dev)
    init_random_(vae, torch.Generator(device=dev).manual_seed(cfg.seed))
    if init_from:
        # continue from an earlier pretrain's best/ (the optimizer restarts)
        states = ckpt.load_state_dicts(init_from)
        if "vae" not in states:
            raise FileNotFoundError(f"no vae component under {init_from}")
        vae.load_state_dict(states["vae"], strict=True)
        logger.info("initialized VAE params from %s", init_from)
    n_params = sum(p.numel() for p in vae.parameters())
    logger.info("=== VAE pretrain -> %s (%d params) ===", output_dir, n_params)
    t_start = time.time()

    train_ds = ImageFolderDataset(os.path.join(data_root, "train"), cfg.image_size,
                                  max_train_samples)
    val_ds = ImageFolderDataset(os.path.join(data_root, "val"), cfg.image_size, max_val_samples)
    train_loader = BatchLoader(train_ds, cfg.batch_size, seed=cfg.seed)
    val_loader = BatchLoader(val_ds, min(cfg.batch_size, 4), shuffle=False, drop_last=False)
    logger.info("train images: %d, val images: %d", len(train_ds), len(val_ds))

    num_steps = max(1, len(train_loader) * cfg.num_epochs)
    tx, step_fn = make_vae_train_step(vae, sf, cfg, num_steps, mesh)
    state = TrainState.create(vae, tx)
    masters = {"vae": state.params}

    csv_path = os.path.join(output_dir, "metrics_vae.csv")
    columns = ["epoch", "psnr", "latent_std", "train_loss"]
    best_psnr = float("-inf")
    global_step = 0
    val_metrics: Dict[str, float] = {}
    for epoch in range(cfg.num_epochs):
        epoch_t0 = time.time()
        losses: List[float] = []
        for batch in train_loader.epoch(epoch):
            noise = draw_posterior_noise(vae, batch["image"].shape,
                                         step_generator(cfg.seed, global_step, dev))
            metrics = step_fn(state, batch, noise)
            losses.append(float(metrics["loss"]))
            global_step += 1
        train_loss = float(np.mean(losses)) if losses else float("nan")

        load_masters(vae, state.params)
        if not _is_main():  # rank 0 validates and writes
            if mesh is not None:
                dist.barrier()
            continue
        # validation: the posterior mean's round trip PSNR and the latent scale
        psnrs: List[float] = []
        stds: List[float] = []
        with torch.no_grad():
            for batch in val_loader.epoch(0):
                x = torch.from_numpy(batch["image"]).to(dev)
                z = vae.encode(x).mean
                recon = vae.decode(z)
                stds.append(float(z.std(unbiased=False)) * sf)
                psnrs.extend(F.psnr((recon + 1) / 2, (x + 1) / 2).tolist())
        val_psnr = float(np.mean(psnrs))
        latent_std = float(np.mean(stds))
        val_metrics = {"psnr": val_psnr, "latent_std": latent_std}
        logger.info("epoch %d/%d loss %.4f val psnr %.3f scaled-latent std %.3f (%.1fs)",
                    epoch + 1, cfg.num_epochs, train_loss, val_psnr, latent_std,
                    time.time() - epoch_t0)
        exists = os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=columns)
            if not exists:
                w.writeheader()
            w.writerow({"epoch": epoch + 1, "psnr": round(val_psnr, 4),
                        "latent_std": round(latent_std, 4), "train_loss": round(train_loss, 6)})
        if val_psnr > best_psnr:
            best_psnr = val_psnr
            ckpt.save_pipeline(os.path.join(output_dir, "best"), {"vae": vae}, model_config,
                               extra_meta={"val_psnr": best_psnr, "epoch": epoch + 1,
                                           "latent_std": latent_std}, states=masters)
            logger.info("new best (psnr %.3f) -> %s/best", best_psnr, output_dir)
        if mesh is not None:
            dist.barrier()

    if _is_main():
        ckpt.save_pipeline(os.path.join(output_dir, "final"), {"vae": vae}, model_config,
                           states=masters)
    if mesh is not None:
        dist.barrier()
    logger.info("VAE pretrain done in %.1fs; best val psnr %.3f", time.time() - t_start,
                best_psnr)
    return val_metrics
