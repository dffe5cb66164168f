"""The trainer: epochs, validation, checkpoints (the port's counterpart
of the JAX package's ``train/trainer.py``).

One generic trainer for the four tasks, with the JAX trainer's behaviour:

- per-epoch validation through the task's sampling function at its
  validation sampler settings, with PSNR/SSIM (+ the Y- or L-channel and
  delta-E extras per task), LPIPS where its weights exist, a dark-output
  warning, the degraded-input baseline on the run's first validated epoch
  and per-sigma buckets for ``_sigma``-suffixed val files;
- the best-by-val-PSNR pipeline to ``{output_dir}/best``, step checkpoints
  ``checkpoint-{step}`` (UNet only) every ``save_steps`` (0: one
  ``checkpoint-epoch-N`` per epoch; -1: none), and ``final/``; all in the JAX
  pipeline layout (``core/checkpoint.save_pipeline``), the UNet as its fp32
  masters;
- ``metrics_{task}.csv`` with the task's columns, ``training_{task}.log``
  (appended across restarts) and a val strip (input | result | gt) per epoch
  in ``val_samples/``;
- the train state for exact resume: one file ``train_state/state.pt`` (fp32
  masters, optimizer state, step), written to a temporary name and renamed,
  every ``state_save_epochs`` epochs and at the last (0: the last only; -1:
  never). JAX writes it with Orbax; the content is the same.

Several devices, by the JAX trainer's rule (``data_parallel_ranks``): with
``use_mesh``, a world of N > 1 devices and a batch that divides by N, the run
trains over a ``data`` mesh of N ranks (``train/loop.py``'s sharded step);
otherwise on one device, and the log says why. The world is ``torchrun``'s
when the process runs under it; a process started alone with N CUDA cards
(or asked for ``num_devices`` gloo ranks on the CPU) starts N ranks itself
(``parallel/launch.py``, one card each; more ranks than cards raises). Every
rank reads the same batches and takes its rows. Rank 0 alone validates
(through the unsharded sampler, while the others wait at a barrier) and writes
the log, the CSV, strips, checkpoints, ``best/``, ``final/`` and the train
state, which is the one-device file. A rank that raises ends the run.
Each step's draws come from a generator seeded from (seed, step), so a
resumed run, or a sharded one, draws what the uninterrupted one-device run
would have.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import checkpoint as ckpt
from ..core import sampling
from ..data.datasets import BatchLoader, PairDataset
from ..data.png import save_image
from ..device import DeviceLike, resolve_device
from ..metrics import functional as F
from ..metrics import perceptual
from ..models.layers import init_random_
from ..models.tokenizer import load_tokenizer
from ..tasks.registry import TaskSpec, get_task
from .loop import (TrainConfig, TrainState, create_train_state, draw_step, load_masters,
                   make_train_step, step_generator)

logger = logging.getLogger(__name__)

FROZEN_COMPONENTS = ("vae", "text_encoder", "text_encoder_2")


def _is_main() -> bool:
    """The JAX trainer writes logs, CSV, strips and pipelines from process 0
    only; the port from rank 0 of a multi-rank run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _setup_logging(output_dir: str, task: str) -> None:
    """Attach the run's log file to the root logger, replacing the handler a
    previous call installed (stacked handlers would copy every later record
    into every earlier run's log)."""
    if not _is_main():
        return
    os.makedirs(output_dir, exist_ok=True)
    root = logging.getLogger()
    for h in [h for h in root.handlers if getattr(h, "_iret_task_log", False)]:
        root.removeHandler(h)
        h.close()
    handler = logging.FileHandler(os.path.join(output_dir, f"training_{task}.log"), mode="a")
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    handler._iret_task_log = True
    root.addHandler(handler)
    if root.level > logging.INFO:
        root.setLevel(logging.INFO)


def _csv_columns(spec: TaskSpec) -> List[str]:
    cols = ["epoch", "psnr", "ssim", "lpips"]
    if spec.with_y_metrics:
        cols += ["psnr_y", "ssim_y"]
    if spec.with_color_metrics:
        cols += ["psnr_l", "ssim_l", "delta_e"]
    return cols + ["train_loss"]


def _append_csv(path: str, columns: List[str], row: Dict[str, float]) -> None:
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        if not exists:
            writer.writeheader()
        writer.writerow({c: row.get(c, "") for c in columns})


def _save_strip(path: str, inp: np.ndarray, out: np.ndarray, gt: np.ndarray) -> None:
    """input | result | gt, [-1, 1] HWC each, as a uint8 PNG (truncated, as the
    JAX trainer's PIL save)."""
    strip = np.concatenate([inp, out, gt], axis=1)
    save_image(path, ((strip + 1) * 127.5).clip(0, 255).astype(np.uint8))


def data_parallel_ranks(use_mesh: bool, batch_size: int, device: torch.device,
                        num_devices: Optional[int] = None) -> int:
    """The data-parallel ranks a run trains over, by the JAX trainer's rule
    (``use_mesh``, more than one device and ``batch_size`` divisible by their
    number; else 1, logged). The devices: the world's ranks under
    torch.distributed, else ``num_devices``, else the CUDA cards this process
    sees (1 on the CPU)."""
    if dist.is_initialized():
        n = dist.get_world_size()
    elif num_devices is not None:
        n = int(num_devices)
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return 1
    if not use_mesh:
        logger.info("training on one device of %d: the mesh is off (--no_mesh)", n)
        return 1
    if batch_size % n:
        logger.info("training on one device of %d: batch %d does not divide by %d devices",
                    n, batch_size, n)
        return 1
    logger.info("data-parallel mesh over %d devices", n)
    return n


def _world(device: torch.device) -> None:
    """Join ``torchrun``'s world (NCCL on the card, gloo on the CPU) where the
    process runs under one of more than one rank."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel.mesh import init_from_env

        init_from_env("nccl" if device.type == "cuda" else "gloo")


def spawn_ranks(fn, n: int, device: torch.device, kwargs: dict):
    """Run ``fn(kwargs)`` (a ``parallel/train.py`` function) on ``n`` new
    ranks, NCCL on the card or gloo on the CPU; rank 0's result."""
    from ..parallel import launch

    return launch.launch(fn, n, "nccl" if device.type == "cuda" else "gloo", (kwargs,))[0]


@dataclasses.dataclass
class ValidationResult:
    metrics: Dict[str, float]

    @property
    def psnr(self) -> float:
        return self.metrics.get("psnr", float("-inf"))


def run_validation(
    modules: sampling.SDModules,
    spec: TaskSpec,
    val_loader: BatchLoader,
    context: sampling.Conditioning,
    uncond_context: Optional[sampling.Conditioning],
    epoch: int,
    output_dir: str,
    max_batches: Optional[int] = None,
    seed: int = 42,
    sampler_fn_cache: Optional[dict] = None,
    log_input_baseline: Optional[bool] = None,
) -> ValidationResult:
    """Sample the task's function on the val pairs with the modules' current
    weights and average the task metrics over the images. ``max_batches``
    None validates the whole loader. A ragged last batch is padded with its
    last pair (one input shape for the sampling function) and the padding
    dropped before the metrics."""
    vs = spec.val_sampler or spec.sampler
    cache = sampler_fn_cache if sampler_fn_cache is not None else {}
    key = ("val", vs.num_inference_steps, vs.strength, vs.guidance_scale, vs.sampler)
    if key not in cache:
        maker = sampling.make_inpaint_fn if spec.uses_mask else sampling.make_img2img_fn
        cache[key] = maker(modules, num_inference_steps=vs.num_inference_steps,
                           strength=vs.strength, guidance_scale=vs.guidance_scale,
                           sampler=vs.sampler)
    fn = cache[key]
    dev = modules.device

    acc: Dict[str, List[float]] = {}
    input_psnrs: List[float] = []
    sigmas = getattr(val_loader.ds, "sigmas", [])
    sigma_buckets: Dict[int, Dict[str, List[float]]] = {}
    strip_saved = False
    sample_idx = 0
    for bi, batch in enumerate(val_loader.epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        gen = step_generator(seed, bi, dev)
        n_valid = batch["input"].shape[0]
        bs = val_loader.batch_size
        if n_valid < bs:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], bs - n_valid, axis=0)], axis=0)
                     for k, v in batch.items()}
        x = torch.from_numpy(batch["input"]).to(dev)
        if spec.uses_mask:
            out = fn(x, torch.from_numpy(batch["mask"]).to(dev), context, uncond_context,
                     generator=gen)
        else:
            out = fn(x, context, uncond_context, generator=gen)
        out01 = (out[:n_valid].float() + 1.0) / 2.0
        gt01 = (torch.from_numpy(batch["gt"][:n_valid]).to(dev) + 1.0) / 2.0
        if float(out01.mean()) < 0.02:
            logger.warning("validation produced near-black output (epoch %d)", epoch)
        if epoch <= 1 if log_input_baseline is None else log_input_baseline:
            # the do-nothing score the output PSNR is measured against
            in01 = (torch.from_numpy(batch["input"][:n_valid]).to(dev) + 1.0) / 2.0
            input_psnrs.extend(F.psnr(in01, gt01).tolist())
        batch_lpips: List[float] = []
        if perceptual.lpips_available():
            batch_lpips = perceptual.lpips_pairs(list(out01.cpu().numpy()),
                                                 list(gt01.cpu().numpy()), device=dev)
        m_batch = {k: v.tolist() for k, v in F.calculate_all(
            out01, gt01, with_color=spec.with_color_metrics,
            with_y=spec.with_y_metrics).items()}
        for i in range(n_valid):
            m = {k: v[i] for k, v in m_batch.items()}
            if i < len(batch_lpips):
                m["lpips"] = batch_lpips[i]
            for name, v in m.items():
                acc.setdefault(name, []).append(float(v))
            sigma = sigmas[sample_idx] if sample_idx < len(sigmas) else None
            if sigma is not None:
                bucket = sigma_buckets.setdefault(int(round(sigma)), {})
                for name in ("psnr", "ssim", "psnr_y", "ssim_y", "lpips"):
                    if name in m:
                        bucket.setdefault(name, []).append(float(m[name]))
            sample_idx += 1
        if not strip_saved and _is_main():
            strip_dir = os.path.join(output_dir, "val_samples")
            os.makedirs(strip_dir, exist_ok=True)
            _save_strip(os.path.join(strip_dir, f"epoch_{epoch}.png"),
                        batch["input"][0], out[0].float().cpu().numpy(), batch["gt"][0])
            strip_saved = True
    if input_psnrs:
        logger.info("val input-vs-gt baseline psnr %.3f (the do-nothing score output "
                    "psnr is measured against)", float(np.mean(input_psnrs)))
    for sv in sorted(sigma_buckets):
        b = sigma_buckets[sv]
        logger.info("  sigma=%d: %s", sv, {k: round(float(np.mean(v)), 4) for k, v in b.items()})
    return ValidationResult({k: float(np.mean(v)) for k, v in acc.items()})


# ---------------------------------------------------------------------------
# train state (exact resume)
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def save_train_state(directory: str, state: TrainState, sharding=None) -> None:
    """fp32 masters, optimizer state and step to ``directory/state.pt``,
    through a temporary name (a crash leaves the previous file whole). Under
    a model axis (``sharding``, a ``parallel/sharding_rules.TrainSharding``;
    every rank of the mesh calls it) the slices are gathered first; rank 0
    writes the full, one-device state."""
    params, opt_state = state.params, state.opt_state
    if sharding is not None:
        from ..parallel.sharding_rules import gather_train_state

        params, opt_state = gather_train_state(params, opt_state, sharding)
    if not _is_main():
        return
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    torch.save({"step": state.step, "params": params, "opt_state": opt_state},
               path + ".tmp")
    os.replace(path + ".tmp", path)


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, STATE_FILE)
    if not os.path.exists(path):
        return None
    return int(torch.load(path, map_location="cpu", weights_only=True)["step"])


def restore_train_state(directory: str, state: TrainState, sharding=None) -> bool:
    """Load ``directory/state.pt`` into ``state`` (masters copied in place, so
    fp32 masters stay the module's own parameters). The file is the full
    state, whatever mesh wrote it; under a model axis (``sharding``) this
    rank takes its slices. False when there is none."""
    path = os.path.join(directory, STATE_FILE)
    if not os.path.exists(path):
        return False
    dev = next(iter(state.params.values())).device
    saved = torch.load(path, map_location=dev, weights_only=True)
    if set(saved["params"]) != set(state.params):
        raise ValueError(f"{path} holds other parameters than the model being trained")
    params, opt_state = saved["params"], saved["opt_state"]
    if sharding is not None:
        from ..parallel.sharding_rules import shard_train_state

        params, opt_state = shard_train_state(params, opt_state, sharding)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(params[n])
    state.opt_state = opt_state
    state.step = int(saved["step"])
    return True


# ---------------------------------------------------------------------------
# train_task
# ---------------------------------------------------------------------------


def _load_components(modules: sampling.SDModules, states, names, source: str) -> List[str]:
    loaded = []
    for comp, module in modules.components().items():
        if comp in names and comp in states:
            module.load_state_dict(states[comp], strict=True)
            loaded.append(comp)
    if not loaded:
        raise FileNotFoundError(f"{source} holds none of {sorted(names)}")
    return loaded


def train_task(
    task_name: str,
    data_root: str = "data/pairs",
    output_dir: Optional[str] = None,
    cfg: TrainConfig = TrainConfig(),
    init_from: Optional[str] = None,
    vae_init: Optional[str] = None,
    max_train_samples: Optional[int] = None,
    max_val_samples: Optional[int] = None,
    use_mesh: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    resume: bool = False,
    model_config=None,
    task_spec: Optional[TaskSpec] = None,
    device: DeviceLike = None,
    num_devices: Optional[int] = None,
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor], TrainState], None]] = None,
) -> Dict[str, float]:
    """Fine-tune one task end to end on ``device`` (``cuda`` unless ``"cpu"``
    is asked for), over a data mesh where ``data_parallel_ranks`` says so
    (``num_devices``: see there). Returns the last validation metrics (rank
    0's).

    ``init_from``: a pipeline directory (the port's or the JAX package's
    layout) or a diffusers directory; without it every component starts
    random from ``cfg.seed``. ``vae_init``: a pipeline whose VAE and text
    towers seed the frozen components (e.g. ``pretrain_vae``'s ``best/``).
    ``model_config`` replaces the task's stack (TINY configs in tests);
    ``task_spec`` replaces the whole task. ``dtype`` is the compute dtype; the
    UNet's masters and the optimizer are fp32 whatever it is. ``on_step(step,
    metrics, state)`` is called after every micro-step, on every rank."""
    spec = task_spec if task_spec is not None else get_task(task_name)
    if model_config is not None:
        spec = dataclasses.replace(spec, model_config=model_config)
    output_dir = output_dir or os.path.join("outputs", "models", spec.model_dir)
    dev = resolve_device(device)
    _world(dev)
    _setup_logging(output_dir, spec.name)
    n_ranks = data_parallel_ranks(use_mesh, cfg.batch_size, dev, num_devices)
    mesh = None
    if n_ranks > 1 and not dist.is_initialized():
        from ..parallel import train as parallel_train

        return spawn_ranks(parallel_train.run_train_task, n_ranks, dev, dict(
            task_name=task_name, data_root=data_root, output_dir=output_dir, cfg=cfg,
            init_from=init_from, vae_init=vae_init, max_train_samples=max_train_samples,
            max_val_samples=max_val_samples, dtype=dtype, resume=resume,
            task_spec=spec, device=dev.type))["metrics"]
    if n_ranks > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh((n_ranks,), ("data",))
        dev = mesh.device
    logger.info("=== training %s -> %s ===", spec.name, output_dir)
    t_start = time.time()

    modules = sampling.SDModules.create(spec.model_config, dtype=dtype, device=dev)
    if init_from and (ckpt.pipeline_exists(init_from) or os.path.isdir(init_from)):
        logger.info("initializing from %s", init_from)
        _load_components(modules, ckpt.load_state_dicts(init_from), ckpt.COMPONENTS, init_from)
    else:
        logger.warning("random-initializing all components (no init_from)")
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        for module in modules.components().values():
            init_random_(module, gen)
    seeded_comps: set = set()
    if vae_init:
        # the frozen components from another pipeline; never the UNet
        seeded_comps.update(_load_components(modules, ckpt.load_state_dicts(vae_init),
                                             FROZEN_COMPONENTS, vae_init))
        logger.info("seeded frozen %s from %s", sorted(seeded_comps), vae_init)
    modules.freeze_all_but_unet()

    train_ds = PairDataset(spec.name, data_root, "train", cfg.image_size, max_train_samples)
    val_ds = PairDataset(spec.name, data_root, "val", cfg.image_size, max_val_samples)
    train_loader = BatchLoader(train_ds, cfg.batch_size, seed=cfg.seed)
    val_loader = BatchLoader(val_ds, min(cfg.batch_size, 8), shuffle=False, drop_last=False)
    logger.info("train pairs: %d, val pairs: %d", len(train_ds), len(val_ds))
    steps_per_epoch = len(train_loader)
    num_opt_steps = max(1, steps_per_epoch * cfg.num_epochs // cfg.gradient_accumulation_steps)

    state = create_train_state(cfg, modules.unet, num_opt_steps)
    step_fn = make_train_step(modules, spec, cfg, mesh=mesh)

    tokenizer = load_tokenizer(init_from, vocab_size=spec.model_config.text_encoder.vocab_size)
    encode = sampling.encode_text_sdxl if modules.is_sdxl else sampling.encode_text
    vs = spec.val_sampler or spec.sampler
    # no_grad, not inference_mode: the training forward saves the context
    # for backward, which an inference tensor cannot be
    with torch.no_grad():
        context = encode(modules, torch.as_tensor(tokenizer([spec.prompt])))
        uncond = (encode(modules, torch.as_tensor(tokenizer([""])))
                  if vs.guidance_scale > 1.0 else None)

    state_dir = os.path.join(output_dir, "train_state")
    start_epoch = 0
    if resume and restore_train_state(state_dir, state):
        # continue the epoch schedule (one step per loader batch)
        start_epoch = min(state.step // max(1, steps_per_epoch), cfg.num_epochs)
        logger.info("resumed training state at step %d (epoch %d/%d)", state.step,
                    start_epoch, cfg.num_epochs)

    csv_path = os.path.join(output_dir, f"metrics_{spec.name}.csv")
    columns = _csv_columns(spec)
    best_psnr = float("-inf")
    if resume:
        meta_path = os.path.join(output_dir, "best", "model_index.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                best_psnr = float(json.load(f).get("val_psnr", float("-inf")))
            logger.info("resumed best val psnr %.3f", best_psnr)
    global_step = state.step
    val_metrics: Dict[str, float] = {}
    sampler_cache: dict = {}
    unet_only = {"unet": modules.unet}
    masters = {"unet": state.params}
    frozen_synced = False
    for epoch in range(start_epoch, cfg.num_epochs):
        epoch_t0 = time.time()
        losses: List[float] = []
        for batch in train_loader.epoch(epoch):
            draws = draw_step(modules, batch["gt"].shape, step_generator(cfg.seed, global_step, dev))
            metrics = step_fn(state, batch, context, draws)
            losses.append(float(metrics["loss"]))
            global_step += 1
            if on_step is not None:
                on_step(global_step, metrics, state)
            if cfg.save_steps > 0 and global_step % cfg.save_steps == 0 and _is_main():
                cdir = os.path.join(output_dir, f"checkpoint-{global_step}")
                ckpt.save_pipeline(cdir, unet_only, spec.model_config, states=masters)
                logger.info("saved step checkpoint %s", cdir)
        train_loss = float(np.mean(losses)) if losses else float("nan")

        load_masters(modules.unet, state.params)  # validate the latest weights
        if _is_main():
            # rank 0 validates through the unsharded sampler (its UNet is
            # whole: the mesh is data-only) and alone decides what to write
            vres = run_validation(modules, spec, val_loader, context, uncond, epoch + 1,
                                  output_dir, seed=cfg.seed, sampler_fn_cache=sampler_cache,
                                  log_input_baseline=(epoch == start_epoch))
            val_metrics = vres.metrics
            logger.info("epoch %d/%d loss %.4f val %s (%.1fs)", epoch + 1, cfg.num_epochs,
                        train_loss, {k: round(v, 4) for k, v in val_metrics.items()},
                        time.time() - epoch_t0)
            _append_csv(csv_path, columns,
                        {"epoch": epoch + 1, "train_loss": train_loss, **val_metrics})
            if vres.psnr > best_psnr:
                best_psnr = vres.psnr
                # frozen components are written on this run's first best-save;
                # seeded ones overwrite what an earlier run left in best/
                skip = tuple(c for c in FROZEN_COMPONENTS
                             if frozen_synced or c not in seeded_comps)
                ckpt.save_pipeline(os.path.join(output_dir, "best"), modules.components(),
                                   spec.model_config,
                                   extra_meta={"val_psnr": best_psnr, "epoch": epoch + 1},
                                   skip_existing=skip, states=masters)
                frozen_synced = True
                logger.info("new best (psnr %.3f) -> %s/best", best_psnr, output_dir)
        if mesh is not None:
            dist.barrier()

        if cfg.save_steps == 0 and _is_main():
            ckpt.save_pipeline(os.path.join(output_dir, f"checkpoint-epoch-{epoch + 1}"),
                               unet_only, spec.model_config, states=masters)
        is_last = epoch + 1 == cfg.num_epochs
        if cfg.state_save_epochs >= 0 and _is_main() and (
                is_last or (cfg.state_save_epochs > 0
                            and (epoch + 1 - start_epoch) % cfg.state_save_epochs == 0)):
            save_train_state(state_dir, state)

    if _is_main():
        ckpt.save_pipeline(os.path.join(output_dir, "final"), modules.components(),
                           spec.model_config, states=masters)
    if mesh is not None:
        dist.barrier()  # the run's files are whole before any rank returns
    logger.info("training done in %.1fs; best val psnr %.3f", time.time() - t_start, best_psnr)
    return val_metrics
