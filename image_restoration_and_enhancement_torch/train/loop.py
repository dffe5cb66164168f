"""The fine-tune step shared by the four restoration tasks (the port's
counterpart of the JAX package's ``train/loop.py``).

Recipe, as in the JAX step:

- the VAE and the text encoders are frozen; the UNet alone trains;
- epsilon-MSE on the soft-conditioning blend of the degraded input's latents
  and the noised clean latents (the inpaint UNet takes the 9 channels
  [latents, mask, masked-image latents]; an SDXL stack adds its ``text_time``
  conditioning);
- with ``lambda_img`` > 0, lambda * L1 between the decoded x_0 estimate and
  the clean image in [0, 1], through a differentiated VAE decode
  (``stop_image_grad`` detaches x_0, the reference trainer's no-grad L1);
- AdamW (or Adafactor) after global-norm clipping, warmup + cosine learning
  rate, gradient accumulation and a NaN/Inf guard (``train/optim.py``).

The JAX step draws its timesteps and noises inside from ``split(key, 4)``.
Here they are arguments (``draw_step``): the trainer draws them from a
``torch.Generator`` seeded from (seed, step), and the parity tests feed JAX's
draws.

Under a mesh (``make_train_step(..., mesh=)``, JAX's ``in_shardings`` of the
batch over ``data``) every rank is handed the global batch and the global
draws, the same on every rank, and takes its rows: a sharded run draws what
one device draws. The loss is the mean over the rank's rows; the gradients
are averaged over the data axis in flat buckets
(``parallel/collectives.all_reduce_mean``), so each data rank holds the
gradient of the global mean, and the metrics are averaged likewise. Under a
model axis the module is already ``shard_module``'d: the gradients of its
sliced parameters stay this rank's, and the optimizer takes its decisions
over the model group (``Optimizer.shard``).

Precision: flax keeps fp32 parameters and computes in the module's dtype. The
port keeps fp32 master parameters (``TrainState.params``) beside the compute
module: before each forward the masters are copied into it (nothing to copy
when it is fp32: the masters are then its own parameters), its gradients are
cast to fp32 for the optimizer. The compute module is never run under
autocast: the port's layers pick their kernels by dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..core import schedulers as sched
from ..core.sampling import (SDModules, encode_image, latent_shape, mask_to_latents,
                             sdxl_time_ids)
from ..tasks.registry import TaskSpec, soft_conditioning_blend
from ..parallel import collectives
from ..parallel.mesh import Mesh, shard_batch
from .optim import Optimizer, Params, State, warmup_cosine_decay


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs; the JAX package's fields and defaults (the reference
    CLIs', train_denoising.py:930-965)."""

    num_epochs: int = 10
    batch_size: int = 1  # per-step batch
    learning_rate: float = 5e-6
    gradient_accumulation_steps: int = 8
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 1.0
    warmup_frac: float = 0.05
    lambda_img: float = 0.05
    image_size: int = 256
    seed: int = 42
    save_steps: int = 500
    stop_image_grad: bool = False  # True = the reference's no-grad L1
    optimizer: str = "adamw"  # or "adafactor" (factored second moments)
    # "apply_if_finite": skip a non-finite micro-step; "zero_grads": zero its
    # NaN entries (not its Inf ones) and step
    nan_guard: str = "apply_if_finite"
    # train-state (exact resume) cadence in epochs: -1 never, 0 the final
    # epoch only, N every N epochs and the final one
    state_save_epochs: int = 5


def make_optimizer(cfg: TrainConfig, num_train_steps: int) -> Optimizer:
    """The JAX trainer's optax chain (``train/optim.py``): warmup over
    ``warmup_frac`` of the optimizer steps, cosine decay to 0 at the end."""
    schedule = warmup_cosine_decay(cfg.learning_rate,
                                   max(1, int(num_train_steps * cfg.warmup_frac)),
                                   max(2, num_train_steps))
    return Optimizer(cfg.optimizer, schedule, b1=cfg.adam_b1, b2=cfg.adam_b2,
                     weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
                     every_k=cfg.gradient_accumulation_steps, nan_guard=cfg.nan_guard)


@dataclasses.dataclass
class TrainState:
    """flax's TrainState for one module: the step counter (one per call,
    skipped or not), fp32 master parameters by name, the optimizer and its
    state."""

    step: int
    params: Params
    tx: Optimizer
    opt_state: State

    @classmethod
    def create(cls, module: torch.nn.Module, tx: Optimizer) -> "TrainState":
        params = master_params(module)
        return cls(0, params, tx, tx.init(params))


def master_params(module: torch.nn.Module) -> Params:
    """fp32 masters of ``module``'s parameters: the parameters themselves where
    they are fp32, fp32 copies otherwise."""
    return {n: p.detach() if p.dtype == torch.float32 else p.detach().float().clone()
            for n, p in module.named_parameters()}


@torch.no_grad()
def load_masters(module: torch.nn.Module, params: Params) -> None:
    """Copy the masters into the compute module (a no-op for fp32 ones)."""
    for n, p in module.named_parameters():
        if p.data_ptr() != params[n].data_ptr():
            p.copy_(params[n])


def create_train_state(cfg: TrainConfig, unet: torch.nn.Module,
                       num_train_steps: int) -> TrainState:
    return TrainState.create(unet, make_optimizer(cfg, num_train_steps))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    return gen.manual_seed((int(seed) << 32 | int(step)) & (2**63 - 1))


def draw_step(modules: SDModules, image_shape, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
    """One step's draws for a batch of ``image_shape`` [B, H, W, 3] images:
    timesteps t [B] in [0, T), and the add_noise, input-posterior and
    gt-posterior noises (fp32, latent-shaped), in that order."""
    dev = generator.device
    shape = latent_shape(modules, image_shape)
    t = torch.randint(0, modules.config.scheduler.num_train_timesteps, (shape[0],),
                      generator=generator, device=dev)
    noise, enc1, enc2 = (torch.randn(shape, generator=generator, device=dev)
                         for _ in range(3))
    return {"t": t, "noise": noise, "enc1": enc1, "enc2": enc2}


def make_loss_fn(modules: SDModules, task: TaskSpec, cfg: TrainConfig) -> Callable:
    """Build loss(batch, context, draws) -> (loss, metrics) on the modules'
    current UNet parameters.

    batch: {"input": [B, H, W, 3] in [-1, 1], "gt": [B, H, W, 3], "mask":
    [B, H, W, 1] in {0, 1} for the inpaint task}; context: ``encode_text``'s
    [1 or B, 77, D], or an SDXL stack's (context, pooled) pair; draws:
    ``draw_step``'s dict. metrics: {"mse", "loss"[, "img_l1"]}, 0-d tensors.
    """
    sch = modules.config.scheduler
    sf = modules.config.vae.scaling_factor

    def loss_fn(batch, context, draws):
        dev = modules.device
        inp = torch.as_tensor(batch["input"]).to(dev, torch.float32)
        gt = torch.as_tensor(batch["gt"]).to(dev, torch.float32)
        b = gt.shape[0]
        ac = sched.alphas_cumprod_tensor(sch, dev)
        t = torch.as_tensor(draws["t"]).to(dev)
        noise = torch.as_tensor(draws["noise"]).to(dev, torch.float32)
        with torch.no_grad():  # the frozen VAE's sampled posteriors
            input_latents = encode_image(modules, inp, torch.as_tensor(draws["enc1"]).to(dev))
            gt_latents = encode_image(modules, gt, torch.as_tensor(draws["enc2"]).to(dev))
        noisy_gt = sched.add_noise(ac, gt_latents, noise, t)
        model_input = soft_conditioning_blend(input_latents, noisy_gt, t,
                                              sch.num_train_timesteps)
        if task.uses_mask:
            # diffusers' 9-channel order: the training input is the masked
            # image, so its latents fill the masked-image slot
            mask = torch.as_tensor(batch["mask"]).to(dev, torch.float32)
            mask_lat = mask_to_latents(mask, tuple(model_input.shape[1:3]))
            model_input = torch.cat([model_input, mask_lat, input_latents], dim=-1)
        added = None
        if isinstance(context, tuple):  # SDXL: (context, pooled) + time ids
            context, pooled = context
            added = {"text_embeds": pooled.to(dev).expand((b,) + pooled.shape[1:]),
                     "time_ids": sdxl_time_ids(b, gt.shape[1], dev)}
        ctx = context.to(dev).expand((b,) + context.shape[1:])
        eps_pred = modules.unet(model_input, t, ctx, added)

        mse = torch.mean((eps_pred - noise) ** 2)
        metrics = {"mse": mse}
        loss = mse
        if cfg.lambda_img > 0.0:
            pred_x0 = sched.pred_x0_from_eps(ac, noisy_gt, eps_pred, t)
            if cfg.stop_image_grad:
                pred_x0 = pred_x0.detach()
            pred_img = modules.vae.decode(pred_x0 / sf)
            # in [0, 1], as the reference (train_denoising.py:692-697)
            img_l1 = torch.mean(torch.abs((pred_img + 1.0) / 2.0 - (gt + 1.0) / 2.0))
            loss = loss + cfg.lambda_img * img_l1
            metrics["img_l1"] = img_l1
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(modules: SDModules, task: TaskSpec, cfg: TrainConfig,
                    mesh: Optional[Mesh] = None, data_axis: str = "data") -> Callable:
    """Build step(state, batch, context, draws) -> metrics. It copies the
    masters into the UNet, takes the loss and its gradients, hands the fp32
    gradients to the optimizer (which steps the masters in place) and
    advances ``state.step``. metrics: the loss's and "grad_norm" (the global
    norm of this call's gradients), detached 0-d tensors. With ``mesh``,
    ``batch`` and ``draws`` are the global ones and the step runs on this
    rank's rows of ``data_axis`` (see the module docstring)."""
    loss_fn = make_loss_fn(modules, task, cfg)
    step = make_module_step(modules.unet, loss_fn, mesh, data_axis)
    if mesh is None:
        return step

    def sharded_step(state: TrainState, batch, context, draws) -> Dict[str, torch.Tensor]:
        return step(state, shard_rows(batch, mesh, data_axis), context,
                    shard_rows(draws, mesh, data_axis))

    return sharded_step


def shard_rows(tree: Dict[str, Any], mesh: Mesh, axis: str = "data") -> Dict[str, Any]:
    """This rank's rows along ``axis`` of every [B, ...] array of a dict, as
    tensors on the rank's device."""
    return {k: shard_batch(torch.as_tensor(v), mesh, axis) for k, v in tree.items()}


def make_module_step(module: torch.nn.Module, loss_fn: Callable,
                     mesh: Optional[Mesh] = None, data_axis: str = "data") -> Callable:
    """The step of ``make_train_step`` for any module and loss_fn(*args) ->
    (loss, metrics) (the VAE pretrain's too). With ``mesh``, ``args`` are
    this rank's rows and the gradients and metrics are averaged over
    ``data_axis``."""
    group = mesh.group(data_axis) if mesh is not None and mesh.size(data_axis) > 1 else None

    def step(state: TrainState, *args) -> Dict[str, torch.Tensor]:
        load_masters(module, state.params)
        module.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(*args)
        loss.backward()
        grads = {n: p.grad.float() for n, p in module.named_parameters()}
        module.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            collectives.all_reduce_mean(list(grads.values()), group)
            names = sorted(metrics)
            total = collectives.all_reduce(torch.stack([metrics[k].float() for k in names]),
                                           group)
            metrics = dict(zip(names, (total / mesh.size(data_axis)).unbind()))
        metrics["grad_norm"] = state.tx.global_norm(grads)
        state.tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return metrics

    return step

