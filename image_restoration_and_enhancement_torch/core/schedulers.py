"""Diffusion noise schedulers: host-side step plans and tensor step functions.

Counterpart of the JAX package's ``core/schedulers.py``, with the same split:

1. a host-side static step plan (``ddim_step_plan`` / ``plms_step_plan``):
   numpy arrays of per-call timesteps, previous timesteps and PLMS order codes,
   with diffusers' "leading" spacing, ``steps_offset`` and the img2img strength
   truncation baked in; the plan functions are copied unchanged;
2. step functions on tensors (DDIM, PLMS, the ancestral DDPM step, and
   ``pred_x0_from_eps`` for the training loss). The loop is unrolled in
   Python, so the PLMS history is a small Python-side carry (``PlmsCarry``)
   and the order code picks its combination with an ordinary branch. A
   Python int timestep selects its table row on the device, so a step copies
   nothing from the host and can be captured in a CUDA graph
   (``core/graphs.py``).

All step math is fp32, as in the JAX functions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig

# ---------------------------------------------------------------------------
# Schedule tables (host, float64)
# ---------------------------------------------------------------------------


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    """Beta schedule table, float64 on host for precision."""
    if cfg.beta_schedule == "scaled_linear":
        return (
            np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
        )
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f"Unknown beta schedule: {cfg.beta_schedule}")


def make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """Cumulative product of alphas, the only table samplers need."""
    return np.cumprod(1.0 - make_betas(cfg), axis=0)


def final_alpha_cumprod(cfg: SchedulerConfig) -> float:
    """alpha_bar used for the step to "before time 0"."""
    ac = make_alphas_cumprod(cfg)
    return 1.0 if cfg.set_alpha_to_one else float(ac[0])


def alphas_cumprod_tensor(cfg: SchedulerConfig, device=None) -> torch.Tensor:
    """The alpha_bar table as the fp32 tensor the step functions index."""
    return torch.as_tensor(make_alphas_cumprod(cfg), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Forward process
# ---------------------------------------------------------------------------


def _index(table: torch.Tensor, t) -> torch.Tensor:
    """table[t]: a select for a Python or numpy int (no host-to-device copy),
    a gather for an integer tensor or array."""
    if isinstance(t, (int, np.integer)):
        return table[int(t)]
    return table[torch.as_tensor(t, device=table.device).long()]


def _at(table: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """table[t] (t an int or integer tensor), broadcast over like's trailing dims."""
    a = _index(table, t).float()
    while a.dim() < like.dim():
        a = a[..., None]
    return a


def add_noise(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
              timesteps) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(a_bar_t) x_0 + sqrt(1 - a_bar_t) eps, math in fp32."""
    ac = _at(alphas_cumprod, timesteps, sample)
    out = torch.sqrt(ac) * sample.float() + torch.sqrt(1.0 - ac) * noise.float()
    return out.to(sample.dtype)


def pred_x0_from_eps(alphas_cumprod: torch.Tensor, sample: torch.Tensor, eps: torch.Tensor,
                     timesteps) -> torch.Tensor:
    """The x_0 estimate of an epsilon prediction (the L1 image loss's),
    (x_t - sqrt(1 - a_bar_t) eps) / sqrt(a_bar_t), math in fp32."""
    ac = _at(alphas_cumprod, timesteps, sample)
    x0 = (sample.float() - torch.sqrt(1.0 - ac) * eps.float()) / torch.sqrt(ac)
    return x0.to(sample.dtype)


# ---------------------------------------------------------------------------
# Step plans (host-side, static) — unchanged from the JAX package
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Static per-call schedule for one sampling run.

    timesteps: int32 [S] effective timestep fed to the model at call i (for
      PLMS call 1 this includes diffusers' t <- t + ratio swap);
    prev_timesteps: int32 [S]; order_codes: int32 [S] PLMS combine rule per
      call (0 raw eps, 1 average with history and restore cur_sample, 2/3/4
      multistep order; all zeros for DDIM); append: bool [S] whether call i
      pushes eps into the history; init_timestep: the timestep that noises the
      img2img init latents; num_inference_steps: the pre-truncation count.
    """

    timesteps: np.ndarray
    prev_timesteps: np.ndarray
    order_codes: np.ndarray
    append: np.ndarray
    init_timestep: int
    num_inference_steps: int

    @property
    def num_calls(self) -> int:
        return int(self.timesteps.shape[0])


def _leading_timesteps_ascending(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """diffusers "leading" spacing: i * (T // S), rounded, + steps_offset."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    return (np.arange(num_inference_steps) * ratio).round().astype(np.int64) + cfg.steps_offset


def _strength_start(num_inference_steps: int, strength: float) -> int:
    """diffusers img2img get_timesteps truncation point (scheduler order 1)."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    return max(num_inference_steps - init_timestep, 0)


def ddim_step_plan(cfg: SchedulerConfig, num_inference_steps: int,
                   strength: float = 1.0) -> StepPlan:
    """DDIM plan with img2img strength truncation."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    full = _leading_timesteps_ascending(cfg, num_inference_steps)[::-1]
    trunc = full[_strength_start(num_inference_steps, strength):].copy()
    if trunc.size == 0:  # strength == 0: nothing to do; keep 1 no-op-ish step
        trunc = full[-1:].copy()
    prev = trunc - ratio
    zeros = np.zeros_like(trunc)
    return StepPlan(
        timesteps=trunc.astype(np.int32),
        prev_timesteps=prev.astype(np.int32),
        order_codes=zeros.astype(np.int32),
        append=np.ones_like(trunc, dtype=bool),
        init_timestep=int(trunc[0]),
        num_inference_steps=num_inference_steps,
    )


def plms_step_plan(cfg: SchedulerConfig, num_inference_steps: int,
                   strength: float = 1.0) -> StepPlan:
    """PLMS (PNDM skip_prk_steps=True) plan with strength truncation: diffusers'
    descending timestep list with the second entry duplicated, and its
    counter-1 call that swaps (t, prev_t) and skips the history append."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    asc = _leading_timesteps_ascending(cfg, num_inference_steps)
    full = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])[::-1]
    trunc = full[_strength_start(num_inference_steps, strength):].copy()
    if trunc.size == 0:
        trunc = full[-1:].copy()

    ts, prevs, codes, append = [], [], [], []
    ets_len = 0
    for counter, t in enumerate(int(x) for x in trunc):
        prev_t = t - ratio
        if counter == 1:
            prev_t, t = t, t + ratio
            append.append(False)
            codes.append(1)
        else:
            ets_len = min(ets_len + 1, 4)
            append.append(True)
            codes.append(0 if counter == 0 else min(ets_len, 4))
        ts.append(t)
        prevs.append(prev_t)
    return StepPlan(
        timesteps=np.asarray(ts, dtype=np.int32),
        prev_timesteps=np.asarray(prevs, dtype=np.int32),
        order_codes=np.asarray(codes, dtype=np.int32),
        append=np.asarray(append, dtype=bool),
        init_timestep=int(trunc[0]),
        num_inference_steps=num_inference_steps,
    )


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def _alpha_prev(alphas_cumprod: torch.Tensor, final_alpha: float, prev_t: int,
                like: torch.Tensor) -> torch.Tensor:
    if int(prev_t) >= 0:
        return _at(alphas_cumprod, int(prev_t), like)
    return torch.full((), final_alpha, dtype=torch.float32, device=like.device)


def ddim_step(alphas_cumprod: torch.Tensor, final_alpha: float, sample: torch.Tensor,
              eps: torch.Tensor, t: int, prev_t: int) -> torch.Tensor:
    """Deterministic DDIM update (eta = 0, epsilon prediction)."""
    sample, eps = sample.float(), eps.float()
    a_t = _at(alphas_cumprod, int(t), sample)
    a_prev = _alpha_prev(alphas_cumprod, final_alpha, prev_t, sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddpm_step(alphas_cumprod: torch.Tensor, sample: torch.Tensor, eps: torch.Tensor,
              t, noise: torch.Tensor) -> torch.Tensor:
    """Ancestral DDPM update with the fixed-small posterior variance, fp32.
    ``t``: an int or an integer tensor ([B] or scalar); ``noise`` is the
    standard-normal draw, added where t > 0."""
    sample, eps = sample.float(), eps.float()
    expand = lambda v: v.reshape(v.shape + (1,) * (sample.dim() - v.dim()))  # noqa: E731
    if isinstance(t, (int, np.integer)):
        t = int(t)
        live = expand(torch.full((), t > 0, device=alphas_cumprod.device))
        prev = max(t - 1, 0)
    else:
        t = torch.as_tensor(t, device=alphas_cumprod.device).long()
        live = expand(t > 0)
        prev = (t - 1).clamp(min=0)
    a_t = expand(_index(alphas_cumprod, t)).float()
    a_prev = torch.where(live, expand(_index(alphas_cumprod, prev)).float(), 1.0)
    alpha_t = a_t / a_prev
    beta_t = 1.0 - alpha_t
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    mean = (torch.sqrt(a_prev) * beta_t / (1.0 - a_t) * x0
            + torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t) * sample)
    var = torch.clamp(beta_t * (1.0 - a_prev) / (1.0 - a_t), min=1e-20)
    return mean + torch.where(live, torch.sqrt(var) * noise.float(), 0.0)


class PlmsCarry(NamedTuple):
    """PLMS state: ets [4, ...] eps history (most recent first) and the
    sample banked at call 0 and restored at call 1."""

    ets: torch.Tensor
    cur_sample: torch.Tensor


def plms_init_carry(latents: torch.Tensor) -> PlmsCarry:
    z = torch.zeros_like(latents, dtype=torch.float32)
    return PlmsCarry(ets=torch.stack([z, z, z, z]), cur_sample=z)


def _plms_prev_sample(alphas_cumprod, final_alpha, sample, eps_eff, t, prev_t):
    """diffusers PNDMScheduler._get_prev_sample, epsilon prediction."""
    a_t = _at(alphas_cumprod, int(t), sample)
    a_prev = _alpha_prev(alphas_cumprod, final_alpha, prev_t, sample)
    b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
    sample_coeff = torch.sqrt(a_prev / a_t)
    denom = a_t * torch.sqrt(b_prev) + torch.sqrt(a_t * b_t * a_prev)
    return sample_coeff * sample - (a_prev - a_t) * eps_eff / denom


def plms_step(alphas_cumprod: torch.Tensor, final_alpha: float, carry: PlmsCarry,
              sample: torch.Tensor, eps: torch.Tensor, t: int, prev_t: int,
              order_code: int, append: bool) -> Tuple[PlmsCarry, torch.Tensor]:
    """One PLMS call. Returns (new_carry, prev_sample)."""
    sample, eps = sample.float(), eps.float()
    ets, cur_sample = carry.ets, carry.cur_sample
    if append:
        ets = torch.cat([eps[None], ets[:-1]], dim=0)
    code = min(max(int(order_code), 0), 4)
    if code == 0:
        eps_eff = eps
    elif code == 1:
        eps_eff = (eps + ets[0]) / 2.0
    elif code == 2:
        eps_eff = (3.0 * ets[0] - ets[1]) / 2.0
    elif code == 3:
        eps_eff = (23.0 * ets[0] - 16.0 * ets[1] + 5.0 * ets[2]) / 12.0
    else:
        eps_eff = (55.0 * ets[0] - 59.0 * ets[1] + 37.0 * ets[2] - 9.0 * ets[3]) / 24.0
    new_cur = sample if code == 0 else cur_sample
    use_sample = cur_sample if code == 1 else sample
    prev_sample = _plms_prev_sample(alphas_cumprod, final_alpha, use_sample, eps_eff, t,
                                    prev_t)
    return PlmsCarry(ets=ets, cur_sample=new_cur), prev_sample
