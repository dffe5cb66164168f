"""The trainer's optimizer: optax's semantics as plain torch code over a dict of
fp32 tensors.

The JAX trainer builds (``train/loop.py``'s ``make_optimizer``)::

    apply_if_finite(MultiSteps(chain([zero_nans,] clip_by_global_norm, adamw | adafactor), k))

with a ``warmup_cosine_decay_schedule`` learning rate. torch has no optax, so
each transform is written out here with optax's arithmetic, in optax's order
of operations:

- ``warmup_cosine_decay``: linear from 0 to the peak over the warmup, then a
  cosine to 0; the rate is 0 at count 0, so the first update is a no-op.
- ``adamw``: eps 1e-8, eps_root 0, bias correction by 1 - b**count, weight
  decay on every tensor, then -lr.
- ``adafactor`` at optax's defaults: factored second moments for tensors whose
  second-largest dimension is >= 128 (decay 1 - (count + 1)**-0.8, eps 1e-30),
  block-RMS clipping at 1.0, lr, scaling by max(RMS(param), 1e-3), then -1.
- ``clip_by_global_norm``: every gradient times max_norm / norm unless the
  norm is below max_norm.
- ``MultiSteps(k)``: the running mean acc + (g - acc) / (n + 1) of k
  micro-step gradients; the inner transform (and so the schedule's count)
  advances once per k. optax also runs the inner transform on the other
  micro-steps and multiplies its update by 0: that is a no-op unless the
  accumulator holds an Inf, whose 0 * NaN poisons the parameters, and the
  accumulator is reset as 0 * acc. Both are kept.
- ``apply_if_finite``: a micro-step with a non-finite gradient leaves the
  inner state (MultiSteps' too) untouched and bumps ``notfinite_count``; after
  ``MAX_CONSECUTIVE_ERRORS`` in a row it applies it anyway.
- ``zero_nans`` (``nan_guard="zero_grads"``): NaN entries become 0; Inf
  entries are kept.

State is a dict of Python ints and tensor dicts keyed like the parameters, so
``torch.save`` writes it as it stands. ``update`` changes the parameters and
the state in place.

Under a mesh the gradients reach ``update`` already averaged over the data
axis (``train/loop.py``), so every data rank takes the same decisions on the
same values. Under a model axis (``shard``: a ``parallel/sharding_rules.
TrainSharding``) the parameters are this rank's slices, and the two decisions
taken on all of them, ``apply_if_finite``'s (and MultiSteps') finiteness and
the clip's global norm, are taken over the model group, so they too are the
one-device decisions on every rank. Adafactor refuses a model axis: its
factored dims and block RMS are taken on a tensor's global shape and values,
which a slice does not have.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]
ADAM_EPS = 1e-8
MAX_CONSECUTIVE_ERRORS = 10_000  # apply_if_finite's, as the JAX trainer sets it


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int
                        ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak, warmup_steps,
    decay_steps, end_value=0), evaluated in float32 as JAX does."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(-peak) * frac + f32(peak))
        steps = f32(decay_steps - warmup_steps)
        c = min(f32(count - warmup_steps), steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / steps, dtype=f32))
        return float(f32(peak) * cosine)

    return schedule


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every entry's square (optax.global_norm), fp32."""
    return torch.stack([g.float().square().sum() for g in grads.values()]).sum().sqrt()


def _factored_dims(shape):
    """optax's choice: the two largest dimensions (d1, d0) when the smaller of
    them is >= 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """``kind`` "adamw" or "adafactor" after clip_by_global_norm(max_grad_norm),
    under MultiSteps(every_k) when every_k > 1, with ``nan_guard`` None,
    "apply_if_finite" or "zero_grads"."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, weight_decay: float = 1e-4, max_grad_norm: float = 1.0,
                 every_k: int = 1, nan_guard: Optional[str] = None):
        if kind not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer {kind}")
        if nan_guard not in (None, "apply_if_finite", "zero_grads"):
            raise ValueError(f"unknown nan_guard {nan_guard}")
        self.kind, self.schedule = kind, schedule
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay
        self.max_grad_norm, self.every_k, self.nan_guard = max_grad_norm, every_k, nan_guard
        self.sharding = None

    def shard(self, sharding) -> None:
        """Step slices over a model axis (``TrainSharding``; None: whole
        tensors)."""
        if sharding is not None and sharding.tp > 1 and self.kind == "adafactor":
            raise NotImplementedError(
                "Adafactor does not run over a model axis: its factored second moments "
                "and block RMS are taken on each parameter's global shape and values, and "
                f"a model axis of {sharding.tp} hands each rank a slice (use adamw)")
        self.sharding = sharding

    def global_norm(self, grads: Params) -> torch.Tensor:
        """optax.global_norm of the (full) gradients."""
        return global_norm(grads) if self.sharding is None else self.sharding.global_norm(grads)

    def _all_finite(self, tensors: Params) -> bool:
        local = torch.stack([torch.isfinite(t).all() for t in tensors.values()]).all()
        return bool(local) if self.sharding is None else self.sharding.all_finite(local)

    # -- state -------------------------------------------------------------

    def init(self, params: Params) -> State:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        if self.kind == "adamw":
            inner = {"count": 0, "mu": zeros(), "nu": zeros()}
        else:
            inner = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
            for n, p in params.items():
                dims = _factored_dims(p.shape)
                if dims is None:
                    inner["v"][n] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    inner["v_row"][n] = p.new_zeros(np.delete(p.shape, d0).tolist())
                    inner["v_col"][n] = p.new_zeros(np.delete(p.shape, d1).tolist())
        state: State = {"inner": inner}
        if self.every_k > 1:
            state["multi"] = {"mini_step": 0, "gradient_step": 0, "acc": zeros()}
        if self.nan_guard == "apply_if_finite":
            state["guard"] = {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0}
        return state

    # -- update ------------------------------------------------------------

    @torch.no_grad()
    def update(self, grads: Params, state: State, params: Params) -> bool:
        """One call (one micro-step). Returns whether the parameters were
        stepped by the inner transform."""
        if self.nan_guard == "apply_if_finite":
            guard = state["guard"]
            finite = self._all_finite(grads)
            guard["notfinite_count"] = 0 if finite else guard["notfinite_count"] + 1
            guard["last_finite"] = finite
            guard["total_notfinite"] += 0 if finite else 1
            if not (finite or guard["notfinite_count"] > MAX_CONSECUTIVE_ERRORS):
                return False
        if self.every_k == 1:
            self._inner(grads, state["inner"], params)
            return True
        multi = state["multi"]
        n, acc = multi["mini_step"], multi["acc"]
        for name, g in grads.items():
            a = acc[name]
            a.add_((g - a) / (n + 1))
        emit = n == self.every_k - 1
        multi["mini_step"] = (n + 1) % self.every_k
        if not emit:
            # under apply_if_finite the accumulator holds only finite gradients
            if self.nan_guard != "apply_if_finite" and not self._all_finite(acc):
                # optax adds 0 * the inner update of this micro-step
                scratch = {n_: p.clone() for n_, p in params.items()}
                self._inner(acc, copy.deepcopy(state["inner"]), scratch)
                for name, p in params.items():
                    p.add_((scratch[name] - p) * 0)
            return False
        multi["gradient_step"] += 1
        self._inner(acc, state["inner"], params)
        for a in acc.values():
            a.mul_(0)
        return True

    def _inner(self, grads: Params, inner: State, params: Params) -> None:
        """chain([zero_nans,] clip_by_global_norm, adamw | adafactor), then
        params += update."""
        if self.nan_guard == "zero_grads":
            grads = {n: torch.where(torch.isnan(g), torch.zeros_like(g), g)
                     for n, g in grads.items()}
        norm = self.global_norm(grads)
        if not bool(norm < self.max_grad_norm):
            grads = {n: g / norm * self.max_grad_norm for n, g in grads.items()}
        step = self._adamw if self.kind == "adamw" else self._adafactor
        step(grads, inner, params)
        inner["count"] += 1

    def _adamw(self, grads: Params, inner: State, params: Params) -> None:
        count = inner["count"] + 1
        bc1, bc2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        lr = self.schedule(inner["count"])
        for name, g in grads.items():
            mu, nu, p = inner["mu"][name], inner["nu"][name], params[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            u = u + self.weight_decay * p
            p.add_(u * -lr)

    def _adafactor(self, grads: Params, inner: State, params: Params) -> None:
        f32 = np.float32
        decay = float(f32(1) - f32(inner["count"] + 1) ** f32(-0.8))
        lr = self.schedule(inner["count"])
        eps = 1e-30
        for name, g in grads.items():
            p = params[name]
            grad_sqr = g.square() + eps
            dims = _factored_dims(p.shape)
            if dims is None:
                v = inner["v"][name]
                v.copy_(decay * v + (1.0 - decay) * grad_sqr)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row, v_col = inner["v_row"][name], inner["v_col"][name]
                v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(dim=d0))
                v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean).pow(-0.5)
                col_factor = v_col.pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(u.square().mean().sqrt() / 1.0, min=1.0)   # block RMS clip
            u = u * lr
            rms = p.square().mean().sqrt()
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            p.add_(u * -1)
