"""What a rank of a multi-device training run executes: the counterpart of
``parallel/serve.py`` for training, and of the JAX package's
``__graft_entry__.dryrun_multichip`` and its mesh tests. ``launch.launch``
starts these functions on every rank (the tests' gloo ranks, the card
check's and the trainer's NCCL ranks); they live in the port, so a spawned
rank imports only the port.

- ``run_train_task(kwargs)`` / ``run_pretrain_vae(kwargs)``: the trainers
  under a ``data`` mesh of every rank (``train/trainer.py`` starts them).
  Each returns {"metrics"} (rank 0's validation metrics) with "losses" (the
  global loss of every micro-step), "seconds" (each micro-step's wall time),
  "fingerprint" (of this rank's masters after the last step), "peak_bytes",
  "collectives" and the kernel launches ("launch_shapes", "launch_paths").
- ``run_steps(case)`` (``run_cases(cases)``: each in turn): train steps
  over any (data, model) mesh: the DP x TP
  step of ``dryrun_multichip`` (AdamW), the sharded save and the restore
  across a mesh reshape. A case is a dict:

    mesh       (shape, axis names); the axes are named "data" and "model"
    config, dtype, weights, backend   the stack, as ``serve.py`` takes it
    task       a task name ("denoise"); ``train`` the TrainConfig fields
    optimizer  "adamw" (optax.adamw(lr), as ``dryrun_multichip``) or
               "config" (the trainer's chain from ``train``, ``num_steps``)
    lr         the AdamW learning rate
    context    the text context [1, 77, D] (numpy)
    steps      a list of {"batch": {"input", "gt"}, "draws": {"t", "noise",
               "enc1", "enc2"}}, global arrays: one micro-step each
    restore    a directory whose ``state.pt`` the state is restored from
    save       a directory the state is saved to after the steps
    reference  True: rank 0 first runs the same steps on its device alone,
               unsharded, and returns the sharded run's errors against it
               ("errors"); the weights are put back before the sharded run
    full       True: rank 0 returns the gathered gradients of the first
               step ("grads") and masters after the last ("params"), numpy

  The steps run with TF32 off for matmuls and cuDNN: fp32 is held to fp32
  (a spawned rank starts at torch's defaults, cuDNN's TF32 on, not at its
  parent's). Every rank returns "metrics" (floats, each micro-step), "seconds",
  "fingerprint", "peak_bytes", "collectives", "launch_shapes" and
  "launch_paths".

The fingerprint of a set of fp32 tensors is an int64 sum of their bit
patterns, weighted by position: equal on two ranks exactly when their masters
are (up to a collision no run has a reason to hit), and cheap on the card.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..ops import _build
from . import collectives
from .mesh import make_mesh


def fingerprint(tensors: Dict[str, torch.Tensor]) -> int:
    """An int64 digest of fp32 tensors' bits (see the module docstring)."""
    total = 0
    for name in sorted(tensors):
        bits = tensors[name].detach().contiguous().view(-1).view(torch.int32).long()
        weights = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        total = (total * 1_000_003 + int((bits * (weights % 65_521 + 1)).sum())) % (1 << 62)
    return total


class _Observed:
    """Micro-step losses, wall times and the last train state of a trainer
    run (its ``on_step``)."""

    def __init__(self):
        self.losses: List[float] = []
        self.seconds: List[float] = []
        self.state = None
        self._t = time.perf_counter()

    def __call__(self, step, metrics, state) -> None:
        self.losses.append(float(metrics["loss"]))
        now = time.perf_counter()
        self.seconds.append(now - self._t)
        self._t = now
        self.state = state


def _measured(run, device) -> Dict[str, Any]:
    """Run ``run()`` with the collective and launch counters and the peak
    memory reset first; what they read after."""
    before = collections.Counter(collectives.counts)
    _build.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = run()
    made = collections.Counter(collectives.counts)
    made.subtract(before)
    return {**out,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "collectives": {k: v for k, v in made.items() if v},
            "launch_shapes": dict(_build.launch_shapes),
            "launch_paths": dict(_build.launch_paths)}


def _rank_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def run_train_task(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``train_task(**kwargs)`` on this rank (see the module docstring)."""
    from ..train.trainer import train_task

    seen = _Observed()

    def run():
        metrics = train_task(**kwargs, on_step=seen)
        return {"metrics": metrics, "losses": seen.losses, "seconds": seen.seconds,
                "fingerprint": fingerprint(seen.state.params) if seen.state else None}
    return _measured(run, _rank_device())


def run_pretrain_vae(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``pretrain_vae(**kwargs)`` on this rank: {"metrics"}."""
    from ..train.vae_pretrain import pretrain_vae

    return {"metrics": pretrain_vae(**kwargs)}


class _KeepGrads:
    """An optimizer that remembers the gradients of every update it is
    handed (the step's, after the data axis's mean) before stepping."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def global_norm(self, grads):
        return self.tx.global_norm(grads)

    def update(self, grads, state, params):
        self.grads.append(grads)
        return self.tx.update(grads, state, params)


def _optimizer(case, cfg):
    from ..train.loop import make_optimizer
    from ..train.optim import Optimizer

    if case["optimizer"] == "adamw":  # optax.adamw(lr): weight decay 1e-4, no clip
        lr = float(case["lr"])
        return Optimizer("adamw", lambda count: lr, weight_decay=1e-4,
                         max_grad_norm=float("inf"))
    return make_optimizer(cfg, int(case["num_steps"]))


def _steps(modules, task, cfg, case, mesh, sharding):
    """Run the case's steps (restored first, saved after) on ``modules``;
    (metrics of each step, seconds of each, the state, the gradients of
    each step)."""
    from ..train.loop import TrainState, make_train_step
    from ..train.trainer import restore_train_state, save_train_state

    tx = _KeepGrads(_optimizer(case, cfg))
    tx.tx.shard(sharding)
    state = TrainState.create(modules.unet, tx)
    if case.get("restore") and not restore_train_state(case["restore"], state, sharding):
        raise FileNotFoundError(f"no train state under {case['restore']}")
    step = make_train_step(modules, task, cfg, mesh)
    ctx = torch.as_tensor(np.asarray(case["context"])).to(modules.device)
    metrics, seconds = [], []
    dev = modules.device
    for s in case["steps"]:
        draws = {k: torch.as_tensor(np.asarray(v)) for k, v in s["draws"].items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = step(state, s["batch"], ctx, draws)
        metrics.append({k: float(v) for k, v in m.items()})
        seconds.append(time.perf_counter() - t0)
    if case.get("save"):
        save_train_state(case["save"], state, sharding)
    return metrics, seconds, state, tx.grads


def _rel_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The largest |got - want| of each tensor over its largest |want|: the
    worst tensor's, and the largest absolute difference."""
    worst, worst_abs, name = 0.0, 0.0, None
    for n, w in want.items():
        d = float((got[n].float() - w.float()).abs().max())
        rel = d / max(float(w.float().abs().max()), 1e-30)
        if rel > worst:
            worst, name = rel, n
        worst_abs = max(worst_abs, d)
    return {"max_rel_err": worst, "max_abs_err": worst_abs, "worst": name}


def run_steps(case: Dict[str, Any]) -> Dict[str, Any]:
    """Train steps over the case's mesh on this rank (see the module docstring)."""
    from ..tasks.registry import get_task
    from ..train.loop import TrainConfig
    from .serve import load_stack
    from .sharding_rules import TrainSharding, shard_module

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*case["mesh"])
    modules = load_stack(case, mesh.device)
    modules.freeze_all_but_unet()
    cfg = TrainConfig(**case.get("train", {}))
    task = get_task(case.get("task", "denoise"))
    reference = None
    if case.get("reference") and dist.get_rank() == 0:
        start = {n: p.detach().clone() for n, p in modules.unet.named_parameters()}
        _, ref_s, ref_state, ref_grads = _steps(modules, task, cfg,
                                                dict(case, save=None), None, None)
        reference = {"grads": ref_grads[0], "seconds": ref_s,
                     "params": {n: p.clone() for n, p in ref_state.params.items()}}
        del ref_state
        with torch.no_grad():
            for n, p in modules.unet.named_parameters():
                p.copy_(start[n])
        del start
    if case.get("reference"):
        dist.barrier()
    model_axis = "model" if "model" in mesh.axis_names else None
    sharding = TrainSharding.of(modules.unet, mesh, model_axis) if model_axis else None
    if model_axis:
        shard_module(modules.unet, mesh, model_axis)

    def run():
        metrics, seconds, state, grads = _steps(modules, task, cfg, case, mesh, sharding)
        out = {"metrics": metrics, "seconds": seconds, "fingerprint": fingerprint(state.params)}
        if case.get("full") or reference is not None or case.get("reference"):
            gather = (lambda d: d) if sharding is None else (
                lambda d: {n: sharding.gather(n, t) for n, t in d.items()})
            full_grads, full_params = gather(grads[0]), gather(state.params)
            if reference is not None:
                out["errors"] = {"grads": _rel_errors(full_grads, reference["grads"]),
                                 "params": _rel_errors(full_params, reference["params"]),
                                 "reference_seconds": reference["seconds"]}
            if case.get("full") and dist.get_rank() == 0:
                out["grads"] = {n: t.cpu().numpy() for n, t in full_grads.items()}
                out["params"] = {n: t.cpu().numpy() for n, t in full_params.items()}
        return out
    return _measured(run, mesh.device)


def run_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``run_steps`` of each case in turn (every rank, the same cases)."""
    return [run_steps(case) for case in cases]
