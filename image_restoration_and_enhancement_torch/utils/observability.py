"""Tracing/profiling + runtime guards (the port's copy of the JAX package's
``utils/observability.py``).

- ``trace(logdir)``: context manager around a ``torch.profiler`` capture of
  the host and, where there is one, the CUDA device, written to ``logdir`` as
  a trace TensorBoard's profiler plugin reads (``*.pt.trace.json``).
- ``annotate(name)``: a named region (``torch.profiler.record_function``)
  that shows up in the trace.
- ``StepTimer``: step-time and throughput (images/sec) EMA counters.
- ``debug_nans(enable)``: while on, the first operator whose output holds a
  NaN raises ``FloatingPointError`` (as ``jax_debug_nans`` does), through a
  ``TorchDispatchMode`` that checks every operator's floating outputs (one
  device sync per operator: a fault-hunting tool, not for serving).
- ``device_memory_stats()``: per-device memory snapshot
  (``torch.cuda.memory_stats``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed block into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Exponential-moving-average step timer with throughput reporting."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last: Optional[float] = None
        self.step_time: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now
        self.steps += 1
        return self.step_time

    def throughput(self, items_per_step: int) -> Optional[float]:
        if not self.step_time:
            return None
        return items_per_step / self.step_time


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator with a NaN output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_NAN_CHECK: Optional[_NanCheck] = None


def debug_nans(enable: bool = True) -> None:
    """Turn the NaN check on or off for every operator that runs afterwards."""
    global _NAN_CHECK
    if enable and _NAN_CHECK is None:
        _NAN_CHECK = _NanCheck()
        _NAN_CHECK.__enter__()
    elif not enable and _NAN_CHECK is not None:
        _NAN_CHECK.__exit__(None, None, None)
        _NAN_CHECK = None


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{device: memory statistics}: ``torch.cuda.memory_stats`` of each CUDA
    device; the host alone reports ``{"cpu": {}}``."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
