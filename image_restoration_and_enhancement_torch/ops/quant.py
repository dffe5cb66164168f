"""Int8 (w8a8) serving: quantizers, the quantization state, exact s8 products.

Counterpart of the JAX package's ``ops/quant.py``.

- Weights: symmetric per-output-channel s8 (absmax / 127). The output channel
  is axis 0 of a conv's OIHW weight and of a Linear's [O, I] weight.
- Activations: symmetric per-tensor s8, with a dynamic absmax (mode
  ``"int8"``) or a calibrated static scale (mode ``"int8_static"``):
  ``x * (1 / s)`` with ``s = max(absmax * margin / 127, 1e-8)`` and ``margin``
  from ``IRET_QUANT_STATIC_MARGIN`` (default 1.0). A site missing from the
  table falls back to the dynamic scale and is recorded in ``misses``.
- Products accumulate in int32 exactly, and the result is
  ``float32(acc) * (act_scale * w_scale[o])`` cast to the activation dtype,
  to which the layer adds its bias in that dtype, as flax does.

Rounding is half-to-even (``torch.round``, like ``jnp.round``) and values are
clipped to [-127, 127]. Every division by 127 is an IEEE division on every
device (``div127``), so the card quantizes exactly as the CPU and JAX do.

The mode, the static table, its misses and the calibration sink live in a
``QuantState`` that the caller creates and hands to the model's quantized
layers (``models/layers.py``); nothing here is process-global.

Under a mesh every scale is the one-device scale of the global tensor: a
dynamic activation absmax is maxed over the groups the activation is sharded
on (``parallel/collectives.global_max``: batch and height, and the model group
around a row-parallel input), and a row-parallel weight's per-channel absmax
over the model group that holds the other parts of its input dim.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, Optional, Set, Tuple, Union

import torch

from ..parallel import collectives

MODES = (None, "int8", "int8_static")
EPS = 1e-8

Scale = Union[float, torch.Tensor]


def mode_from_env(mode: Optional[str]) -> Optional[str]:
    """``None`` defers to ``IRET_QUANT``; ``""`` means off."""
    if mode is None:
        mode = os.environ.get("IRET_QUANT", "")
    mode = mode or None
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; use one of {MODES}")
    return mode


def _static_margin() -> float:
    return float(os.environ.get("IRET_QUANT_STATIC_MARGIN", "1.0"))


@dataclasses.dataclass
class QuantState:
    """The quantization mode of one model, its static table and what it saw.

    ``table`` maps a site (the JAX flax module path of a quantized layer, e.g.
    ``down_blocks_0/resnets_0/conv1``) to its calibrated activation absmax.
    ``misses`` collects the sites that mode ``"int8_static"`` found missing.
    ``sink``, while ``collect()`` is active, maps each site to the running max
    of its dynamic activation absmax (a 0-dim fp32 tensor on the device).
    """

    mode: Optional[str] = None
    table: Dict[str, float] = dataclasses.field(default_factory=dict)
    margin: float = dataclasses.field(default_factory=_static_margin)
    misses: Set[str] = dataclasses.field(default_factory=set)
    sink: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown quantization mode {self.mode!r}; use one of {MODES}")
        self.table = {str(k): float(v) for k, v in self.table.items()}

    @property
    def active(self) -> bool:
        return self.mode is not None

    def static_scale(self, site: Optional[str]) -> Optional[float]:
        """The static scale of ``site`` in mode int8_static, else None (and a
        miss is recorded for a site the table lacks)."""
        if self.mode != "int8_static" or site is None:
            return None
        a = self.table.get(site)
        if a is None:
            self.misses.add(site)
            return None
        return max(a * self.margin / 127.0, EPS)

    @contextlib.contextmanager
    def collect(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Record {site: running max of the activation absmax} for every
        dynamically quantized call inside the block."""
        prev, self.sink = self.sink, {}
        try:
            yield self.sink
        finally:
            self.sink = prev

    def quantize_activation(self, x: torch.Tensor,
                            site: Optional[str]) -> Tuple[torch.Tensor, Scale]:
        """Per-tensor s8 of ``x``: (x_q, scale). The scale is a Python float
        for a static site and a 0-dim fp32 tensor for a dynamic one, whose
        absmax is global over the groups ``x`` is sharded on
        (``collectives.sharded_over``)."""
        xf = x.float()
        s = self.static_scale(site)
        if s is not None:
            return round_clip_s8(xf * (1.0 / s)), s
        a, = collectives.global_max(xf.abs().amax())
        if self.sink is not None and site is not None:
            prev = self.sink.get(site)
            self.sink[site] = a if prev is None else torch.maximum(prev, a)
        s = torch.clamp(div127(a), min=EPS)
        return round_clip_s8(xf / s), s


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division. CUDA computes a division by a Python
    number as a product with its fp32 reciprocal, which is one ulp off for
    about 4% of values, and a scale one ulp off flips s8 values that lie at a
    rounding boundary. A 0-dim tensor divisor takes the true division."""
    return t / torch.full((), 127.0, device=t.device)


def round_clip_s8(xf: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to [-127, 127], store as s8."""
    return torch.round(xf).clamp_(-127, 127).to(torch.int8)


def quantize_weight_out_channel(w: torch.Tensor, group=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel s8; the output channel is axis 0.
    Returns (w_q, fp32 scale [O]). ``group``: the ranks holding the other
    slices of the input dim (a row-parallel weight), over which each
    channel's absmax is maxed."""
    wf = w.detach().float()
    amax = collectives.all_reduce_max(wf.abs().amax(dim=tuple(range(1, w.dim()))), group)
    s = torch.clamp(div127(amax), min=EPS)
    return round_clip_s8(wf / s.view((-1,) + (1,) * (w.dim() - 1))), s


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> int32 product of a [M, K] and b [K, N].

    On the card ``torch._int_mm`` where its shape rules hold (M > 16, K and N
    multiples of 8). Elsewhere float64: every product and partial sum is an
    integer of magnitude at most 127 * 127 * K, far below 2**53, so float64
    holds each one exactly and the sum does not depend on its order.
    """
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(a, b)
    return (a.double() @ b.double()).to(torch.int32)


def dequantize(acc: torch.Tensor, act_scale: Scale, w_scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``float32(acc) * (act_scale * w_scale)`` in the activation dtype; the
    output channel is acc's last axis."""
    return (acc.float() * (w_scale * act_scale)).to(dtype)
