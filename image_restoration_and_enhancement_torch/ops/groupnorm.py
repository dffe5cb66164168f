"""GroupNorm(+SiLU) over NHWC: the CUDA kernel K2 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/groupnorm.py``. ``group_norm`` launches
the hand-written kernel (``csrc/groupnorm.cu``) for a CUDA tensor and uses
``group_norm_reference`` for a CPU tensor; there is no other branch.

``group_norm_reference`` matches ``_reference_group_norm`` in the JAX package:
per-channel fp32 sum and sum of squares, combined per group, the variance
E[x^2] - E[x]^2 clamped at 0, rsqrt(var + eps), the affine folded into
y = x * w + b, an optional SiLU, and y in the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Pass 1 of the kernel splits each sample's rows into chunks so that a batch
# gives the card about this many blocks (132 SMs).
_TARGET_STAT_BLOCKS = 1024
_MIN_ROWS_PER_CHUNK = 16


def group_norm_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
    eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """Two-stage GroupNorm on NHWC with fp32 statistics."""
    b, h, w, c = x.shape
    gc = c // groups
    n = h * w * gc
    xf = x.float()
    s = xf.sum(dim=(1, 2))
    ss = xf.square().sum(dim=(1, 2))
    g_mean = s.view(b, groups, gc).sum(-1) / n
    g_var = torch.clamp(ss.view(b, groups, gc).sum(-1) / n - g_mean.square(), min=0.0)
    g_rstd = torch.rsqrt(g_var + eps)
    w_c = g_rstd.repeat_interleave(gc, dim=-1) * scale.float()[None, :]
    b_c = bias.float()[None, :] - g_mean.repeat_interleave(gc, dim=-1) * w_c
    y = xf * w_c[:, None, None, :] + b_c[:, None, None, :]
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _chunking(batch: int, rows: int) -> tuple:
    per_sample = max(1, _TARGET_STAT_BLOCKS // batch)
    rows_per_chunk = max(_MIN_ROWS_PER_CHUNK, -(-rows // per_sample))
    return -(-rows // rows_per_chunk), rows_per_chunk


def _launch(x, scale, bias, groups, eps, act):
    b, h, w, c = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the group_norm kernel takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the group_norm kernel takes a contiguous NHWC tensor")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be [{c}]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must be on x's device")
    lib = _build.library()
    rows = h * w
    chunks, rows_per_chunk = _chunking(b, rows)
    if scale.dtype != bias.dtype or scale.dtype not in _DTYPE_CODES:
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.detach().contiguous(), bias.detach().contiguous()
    out = torch.empty_like(x)
    partial = torch.empty((b, chunks, c, 2), dtype=torch.float32, device=x.device)
    wb = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    err = lib.iret_group_norm(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), partial.data_ptr(), wb.data_ptr(),
        b, rows, c, groups, chunks, rows_per_chunk, float(eps),
        1 if act == "silu" else 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "group_norm")
    _build.record_launch("group_norm", (b, h, w, c, groups, float(eps), act, str(x.dtype)))
    return out


class _GroupNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, act)
        return _launch(x, scale, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = group_norm_reference(x, scale, bias, *ctx.args)
        return (*torch.autograd.grad(out, (x, scale, bias), grad), None, None, None)


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
    eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm with optional fused SiLU. x: [B, H, W, C]; act: None or "silu"."""
    if x.dim() != 4:
        raise ValueError("group_norm takes an NHWC tensor")
    if act not in (None, "none", "silu"):
        raise ValueError(f"unknown activation {act!r}")
    act = None if act == "none" else act
    if x.shape[-1] % groups:
        raise ValueError(f"{x.shape[-1]} channels do not split into {groups} groups")
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")
    return _GroupNormFn.apply(x, scale, bias, groups, eps, act)
