"""GroupNorm(+SiLU) over NHWC: the CUDA kernel K2 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/groupnorm.py``. ``group_norm`` launches
the hand-written kernel (``csrc/groupnorm.cu``) for a CUDA tensor and uses
``group_norm_reference`` for a CPU tensor; there is no other branch.

``group_norm_reference`` matches ``_reference_group_norm`` in the JAX package:
per-channel fp32 sum and sum of squares, combined per group, the variance
E[x^2] - E[x]^2 clamped at 0, rsqrt(var + eps), the affine folded into
y = x * w + b, an optional SiLU, and y in the input dtype.

``plan`` names how the kernel cuts a call, from the shape alone: "onchip"
(one launch; each block holds a slab of rows in shared memory, the statistics
meet in one grid-wide barrier, x is read once) wherever a sample's slabs fit,
which is every UNet shape at batch 1 and 2, and "twophase" (a stats launch,
then an apply launch that folds the finalize in) for the VAE's largest
shapes. The wrapper passes the path to the C entry, which raises
(``KernelError``) for a path its arguments cannot take and never picks
another; ``_build.launch_paths`` counts calls by path.

Height-sharded GroupNorm (``parallel/spatial.py``) needs global statistics,
so the twophase path's two kernels are also two entries of their own:
``group_norm_stats`` writes each block's per-group fp32 (sum, sum of squares)
into a tensor [B, blocks, G, 2] the caller gets back, and ``group_norm_apply``
takes such partials (the shards' all-gathered, [B, P, G, 2] in (rank, block)
order), reduces them in that fixed order and normalises with the global
element count it is given. The plain split (``group_norm_stats_reference``,
``group_norm_apply_reference``) computes the same function on the CPU: one
partial per sample and group, then the reference's statistics from the summed
partials. The unsharded ``group_norm`` and its plans are unchanged.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"onchip": 0, "twophase": 1}
# An H100 SXM's SMs; the wrapper reads the card's own count.
H100_SMS = 132
# Bytes of x a block of the onchip path holds in shared memory (its slab of
# rows): 192 KiB of the 227 KiB a block can have, beside 32 KiB of reduction
# buffer (csrc/groupnorm.cu kMaxSlabBytes).
ONCHIP_SLAB_BYTES = 192 * 1024
# Blocks per SM of the twophase path's stats and apply kernels.
TWOPHASE_BLOCKS_PER_SM = 2
# Bytes of x a block of the onchip path takes at least: a small call (2x8x8x1280,
# 160 KB a sample) spreads over 10 blocks a sample, not 66, so fewer blocks
# meet at the grid barrier and each reduces fewer partials.
MIN_SLAB_BYTES = 16 * 1024


class Plan(NamedTuple):
    """How the kernel cuts one call: ``path`` ("onchip": one launch, every
    slab held on chip; "twophase": a stats launch and an apply launch), rows
    per block (the slab) and blocks per sample."""
    path: str
    rows_per_block: int
    blocks_per_sample: int


def _cut(hw: int, per_sample: int) -> Tuple[int, int]:
    rows = -(-hw // max(1, min(per_sample, hw)))
    return rows, -(-hw // rows)


def twophase_plan(b: int, hw: int, sms: int = H100_SMS) -> Plan:
    """The twophase cut: about TWOPHASE_BLOCKS_PER_SM blocks an SM."""
    return Plan("twophase", *_cut(hw, TWOPHASE_BLOCKS_PER_SM * sms // b))


@functools.lru_cache(maxsize=None)
def plan(b: int, hw: int, c: int, itemsize: int, sms: int = H100_SMS) -> Plan:
    """The launch plan of a [b, hw, c] GroupNorm in a dtype of ``itemsize``
    bytes on a card of ``sms`` SMs. Onchip when a sample spread over
    ``sms // b`` blocks (one block per SM, as the cooperative launch needs)
    gives slabs of at most ONCHIP_SLAB_BYTES (and fewer blocks where slabs
    would fall below MIN_SLAB_BYTES); else twophase."""
    if b <= sms:
        rows, blocks = _cut(hw, min(sms // b, -(-hw * c * itemsize // MIN_SLAB_BYTES)))
        if rows * c * itemsize <= ONCHIP_SLAB_BYTES:
            return Plan("onchip", rows, blocks)
    return twophase_plan(b, hw, sms)


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


def group_norm_stats_reference(x: torch.Tensor, groups: int,
                               rows_per_block: Optional[int] = None) -> torch.Tensor:
    """Per-group fp32 (sum, sum of squares) of an NHWC x (per channel over the
    rows, then over each group's channels, as ``group_norm_reference`` sums):
    [B, 1, G, 2], or with ``rows_per_block`` one partial per slab of that many
    of the H*W rows, [B, blocks, G, 2], as the stats kernel cuts them."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, c)
    slabs = xf.split(rows_per_block or h * w, dim=1)
    s = torch.stack([t.sum(1) for t in slabs], 1).view(b, len(slabs), groups, c // groups)
    ss = torch.stack([t.square().sum(1) for t in slabs], 1).view(b, len(slabs), groups,
                                                                 c // groups)
    return torch.stack([s.sum(-1), ss.sum(-1)], dim=-1)


def group_norm_apply_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, partials: torch.Tensor,
    count: float, groups: int, eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm (+SiLU) of x with the statistics of ``partials`` [B, P, G, 2]
    (summed over P) over ``count`` elements a group, as ``group_norm_reference``
    finishes them."""
    c = x.shape[-1]
    gc = c // groups
    tot = partials.sum(dim=1)
    g_mean = tot[..., 0] / count
    g_var = torch.clamp(tot[..., 1] / count - g_mean.square(), min=0.0)
    g_rstd = torch.rsqrt(g_var + eps)
    w_c = g_rstd.repeat_interleave(gc, dim=-1) * scale.float()[None, :]
    b_c = bias.float()[None, :] - g_mean.repeat_interleave(gc, dim=-1) * w_c
    y = x.float() * w_c[:, None, None, :] + b_c[:, None, None, :]
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _call_plan(b, h, w, c, groups, eps, act, dtype, index):
    """What a call of this shape passes to the C entry besides its pointers,
    and its launch record."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the group_norm kernel takes float32 or bfloat16, not {dtype}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    if c * itemsize % 16:
        raise ValueError(f"the group_norm kernel takes rows of a multiple of 16 bytes, not "
                         f"{c} channels of {dtype}")
    p = plan(b, h * w, c, itemsize, _sms(index))
    args = (b, h * w, c, groups, p.rows_per_block, float(eps), 1 if act == "silu" else 0)
    return _PATH_CODES[p.path], _DTYPE_CODES[dtype], args, p.path, \
        (b, h, w, c, groups, float(eps), act, str(dtype))


def _launch(x, scale, bias, groups, eps, act):
    b, h, w, c = x.shape
    if not x.is_contiguous():
        raise ValueError("the group_norm kernel takes a contiguous NHWC tensor")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be [{c}]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must be on x's device")
    path, dtype, args, path_name, key = _call_plan(b, h, w, c, groups, eps, act, x.dtype,
                                                   x.device.index)
    if scale.dtype != bias.dtype or scale.dtype not in _DTYPE_CODES:
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    err = _build.entry("iret_group_norm")(
        path, dtype, _DTYPE_CODES[scale.dtype], x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), *args, _build.raw_stream(x.device.index))
    _build.check(err, "group_norm")
    _build.record_launch("group_norm", key, path_name)
    return out


def _check_nhwc(x: torch.Tensor, groups: int) -> None:
    if x.dim() != 4 or x.shape[-1] % groups:
        raise ValueError(f"takes an NHWC tensor whose channels split into {groups} groups")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")


def _sharded_args(x: torch.Tensor, groups: int):
    """(dtype code, rows per block, blocks a sample) of a sharded entry's call:
    the twophase cut of the shard."""
    b, h, w, c = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the group_norm kernel takes float32 or bfloat16, not {x.dtype}")
    if c * x.element_size() % 16 or not x.is_contiguous():
        raise ValueError("the group_norm kernel takes a contiguous NHWC tensor with rows of "
                         "a multiple of 16 bytes")
    p = twophase_plan(b, h * w, _sms(x.device.index))
    return _DTYPE_CODES[x.dtype], p.rows_per_block, p.blocks_per_sample


def group_norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-group fp32 (sum, sum of squares) partials of an NHWC x, [B, P, G, 2]:
    the stats kernel's P blocks a sample on the card (its twophase cut), one
    partial (``group_norm_stats_reference``) on the CPU."""
    _check_nhwc(x, groups)
    if x.device.type == "cpu":
        return group_norm_stats_reference(x, groups)
    code, rows, blocks = _sharded_args(x, groups)
    b, h, w, c = x.shape
    out = torch.empty((b, blocks, groups, 2), dtype=torch.float32, device=x.device)
    err = _build.entry("iret_group_norm_stats")(
        code, x.data_ptr(), out.data_ptr(), b, h * w, c, groups, rows,
        _build.raw_stream(x.device.index))
    _build.check(err, "group_norm_stats")
    _build.record_launch("group_norm_stats", (b, h, w, c, groups, str(x.dtype)), "twophase")
    return out


def group_norm_apply(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, partials: torch.Tensor,
    count: float, groups: int, eps: float = 1e-5, act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm (+SiLU) of an NHWC x with the statistics of ``partials``
    [B, P, G, 2] (reduced in their order) over ``count`` elements a group: the
    apply kernel on the card, ``group_norm_apply_reference`` on the CPU."""
    _check_nhwc(x, groups)
    act = None if act == "none" else act
    if x.device.type == "cpu":
        return group_norm_apply_reference(x, scale, bias, partials, count, groups, eps, act)
    code, rows, _ = _sharded_args(x, groups)
    b, h, w, c = x.shape
    if partials.shape[0] != b or partials.shape[2:] != (groups, 2) \
            or partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError(f"partials must be contiguous fp32 [{b}, P, {groups}, 2]")
    if scale.dtype != bias.dtype or scale.dtype not in _DTYPE_CODES:
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    err = _build.entry("iret_group_norm_apply")(
        code, _DTYPE_CODES[scale.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        partials.data_ptr(), partials.shape[1], out.data_ptr(), b, h * w, c, groups, rows,
        float(count), float(eps), 1 if act == "silu" else 0, _build.raw_stream(x.device.index))
    _build.check(err, "group_norm_apply")
    _build.record_launch("group_norm_apply", (b, h, w, c, groups, float(eps), act,
                                              str(x.dtype), partials.shape[1]), "twophase")
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
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormFn.apply(x, scale, bias, groups, eps, act)
    return _launch(x, scale, bias, groups, eps, act)
