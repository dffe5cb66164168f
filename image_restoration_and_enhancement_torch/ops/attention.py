"""Attention on [B, N, H, D]: the CUDA kernels K1 (exact) and K4 (int8 Q.K^T),
each beside its plain PyTorch version.

Counterpart of the JAX package's ``ops/attention.py``. ``attention(q, k, v,
backend)`` picks the function:

- ``None``, ``"pallas"`` or ``"xla"``: exact attention. ``attention_reference``
  matches ``xla_attention`` in the JAX package: fp32 scores scaled by
  1/sqrt(D), fp32 softmax, probabilities cast to V's dtype for the P.V
  product, output in the input dtype. On a CUDA tensor the hand-written K1
  (``csrc/attention.cu``) computes it with an online softmax.
- ``"int8"``: ``int8_attention``, the function of the JAX package's Pallas
  int8 kernel. Q is scaled by 1/sqrt(D) in its own dtype, K is smoothed by
  its token mean, both are quantized to s8 with one per-tensor scale each
  over all B*H (``smooth_quantize_qk``); the scores are the exact s8 products
  times sq*sk*log2(e), exponentiated with exp2 against the row max; P is cast
  to V's dtype for P.V and the row sum is taken over that cast P. On a CUDA
  tensor the hand-written K4 (``csrc/int8_attention.cu``) computes it.
- ``"xla_int8"`` and ``"xla_int8_pv"``: the JAX package's plain XLA int8
  variants (s8 Q.K^T; s8 Q.K^T and s8 P.V), in plain PyTorch on any device.
- ``"flash"`` and ``"pallas_packed"`` (the TPU kernels K5 and K6) are not
  ported yet and raise ``NotImplementedError``.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version; there is
no other branch. Gradients recompute through ``attention_reference``, as the
JAX package's custom_vjp recomputes through ``xla_attention`` for every
backend (rounding has no useful gradient).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .quant import EPS, div127, round_clip_s8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
LOG2E = 1.4426950408889634
# K4's padded widths, as csrc/int8_attention.cu instantiates them:
# (largest head_dim, s8 Q/K width DP (a multiple of 32), V width DV).
_INT8_WIDTHS = ((16, 32, 16), (48, 64, 48), (80, 96, 80), (160, 160, 160))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain dot-product attention, [B, N, H, D] layout, fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes [B, N, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim <= {MAX_HEAD_DIM}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride on its head_dim axis")
    lib = _build.library()
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    err = lib.iret_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, nq, nk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "attention")
    _build.record_launch("attention", (b, nq, nk, h, d, str(q.dtype)))
    return out


class _AttentionFn(torch.autograd.Function):
    """``forward`` through ``fn`` (a kernel launcher), gradient through
    ``attention_reference``."""

    @staticmethod
    def forward(ctx, fn, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fn(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v)
        return (None, *torch.autograd.grad(out, (q, k, v), grad))


# ---------------------------------------------------------------------------
# int8 Q.K^T attention (K4) and the plain XLA int8 variants
# ---------------------------------------------------------------------------


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(D), the factor cast to q's dtype first (as the JAX package)."""
    return q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)


def smooth_quantize_qk(q: torch.Tensor, k: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N, H, D] -> (q_s8, k_s8, fp32 0-dim scale sq*sk); q arrives pre-scaled.

    K minus its per-(batch, head, channel) token mean (softmax-invariant: it
    shifts each score row by a constant), then dynamic per-tensor symmetric s8
    of each over all batches and heads."""
    kf = k.float()
    kf = kf - kf.mean(dim=1, keepdim=True)
    qf = q.float()
    sq = torch.clamp(div127(qf.abs().amax()), min=EPS)
    sk = torch.clamp(div127(kf.abs().amax()), min=EPS)
    return round_clip_s8(qf / sq), round_clip_s8(kf / sk), sq * sk


def _int8_scores(q8: torch.Tensor, k8: torch.Tensor) -> torch.Tensor:
    """Exact s8 q.k [B, H, Nq, Nk] as fp32: each |sum| <= 127 * 127 * D < 2**24,
    so fp32 holds every partial sum exactly."""
    return torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float())


def int8_attention_core_reference(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                                  scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 on its own inputs: s8 q8, k8 [B, N, H, D], v
    [B, Nk, H, D], scale = sq*sk; the output [B, Nq, H, D] in v's dtype."""
    s = _int8_scores(q8, k8) * (scale.float() * LOG2E)
    p = torch.exp2(s - s.amax(-1, keepdim=True)).to(v.dtype)
    l = p.float().sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.float(), v.float())
    return (acc * (1.0 / l)).to(v.dtype).transpose(1, 2)


def _int8_widths(d: int) -> Tuple[int, int]:
    """(DP, DV): the s8 Q/K and V widths K4 pads head_dim ``d`` to."""
    for limit, dp, dv in _INT8_WIDTHS:
        if d <= limit:
            return dp, dv
    raise ValueError(f"the int8 attention kernel takes head_dim <= {_INT8_WIDTHS[-1][0]}, "
                     f"not {d}")


def _launch_int8(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    b, nq, h, d = q8.shape
    nk = k8.shape[1]
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"the int8 attention kernel takes float32 or bfloat16 v, not {v.dtype}")
    dp, dv = _int8_widths(d)
    q8p = F.pad(q8, (0, dp - d)).contiguous()
    k8p = F.pad(k8, (0, dp - d)).contiguous()
    vp = F.pad(v, (0, dv - d)).contiguous()
    sc = scale.float().reshape(1).contiguous()
    lib = _build.library()
    out = torch.empty((b, nq, h, d), dtype=v.dtype, device=v.device)
    err = lib.iret_int8_attention(
        _DTYPE_CODES[v.dtype], q8p.data_ptr(), k8p.data_ptr(), vp.data_ptr(),
        sc.data_ptr(), out.data_ptr(), b, h, nq, nk, d, dp, dv,
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(err, "int8_attention")
    _build.record_launch("int8_attention", (b, nq, nk, h, d, str(v.dtype)))
    return out


def int8_attention_core(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """K4 on its own inputs (see ``int8_attention_core_reference``): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if q8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise TypeError("int8_attention_core takes s8 q and k")
    if q8.shape[0] != k8.shape[0] or q8.shape[2:] != k8.shape[2:] or k8.shape != v.shape:
        raise ValueError(f"shape mismatch: q {tuple(q8.shape)}, k {tuple(k8.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q8.device == k8.device == v.device == scale.device):
        raise ValueError("q, k, v and scale must be on one device")
    if q8.device.type == "cpu":
        return int8_attention_core_reference(q8, k8, v, scale)
    if q8.device.type != "cuda":
        raise ValueError(f"int8 attention runs on cuda or cpu, not {q8.device}")
    return _launch_int8(q8, k8, v, scale)


def int8_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_attention`` (any device)."""
    q8, k8, s = smooth_quantize_qk(_prescale(q), k)
    return int8_attention_core_reference(q8, k8, v, s).to(q.dtype)


def _int8_forward(q, k, v):
    q8, k8, s = smooth_quantize_qk(_prescale(q), k)
    return int8_attention_core(q8, k8, v, s).to(q.dtype)


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Int8-Q.K^T attention, [B, N, H, D] (serving): K4 on the card."""
    _check(q, k, v)
    return _AttentionFn.apply(_int8_forward, q, k, v)


def xla_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA attention with s8 Q.K^T: fp32 softmax of the
    dequantized scores, P cast to V's dtype, P.V accumulated in fp32."""
    q8, k8, s = smooth_quantize_qk(_prescale(q), k)
    p = torch.softmax(_int8_scores(q8, k8) * s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def xla_attention_int8_pv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's fully quantized XLA attention: s8 Q.K^T and s8 P.V.

    P = round(exp(s - max) * 127) in s8 (the row max is exactly 127), V in s8
    with per-(batch, head, channel) scales, and the row sum taken over the
    same s8 P through a 127-valued ones column. The P.V sum reaches
    127 * 127 * Nk, above 2**24, so it runs in float64, which holds it exactly.
    """
    d = q.shape[-1]
    q8, k8, s_qk = smooth_quantize_qk(_prescale(q), k)
    s = _int8_scores(q8, k8) * s_qk
    p8 = torch.round(torch.exp(s - s.amax(-1, keepdim=True)) * 127.0).to(torch.int8)
    vf = v.float()
    sv = div127(torch.clamp(vf.abs().amax(dim=1, keepdim=True), min=EPS))  # [B, 1, H, D]
    v8 = round_clip_s8(vf / sv)
    ones = torch.full(v8.shape[:-1] + (1,), 127, dtype=torch.int8, device=v.device)
    v8e = torch.cat([v8, ones], dim=-1)
    o32 = torch.einsum("bhqk,bkhd->bqhd", p8.double(), v8e.double()).float()
    l = o32[..., d:]
    o = o32[..., :d] * (sv * 127.0) / l
    return o.to(q.dtype)


_NOT_PORTED = {"flash": "K5 (flash attention)", "pallas_packed": "K6 (packed-layout attention)"}


def check_backend(backend: Optional[str]) -> None:
    """Raise unless ``attention`` takes ``backend``."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"attention backend {backend!r} runs the TPU kernel {_NOT_PORTED[backend]}, "
            "which is not ported to CUDA yet (ROADMAP.md)")
    if backend not in _BACKENDS:
        raise ValueError(f"Unknown attention backend: {backend}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-head softmax attention, [B, Nq, H, D] x [B, Nk, H, D] -> [B, Nq, H, D].

    ``backend``: None, "pallas" or "xla" (exact: K1 on the card), "int8" (K4),
    "xla_int8" or "xla_int8_pv" (plain int8 variants)."""
    check_backend(backend)
    _check(q, k, v)
    return _BACKENDS[backend](q, k, v)


def _exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    return _AttentionFn.apply(_launch, q, k, v)


_BACKENDS: "dict[Optional[str], Callable]" = {
    None: _exact_attention, "pallas": _exact_attention, "xla": _exact_attention,
    "int8": int8_attention,
    "xla_int8": lambda q, k, v: _AttentionFn.apply(xla_attention_int8, q, k, v),
    "xla_int8_pv": lambda q, k, v: _AttentionFn.apply(xla_attention_int8_pv, q, k, v),
}
