"""Attention on [B, N, H, D]: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/attention.py``. ``attention(q, k, v)``
launches the hand-written kernel (``csrc/attention.cu``) for a CUDA tensor and
uses ``attention_reference`` for a CPU tensor; there is no other branch.

``attention_reference`` matches ``xla_attention`` in the JAX package: fp32
scores scaled by 1/sqrt(D), fp32 softmax, probabilities cast to V's dtype for
the P.V product, output in the input dtype. The kernel computes the same
function with an online softmax (see the note in the CUDA source).

The gradient recomputes through the plain version, as the JAX package's
custom_vjp recomputes through ``xla_attention``.
"""
from __future__ import annotations

import math

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512


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
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v)
        return torch.autograd.grad(out, (q, k, v), grad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head softmax attention, [B, Nq, H, D] x [B, Nk, H, D] -> [B, Nq, H, D]."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    return _AttentionFn.apply(q, k, v)
