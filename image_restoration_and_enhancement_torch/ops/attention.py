"""Attention on [B, N, H, D]: the CUDA kernels K1 (exact), K5 (flash), K6a/K6b
(exact, packed layout) and K4 (int8 Q.K^T), each beside its plain PyTorch
version.

Counterpart of the JAX package's ``ops/attention.py``. ``attention(q, k, v,
backend)`` picks the function as the JAX package's ``attention`` does:

- ``"xla"``: ``attention_reference``, the function of ``xla_attention``: fp32
  scores scaled by 1/sqrt(D), fp32 softmax, the normalised probabilities cast
  to V's dtype for P.V, output in the input dtype. Plain PyTorch on every
  device (in the JAX package ``"xla"`` never reaches a Pallas kernel).
- ``"pallas"``: K1 (``csrc/attention.cu``), the function of the Pallas
  ``_fused_attention_kernel``, whose plain version is
  ``pallas_attention_reference``: Q times 1/sqrt(D) rounded to Q's dtype before
  the dot, P = exp(s - row max) rounded to V's dtype, the row sum over that
  rounded P, P.V divided once by the row sum. Its opt-in branches
  IRET_ATTN_SCORES_BF16 and IRET_ATTN_NORM_BOUND are read at call time.
- ``None``: K1 on the card and ``attention_reference`` on the CPU. (The JAX
  package runs Pallas on the TPU only inside a window of sequence lengths and
  XLA elsewhere; the port runs K1 at every site on the card.)
- ``"flash"``: K5, the function of ``_flash_attention_kernel``
  (``flash_attention_reference``): K1's, with KV walked in chunks and the row
  sum taken over the fp32 P.
- ``"pallas_packed"``: K6b through ``packed_call``, on the projection layout
  [B, N, H*D] (``packed_attention_reference``, K1's function per head); K6a is
  ``packed_call(..., variant="packed")``, as in the JAX package.
- ``"int8"``: ``int8_attention``, the function of the JAX package's Pallas
  int8 kernel. Q is scaled by 1/sqrt(D) in its own dtype, K is smoothed by
  its token mean, both are quantized to s8 with one per-tensor scale each
  over all B*H (``smooth_quantize_qk``); the scores are the exact s8 products
  times sq*sk*log2(e), exponentiated with exp2 against the row max; P is cast
  to V's dtype for P.V and the row sum is taken over that cast P. On a CUDA
  tensor the hand-written K4 computes it, on the device code
  ``int8_kernel_path`` names: "sm90" (``csrc/attention.cu``'s wgmma + TMA
  code with an s8 Q.K^T, reading q8, k8 and v where they lie; bf16 v) or
  "mma" (``csrc/int8_attention.cu``'s mma.sync code on zero-padded copies:
  fp32 v, or rows TMA cannot address).
- ``"xla_int8"`` and ``"xla_int8_pv"``: the JAX package's plain XLA int8
  variants (s8 Q.K^T; s8 Q.K^T and s8 P.V), in plain PyTorch on any device.

``int8_min`` (0: off) is the JAX package's ``IRET_ATTN_XLA_INT8_MIN`` as an
argument: under the default backend (None), a call whose Nq and Nk are both at
least ``int8_min`` computes ``xla_attention_int8_pv`` instead. It changes the
function, not only the routing. The JAX package honours it on the TPU only;
the port on every device. The model layers carry it
(``models/layers.set_attn_int8``).

For a kernel's backend a CUDA tensor goes to the kernel and a CPU tensor to
its plain version; there is no other branch. Which device code of
``csrc/attention.cu`` serves K1, K5, K6a and K6b is ``kernel_path``'s answer,
from the layout, the dtype, head_dim and the flags alone: "sm90" (wgmma + TMA,
bf16 at head_dim <= 160), "sm90_split" (the same at 160 < head_dim <= 512, the
output's dims split over the grid: the VAE mid-block), "mma" (mma.sync: K1's
opt-in branches, or rows TMA cannot address) or "simt" (CUDA cores: fp32, and
bf16 above 160 where sm90_split cannot go). The wrapper passes it to the C
entry, which raises (``KernelError``) for a path its arguments cannot take and
never picks another. Gradients recompute through
``attention_reference``, as the JAX package's custom_vjp recomputes through
``xla_attention`` for every backend (rounding has no useful gradient).
"""
from __future__ import annotations

import functools
import math
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives
from . import _build
from .quant import EPS, div127, round_clip_s8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
SM90_MAX_HEAD_DIM = 160  # above it the output dims are split over the grid
# csrc/attention.cu's paths (its enum Path)
_PATH_CODES = {"simt": 0, "mma": 1, "sm90": 2, "sm90_split": 3}
LOG2E = 1.4426950408889634
# The padded widths of K4's "mma" code, as csrc/int8_attention.cu instantiates
# them: (largest head_dim, s8 Q/K width DP (a multiple of 32), V width DV).
_INT8_WIDTHS = ((16, 32, 16), (48, 64, 48), (80, 96, 80), (160, 160, 160))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain dot-product attention, [B, N, H, D] layout, fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


# csrc/attention.cu's function flags
_ROWSUM_F32, _SCORES_BF16, _NORM_BOUND = 1, 2, 4


def _k1_flags() -> int:
    """K1's opt-in branches, read from the environment at call time as the JAX
    package reads them: IRET_ATTN_SCORES_BF16=1 and IRET_ATTN_NORM_BOUND=1."""
    scores_bf16 = os.environ.get("IRET_ATTN_SCORES_BF16") == "1"
    norm_bound = os.environ.get("IRET_ATTN_NORM_BOUND", "0") == "1"
    return ((_SCORES_BF16 if scores_bf16 else 0) | (_NORM_BOUND if norm_bound else 0)
            | (_ROWSUM_F32 if scores_bf16 and not norm_bound else 0))


def _pallas_function(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     flags: int = 0) -> torch.Tensor:
    """The Pallas K1 function on [B, N, H, D] with ``flags`` (``_k1_flags``)."""
    qs = _prescale(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if flags & _SCORES_BF16:
        s = s.to(torch.bfloat16)
    if flags & _NORM_BOUND:
        qn = qs.float().square().sum(-1).sqrt()         # [B, Nq, H]
        kn = k.float().square().sum(-1).amax(1).sqrt()  # [B, H]
        m = (qn * kn[:, None]).transpose(1, 2)[..., None]
    else:
        m = s.amax(-1, keepdim=True)
    pf = torch.exp((s - m).float())  # bf16 scores: s - m is a bf16 difference
    p = pf.to(v.dtype)
    l = (pf if flags & _ROWSUM_F32 else p.float()).sum(-1, keepdim=True)
    if flags & _NORM_BOUND:
        l = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.float(), v.float()) * (1.0 / l)
    return o.to(q.dtype).transpose(1, 2)


def pallas_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version of K1, the JAX package's ``_fused_attention_kernel``, on
    [B, N, H, D]: Q times 1/sqrt(D) in Q's dtype, fp32 scores, P = exp(s - row
    max) rounded to V's dtype, the row sum over that rounded P, P.V in fp32
    times the reciprocal of the row sum, the output in Q's dtype.

    Its two opt-in branches are read from the environment at call time:
    IRET_ATTN_SCORES_BF16=1 rounds the scores to bf16 before the max and exp
    (s - max is then a bf16 difference), and IRET_ATTN_NORM_BOUND=1 shifts by
    ||q'|| * max_j ||k_j|| in fp32 instead of the row max and clamps the row sum
    at 1e-30. With bf16 scores the exp is taken in fp32 and the row sum adds
    that fp32 exp, and so does P.V in fp32: that is how the JAX kernel runs on
    the CPU in interpret mode, where XLA keeps the fp32 value of a bf16 exp
    that feeds an fp32 operation."""
    return _pallas_function(q, k, v, _k1_flags())


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              block_k: Optional[int] = None) -> torch.Tensor:
    """Plain version of K5, the JAX package's ``_flash_attention_kernel``, on
    [B, N, H, D]: Q prescaled as in K1, KV walked in chunks of
    min(block_k, round_up(Nk, 128)) keys (``block_k`` defaults to
    IRET_FLASH_BLOCK_K or 1024, read at call time) with a running max m, and per
    chunk alpha = exp(m - m_new), P = exp(s - m_new) in fp32, l = l*alpha + the
    sum of the fp32 P, acc = acc*alpha + (P in V's dtype).V; at the end acc
    times the reciprocal of l, in Q's dtype."""
    if block_k is None:
        block_k = int(os.environ.get("IRET_FLASH_BLOCK_K", "1024"))
    nk = k.shape[1]
    chunk = min(block_k, -(-nk // 128) * 128)
    qs = _prescale(q).float()
    m = l = acc = None
    for k0 in range(0, nk, chunk):
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:, k0:k0 + chunk].float())
        m_new = s.amax(-1, keepdim=True) if m is None else torch.maximum(
            m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          v[:, k0:k0 + chunk].float())
        if m is None:
            l, acc = p.sum(-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
        m = m_new
    return (acc * (1.0 / l)).to(q.dtype).transpose(1, 2)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain version of K6a and K6b on the projection layout: q [B, Nq, H*D],
    k and v [B, Nk, H*D] -> [B, Nq, H*D]. Both TPU kernels compute K1's Pallas
    function per head (without its opt-in branches)."""
    b, nq, hd = q.shape
    split = [t.unflatten(-1, (heads, hd // heads)) for t in (q, k, v)]
    return _pallas_function(*split).reshape(b, nq, hd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes [B, N, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[2] % heads:
        raise ValueError(f"packed attention takes q [B, Nq, H*D] and k, v [B, Nk, H*D] "
                         f"with H = {heads}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check(*(t.unsqueeze(2) for t in (q, k, v)))


def _tma_rows(ptr: int, strides) -> bool:
    """Whether TMA can address the rows of a [B, N, H, D] bf16 view at ``ptr``
    with element ``strides`` (b, n, h): a 16-byte aligned base and positive
    strides of a 16-byte multiple."""
    return ptr % 16 == 0 and all(s > 0 and s % 8 == 0 for s in strides)


def _path(dtype: torch.dtype, d: int, flags: int, views) -> str:
    """``kernel_path`` on ``views``, (data_ptr, (b, n, h) strides) of q, k, v."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {dtype}")
    plain = not flags & (_SCORES_BF16 | _NORM_BOUND)
    tma = all(_tma_rows(ptr, strides) for ptr, strides in views)
    if d <= SM90_MAX_HEAD_DIM:
        return "sm90" if plain and tma else "mma"
    return "sm90_split" if plain and tma else "simt"


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, flags: int = 0) -> str:
    """The device code of ``csrc/attention.cu`` that serves K1, K5, K6a or K6b on
    these [B, N, H, D] views (K6's [B, N, H*D] views split into heads) with
    these function flags (``_k1_flags``, or ``_ROWSUM_F32`` for K5):

    - "sm90": bf16, head_dim <= 160, no opt-in branch, rows TMA can address;
    - "sm90_split": the same at 160 < head_dim <= 512;
    - "mma": bf16, head_dim <= 160, an opt-in branch or rows TMA cannot address;
    - "simt": fp32, or bf16 above 160 with an opt-in branch or such rows.

    Decided by the arguments alone, never by a failed build or launch; the C
    entry refuses a path its arguments cannot take."""
    return _path(q.dtype, q.shape[-1], flags,
                 [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)])


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) as ``dtype`` holds it."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def _kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d: int, flags: int,
                 head_stride: Optional[int] = None):
    """(dtype code, path, path code, scale) for the csrc/attention.cu entries,
    after checking what they take: [B, N, H, D] views, or [B, N, H*D] views
    with ``head_stride`` D. The scale is 1/sqrt(D) as q's dtype holds it."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim <= {MAX_HEAD_DIM}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on its head_dim axis")
    views = [(t.data_ptr(), t.stride()[:3] if head_stride is None
              else (t.stride(0), t.stride(1), head_stride)) for t in (q, k, v)]
    path = _path(q.dtype, d, flags, views)
    return _DTYPE_CODES[q.dtype], path, _PATH_CODES[path], _scale(d, q.dtype)


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 (``"attention"``) or K5 (``"flash_attention"``) on [B, N, H, D] views."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    flags = _k1_flags() if kernel == "attention" else _ROWSUM_F32
    code, path, path_code, scale = _kernel_args(q, k, v, d, flags)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    err = getattr(_build.library(), f"iret_{kernel}")(
        code, path_code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, nq, nk, d, *(t.stride(i) for t in (q, k, v) for i in range(3)),
        scale, *((flags,) if kernel == "attention" else ()),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, f"{kernel} ({path})")
    _build.record_launch(kernel, (b, nq, nk, h, d, str(q.dtype)), path)
    return out


def _launch_packed(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """K6a (``"packed_attention"``) or K6b (``"packed_attention_grid"``) on
    [B, N, H*D] views."""
    b, nq, hd = q.shape
    nk, d = k.shape[1], hd // heads
    code, path, path_code, scale = _kernel_args(q, k, v, d, 0, head_stride=d)
    out = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    err = getattr(_build.library(), f"iret_{kernel}")(
        code, path_code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, heads, nq, nk, d, *(t.stride(i) for t in (q, k, v) for i in range(2)),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, f"{kernel} ({path})")
    _build.record_launch(kernel, (b, nq, nk, heads, d, str(q.dtype)), path)
    return out


def pallas_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 on [B, N, H, D]: the kernel for CUDA tensors, ``pallas_attention_reference``
    for CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return pallas_attention_reference(q, k, v)
    return _launch("attention", q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5 on [B, N, H, D]: the kernel for CUDA tensors, ``flash_attention_reference``
    for CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return _launch("flash_attention", q, k, v)


def pallas_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """K6a on [B, N, H*D]: the kernel for CUDA tensors,
    ``packed_attention_reference`` for CPU tensors."""
    _check_packed(q, k, v, heads)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, heads)
    return _launch_packed("packed_attention", q, k, v, heads)


def pallas_attention_packed_grid(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int) -> torch.Tensor:
    """K6b on [B, N, H*D]: the kernel for CUDA tensors,
    ``packed_attention_reference`` for CPU tensors."""
    _check_packed(q, k, v, heads)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, heads)
    return _launch_packed("packed_attention_grid", q, k, v, heads)


def packed_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                variant: str = "grid") -> torch.Tensor:
    """[B, N, H, D] through the packed layout: each of q, k, v reshaped to
    [B, N, H*D] (a view when its head and dim axes are contiguous, as the
    UNet's projections are), K6b (``"grid"``) or K6a (``"packed"``), and back."""
    if variant not in ("grid", "packed"):
        raise ValueError(f"Unknown packed variant: {variant}")
    impl = pallas_attention_packed_grid if variant == "grid" else pallas_attention_packed
    b, nq, h, d = q.shape
    out = impl(*(t.reshape(t.shape[0], t.shape[1], h * d) for t in (q, k, v)), heads=h)
    return out.view(b, nq, h, d)


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
    of each over all batches and heads. Under a mesh both absmaxes are global
    (``collectives.global_max``: over the batch and height groups the
    serving factories name, and the model group of local heads, which
    ``CrossAttention`` adds); K's token mean is over the tokens given, which
    a height-sharded level has gathered."""
    kf = k.float()
    kf = kf - kf.mean(dim=1, keepdim=True)
    qf = q.float()
    qa, ka = collectives.global_max(qf.abs().amax(), kf.abs().amax())
    sq = torch.clamp(div127(qa), min=EPS)
    sk = torch.clamp(div127(ka), min=EPS)
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
    """(DP, DV): the s8 Q/K and V widths K4's "mma" code pads head_dim ``d`` to."""
    for limit, dp, dv in _INT8_WIDTHS:
        if d <= limit:
            return dp, dv
    raise ValueError(f"the int8 attention kernel takes head_dim <= {_INT8_WIDTHS[-1][0]}, "
                     f"not {d}")


def _s8_rows(shape, strides) -> bool:
    """Whether the 3-D TMA map of K4's "sm90" code can read an s8 [B, N, H, D]
    view of ``shape`` and element ``strides`` at a 16-byte aligned base: heads
    packed in its rows (unit stride on D, head stride D or one head) and
    positive 16-byte multiple row and batch strides."""
    sb, sn, sh, sd = strides
    return (sd == 1 and (sh == shape[3] or shape[2] == 1) and sb > 0 and sn > 0
            and sb % 16 == 0 and sn % 16 == 0)


def _s8_row_bytes(h: int, d: int) -> int:
    """The bytes of an s8 row K4's sm90 code multiplies for every head: its
    boxes start at the 16-byte boundary at or below column h*d, so d past the
    largest such lead (h*d mod 16) over the heads."""
    return d + max((i * d) % 16 for i in range(min(h, 16)))


@functools.lru_cache(maxsize=None)
def _int8_path(q_shape, q_strides, k_shape, k_strides, v_strides, v_dtype, aligned) -> str:
    """``int8_kernel_path`` on shapes, strides, v's dtype and whether every base
    is 16-byte aligned (cached: the wrapper asks on every call)."""
    if v_dtype not in _DTYPE_CODES:
        raise TypeError(f"the int8 attention kernel takes float32 or bfloat16 v, not {v_dtype}")
    _int8_widths(q_shape[3])
    sm90 = (v_dtype == torch.bfloat16 and aligned and _s8_rows(q_shape, q_strides)
            and _s8_rows(k_shape, k_strides) and v_strides[3] == 1
            and all(x > 0 and x % 8 == 0 for x in v_strides[:3])
            and _s8_row_bytes(q_shape[2], q_shape[3]) <= SM90_MAX_HEAD_DIM)
    return "sm90" if sm90 else "mma"


def int8_kernel_path(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor) -> str:
    """The device code that serves K4 on these s8 q8, k8 and v [B, N, H, D]:

    - "sm90": bf16 v, q8 and k8 with heads packed in 16-byte aligned rows
      (``_s8_rows``: the quantizer's contiguous outputs at the UNet's
      H*D = 320, 640, 1280), head_dim plus the largest lead of a head within
      160 bytes (``_s8_row_bytes``: 48, 80, 160 at d = 40, 80, 160) and v rows
      TMA can address (as K1's);
    - "mma": fp32 v, or rows the sm90 code cannot address (the wrapper then
      passes zero-padded contiguous copies).

    Decided by the arguments alone, never by a failed build or launch; the C
    entry refuses a path its arguments cannot take."""
    aligned = (q8.data_ptr() | k8.data_ptr() | v.data_ptr()) % 16 == 0
    return _int8_path(q8.shape, q8.stride(), k8.shape, k8.stride(), v.stride(),
                      v.dtype, aligned)


def _launch_int8(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """K4 through ``int8_kernel_path``'s code. On "sm90" (every served call) the
    kernel reads q8, k8 and v where they lie and only the output is allocated;
    the "mma" code takes contiguous copies zero-padded to ``_int8_widths``."""
    b, nq, h, d = q8.shape
    nk = k8.shape[1]
    path = int8_kernel_path(q8, k8, v)
    if path == "mma":
        dp, dv = _int8_widths(d)
        q8, k8 = (F.pad(t, (0, dp - d)).contiguous() for t in (q8, k8))
        v = F.pad(v, (0, dv - d)).contiguous()
    if scale.dtype != torch.float32:
        scale = scale.float()
    out = torch.empty((b, nq, h, d), dtype=v.dtype, device=v.device)
    err = _build.entry("iret_int8_attention")(
        _PATH_CODES[path], _DTYPE_CODES[v.dtype], q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
        scale.data_ptr(), out.data_ptr(), b, h, nq, nk, d, *q8.stride()[:3], *k8.stride()[:3],
        *v.stride()[:3], _build.raw_stream(v.device.index),
    )
    _build.check(err, f"int8_attention ({path})")
    _build.record_launch("int8_attention", (b, nq, nk, h, d, str(v.dtype)), path)
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
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, not {scale.numel()}")
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


def xla_int8_core(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """``xla_attention_int8`` on K4's own inputs: fp32 softmax of the
    dequantized scores, the normalised P cast to V's dtype, P.V accumulated in
    fp32, the output in V's dtype. K4's function with its roundings elsewhere:
    the wrong version of K4's placement check (``ops/tolerance.py``)."""
    p = torch.softmax(_int8_scores(q8, k8) * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(v.dtype)


def xla_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA attention with s8 Q.K^T: fp32 softmax of the
    dequantized scores, P cast to V's dtype, P.V accumulated in fp32."""
    q8, k8, s = smooth_quantize_qk(_prescale(q), k)
    return xla_int8_core(q8, k8, v, s).to(q.dtype)


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


def check_backend(backend: Optional[str]) -> None:
    """Raise unless ``attention`` takes ``backend``."""
    if backend not in _BACKENDS:
        raise ValueError(f"Unknown attention backend: {backend}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              backend: Optional[str] = None, int8_min: int = 0) -> torch.Tensor:
    """Multi-head softmax attention, [B, Nq, H, D] x [B, Nk, H, D] -> [B, Nq, H, D].

    ``backend``: None (K1 on the card, ``attention_reference`` on the CPU),
    "pallas" (K1), "xla" (``attention_reference`` everywhere), "flash" (K5),
    "pallas_packed" (K6b), "int8" (K4), "xla_int8" or "xla_int8_pv" (plain int8
    variants). ``int8_min``: see the module docstring."""
    check_backend(backend)
    _check(q, k, v)
    if backend is None and 0 < int8_min <= min(q.shape[1], k.shape[1]):
        backend = "xla_int8_pv"
    return _BACKENDS[backend](q, k, v)


def _default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    return _AttentionFn.apply(pallas_attention, q, k, v)


_BACKENDS: "dict[Optional[str], Callable]" = {
    None: _default_attention,
    "pallas": lambda q, k, v: _AttentionFn.apply(pallas_attention, q, k, v),
    "xla": attention_reference,
    "flash": lambda q, k, v: _AttentionFn.apply(flash_attention, q, k, v),
    "pallas_packed": lambda q, k, v: _AttentionFn.apply(packed_call, q, k, v),
    "int8": int8_attention,
    "xla_int8": lambda q, k, v: _AttentionFn.apply(xla_attention_int8, q, k, v),
    "xla_int8_pv": lambda q, k, v: _AttentionFn.apply(xla_attention_int8_pv, q, k, v),
}
