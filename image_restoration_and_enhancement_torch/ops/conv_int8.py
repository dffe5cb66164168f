"""Int8 3x3 stride-1 SAME convolution: the CUDA kernel K3 and its plain version.

Counterpart of the JAX package's ``ops/conv_int8.py``. ``conv3x3_same_int8``
keeps the JAX signature: an s8 input already padded by one pixel on each side,
[B, H+2, W+2, C]; an s8 weight [3, 3, C, N] (HWIO); the fp32 output scale [N]
(activation scale times the per-channel weight scale); and it returns
[B, H, W, N] in ``out_dtype``:

    out[b, y, x, n] = float32(sum_{dy, dx, c} x[b, y+dy, x+dx, c] * w[dy, dx, c, n])
                      * scale[n]

For a CUDA tensor it launches the hand-written kernel (``csrc/conv_int8.cu``);
for a CPU tensor it uses ``conv3x3_same_int8_reference``; there is no other
branch. The int32 sums are exact on both, so both compute the function that
XLA's int8 conv and the Pallas kernel compute in the JAX package.

The kernel reads the weight as [N, 3, 3, C] (for each output channel its
9*C taps contiguous). A weight passed as the [3, 3, C, N] view of such a
tensor, as ``QConv2d`` does, is used without a copy.
"""
from __future__ import annotations

import torch

from . import _build

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_same_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor,
                                out_scale: torch.Tensor,
                                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: nine tap slices, each an exact integer product.

    The products run in float64: every partial sum is an integer of magnitude
    at most 127 * 127 * 9 * C (about 3.7e8 at C = 2560), which float64 holds
    exactly (float32 would not: it is above 2**24), so the sum is the int32
    sum whatever its order. ``F.conv2d`` takes no int8.
    """
    b, hp, wp, c = x_q.shape
    h, w = hp - 2, wp - 2
    n = w_q.shape[-1]
    xf = x_q.double()
    wf = w_q.double()
    acc = torch.zeros((b * h * w, n), dtype=torch.float64, device=x_q.device)
    for dy in range(3):
        for dx in range(3):
            acc += xf[:, dy:dy + h, dx:dx + w, :].reshape(-1, c) @ wf[dy, dx]
    y = acc.float() * out_scale.float()
    return y.to(out_dtype).view(b, h, w, n)


def _check(x_q: torch.Tensor, w_q: torch.Tensor, out_scale: torch.Tensor) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("conv3x3_same_int8 takes int8 x and w")
    if x_q.dim() != 4 or w_q.dim() != 4 or w_q.shape[:2] != (3, 3):
        raise ValueError(f"x must be [B, H+2, W+2, C] and w [3, 3, C, N]; got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if w_q.shape[2] != x_q.shape[3]:
        raise ValueError(f"x has {x_q.shape[3]} channels, w takes {w_q.shape[2]}")
    if x_q.shape[1] < 3 or x_q.shape[2] < 3:
        raise ValueError("x must be padded by one pixel on each side")
    if out_scale.shape != (w_q.shape[3],):
        raise ValueError(f"out_scale must be [{w_q.shape[3]}]")
    if not (x_q.device == w_q.device == out_scale.device):
        raise ValueError("x, w and out_scale must be on one device")


def _launch(x_q, w_q, out_scale, out_dtype):
    b, hp, wp, c = x_q.shape
    n = w_q.shape[3]
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"the conv3x3_int8 kernel writes float32 or bfloat16, not {out_dtype}")
    if c % 8:
        raise ValueError(f"the conv3x3_int8 kernel takes a multiple of 8 input "
                         f"channels, not {c}")
    x_q = x_q.contiguous()
    w_nhwc = w_q.permute(3, 0, 1, 2).contiguous()  # no copy for a view of [N, 3, 3, C]
    scale = out_scale.float().contiguous()
    lib = _build.library()
    out = torch.empty((b, hp - 2, wp - 2, n), dtype=out_dtype, device=x_q.device)
    err = lib.iret_conv3x3_int8(
        _OUT_CODES[out_dtype], x_q.data_ptr(), w_nhwc.data_ptr(), scale.data_ptr(),
        out.data_ptr(), b, hp - 2, wp - 2, c, n,
        torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    _build.check(err, "conv3x3_int8")
    _build.record_launch("conv3x3_int8", (b, hp - 2, wp - 2, c, n, str(out_dtype)))
    return out


def conv3x3_same_int8(x_q: torch.Tensor, w_q: torch.Tensor, out_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Implicit-GEMM s8 3x3 stride-1 conv of a pre-padded input; [B, H, W, N]."""
    _check(x_q, w_q, out_scale)
    if x_q.device.type == "cpu":
        return conv3x3_same_int8_reference(x_q, w_q, out_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv3x3_same_int8 runs on cuda or cpu, not {x_q.device}")
    return _launch(x_q, w_q, out_scale, out_dtype)
