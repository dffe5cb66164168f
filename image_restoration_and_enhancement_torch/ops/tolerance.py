"""How close a kernel's output must be to its plain PyTorch version.

float32: 1e-4 absolute and relative. Both take the same fp32 sums in another
order.

bfloat16: both sides compute in fp32 and round the output to bf16 once. Two
values that round differently lie one bf16 step apart, and a step is at most
2**-7 of the value. Before that rounding they differ by a little, and the
absolute term covers that as a share of the largest output:

    |got - ref| <= share * max|ref| + 2**-7 * |ref|      (elementwise)

- attention, share 2**-8 (half a step of the largest value): the plain
  version rounds the normalised probabilities to bf16 before P.V, the kernel
  the unnormalised ones, each to 2**-9 of itself with random sign.
  Self-attention over 4096 random keys averages to |out| ~ 0.03, and a kernel
  that dropped one 64-key tile or skipped the online-softmax rescale moves it
  by far more than this limit (tests/test_torch_cuda.py holds both faults
  against it).
- group_norm, share 2**-10: the two sides differ before rounding only by
  fp32 sums taken in another order, which shows where x*w + b cancels near 0.
- int8_attention (K4), share 2**-8, as attention: Q.K^T is exact in s8 on
  both sides, and they differ in the bf16 rounding of P, the kernel rounding
  it against the running max of 64-key tiles, the plain version against the
  row max (the same difference as K1's).

conv3x3_int8 (K3): both sides take the same exact int32 sums, convert each
to fp32 with one rounding and multiply by the same fp32 scale, so they agree
to within one rounding of the output dtype: |got - ref| <= eps(dtype) * |ref|,
no absolute term (in practice they are bitwise equal).

int8_layer: a whole quantized layer (``QLinear``, ``QConv2d``) on the card
against the same layer on the CPU, on the same input. The quantizers are the
same elementwise fp32 operations, the s8 products are exact on both devices
and the scale and bias are applied by the same operations, so the limit is
K3's.
"""
from __future__ import annotations

from typing import Tuple

import torch

_BF16_SHARE = {"attention": 2.0**-8, "group_norm": 2.0**-10, "int8_attention": 2.0**-8}


def limits(ref: torch.Tensor, kernel: str) -> Tuple[float, float]:
    """(atol, rtol) for holding ``kernel``'s output against its plain ``ref``."""
    if kernel in ("conv3x3_int8", "int8_layer"):
        return 0.0, torch.finfo(ref.dtype).eps
    if ref.dtype == torch.bfloat16:
        return _BF16_SHARE[kernel] * float(ref.float().abs().max()), 2.0**-7
    if ref.dtype == torch.float32:
        return 1e-4, 1e-4
    raise TypeError(f"no tolerance for {ref.dtype}")


def within(got: torch.Tensor, ref: torch.Tensor, kernel: str) -> Tuple[bool, float]:
    """Whether ``got`` is within ``limits(ref, kernel)``, and the max abs error."""
    atol, rtol = limits(ref, kernel)
    err = (got.float() - ref.float()).abs()
    return bool(torch.all(err <= atol + rtol * ref.float().abs())), float(err.max())
