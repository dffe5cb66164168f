"""How close a kernel's output must be to its plain PyTorch version.

float32: 1e-4 absolute and relative. Both take the same fp32 sums in another
order.

bfloat16: both sides compute in fp32 and round the output to bf16 once. Two
values that round differently lie one bf16 step apart, and a step is at most
2**-7 of the value. Before that rounding they differ by a little, and the
absolute term covers that as a share of the largest output:

    |got - ref| <= share * max|ref| + 2**-7 * |ref|      (elementwise)

- attention (K1), share 2**-8 (half a step of the largest value): the plain
  version (``pallas_attention_reference``) rounds P to bf16 against the row
  max, the kernel against the running max of its KV tiles, each to 2**-9 of
  itself with random sign. The tiles are the device code's: 128 keys on the
  sm90 path up to head_dim 80, 64 at 160, 32 at the d = 512 split path, 64
  on the mma path. Self-attention over 4096 random keys averages to
  |out| ~ 0.03, and a kernel that dropped one KV tile (of 32, 64 or 128 keys)
  or skipped the online-softmax rescale moves it by far more than this limit
  (tests/test_torch_cuda.py holds both faults against it at each tile).
- flash_attention (K5), share 2**-8, as attention: the plain version rounds
  P against the running max of 1024-key chunks, the kernel against that of
  its KV tiles; the row sum is the fp32 P's on both sides.
- packed_attention and packed_attention_grid (K6a, K6b), share 2**-8: K1's
  function and K1's device code on another layout, so K1's difference.
- attention_scores_bf16: K1 with IRET_ATTN_SCORES_BF16=1, in either input
  dtype, share 2**-8 as attention. Both sides take the exact row max and shift
  by it, but the scores are fp32 sums that each side rounds to bf16, and one
  summed in another order can round to the neighbouring bf16 value. A score
  of |s| < 1 then moves its P by at most 2**-8 of itself, in fp32 inputs too,
  which the limit covers. A bf16 step of a larger score is larger (2**-5 at
  |s| in [4, 8)), and when the score that rounds the other way is the row max,
  every other P of the row moves by that factor against the max's; the limit
  does not cover that row. ``scores_bf16_within`` passes such a row only when
  its exact row max lies within MIDPOINT_SLACK of a bf16 step of a rounding
  midpoint and the plain function with that score rounded to the other
  neighbour puts the row within the limit (measured on an H100 80GB HBM3: a row
  max 1.9e-6 of a step below the midpoint 5.921875 gave 15 elements over the
  limit, and the plain function with it rounded down equals the kernel's row
  bitwise).
- group_norm, share 2**-10: the two sides differ before rounding by fp32
  sums taken in another order, which shows where x*w + b cancels near 0, and
  by the kernel's SiLU (the MUFU exponential and reciprocal, a few fp32 ulps).
- int8_attention (K4), share 2**-8, as attention: Q.K^T is exact in s8 on
  both sides, and they differ in the bf16 rounding of P, the kernel rounding
  it against the running max of its KV tiles (128 keys on the sm90 path up to
  head_dim 96, 64 at 160, 64 on the mma path), the plain version against the
  row max (the same difference as K1's). tests/test_torch_cuda.py holds a
  dropped KV tile and a skipped rescale against it at each tile.

Placement (bf16 only): the limit above also passes a kernel that puts its
bf16 roundings elsewhere (for example one that scales the fp32 scores instead
of rounding Q*(1/sqrt(D)), or sums the fp32 P), so ``placement`` adds a check:
the share of output elements bitwise equal to the right plain version must
beat the share bitwise equal to a plain version with other roundings
(``attention_reference``, xla_attention's) by ``PLACEMENT_MARGIN``. On the CPU
(bf16 inputs from a seed, 128 query rows at 2x4096x8x40, 2x1024x8x80 and
2x77x8x160) a plain emulation of the kernel's tiles with the Pallas roundings
equals ``pallas_attention_reference`` on 62.6-93.5% of elements at 64-key
tiles and 63.0-93.5% at the sm90 tiles (128, 128, 64 keys), and
``attention_reference`` on 43.4-46.6% at either; the same emulation with the
roundings K1 had before (fp32 scores scaled after the dot, row sum over the
fp32 P) equals them on 43.9-48.7% and 49.8-52.2% at either tile. A margin of
0.1 share lies between: the right placement clears it by 0.09 or more, the
wrong one misses it by 0.13 or more.

K4 (int8_attention, bf16) takes the same check with ``int8_attention_core_
reference`` as the right version and ``attention.xla_int8_core`` as the
wrong one (xla_attention_int8's roundings on the same s8 inputs: P normalised
in fp32 and then rounded to bf16, no divide after P.V). On the CPU (seeds 4
and 5, 128 query rows at 2x4096x8x40, 2x1024x8x80 and 2x77x8x160) a plain
emulation of K4's tiles equals the right version on 62.4-93.5% of elements at
64-key tiles and 62.8-93.5% at the sm90 tiles (128, 128, 64 keys), and the
wrong one on 49.7-52.4%: the right placement clears the margin by 0.024 or
more, and an emulation that normalises P before rounding it equals the wrong
version. The other misplacement one would expect, the row sum taken over the
fp32 P instead of the rounded P, cannot be told apart by any margin: an
emulation with it equals the right version on 62.4-90.4% of elements and the
fp32-row-sum version on 62.4-93.4%, and the right emulation equals the two on
shares within 0.031 of each other (a row sum over 77-4096 keys moves by far
less than a bf16 step of the output), so no check is made for it.

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

import math
from typing import Tuple

import torch

# fp32 sums of up to 512 products sit within ~1e-3 of a bf16 step of the
# exact score; a row max closer than this to a rounding midpoint can round
# either way.
MIDPOINT_SLACK = 2.0**-8
_BF16_SHARE = {"attention": 2.0**-8, "group_norm": 2.0**-10, "group_norm_apply": 2.0**-10,
               "int8_attention": 2.0**-8,
               "flash_attention": 2.0**-8, "packed_attention": 2.0**-8,
               "packed_attention_grid": 2.0**-8, "attention_scores_bf16": 2.0**-8}
PLACEMENT_MARGIN = 0.1


def limits(ref: torch.Tensor, kernel: str) -> Tuple[float, float]:
    """(atol, rtol) for holding ``kernel``'s output against its plain ``ref``."""
    if kernel in ("conv3x3_int8", "int8_layer"):
        return 0.0, torch.finfo(ref.dtype).eps
    if ref.dtype == torch.bfloat16 or kernel == "attention_scores_bf16":
        return _BF16_SHARE[kernel] * float(ref.float().abs().max()), 2.0**-7
    if ref.dtype == torch.float32:
        return 1e-4, 1e-4
    raise TypeError(f"no tolerance for {ref.dtype}")


def within(got: torch.Tensor, ref: torch.Tensor, kernel: str) -> Tuple[bool, float]:
    """Whether ``got`` is within ``limits(ref, kernel)``, and the max abs error."""
    atol, rtol = limits(ref, kernel)
    err = (got.float() - ref.float()).abs()
    return bool(torch.all(err <= atol + rtol * ref.float().abs())), float(err.max())


def _scores_bf16_row(sb: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """K1's plain function under IRET_ATTN_SCORES_BF16 (row sum over the fp32 P)
    for one query row, from its bf16 scores ``sb`` [Nk] and ``v`` [Nk, D]."""
    pf = torch.exp((sb - sb.max()).float())
    return ((pf.to(v.dtype).float() @ v.float()) * (1.0 / pf.sum())).to(out_dtype)


def scores_bf16_within(got: torch.Tensor, ref: torch.Tensor, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> Tuple[bool, float]:
    """``within(got, ref, "attention_scores_bf16")`` for K1 under
    IRET_ATTN_SCORES_BF16=1 on [B, N, H, D] inputs, where a query row outside
    the limit passes only when its row max rounds either way: its exact score
    (q*(1/sqrt(D)) in Q's dtype, then float64 products) lies within
    MIDPOINT_SLACK of a bf16 step of a rounding midpoint, and the plain
    function of the row with that score rounded to the other bf16 neighbour
    is within the limit (see the module docstring)."""
    from .attention import _prescale

    atol, rtol = limits(ref, "attention_scores_bf16")
    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    qs = _prescale(q)
    for b, i, h in (err > bound).any(-1).nonzero().tolist():
        exact = k[b, :, h].double() @ qs[b, i, h].double()
        j = int(exact.argmax())
        x = float(exact[j])
        step = 2.0 ** (math.floor(math.log2(abs(x))) - 7)
        low = math.floor(x / step) * step
        if abs(x - (low + step / 2)) > MIDPOINT_SLACK * step:
            return False, float(err.max())
        sb = (k[b, :, h].float() @ qs[b, i, h].float()).to(torch.bfloat16)
        other = low + step if float(sb[j]) == low else low
        sb[j] = other
        row = _scores_bf16_row(sb, v[b, :, h], got.dtype)
        if not bool(torch.all((got[b, i, h].float() - row.float()).abs() <= bound[b, i, h])):
            return False, float(err.max())
    return True, float(err.max())


def placement(got: torch.Tensor, right_ref: torch.Tensor, wrong_ref: torch.Tensor
              ) -> Tuple[bool, float, float]:
    """Whether ``got`` equals ``right_ref`` bitwise on a share of its elements
    that beats its share equal to ``wrong_ref`` by ``PLACEMENT_MARGIN``; and both
    shares."""
    right = float((got.float() == right_ref.float()).float().mean())
    wrong = float((got.float() == wrong_ref.float()).float().mean())
    return right >= wrong + PLACEMENT_MARGIN, right, wrong
