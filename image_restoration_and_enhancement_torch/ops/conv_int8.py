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

Which device code serves a call is ``conv_path``'s answer, from the shape
alone: "sm90" (s8 wgmma + TMA; C a multiple of 64, N of 8, and 128-pixel
tiles that are one rectangle of the image, ``sm90_box``: every 3x3 conv of
SD-1.5's UNet and VAE) or "mma" (mma.sync; any C that is a multiple of 8).
``split_k`` names the sm90 path's K split, where the output tiles alone would
leave SMs idle. The wrapper passes both to the C entry, which raises
(``KernelError``) for a path its arguments cannot take and never picks
another; ``_build.launch_paths`` counts launches by path.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"mma": 0, "sm90": 1}
# An H100 SXM's SMs; the wrapper reads the card's own count.
H100_SMS = 132
TILE = 128            # output pixels of a block's tile
MIN_SPLIT_KBLOCKS = 4  # K blocks a split takes at least
# Splits a tile takes at most: the last block to arrive reads the other splits'
# int32 partial tiles (80 KB each at 128 x 160) alone, a cost that grows with
# the splits while the K walk they shorten shrinks (PERF.md, PR 8).
MAX_SPLITS = 8


def sm90_box(h: int, w: int) -> Optional[Tuple[int, int, int]]:
    """The (pixels, rows, images) box of one 128-pixel output tile on the sm90
    path: a run of 128 pixels of a row where W is a multiple of 128, else
    whole rows of one image or whole images; None where no such box exists."""
    if w % TILE == 0:
        return TILE, 1, 1
    if TILE % w:
        return None
    rows = TILE // w
    if rows <= h and h % rows == 0:
        return w, rows, 1
    if TILE % (h * w) == 0:
        return w, h, TILE // (h * w)
    return None


def conv_path(b: int, h: int, w: int, c: int, n: int) -> str:
    """The device code that serves an [b, h, w, c] -> n conv: "sm90" or "mma"."""
    return "sm90" if c % 64 == 0 and n % 8 == 0 and sm90_box(h, w) else "mma"


def tile_n(n: int) -> int:
    """Output channels of an sm90 tile: 160 where N is a multiple of 160 (the
    UNet's 320, 640, 1280), else 128."""
    return 160 if n % 160 == 0 else 128


def tiles(b: int, h: int, w: int, n: int) -> int:
    """The sm90 path's output tiles: 128 pixels x ``tile_n`` channels each."""
    return -(-b * h * w // TILE) * -(-n // tile_n(n))


def split_k(b: int, h: int, w: int, c: int, n: int, sms: int = H100_SMS) -> int:
    """How many blocks share each sm90 output tile's K = 9*C, so that the
    tiles fill the card's ``sms`` SMs: sms // tiles(), at most one split per
    MIN_SPLIT_KBLOCKS K blocks of 128 (or, at C % 128 == 64, 64) channels and
    at most MAX_SPLITS. 1 on the mma path."""
    if conv_path(b, h, w, c, n) != "sm90":
        return 1
    kblocks = 9 * c // (128 if c % 128 == 0 else 64)
    return max(1, min(sms // tiles(b, h, w, n), kblocks // MIN_SPLIT_KBLOCKS, MAX_SPLITS))


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


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _call_plan(b, h, w, c, n, out_dtype, index):
    """(path code, splits, path, launch record, workspace ints, tiles) of a call."""
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"the conv3x3_int8 kernel writes float32 or bfloat16, not {out_dtype}")
    if c % 8:
        raise ValueError(f"the conv3x3_int8 kernel takes a multiple of 8 input "
                         f"channels, not {c}")
    path = conv_path(b, h, w, c, n)
    splits = split_k(b, h, w, c, n, _sms(index))
    t = tiles(b, h, w, n)
    return (_PATH_CODES[path], splits, path, (b, h, w, c, n, str(out_dtype)),
            t * splits * TILE * tile_n(n) if splits > 1 else 0, t)


# Split-K scratch per device: the int32 partial tiles and the per-tile
# counters (zeroed once; each launch leaves them zero). Grown, never shrunk.
# Launches that share it must be ordered, as on one stream: the port issues
# every kernel on the current stream. An outgrown buffer is kept
# (``_outgrown``): a CUDA graph captured with it replays on its address.
_scratch = {}
_outgrown = []


def _split_scratch(device: torch.device, ints: int, tiles: int):
    old_ws, old_counters = _scratch.get(device.index, (None, None))
    ws, counters = old_ws, old_counters
    if ws is None or ws.numel() < ints:
        ws = torch.empty(ints, dtype=torch.int32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    if ws is not old_ws or counters is not old_counters:
        _outgrown.append((old_ws, old_counters))
        _scratch[device.index] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


def _launch(x_q, w_q, out_scale, out_dtype):
    b, hp, wp, c = x_q.shape
    n = w_q.shape[3]
    path, splits, path_name, key, ints, tiles = _call_plan(b, hp - 2, wp - 2, c, n, out_dtype,
                                                           x_q.device.index)
    x_q = x_q.contiguous()
    w_nhwc = w_q.permute(3, 0, 1, 2).contiguous()  # no copy for a view of [N, 3, 3, C]
    scale = out_scale.float().contiguous()
    out = torch.empty((b, hp - 2, wp - 2, n), dtype=out_dtype, device=x_q.device)
    ws, counters = _split_scratch(x_q.device, ints, tiles) if splits > 1 else (None, None)
    err = _build.entry("iret_conv3x3_int8")(
        path, _OUT_CODES[out_dtype], x_q.data_ptr(), w_nhwc.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws, counters, b, hp - 2, wp - 2, c, n, splits,
        _build.raw_stream(x_q.device.index),
    )
    _build.check(err, "conv3x3_int8")
    _build.record_launch("conv3x3_int8", key, path_name)
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
