"""Level-gated height sharding: the sequence-parallel analog for vision.

Counterpart of the JAX package's ``parallel/spatial.py``. Resolution is this
system's context length: sharding the image HEIGHT over a mesh axis lets one
image larger than a card be served by a row of cards. In the JAX package GSPMD
partitions the convs from sharding constraints; here the code does it:

- the policy (``spatial_sharding``) holds the ``sp`` group, this rank's index
  in it and ``MIN_ROWS_PER_SHARD``. An activation of global height H is
  height-sharded while ``H % sp == 0`` and ``H / sp >= 4`` (``Policy.gate``,
  the JAX rule), else every rank of the group holds all H rows. The policy
  tracks the global height of the level the model computes (``Policy.height``):
  the model entries set it (``begin``: the VAE encoder starts at the image
  height, the UNet and the VAE decoder at the latent height, both named per
  request by ``request``), and the height-changing blocks update it, gathering
  to full height where a level falls under the gate (the UNet's and the VAE
  encoder's down paths) and slicing again where it rises over it (the up
  paths). Tensors here are NCHW-shaped and channels-last: the height is dim 2
  (dim 1 of the NHWC tensors that enter and leave the models).
- 3x3 convs exchange halo rows with the neighbouring shards
  (``collectives.halo_exchange``; an int8 conv its s8 rows, ``int8_conv``),
  the global top and bottom shards padding with zeros: a stride-1 pad-1 conv takes one row from above and one from
  below; the stride-2 pad-1 ``Downsample2D`` one from above only; the VAE's
  downsample (``F.pad(x, (0, 1, 0, 1))`` then stride 2, pad 0) one from below
  only. A stride-2 conv needs every shard to start at an even global row; a
  shard of odd height is gathered first (its output falls under the gate
  anyway). 1x1 convs are local.
- GroupNorm's statistics are global: each rank's per-group partial sums are
  all-gathered over the group and reduced in (rank, block) order
  (``ops/groupnorm.py``'s two sharded entries).
- self-attention keeps its queries local and all-gathers K and V
  (``gather_tokens``); cross-attention is local.

Every rank of the group computes the same function as one device would; the
policy is a ``contextvars`` value, active only inside ``spatial_sharding``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import collectives

# The JAX package's gate: shard a level while every shard keeps >= 4 rows.
MIN_ROWS_PER_SHARD = 4
CL = torch.channels_last


@dataclasses.dataclass
class Policy:
    """The active height sharding: the ``sp`` group, its size, this rank's
    index in it, the gate's rows, and the global heights of the request
    (``image_height``, ``latent_height``) and of the level being computed."""

    group: object
    size: int
    index: int
    min_rows: int = MIN_ROWS_PER_SHARD
    image_height: int = 0
    latent_height: int = 0
    height: int = 0

    def gate(self, h: int) -> bool:
        """Whether an activation of global height ``h`` is height-sharded."""
        return h % self.size == 0 and h // self.size >= self.min_rows

    @property
    def sharded(self) -> bool:
        return self.gate(self.height)


_policy: "contextvars.ContextVar[Optional[Policy]]" = contextvars.ContextVar(
    "spatial_policy", default=None)


@contextlib.contextmanager
def spatial_sharding(mesh, spatial_axis: str = "sp", min_rows: int = MIN_ROWS_PER_SHARD):
    """Activate the policy over ``mesh``'s ``spatial_axis`` for the code run
    inside this context."""
    token = _policy.set(Policy(mesh.group(spatial_axis), mesh.size(spatial_axis),
                               mesh.coordinate(spatial_axis), min_rows))
    try:
        yield
    finally:
        _policy.reset(token)


def active() -> Optional[Policy]:
    return _policy.get()


def sharded() -> Optional[Policy]:
    """The policy when the current level is height-sharded, else None."""
    pol = _policy.get()
    return pol if pol is not None and pol.sharded else None


def request(image_height: int, latent_height: int) -> None:
    """Name the global image and latent heights of the request being served."""
    pol = _policy.get()
    if pol is not None:
        pol.image_height, pol.latent_height = int(image_height), int(latent_height)


def begin(level: str) -> None:
    """At a model entry: the current level is the request's "image" or
    "latent" height."""
    pol = _policy.get()
    if pol is not None:
        pol.height = pol.image_height if level == "image" else pol.latent_height


def scatter_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a full-height tensor along ``dim``, where its height
    passes the gate (else all of it)."""
    pol = _policy.get()
    h = x.shape[dim]
    if pol is None or not pol.gate(h):
        return x
    n = h // pol.size
    return x.narrow(dim, pol.index * n, n)


def gather_rows(x: torch.Tensor, height: int, dim: int = 1) -> torch.Tensor:
    """The full-height tensor from this rank's rows along ``dim`` (1: NHWC; 2:
    an NCHW-shaped channels-last tensor, gathered as its NHWC view), where a
    tensor of global ``height`` is height-sharded (else ``x`` as it is)."""
    pol = _policy.get()
    if pol is None or not pol.gate(height):
        return x
    return _all_rows(x, pol) if dim == 2 else collectives.all_gather(x, pol.group, dim)


def _all_rows(x: torch.Tensor, pol: Policy) -> torch.Tensor:
    """Every shard's rows of a height-sharded NCHW-shaped channels-last x."""
    return collectives.all_gather(x.permute(0, 2, 3, 1), pol.group, 1).permute(0, 3, 1, 2)


def _halo(x: torch.Tensor, pol: Policy, above: int, below: int) -> torch.Tensor:
    """x (NCHW, height-sharded) with ``above`` rows of the previous shard and
    ``below`` of the next on top and bottom, zeros beyond the global edges."""
    up, down = collectives.halo_exchange(x, pol.group, 2, above, below)
    parts = []
    if above:
        parts.append(up if up is not None else x.new_zeros(x.shape[:2] + (above, x.shape[3])))
    parts.append(x)
    if below:
        parts.append(down if down is not None
                     else x.new_zeros(x.shape[:2] + (below, x.shape[3])))
    return torch.cat([p.contiguous(memory_format=CL) for p in parts], dim=2)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int, pad_w: int) -> torch.Tensor:
    return F.conv2d(x, conv.weight, conv.bias, (stride, stride), (0, pad_w))


def _local(conv: nn.Conv2d, x: torch.Tensor, vae_pad: bool) -> torch.Tensor:
    """The conv on a tensor that holds every row it needs."""
    return nn.Conv2d.forward(conv, F.pad(x, (0, 1, 0, 1)) if vae_pad else x)


def conv(conv: nn.Conv2d, x: torch.Tensor, vae_pad: bool = False) -> torch.Tensor:
    """``conv`` (3x3: stride 1 pad 1, stride 2 pad 1, or with ``vae_pad`` the
    VAE's stride 2 pad 0 after its (0, 1) pad; or 1x1) on the current level's
    x under the active policy, in the layout of its output's height; a stride-2
    conv updates the policy's height."""
    pol = _policy.get()
    kh, stride = conv.kernel_size[0], conv.stride[0]
    if kh == 1 or (stride == 1 and not pol.sharded):
        return _local(conv, x, vae_pad)
    if stride == 1:
        return _conv(conv, _halo(x, pol, 1, 1), 1, conv.padding[1])
    h_in = pol.height
    pol.height = h_in // 2
    if not pol.gate(h_in) or x.shape[2] % 2:
        # replicated, or a shard starting at an odd global row: run the whole
        # level (its output falls under the gate)
        return _local(conv, _all_rows(x, pol) if pol.gate(h_in) else x, vae_pad)
    if vae_pad:
        y = _conv(conv, _halo(F.pad(x, (0, 1)), pol, 0, 1), 2, 0)
    else:
        y = _conv(conv, _halo(x, pol, 1, 0), 2, conv.padding[1])
    return y if pol.gate(pol.height) else _all_rows(y, pol)


def int8_conv(run, xq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """A quantized 3x3 conv (stride 1 or 2, padding ``pad``) on the current
    level's s8 NHWC ``xq`` under the active policy, with ``spatial.conv``'s
    geometry on the s8 rows (one byte an element): ``run(rows, top, bottom)``
    is the local conv of ``rows`` padded by ``top`` and ``bottom`` zero rows.
    A stride-1 conv of a sharded level takes one halo row from above and one
    from below (zero rows at the global edges), a stride-2 conv one from
    above; a stride-2 conv updates the policy's height."""
    pol = _policy.get()
    if stride == 1:
        if not pol.sharded:
            return run(xq, pad, pad)
        up, down = collectives.halo_exchange(xq, pol.group, 1, 1, 1)
        zero = lambda: xq.new_zeros((xq.shape[0], 1) + xq.shape[2:])  # noqa: E731
        return run(torch.cat([up if up is not None else zero(), xq,
                              down if down is not None else zero()], dim=1), 0, 0)
    h_in = pol.height
    pol.height = h_in // 2
    if not pol.gate(h_in) or xq.shape[1] % 2:
        # replicated, or a shard starting at an odd global row: the whole level
        rows = collectives.all_gather(xq, pol.group, 1) if pol.gate(h_in) else xq
        return run(rows, pad, pad)
    up, _ = collectives.halo_exchange(xq, pol.group, 1, 1, 0)
    top = up if up is not None else xq.new_zeros((xq.shape[0], 1) + xq.shape[2:])
    y = run(torch.cat([top, xq], dim=1), 0, 0)
    return y if pol.gate(pol.height) else collectives.all_gather(y, pol.group, 1)


def upsampled(x: torch.Tensor) -> torch.Tensor:
    """After a 2x nearest upsample of the current level: the layout of the
    doubled height (a replicated level that rises over the gate is sliced to
    this rank's rows); updates the policy's height."""
    pol = _policy.get()
    if pol is None:
        return x
    was = pol.sharded
    pol.height *= 2
    return x if was else scatter_rows(x, dim=2)


def gather_tokens(t: torch.Tensor) -> torch.Tensor:
    """Self-attention's K or V [B, n, ...] of a height-sharded level: every
    shard's tokens, in order (the tokens are rows of the flattened grid)."""
    pol = sharded()
    return t if pol is None else collectives.all_gather(t, pol.group, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, act: Optional[str]) -> torch.Tensor:
    """GroupNorm (+SiLU) of a height-sharded NHWC level with global
    statistics: each rank's per-group partial sums, all-gathered over the
    group and reduced in (rank, block) order by the apply entry, over the
    global element count."""
    from ..ops import groupnorm as G

    pol = sharded()
    parts = collectives.all_gather(G.group_norm_stats(x, groups), pol.group, 1)
    b, h, w, c = x.shape
    count = float(h * pol.size * w * (c // groups))
    return G.group_norm_apply(x, scale, bias, parts, count, groups, eps, act)
