"""The collectives multi-device serving and training call, each on an explicit
group.

In the JAX package XLA inserts these from sharding annotations; the port calls
them itself. Each works under NCCL (the card) and gloo (the CPU tests), and each
call on a group of more than one rank adds one to ``counts`` under its kind
("all_gather", "all_reduce" (a float sum), "all_reduce_s32", "all_reduce_max",
"halo", "grad_bucket"): the port's stand-in for inspecting the compiled
program's collectives (the JAX package's
``test_sharded_img2img_dp_has_no_collectives``). A group of one rank makes no
call and counts nothing.

Besides the plain calls:

- ``copy_to_group`` and ``reduce_from_group``, Megatron's "f" and "g": the
  identity forward with the gradient summed over the group backward, and the
  sum forward with the identity backward. Under ``torch.no_grad`` (serving)
  they are the identity and ``all_reduce``.
- ``all_reduce_mean``: a list of tensors (the gradients of a data-parallel
  step) summed over the group in flat buckets of ``BUCKET_BYTES`` and divided
  by its size; one call per bucket, not one per tensor.
- ``global_max``: a per-tensor statistic of an activation (an int8 scale)
  made global over the groups its tensor is sharded on. The serving factories
  name the batch and height groups for the duration of a request
  (``sharded_over``); the layers add the model group around a row-parallel
  input and attention on local heads.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

counts: "collections.Counter[str]" = collections.Counter()
BUCKET_BYTES = 32 << 20
_sharded_over: "contextvars.ContextVar[Tuple]" = contextvars.ContextVar(
    "activation_groups", default=())


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order (the
    list form, which NCCL and gloo both take)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    counts["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` (in place; returns ``x``): exact for int32
    (the row-parallel s8 products' partial sums)."""
    if group_size(group) == 1:
        return x
    dist.all_reduce(x, group=group)
    counts["all_reduce_s32" if x.dtype == torch.int32 else "all_reduce"] += 1
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the ranks' ``x`` (in place; returns ``x``)."""
    if group_size(group) == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    counts["all_reduce_max"] += 1
    return x


@contextlib.contextmanager
def sharded_over(*groups) -> Iterator[None]:
    """Inside this block the model's activations are sharded over ``groups``
    (None entries and groups of one rank are dropped): ``global_max`` reduces
    over them."""
    token = _sharded_over.set(_sharded_over.get()
                              + tuple(g for g in groups if group_size(g) > 1))
    try:
        yield
    finally:
        _sharded_over.reset(token)


def global_max(*values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 0-dim ``values`` maxed over the active ``sharded_over`` groups, in
    one call per group; the values themselves where there is none."""
    groups = _sharded_over.get()
    if not groups:
        return values
    stacked = torch.stack([v.float() for v in values])
    for g in groups:
        all_reduce_max(stacked, g)
    return tuple(stacked.unbind())


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` itself, whose gradient is
    summed over ``group`` in the backward pass (each rank holds a part of the
    layer's outputs, so each holds a part of ``x``'s gradient). The identity
    where no gradient flows to ``x``."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel layer: ``x`` summed over ``group``, whose
    gradient passes to every rank's part unchanged. ``all_reduce`` (in place)
    where no gradient flows."""
    if group_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce(x, group)
    return _ReduceFromGroup.apply(x, group)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each of ``tensors`` (in place) by its mean over ``group``: the
    tensors, in order, are packed into flat buckets of at most
    ``bucket_bytes`` (a larger tensor takes a bucket of its own), each bucket
    summed in one call and divided by the group's size."""
    n = group_size(group)
    if n == 1:
        return
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        counts["grad_bucket"] += 1
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        flush()


def halo_exchange(x: torch.Tensor, group, dim: int, above: int, below: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The ``above`` rows of ``x`` along ``dim`` that end the previous rank's
    shard and the ``below`` rows that start the next rank's, through
    ``batch_isend_irecv`` with the two neighbours; None at the group's first
    (last) rank, where the global tensor has no such rows, and where 0 rows
    are asked for."""
    n, me = group_size(group), dist.get_rank(group)
    ops, got_above, got_below = [], None, None

    def rows(t: torch.Tensor, start: int, count: int) -> torch.Tensor:
        return t.narrow(dim, start, count).contiguous()

    def peer(r: int) -> int:
        return dist.get_global_rank(group, r)

    size = x.shape[dim]
    if above and me > 0:
        got_above = torch.empty_like(rows(x, 0, above))
        ops.append(dist.P2POp(dist.irecv, got_above, peer(me - 1), group))
    if above and me < n - 1:
        ops.append(dist.P2POp(dist.isend, rows(x, size - above, above), peer(me + 1), group))
    if below and me < n - 1:
        got_below = torch.empty_like(rows(x, 0, below))
        ops.append(dist.P2POp(dist.irecv, got_below, peer(me + 1), group))
    if below and me > 0:
        ops.append(dist.P2POp(dist.isend, rows(x, 0, below), peer(me - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        counts["halo"] += 1
    return got_above, got_below
