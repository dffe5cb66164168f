"""The collectives multi-device serving calls, each on an explicit group.

In the JAX package XLA inserts these from sharding annotations; the port calls
them itself. Each works under NCCL (the card) and gloo (the CPU tests), and each
call on a group of more than one rank adds one to ``counts`` under its kind:
the port's stand-in for inspecting the compiled program's collectives (the
JAX package's ``test_sharded_img2img_dp_has_no_collectives``). A group of one
rank makes no call and counts nothing.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.distributed as dist

counts: "collections.Counter[str]" = collections.Counter()


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
    """The sum of the ranks' ``x`` (in place; returns ``x``)."""
    if group_size(group) == 1:
        return x
    dist.all_reduce(x, group=group)
    counts["all_reduce"] += 1
    return x


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
