"""Token merging (ToMe) around the UNet's large self-attention sites.

Counterpart of the JAX package's ``ops/token_merge.py`` (after "Token Merging
for Fast Stable Diffusion", Bolya & Hoffman, 2023). Before a self-attention
over N spatial tokens, the r source tokens most similar to a destination token
are merged into it (bipartite matching against a strided destination grid:
one destination per 2x2 tile, its top-left token); attention runs over the
N - r survivors; each destination's output is then copied back to the tokens
that merged into it. Only self-attention (``attn1``) is merged, and only at
sites with N >= ``min_tokens`` (4096 by default: the level-0 blocks of a
512 px request); cross-attention and the feed-forward stay exact.

An opt-in approximation, off by default, as in the JAX package. Its policy is
a ``TomeState`` that the pipeline owns and hands to its UNet
(``models/layers.set_tome``), as it hands a ``QuantState`` to the quantized
layers: ``RestorationPipeline(tome_ratio=r)``, or with no ``tome_ratio`` the
``IRET_TOME`` and ``IRET_TOME_MIN`` variables, read once when the pipeline is
built (``state_from_env``).

Numerics kept from the JAX function: the similarity is the cosine of the
block input rows (normalised in fp32, rounded back to the input dtype, then
multiplied in fp32); each source's best destination is the first maximum,
and the sources are ranked by a stable sort of their best score. The merged
destination is the fp32 mean of its group, cast to the input dtype. The token
order after merging is [destinations, unmerged sources]. The JAX function
accumulates the groups with a one-hot matmul and builds its row map from
scatter-free index maps, for the TPU; here the groups are summed in fp32 by
``index_put_`` with ``accumulate=True`` and unmerged with one ``gather``. On
the card that sum is sort-based and adds each group's rows in token order, so
a merge gives the same bits at every run (``index_add_``'s atomic adds land
in any order: a served image then differed from run to run, and a CUDA graph
of the serve from the eager serve).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

DEFAULT_MIN_TOKENS = 4096


@dataclasses.dataclass(frozen=True)
class TomeState:
    """The merge policy: the fraction of tokens merged away at self-attention
    sites of at least ``min_tokens`` tokens (ratio 0: off)."""

    ratio: float = 0.0
    min_tokens: int = DEFAULT_MIN_TOKENS

    @property
    def active(self) -> bool:
        return self.ratio > 0.0

    def applies(self, n_tokens: int) -> bool:
        return self.active and n_tokens >= self.min_tokens


def ratio_from_env() -> float:
    """``IRET_TOME`` as the JAX package parses it: unset, empty or not a
    number is 0.0."""
    try:
        return float(os.environ.get("IRET_TOME", "0") or 0.0)
    except ValueError:
        return 0.0


def state_from_env(ratio: Optional[float] = None) -> TomeState:
    """The policy of a pipeline: ``ratio`` when given and non-zero, else
    ``IRET_TOME``; the site threshold from ``IRET_TOME_MIN`` (default 4096)."""
    return TomeState(float(ratio) if ratio else ratio_from_env(),
                     int(os.environ.get("IRET_TOME_MIN", str(DEFAULT_MIN_TOKENS))))


def plan(h: int, w: int, sx: int = 2, sy: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Static bipartite split of the h*w token grid: one destination token per
    sy x sx tile (its top-left), the rest are merge sources. Returns
    (dst_idx [Nd], src_idx [Ns]), flat row-major int32 indices."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    is_dst = ((ii % sy) == 0) & ((jj % sx) == 0)
    idx = np.arange(h * w).reshape(h, w)
    return idx[is_dst].astype(np.int32), idx[~is_dst].astype(np.int32)


def merge_count(h: int, w: int, ratio: float, sx: int = 2, sy: int = 2) -> int:
    """Tokens merged away: ratio*N, capped at the number of sources and
    floored at 0."""
    n = h * w
    ns = n - (-(-h // sy)) * (-(-w // sx))  # n - ceil(h/sy)*ceil(w/sx)
    return max(0, min(int(n * ratio), ns))


_indices: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _plan_indices(h: int, w: int, sx: int, sy: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``plan``'s (dst, src) as int64 tensors on ``device``, copied there once
    per grid and kept: a merge then copies nothing from the host, so it can be
    captured in a CUDA graph. The tensors are only read, and are made outside
    inference mode, so that autograd may save them."""
    key = (h, w, sx, sy, str(device))
    idx = _indices.get(key)
    if idx is None:
        with torch.inference_mode(False):
            idx = _indices[key] = tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                                        for a in plan(h, w, sx, sy))
    return idx


def build_merge(metric: torch.Tensor, h: int, w: int, r: int, sx: int = 2, sy: int = 2
                ) -> Tuple[Callable, Callable, int]:
    """(merge, unmerge, N - r) from the similarity ``metric`` [B, N, C] (the
    transformer block's input). merge(x [B, N, C]) -> [B, N - r, C];
    unmerge(y [B, N - r, C']) -> [B, N, C'], each token taking the row of its
    destination (merged), or its own."""
    b, n, _ = metric.shape
    if n != h * w:
        raise ValueError(f"{n} tokens are not a {h}x{w} grid")
    nd = (-(-h // sy)) * (-(-w // sx))
    ns = n - nd
    r = max(0, min(int(r), ns))
    if r == 0:
        return (lambda x: x), (lambda y: y), n

    dev = metric.device
    dst, src = _plan_indices(h, w, sx, sy, dev)
    mn = metric.float()
    mn = (mn / (torch.linalg.vector_norm(mn, dim=-1, keepdim=True) + 1e-6)).to(metric.dtype)
    scores = torch.einsum("bsc,bdc->bsd", mn[:, src].float(), mn[:, dst].float())
    node_max = scores.amax(dim=-1)                                   # [B, Ns]
    node_dst = scores.argmax(dim=-1)                                 # [B, Ns], first max
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged_pos, unm_pos = order[:, :r], order[:, r:]                 # positions in src
    dst_of_merged = torch.gather(node_dst, 1, merged_pos)            # [B, r]

    # the merged output's row of every original token: destination k -> k,
    # unmerged source i -> nd + i, merged source -> its destination's row
    src_rows = torch.empty((b, ns), dtype=torch.int64, device=dev)
    src_rows.scatter_(1, unm_pos, torch.arange(nd, nd + ns - r, device=dev).expand(b, -1))
    src_rows.scatter_(1, merged_pos, dst_of_merged)
    row_of_token = torch.empty((b, n), dtype=torch.int64, device=dev)
    row_of_token[:, dst] = torch.arange(nd, device=dev)
    row_of_token[:, src] = src_rows
    # flat destination rows of the merged sources, for one index_add_ over B*Nd
    flat_dst = (dst_of_merged + nd * torch.arange(b, device=dev)[:, None]).reshape(-1)
    counts = torch.ones(b * nd, device=dev).index_add_(
        0, flat_dst, torch.ones(b * r, device=dev)).view(b, nd, 1)

    def take(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))

    def merge(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xs = x[:, src]
        sums = x[:, dst].float().reshape(b * nd, c).index_put_(
            (flat_dst,), take(xs, merged_pos).float().reshape(b * r, c), accumulate=True)
        xd = (sums.view(b, nd, c) / counts).to(x.dtype)
        return torch.cat([xd, take(xs, unm_pos)], dim=1)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return take(y, row_of_token)

    return merge, unmerge, n - r
