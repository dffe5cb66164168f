"""Tensor-parallel rules for the SD stack, on the port's (diffusers) names.

Counterpart of the JAX package's ``parallel/sharding_rules.py``: the same
Megatron-style column/row pairs, collective-free inside each pair.

- attention ``to_q``/``to_k``/``to_v``: column parallel (output, i.e. head, dim)
- attention ``to_out.0``: row parallel (input dim)
- GEGLU ``ff.net.0.proj``: column; ``ff.net.2``: row
- CLIP ``q_proj``/``k_proj``/``v_proj`` and ``fc1`` column, ``out_proj`` and
  ``fc2`` row
- the time-embedding MLP: ``time_embedding.linear_1`` column, ``linear_2`` row

Everything else is replicated: convs, norms, embeddings, ``Transformer2D``'s
``proj_in``/``proj_out`` (in the JAX rules only the ``ff/`` suffix matches), the
SDXL ``add_embedding``. JAX kernels are [in, out] and torch weights [out, in],
so "column" (JAX ``P(None, "model")``) shards torch dim 0 and "row" (JAX
``P("model", None)``) dim 1; a column bias shards dim 0, a row bias stays whole
and is added once, after the all-reduce (``models/layers.row_parallel``).

Two things the JAX rules leave to XLA are explicit here:
- GEGLU's ``proj`` is [2 * inner, dim], the hidden half above the gate half
  (``GEGLU.forward`` chunks it). A contiguous dim-0 shard would hand one rank
  all hidden rows and the other all gate rows, so each half is sharded on its
  own: rank r holds [hidden_r; gate_r].
- Q/K/V shards must fall on head boundaries. A site whose heads do not divide
  by the model-axis size (SDXL level 1 has 10 heads at tp = 4; TINY_SD 2)
  keeps its attention replicated, full weights on every rank: the same
  function. ``replicated_sites`` names such sites, and logs each.
Serving shards only the UNet, as the JAX serving factories do; the CLIP rules
are here and tested against the JAX package's, but not served.

Training over a (data, model) mesh keeps the UNet's fp32 masters and the
optimizer's per-parameter state (AdamW's ``mu``/``nu``, MultiSteps' ``acc``,
Adafactor's unfactored ``v``) as this rank's slices of the same partition;
``TrainSharding`` names them, takes the global-norm and finiteness decisions
over the model group, and slices a full train state (``shard_train_state``)
or gathers one back to full (``gather_train_state``): the saved state is the
one-device file, whatever mesh wrote or reads it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, Mapping, Optional, Set

import torch
import torch.nn as nn

from . import collectives
from .mesh import Mesh

logger = logging.getLogger(__name__)

_COLUMN = ("to_q.weight", "to_k.weight", "to_v.weight", "ff.net.0.proj.weight",
           "q_proj.weight", "k_proj.weight", "v_proj.weight", "fc1.weight",
           "time_embedding.linear_1.weight")
_ROW = ("to_out.0.weight", "ff.net.2.weight", "out_proj.weight", "fc2.weight",
        "time_embedding.linear_2.weight")
_COLUMN_BIAS = ("to_q.bias", "to_k.bias", "to_v.bias", "ff.net.0.proj.bias",
                "q_proj.bias", "k_proj.bias", "v_proj.bias", "fc1.bias",
                "time_embedding.linear_1.bias")
GEGLU_PROJ = "ff.net.0.proj"


def _matches(name: str, suffixes: Iterable[str]) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


def partition_dim(name: str, ndim: int) -> Optional[int]:
    """The torch dim along which parameter ``name`` (of ``ndim`` dims) shards
    over the model axis: 0 (column weight or bias), 1 (row weight) or None
    (replicated)."""
    if ndim == 2:
        if _matches(name, _COLUMN):
            return 0
        if _matches(name, _ROW):
            return 1
    if ndim == 1 and _matches(name, _COLUMN_BIAS):
        return 0
    return None


def replicated_sites(module: nn.Module, tp: int) -> Set[str]:
    """Module names under ``module`` whose rule cannot apply at model-axis size
    ``tp`` and which therefore stay replicated: attention whose heads do not
    divide, and GEGLU or time-embedding widths that do not (each logged)."""
    from ..models.layers import CrossAttention, GEGLUFeedForward, TimestepEmbedding

    out = set()
    if tp == 1:
        return out
    for name, m in module.named_modules():
        if isinstance(m, CrossAttention):
            if m.heads % tp:
                out.add(name)
                logger.info("tensor parallel: %s keeps its attention replicated "
                            "(%d heads over model=%d)", name, m.heads, tp)
        elif isinstance(m, GEGLUFeedForward):
            if m.net[2].in_features % tp:
                out.add(name)
                logger.info("tensor parallel: %s stays replicated (inner %d over model=%d)",
                            name, m.net[2].in_features, tp)
        elif isinstance(m, TimestepEmbedding) and name.endswith("time_embedding"):
            if m.linear_1.out_features % tp:
                out.add(name)
                logger.info("tensor parallel: %s stays replicated (%d over model=%d)",
                            name, m.linear_1.out_features, tp)
    return out


def _in_site(name: str, sites: Iterable[str]) -> bool:
    return any(name.startswith(s + ".") for s in sites)


def shard_tensor(name: str, t: torch.Tensor, tp: int, index: int) -> torch.Tensor:
    """Slice ``index`` of ``tp`` of parameter ``name`` under the rules (the
    whole tensor where it is replicated)."""
    dim = partition_dim(name, t.dim())
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} not divisible by model={tp}")
    if _matches(name, (GEGLU_PROJ + ".weight", GEGLU_PROJ + ".bias")):
        return torch.cat([h.chunk(tp, dim=0)[index] for h in t.chunk(2, dim=0)], 0).contiguous()
    return t.chunk(tp, dim=dim)[index].contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], mesh: Mesh, rank: int,
                     model_axis: str = "model",
                     replicated: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slices of a full state dict over ``mesh``'s
    ``model_axis``; the parameters of the modules named in ``replicated``
    (``replicated_sites``) stay whole."""
    tp, index = mesh.size(model_axis), mesh.coordinate_of(rank, model_axis)
    replicated = set(replicated)
    return {k: v if _in_site(k, replicated) else shard_tensor(k, v, tp, index)
            for k, v in sd.items()}


def shard_module(module: nn.Module, mesh: Mesh, model_axis: str = "model") -> nn.Module:
    """Make ``module`` (a full UNet, say) this rank's tensor-parallel part over
    ``mesh``'s ``model_axis``, in place: its parameters become this rank's
    slices and its attention, GEGLU and time-embedding modules run as
    column/row pairs over the axis's group (``models/layers``)."""
    import torch.distributed as dist

    from ..models import layers

    tp = mesh.size(model_axis)
    if tp == 1:
        return module
    keep = replicated_sites(module, tp)
    local = shard_state_dict(module.state_dict(), mesh, dist.get_rank(), model_axis, keep)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = local[name]
    layers.set_tensor_parallel(module, mesh.group(model_axis), tp, keep)
    return module


def sharded_params(module: nn.Module, tp: int) -> Dict[str, int]:
    """{parameter name: partition dim} of the parameters of a full ``module``
    that ``shard_module`` slices at model-axis size ``tp``."""
    if tp == 1:
        return {}
    keep = replicated_sites(module, tp)
    out = {}
    for name, p in module.named_parameters():
        dim = partition_dim(name, p.dim())
        if dim is not None and not _in_site(name, keep):
            out[name] = dim
    return out


def unshard_tensor(name: str, parts, dim: int) -> torch.Tensor:
    """The full parameter ``name`` from its ``tp`` slices in rank order (the
    inverse of ``shard_tensor``, GEGLU's half split included)."""
    if _matches(name, (GEGLU_PROJ + ".weight", GEGLU_PROJ + ".bias")):
        halves = [p.chunk(2, dim=0) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], 0)
    return torch.cat(list(parts), dim=dim)


@dataclasses.dataclass
class TrainSharding:
    """A train state over a mesh's model axis: the axis's ``group``, its size
    ``tp``, this rank's ``index`` on it and ``dims``, {parameter name:
    partition dim} of the sliced parameters (``sharded_params``)."""

    group: Any
    tp: int
    index: int
    dims: Dict[str, int]

    @classmethod
    def of(cls, module: nn.Module, mesh: Mesh, model_axis: str = "model") -> "TrainSharding":
        """The sharding ``shard_module(module, mesh, model_axis)`` gives a
        full ``module`` (call before sharding it)."""
        tp = mesh.size(model_axis)
        return cls(mesh.group(model_axis) if tp > 1 else None, tp,
                   mesh.coordinate(model_axis), sharded_params(module, tp))

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the full gradients: the sliced ones' squares
        summed over the group, the replicated ones' counted once."""
        def sq(names):
            parts = [grads[n].float().square().sum() for n in names]
            return torch.stack(parts).sum() if parts else torch.zeros(
                (), device=next(iter(grads.values())).device)
        sliced = collectives.all_reduce(sq([n for n in grads if n in self.dims]), self.group)
        return (sliced + sq([n for n in grads if n not in self.dims])).sqrt()

    def all_finite(self, local: torch.Tensor) -> bool:
        """Whether every rank of the group found its tensors finite
        (``local``: this rank's bool)."""
        bad = collectives.all_reduce_max((~local).float().reshape(1), self.group)
        return not bool(bad[0])

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        return t if dim is None else shard_tensor(name, t, self.tp, self.index)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        if dim is None:
            return t
        parts = collectives.all_gather(t.unsqueeze(0), self.group, 0)
        return unshard_tensor(name, parts.unbind(0), dim)


def _map_state(tree, fn):
    """``tree`` (the optimizer's state: dicts of ints and {name: tensor}) with
    ``fn(name, tensor)`` applied to each per-parameter tensor."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if isinstance(v, torch.Tensor) else _map_state(v, fn)
                for k, v in tree.items()}
    return tree


def shard_train_state(params: Mapping[str, torch.Tensor], opt_state,
                      sharding: TrainSharding):
    """(params, opt_state) of a full train state sliced for this rank."""
    def cut(name, t):
        if name in sharding.dims and t.shape != params[name].shape:
            raise ValueError(f"{name}: a factored optimizer state {tuple(t.shape)} cannot be "
                             "sliced over the model axis")
        return sharding.shard(name, t).contiguous()
    return {n: cut(n, t) for n, t in params.items()}, _map_state(opt_state, cut)


def gather_train_state(params: Mapping[str, torch.Tensor], opt_state,
                       sharding: TrainSharding):
    """(params, opt_state) of this rank's slices gathered to the full train
    state (every rank of the model group calls it, in the same order)."""
    return ({n: sharding.gather(n, t) for n, t in params.items()},
            _map_state(opt_state, sharding.gather))
