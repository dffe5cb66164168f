"""CLIP text encoders (ViT-L/14, and SDXL's OpenCLIP bigG/14), in PyTorch.

Counterpart of the JAX package's ``models/clip_text.py``: pre-LayerNorm causal
transformer over 77 tokens with quick_gelu (or tanh-GELU for ``hidden_act=
"gelu"``, the bigG tower) and a final LayerNorm. Its attention is plain
PyTorch, as the JAX encoder's is plain XLA: at 77 tokens no kernel is on this
path. Returns last_hidden_state [B, 77, hidden] in fp32; with
``return_dict=True`` also what SDXL takes from its two towers: the output of
layer ``num_hidden_layers - 2`` before the final LayerNorm (fp32) and the
final-LayerNorm output at each sequence's first ``eos_token_id``, through the
bias-free ``text_projection`` when built ``with_projection`` (bigG).
"""
from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm: fp32 statistics with var = E[x^2] - E[x]^2 >= 0."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + ln.eps)
    return (y * ln.weight.float() + ln.bias.float()).to(out_dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        q = self.q_proj(x).view(b, n, self.heads, hd)
        k = self.k_proj(x).view(b, n, self.heads, hd)
        v = self.v_proj(x).view(b, n, self.heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        s = s / (hd ** 0.5) + causal_mask
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)
        return self.out_proj(o)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.quick_gelu = cfg.hidden_act == "quick_gelu"
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm(self.layer_norm1, x, x.dtype), causal_mask)
        h = self.fc1(_layer_norm(self.layer_norm2, x, x.dtype))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h, approximate="tanh")
        return x + self.fc2(h)


class CLIPTextModel(nn.Module):
    """Token ids [B, 77] (integer) -> last_hidden_state [B, 77, hidden] (fp32),
    or with ``return_dict`` {"last_hidden_state", "penultimate_hidden_state",
    "pooled"} (all fp32)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 with_projection: bool = False):
        super().__init__()
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_position_embeddings,
                                               config.hidden_size)
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(config) for _ in range(config.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.text_projection = (nn.Linear(config.hidden_size, config.hidden_size, bias=False)
                                if with_projection else None)

    def forward(self, input_ids: torch.Tensor, return_dict: bool = False
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        b, n = input_ids.shape
        x = self.token_embedding(input_ids.long()) + self.position_embedding.weight[None, :n]
        causal = torch.triu(
            torch.full((n, n), -1e9, dtype=torch.float32, device=x.device), diagonal=1)
        penultimate = None
        for i, layer in enumerate(self.layers):
            x = layer(x, causal[None, None])
            if i == cfg.num_hidden_layers - 2:
                penultimate = x.float()
        last = _layer_norm(self.final_layer_norm, x, torch.float32)
        if not return_dict:
            return last
        # the first eos position of each sequence (0 where there is none)
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos_pos.to(last.device)]
        if self.text_projection is not None:
            w = self.text_projection.weight
            pooled = self.text_projection(pooled.to(w.dtype)).float()
        return {"last_hidden_state": last, "penultimate_hidden_state": penultimate,
                "pooled": pooled}
