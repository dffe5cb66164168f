"""Shared PyTorch building blocks for the UNet and VAE.

Counterparts of the JAX package's ``models/layers.py``. Parameter names are the
diffusers names that ``export_torch_state_dict`` gives the JAX parameters, so a
state dict bridged from the JAX package loads with ``strict=True``.

Layout: 2-D blocks take and return NCHW-shaped tensors kept in the
``channels_last`` memory format, which is NHWC in memory. ``nchw.permute(0, 2,
3, 1)`` is then a contiguous NHWC view, so the NHWC GroupNorm kernel and the
token reshape of Transformer2D cost no copy.

Quantized layers: ``QConv2d`` and ``QLinear`` are ``nn.Conv2d`` and
``nn.Linear`` with the same parameters, used exactly where the JAX blocks use
``QConv`` and ``QDense``; each carries ``site``, its JAX flax module path. With
no quantization state, or one whose mode is None, they are the plain layers.
Under mode ``"int8"``/``"int8_static"`` (``ops/quant.py``) they compute w8a8
with exact int32 sums: a 3x3 stride-1 conv through ``conv3x3_same_int8`` (K3
on the card), every other conv and Linear through ``quant.int_matmul``. The s8
weights and scales are made once and cached on the layer (not in its
``state_dict``), and made again if the weight changes. Under a mesh the scales
are global (``ops/quant.py``): a row-parallel ``QLinear`` (``row_group``) sums
its s32 partial products over the model group exactly and dequantizes after
the sum, and a ``QConv2d`` on a height-sharded level exchanges s8 halo rows.

Multi-device serving (``parallel/``): under an active height-sharding policy
(``parallel/spatial.py``) the 3x3 convs (``Conv2d``, ``QConv2d``) exchange halo
rows, GroupNorm takes global statistics, self-attention gathers K and V, and the
up- and downsamplers move the level's layout across the gate; with no policy
they are the plain layers. ``set_tensor_parallel`` turns the UNet's attention,
GEGLU feed-forwards and time-embedding MLP into Megatron column/row pairs over a
model group (``parallel/sharding_rules.py``): the row-parallel products are
summed over the group in fp32 and take their bias once, after the sum. Under
autograd the column-parallel inputs go through ``collectives.copy_to_group`` and
the row-parallel sums through ``reduce_from_group``, so the backward pass sums
the input gradients over the group.

Numerics kept from the JAX blocks:
- GEGLU gates with the tanh-approximated GELU (flax ``nn.gelu`` default), not
  diffusers' erf GELU.
- GroupNorm eps is 1e-5 in UNet resnets and 1e-6 in the Transformer2D norm and
  everywhere in the VAE; LayerNorm uses E[x^2] - E[x]^2 clamped at 0.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.checkpoint import flax_module_path
from ..ops import quant, token_merge
from ..ops.attention import attention
from ..ops.conv_int8 import conv3x3_same_int8
from ..ops.groupnorm import group_norm
from ..parallel import collectives, spatial

CL = torch.channels_last


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped -> contiguous NHWC (a view when x is channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW-shaped channels_last view."""
    return x.permute(0, 3, 1, 2)


class _Quantized:
    """What QConv2d and QLinear share: the state, the site, the s8 weight cache."""

    site: Optional[str] = None
    quant: Optional[quant.QuantState] = None
    row_group = None  # the model group of a row-parallel layer
    _wq: Optional[tuple] = None

    def set_quant(self, state: Optional[quant.QuantState]) -> None:
        self.quant = state
        if state is not None and state.active:
            self.quantized_weight()

    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s8 weight, fp32 scale [O]): OHWI for a conv, [O, I] for a Linear."""
        w = self.weight
        # the shape too: a rank's first slice of a sharded weight starts
        # where the whole weight did
        key = (w.data_ptr(), w._version, w.device, w.shape)
        if self._wq is None or self._wq[0] != key:
            wq, s = quant.quantize_weight_out_channel(w, self.row_group)
            if wq.dim() == 4:
                wq = wq.permute(0, 2, 3, 1).contiguous()
            self._wq = (key, wq, s)
        return self._wq[1], self._wq[2]

    def _quantized(self) -> bool:
        return self.quant is not None and self.quant.active

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """y (channels last) + bias, added in y's dtype as flax adds it."""
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QLinear(_Quantized, nn.Linear):
    """``nn.Linear`` that runs w8a8 under an active quantization state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._quantized():
            return super().forward(x)
        xq, sx = self.quant.quantize_activation(x, self.site)
        wq, sw = self.quantized_weight()
        acc = quant.int_matmul(xq.reshape(-1, xq.shape[-1]), wq.t())
        y = quant.dequantize(acc, sx, sw, x.dtype).view(*x.shape[:-1], -1)
        return self._add_bias(y)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that follows an active height-sharding policy
    (``parallel/spatial.conv``: halo rows, the level's layout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.active() is None:
            return super().forward(x)
        return spatial.conv(self, x)


class QConv2d(_Quantized, Conv2d):
    """``Conv2d`` that runs w8a8 under an active quantization state. Under a
    height-sharding policy the input is quantized with the global scale and
    its s8 rows take the halo geometry of ``spatial.conv``
    (``spatial.int8_conv``): the 3x3 stride-1 site reaches K3 with one halo
    row above and below as its padded input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._quantized():
            return super().forward(x)
        if self.groups != 1 or self.dilation != (1, 1) or self.padding_mode != "zeros":
            raise NotImplementedError("int8 convs take groups=1, no dilation, zero padding")
        xq, sx = self.quant.quantize_activation(to_nhwc(x), self.site)
        wq, sw = self.quantized_weight()
        (kh, kw), (sh, sw_), (ph, pw) = self.kernel_size, self.stride, self.padding

        def run(rows: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
            """The conv of s8 NHWC ``rows`` padded by ``top`` and ``bottom``
            zero rows (and ``pw`` columns on each side)."""
            xp = F.pad(rows, (0, 0, pw, pw, top, bottom))
            if (kh, kw, sh, sw_, pw) == (3, 3, 1, 1, 1):
                return conv3x3_same_int8(xp, wq.permute(1, 2, 3, 0), sw * sx, out_dtype=x.dtype)
            b, hp, wp, _ = xp.shape
            ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw_ + 1
            taps = [xp[:, dy:dy + sh * (ho - 1) + 1:sh, dx:dx + sw_ * (wo - 1) + 1:sw_, :]
                    for dy in range(kh) for dx in range(kw)]
            cols = torch.cat(taps, dim=-1).view(b * ho * wo, -1)
            acc = quant.int_matmul(cols, wq.reshape(wq.shape[0], -1).t())
            return quant.dequantize(acc, sx, sw, x.dtype).view(b, ho, wo, -1)

        if spatial.active() is None or kh == 1:
            y = run(xq, ph, ph)
        else:
            y = spatial.int8_conv(run, xq, sh, ph)
        return from_nhwc(self._add_bias(y))


def set_quant(root: nn.Module, state: Optional[quant.QuantState]) -> None:
    """Hand ``state`` to every quantized layer under ``root`` (None: plain)."""
    for m in root.modules():
        if isinstance(m, _Quantized):
            m.set_quant(state)


def set_tome(root: nn.Module, state: Optional[token_merge.TomeState]) -> None:
    """Hand the ToMe policy ``state`` to every transformer block under ``root``
    (None: off)."""
    for m in root.modules():
        if isinstance(m, BasicTransformerBlock):
            m.tome = state


def set_attn_int8(root: nn.Module, min_tokens: int = 0) -> None:
    """Send every default-backend attention call under ``root`` (UNet sites
    and the VAE's mid-block) whose Nq and Nk are at least ``min_tokens`` to
    the plain s8 Q.K^T / P.V attention (``ops/attention.attention``'s
    ``int8_min``). 0 turns it off."""
    for m in root.modules():
        if isinstance(m, (CrossAttention, VAEAttentionBlock)):
            m.attn_int8_min = int(min_tokens)


def set_tensor_parallel(root: nn.Module, group, tp: int, replicated=()) -> None:
    """Mark the attention, GEGLU feed-forward and time-embedding modules under
    ``root`` as tensor parallel over ``group`` (``tp`` ranks): their weights
    must already be this rank's slices (``parallel/sharding_rules.py``).
    Attention keeps heads / tp local heads. The modules named in
    ``replicated`` stay whole."""
    replicated = set(replicated)
    for name, m in root.named_modules():
        if name in replicated:
            continue
        if isinstance(m, CrossAttention):
            m.heads //= tp
            m.tp_group = m.to_out[0].row_group = group
        elif isinstance(m, GEGLUFeedForward):
            m.tp_group = m.net[2].row_group = group
        elif isinstance(m, TimestepEmbedding) and name.endswith("time_embedding"):
            m.tp_group = group


def row_parallel(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel Linear: this rank's slice of the input dim times its
    slice of the weight, summed over ``group`` in fp32
    (``collectives.reduce_from_group``), then the bias once. A quantized
    layer sums its exact s32 partial products over ``group`` and dequantizes
    the sum with the global scales: bitwise the unsharded ``QLinear``."""
    if isinstance(layer, _Quantized) and layer._quantized():
        with collectives.sharded_over(group):  # the input's features are sharded
            xq, sx = layer.quant.quantize_activation(x, layer.site)
        wq, sw = layer.quantized_weight()
        acc = quant.int_matmul(xq.reshape(-1, xq.shape[-1]), wq.t())
        acc = collectives.all_reduce(acc, group)
        return layer._add_bias(quant.dequantize(acc, sx, sw, x.dtype).view(*x.shape[:-1], -1))
    y = collectives.reduce_from_group(F.linear(x, layer.weight).float(), group)
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(x.dtype)


def assign_sites(root: nn.Module) -> None:
    """Give every quantized layer under ``root`` its flax module path as site."""
    for name, m in root.named_modules():
        if isinstance(m, _Quantized):
            m.site = flax_module_path(name)


class FusedGroupNorm(nn.Module):
    """GroupNorm with optional fused SiLU on the port's group_norm op."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = group_norm if spatial.sharded() is None else spatial.group_norm
        return from_nhwc(norm(to_nhwc(x), self.weight, self.bias, self.groups, self.eps,
                              self.act))


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics, var = E[x^2] - E[x]^2 >= 0."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        w = torch.rsqrt(var + self.eps) * self.weight.float()
        b = self.bias.float() - mean * w
        return (xf * w + b).to(x.dtype)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0, max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers semantics): [B] -> [B, dim] fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """``tp_group`` (``set_tensor_parallel``): linear_1 column, linear_2 row parallel."""

    tp_group = None

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            t_emb = collectives.copy_to_group(t_emb, self.tp_group)
        h = F.silu(self.linear_1(t_emb))
        return self.linear_2(h) if self.tp_group is None else \
            row_parallel(self.linear_2, h, self.tp_group)


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> Conv3x3, time-conditioned, with skip projection."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = FusedGroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = QConv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels else None
        )
        self.norm2 = FusedGroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = QConv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            QConv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and t_emb is not None:
            h = h + self.time_emb_proj(F.silu(t_emb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample then Conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = spatial.upsampled(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv(x.contiguous(memory_format=CL))


class CrossAttention(nn.Module):
    """Multi-head attention over tokens [B, N, C]; self-attention when context is None.
    ``attention_backend`` selects the attention function (``ops/attention.py``);
    ``attn_int8_min`` (``set_attn_int8``) is its ``int8_min``. Under tensor
    parallelism (``tp_group``) the module holds ``heads`` local heads, its
    inputs reach the column-parallel Q/K/V through ``copy_to_group``, an int8
    attention's scales are maxed over the group, and its output projection is
    row parallel; on a height-sharded level self-attention takes every
    shard's K and V."""

    attn_int8_min: int = 0
    tp_group = None

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, attention_backend: Optional[str] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.attention_backend = attention_backend
        self.to_q = QLinear(query_dim, inner, bias=False)
        self.to_k = QLinear(context_dim or query_dim, inner, bias=False)
        self.to_v = QLinear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([QLinear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp_group is not None:
            x = collectives.copy_to_group(x, self.tp_group)
            if context is not None:
                context = collectives.copy_to_group(context, self.tp_group)
        ctx = x if context is None else context
        b, nq, _ = x.shape
        nk = ctx.shape[1]
        k, v = self.to_k(ctx), self.to_v(ctx)
        if context is None:
            k, v = spatial.gather_tokens(k), spatial.gather_tokens(v)
            nk = k.shape[1]
        q = self.to_q(x).view(b, nq, self.heads, self.head_dim)
        k = k.view(b, nk, self.heads, self.head_dim)
        v = v.view(b, nk, self.heads, self.head_dim)
        with collectives.sharded_over(self.tp_group):
            o = attention(q, k, v, self.attention_backend, self.attn_int8_min)
        o = o.reshape(b, nq, self.heads * self.head_dim)
        if self.tp_group is not None:
            return row_parallel(self.to_out[0], o, self.tp_group)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QLinear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` / ``net.2`` are the diffusers names.
    Under tensor parallelism (``tp_group``) ``net.0.proj`` holds this rank's
    hidden and gate rows and ``net.2`` is row parallel."""

    tp_group = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), QLinear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            x = collectives.copy_to_group(x, self.tp_group)
        h = self.net[0](x)
        if self.tp_group is not None:
            return row_parallel(self.net[2], h, self.tp_group)
        return self.net[2](h)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, all residual.

    ``tome`` (``set_tome``): under an active policy, self-attention at a site
    of at least ``tome.min_tokens`` tokens runs on the merged tokens
    (``ops/token_merge.py``), matched on the block input ``x`` (not on
    ``norm1(x)``, as in the JAX block); ``hw`` is the token grid.
    ``cfg_dedup``: ``x`` arrives at half the context batch (the shared CFG
    prefix); self-attention runs on it and the batch is duplicated as
    [x; x] just before the cross-attention."""

    tome: Optional[token_merge.TomeState] = None

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 attention_backend: Optional[str] = None):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim, None, attention_backend)
        self.norm2 = FusedLayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim, attention_backend)
        self.norm3 = FusedLayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, cfg_dedup: bool = False,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        n1 = self.norm1(x)
        if self.tome is not None and hw is not None and self.tome.applies(x.shape[1]):
            r = token_merge.merge_count(hw[0], hw[1], self.tome.ratio)
            merge, unmerge, _ = token_merge.build_merge(x, hw[0], hw[1], r)
            x = x + unmerge(self.attn1(merge(n1)))
        else:
            x = x + self.attn1(n1)
        if cfg_dedup:
            x = torch.cat([x, x], dim=0)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GroupNorm, proj in, transformer blocks, proj out,
    residual. SD-1.5 projects with 1x1 convs; ``use_linear_projection`` (SDXL)
    with Linear layers on the flattened tokens, as in the JAX block (both
    keep their flax sites, ``.../proj_in`` and ``.../proj_out``).
    ``cfg_dedup``: ``x`` arrives at half the context batch; block 0
    duplicates it after its self-attention and the rest runs at the full
    batch, the residual duplicated to match."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, groups: int = 32, attention_backend: Optional[str] = None,
                 use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        proj = (lambda: QLinear(channels, channels)) if use_linear_projection \
            else (lambda: QConv2d(channels, channels, 1))
        self.norm = FusedGroupNorm(channels, groups, eps=1e-6)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, head_dim, context_dim, attention_backend)
            for _ in range(depth)
        )
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cfg_dedup: bool = False) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        if self.use_linear_projection:
            t = self.proj_in(to_nhwc(y).view(b, h * w, c))
        else:
            t = to_nhwc(self.proj_in(y)).view(b, h * w, c)
        for i, block in enumerate(self.transformer_blocks):
            t = block(t, context, cfg_dedup and i == 0, (h, w))
        out_b = t.shape[0]
        if self.use_linear_projection:
            y = from_nhwc(self.proj_out(t).view(out_b, h, w, c))
        else:
            y = self.proj_out(from_nhwc(t.view(out_b, h, w, c)))
        if cfg_dedup:
            x = torch.cat([x, x], dim=0)
        return y + x


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over spatial tokens (VAE mid block), on the
    default attention backend; ``attn_int8_min`` as in ``CrossAttention``."""

    attn_int8_min: int = 0

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = FusedGroupNorm(channels, groups, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = to_nhwc(self.group_norm(x)).view(b, h * w, 1, c)
        q = self.to_q(y)
        k, v = spatial.gather_tokens(self.to_k(y)), spatial.gather_tokens(self.to_v(y))
        o = attention(q, k, v, None, self.attn_int8_min)
        o = o.view(b, h * w, c)
        o = self.to_out[0](o).view(b, h, w, c)
        return x + from_nhwc(o)


# The std of N(0, 1) truncated to [-2, 2]: flax's lecun_normal divides its
# scale by it, so a truncated draw keeps the variance 1/fan_in.
TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` with the distribution that the
    JAX package's flax ``init`` draws its counterpart from:

    - a Conv or Linear weight (a flax Conv/Dense kernel): ``lecun_normal``,
      N(0, s^2) truncated to [-2s, 2s] with s = 1 / (sqrt(fan_in) *
      ``TRUNCATED_NORMAL_STD``) and fan_in = in * kh * kw;
    - an ``nn.Embedding`` weight: N(0, 1/features), flax ``nn.Embed``'s
      default;
    - norm scales 1 and biases 0;
    - a parameter that its module names in a ``flax_init`` class attribute
      ({name: ("normal", std) or ("constant", value)}): that initializer, the
      one the JAX module names in its ``self.param(...)``.

    Only the distributions are JAX's; the draws are not. Values are drawn in
    fp32 on the parameter's device (``generator`` must be on it) and then
    cast."""
    rules = {id(m.weight): ("normal", m.embedding_dim ** -0.5)
             for m in module.modules() if isinstance(m, nn.Embedding)}
    for m in module.modules():  # named initializers over the defaults
        for name, rule in getattr(m, "flax_init", {}).items():
            rules[id(m.get_parameter(name))] = rule

    def draw(p: torch.Tensor) -> torch.Tensor:
        return torch.empty(p.shape, dtype=torch.float32, device=p.device)

    for name, p in module.named_parameters():
        kind, value = rules.get(id(p), (None, None))
        if kind == "constant":
            p.fill_(value)
        elif kind == "normal":
            p.copy_(draw(p).normal_(0.0, value, generator=generator))
        elif kind is not None:
            raise ValueError(f"{name}: unknown initializer {kind!r}")
        elif name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            scale = 1.0 / (math.sqrt(p[0].numel()) * TRUNCATED_NORMAL_STD)
            w = nn.init.trunc_normal_(draw(p), 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(w * scale)
    return module
