"""RRDBNet, Real-ESRGAN's x4 generator, in PyTorch.

Counterpart of the JAX package's ``models/rrdbnet.py``: 23 Residual-in-Residual
Dense Blocks of 64 features (growth 32, LeakyReLU 0.2, 0.2-scaled residuals),
then two nearest x2 upsamples, each followed by a conv. The parameter names are
Real-ESRGAN's (``conv_first``, ``body.N.rdbM.convK``, ``conv_body``,
``conv_up1/2``, ``conv_hr``, ``conv_last``), so a Real-ESRGAN state dict loads
with a strict ``load_state_dict``.

The pipeline serves it between the SD img2img path and LANCZOS when
``$IRET_WEIGHTS_DIR/realesrgan_x4.safetensors`` exists. That file is in the
JAX layout (flax paths such as ``body_0/rdb1/conv1/kernel`` in a flat
safetensors file); ``load_weights`` reads it with the port's own reader and
maps it through the weight bridge, and ``save_weights`` writes it. No kernel
of the port is on this path: its convs are cuDNN's on the card.
"""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import checkpoint as ckpt
from ..device import DeviceLike, resolve_device

WEIGHTS_FILE = "realesrgan_x4.safetensors"


def weights_path() -> str:
    return os.path.join(os.environ.get("IRET_WEIGHTS_DIR", "weights"), WEIGHTS_FILE)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class DenseBlock(nn.Module):
    """5-conv dense block with a 0.2-scaled residual."""

    def __init__(self, features: int = 64, growth: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", _conv(features + i * growth, growth))
        self.conv5 = _conv(features + 4 * growth, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(_lrelu(conv(torch.cat(feats, dim=1))))
        return x + 0.2 * self.conv5(torch.cat(feats, dim=1))


class RRDB(nn.Module):
    def __init__(self, features: int = 64, growth: int = 32):
        super().__init__()
        self.rdb1 = DenseBlock(features, growth)
        self.rdb2 = DenseBlock(features, growth)
        self.rdb3 = DenseBlock(features, growth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """x4 SR generator: RGB in [0, 1], NHWC [B, H, W, 3] -> [B, 4H, 4W, 3] (fp32)."""

    def __init__(self, num_blocks: int = 23, features: int = 64, growth: int = 32):
        super().__init__()
        self.conv_first = _conv(3, features)
        self.body = nn.ModuleList(RRDB(features, growth) for _ in range(num_blocks))
        self.conv_body = _conv(features, features)
        self.conv_up1 = _conv(features, features)
        self.conv_up2 = _conv(features, features)
        self.conv_hr = _conv(features, features)
        self.conv_last = _conv(features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_first.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feat = self.conv_first(x)
        body = feat
        for block in self.body:
            body = block(body)
        feat = feat + self.conv_body(body)
        for conv in (self.conv_up1, self.conv_up2):
            feat = _lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(feat)))
        return out.permute(0, 2, 3, 1).float()


_FLAX_BODY = re.compile(r"^body_(\d+)\.")
_TORCH_BODY = re.compile(r"^body/(\d+)/")


def params_from_flax(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """JAX-layout RRDBNet params (flax paths) -> Real-ESRGAN names."""
    return {_FLAX_BODY.sub(r"body.\1.", k): v for k, v in ckpt.params_from_flax(flat).items()}


def flax_from_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Real-ESRGAN names -> JAX-layout flax paths (inverse of ``params_from_flax``)."""
    return {_TORCH_BODY.sub(r"body_\1/", k): v for k, v in ckpt.flax_from_params(state).items()}


def import_rrdb_torch_state(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A Real-ESRGAN torch state dict (arrays or tensors) -> this module's state
    dict. The names already agree, so this only makes tensors; a strict
    ``load_state_dict`` then rejects any name that does not."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}


def load_weights(path: str, device: DeviceLike = None) -> RRDBNet:
    """An fp32 RRDBNet on ``device`` (``cuda`` unless ``"cpu"``) from a JAX-layout file."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = RRDBNet()
    model = model.to_empty(device=dev).to(memory_format=torch.channels_last).eval()
    model.load_state_dict(params_from_flax(ckpt.load_safetensors(path)), strict=True)
    return model


def save_weights(model: RRDBNet, path: str) -> None:
    """Write ``model`` in the JAX layout that ``load_weights`` and the JAX
    package's ``load_params`` read."""
    ckpt.save_safetensors(flax_from_params(model.state_dict()), path)


def weights_available() -> bool:
    return os.path.exists(weights_path())


@functools.lru_cache(maxsize=1)
def _model(path: str, device: str) -> RRDBNet:
    return load_weights(path, device)


def upscale_x4(img01: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """float [0, 1] HWC -> the x4 upscale in [0, 1]; needs the weights file."""
    dev = resolve_device(device)
    model = _model(weights_path(), str(dev))
    with torch.inference_mode():
        out = model(torch.from_numpy(np.asarray(img01, np.float32))[None].to(dev))[0]
    return out.clamp(0.0, 1.0).cpu().numpy()
