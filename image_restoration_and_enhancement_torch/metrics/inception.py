"""InceptionV3 pool3 features for FID (the port's copy of the JAX package's
``metrics/inception.py``).

torchvision's ``inception_v3`` feature extractor with its module names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``, ...),
so a torchvision state dict loads directly (``import_inception_torch_state``
drops ``fc`` and ``AuxLogits``): inference BatchNorm (eps 1e-3, running
statistics), average pools that count their padding, VALID max pools, the
ImageNet normalisation inside, 299x299 inputs in [0, 1], a [B, 2048] output.
The JAX layout's ``bn_scale/bn_bias/bn_mean/bn_var`` leaves are
``bn.weight/bias/running_mean/running_var`` here (``params_from_flax``).

In the random-init FID mode the trunk takes the port's own seeded init
(``layers.init_random_`` on a CPU generator seeded 0, then moved), so every
device holds the same weights; they are not the JAX package's random weights.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import checkpoint as ckpt
from ..device import DeviceLike, resolve_device
from ..models.layers import init_random_
from ..ops.image import full_fp32, resize
from .perceptual import fid_random_init_ok, inception_weights_path

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_BN_LEAVES = {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean",
              "running_var": "bn_var"}


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)   # counts the padding, as flax's


def _maxpool3(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionV3Features(nn.Module):
    """[B, 3, H, W] in [0,1] (ImageNet-normalized inside) -> [B, 2048] pool3
    features. Inference only: keep it in ``eval()`` mode."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = (x - self.mean) / self.std
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3(x)
        x = _maxpool3(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Weight bridges
# ---------------------------------------------------------------------------


def params_from_flax(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3Features params (flat flax paths:
    ``Mixed_5b/branch1x1/conv/kernel`` HWIO, ``.../bn_scale`` ...) -> this
    module's state dict (with each BatchNorm's ``num_batches_tracked`` at 0)."""
    leaves = {v: k for k, v in _BN_LEAVES.items()}
    out = {}
    for key, arr in flat.items():
        arr = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
        *mods, leaf = key.split("/")
        if leaf == "kernel":
            out[".".join(mods) + ".weight"] = arr.permute(3, 2, 0, 1).contiguous()
        else:
            prefix = ".".join(mods) + ".bn."
            out[prefix + leaves[leaf]] = arr
            out[prefix + "num_batches_tracked"] = torch.tensor(0)
    return out


def flax_from_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This module's state dict -> the JAX package's flat params."""
    out = {}
    for key, t in state.items():
        *mods, owner, leaf = key.split(".")
        if owner == "conv":
            out["/".join(mods + ["conv", "kernel"])] = t.permute(2, 3, 1, 0).contiguous()
        elif leaf in _BN_LEAVES:
            out["/".join(mods + [_BN_LEAVES[leaf]])] = t
    return out


def import_inception_torch_state(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state dict -> this module's state dict
    (``fc`` and ``AuxLogits`` dropped; the other names already agree)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")}


def random_init_model() -> InceptionV3Features:
    """The weights-pending trunk: the port's seeded init on a CPU generator."""
    model = InceptionV3Features()
    with torch.no_grad():
        init_random_(model, torch.Generator().manual_seed(0))
    return model.eval()


@functools.lru_cache(maxsize=2)
def _inception_model(path: str, device: str) -> InceptionV3Features:
    if os.path.exists(path):
        model = InceptionV3Features()
        model.load_state_dict(params_from_flax(ckpt.load_safetensors(path)), strict=True)
    elif fid_random_init_ok():
        model = random_init_model()
    else:
        raise RuntimeError("InceptionV3 weights not imported")
    return model.to(device).eval()


def inception_features(images: Sequence[np.ndarray], batch_size: int = 8,
                       device: DeviceLike = None) -> np.ndarray:
    """images: float [0,1] HWC arrays -> [N, 2048] float32 features. Each image
    is resized to 299x299 as the JAX package does (``jax.image.resize``
    bilinear, antialiased), on ``device``."""
    dev = resolve_device(device)
    model = _inception_model(inception_weights_path(), str(dev))
    feats = []
    with torch.inference_mode(), full_fp32():
        for i in range(0, len(images), batch_size):
            batch = torch.stack([
                resize(torch.from_numpy(np.asarray(im, np.float32)).to(dev), (299, 299),
                       "bilinear") for im in images[i: i + batch_size]])
            feats.append(model(batch.permute(0, 3, 1, 2)).cpu().numpy())
    return np.concatenate(feats, axis=0)
