"""Perceptual metrics: LPIPS (AlexNet) and FID (the port's copy of the JAX
package's ``metrics/perceptual.py``).

The networks are torch modules with the parameter names of the ``lpips``
package (``net.slice1.0.weight``, ..., ``lin0.model.1.weight``) and of
torchvision's ``inception_v3`` (``metrics/inception.py``), so those state
dicts load directly (``import_lpips_torch_state`` maps the other spellings:
torchvision's ``features.N`` trunk names and ``lins.N``). The weights files
are the JAX package's, in its layout (flax paths, HWIO kernels):

    $IRET_WEIGHTS_DIR/lpips_alex.safetensors     (AlexNet trunk + LPIPS lin heads)
    $IRET_WEIGHTS_DIR/inception_v3.safetensors   (InceptionV3, pool3 head)

``params_from_flax`` / ``flax_from_params`` carry them across (the inverse
of the JAX package's torch importer). ``IRET_WEIGHTS_DIR`` (default
``weights``) is read at each call. When a file is absent, ``lpips_available()``
/ ``fid_available()`` are False and evaluation skips the metric;
``IRET_FID_RANDOM_INIT=1`` runs FID on a seeded random trunk, a number that is
not a comparable FID (evaluation keys it ``fid_random_init_weights_pending``).

As in the JAX package, LPIPS takes the absolute value of the lin weights, and
the unit normalisation is x / sqrt(sum x^2 + 1e-10). The networks run in full
fp32 (``ops.image.full_fp32``) on every device.
"""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..core import checkpoint as ckpt
from ..device import DeviceLike, resolve_device
from ..ops.image import full_fp32

LPIPS_FILE = "lpips_alex.safetensors"
INCEPTION_FILE = "inception_v3.safetensors"

# ImageNet normalization used by LPIPS's scaling layer.
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)

# torchvision alexnet.features index -> (lpips slice, JAX conv name)
_ALEX_CONVS = {0: (1, "conv1"), 3: (2, "conv2"), 6: (3, "conv3"), 8: (4, "conv4"),
               10: (5, "conv5")}
_SLICES = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))


def weights_dir() -> str:
    return os.environ.get("IRET_WEIGHTS_DIR", "weights")


def lpips_weights_path() -> str:
    return os.path.join(weights_dir(), LPIPS_FILE)


def inception_weights_path() -> str:
    return os.path.join(weights_dir(), INCEPTION_FILE)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's feature trunk in lpips's five slices (torchvision's
    layer indices); returns the five ReLU taps. NCHW."""

    def __init__(self):
        super().__init__()
        layers = [nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
                  nn.MaxPool2d(3, stride=2),
                  nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
                  nn.MaxPool2d(3, stride=2),
                  nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
                  nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
                  nn.Conv2d(256, 256, 3, padding=1), nn.ReLU()]
        for k, (lo, hi) in enumerate(_SLICES, start=1):
            s = nn.Sequential()
            for i in range(lo, hi):
                s.add_module(str(i), layers[i])
            setattr(self, f"slice{k}", s)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for k in range(1, 6):
            x = getattr(self, f"slice{k}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """lpips's 1x1 head (dropout, then a bias-free 1x1 conv to one channel)."""

    # the JAX model's self.param(f"lin{i}", ones, ...)
    flax_init = {"model.1.weight": ("constant", 1.0)}

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPSAlex(nn.Module):
    """LPIPS distance: unit-normalized feature differences weighted by |lin|,
    spatial mean, layer sum. Images in [-1, 1], NCHW; returns [B]."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.net = AlexNetFeatures()
        for i, c in enumerate((64, 192, 384, 256, 256)):
            setattr(self, f"lin{i}", NetLinLayer(c))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.net((a - self.shift) / self.scale)
        fb = self.net((b - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt((xa**2).sum(dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt((xb**2).sum(dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.abs()          # [1, C, 1, 1]
            total = total + (w * (na - nb) ** 2).sum(dim=1).mean(dim=(1, 2))
        return total


# ---------------------------------------------------------------------------
# Weight bridges
# ---------------------------------------------------------------------------


def params_from_flax(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPSAlex params (flat flax paths: ``alex/conv1/kernel``
    HWIO, ``lin0`` [C]) -> this module's state dict."""
    names = {jax_name: (k, idx) for idx, (k, jax_name) in _ALEX_CONVS.items()}
    out = {}
    for key, arr in flat.items():
        arr = torch.as_tensor(np.asarray(arr)) if not torch.is_tensor(arr) else arr
        parts = key.split("/")
        if parts[0] == "alex":
            k, idx = names[parts[1]]
            leaf = "weight" if parts[2] == "kernel" else "bias"
            out[f"net.slice{k}.{idx}.{leaf}"] = \
                arr.permute(3, 2, 0, 1).contiguous() if leaf == "weight" else arr
        elif re.fullmatch(r"lin\d", parts[0]):
            out[f"{parts[0]}.model.1.weight"] = arr.reshape(1, -1, 1, 1)
        else:
            raise KeyError(f"unexpected LPIPS parameter {key}")
    return out


def flax_from_params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This module's state dict -> the JAX package's flat LPIPSAlex params."""
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] == "net":
            name = _ALEX_CONVS[int(parts[2])][1]
            leaf = "kernel" if parts[3] == "weight" else "bias"
            out[f"alex/{name}/{leaf}"] = t.permute(2, 3, 1, 0).contiguous() \
                if leaf == "kernel" else t
        else:
            out[parts[0]] = t.reshape(-1)
    return out


def import_lpips_torch_state(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A state dict of the ``lpips`` package (or a torchvision AlexNet trunk
    under ``features.N`` / ``net.features.N``, and heads under ``linN`` or
    ``lins.N``) -> this module's state dict. Other keys (the scaling layer's
    buffers, the classifier) are dropped."""
    slice_of = {i: k for k, (lo, hi) in enumerate(_SLICES, start=1) for i in range(lo, hi)}
    out = {}
    for key, arr in state.items():
        t = torch.as_tensor(np.asarray(arr))
        parts = key.split(".")
        if "features" in parts:
            idx = int(parts[parts.index("features") + 1])
            if idx in _ALEX_CONVS:
                out[f"net.slice{slice_of[idx]}.{idx}.{parts[-1]}"] = t
        elif re.search(r"slice\d\.", key):
            out["net." + key[key.index("slice"):]] = t
        elif ".model." in key and key.endswith("weight"):
            n = parts[1] if parts[0] == "lins" else parts[0].replace("lin", "")
            out[f"lin{n}.model.1.weight"] = t
    return out


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------


def lpips_available() -> bool:
    return os.path.exists(lpips_weights_path())


def load_lpips(path: str, device: DeviceLike = None) -> LPIPSAlex:
    """An LPIPSAlex on ``device`` (``cuda`` unless ``"cpu"``) from a JAX-layout file."""
    model = LPIPSAlex()
    model.load_state_dict(params_from_flax(ckpt.load_safetensors(path)), strict=True)
    return model.to(resolve_device(device)).eval()


def save_lpips(model: LPIPSAlex, path: str) -> None:
    """Write ``model`` in the JAX layout that ``load_lpips`` and the JAX
    package's ``load_params`` read."""
    ckpt.save_safetensors(flax_from_params(model.state_dict()), path)


@functools.lru_cache(maxsize=2)
def _lpips_model(path: str, device: str) -> LPIPSAlex:
    return load_lpips(path, device)


def lpips_pairs(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray],
                device: DeviceLike = None) -> List[float]:
    """LPIPS per pair; inputs float [0,1] HWC (converted to [-1,1])."""
    dev = resolve_device(device)
    model = _lpips_model(lpips_weights_path(), str(dev))

    def nchw(x):
        return torch.from_numpy(np.asarray(x, np.float32) * 2.0 - 1.0).to(dev) \
            .permute(2, 0, 1)[None]

    out = []
    with torch.inference_mode(), full_fp32():
        for p, g in zip(preds, gts):
            out.append(float(model(nchw(p), nchw(g))[0]))
    return out


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------


def fid_available() -> bool:
    return os.path.exists(inception_weights_path())


def fid_random_init_ok() -> bool:
    """Opt-in (``IRET_FID_RANDOM_INIT=1``): run the full FID path on a seeded
    random InceptionV3 when the imported weights are absent. The number is NOT
    a comparable FID; callers label it as weights-pending."""
    return os.environ.get("IRET_FID_RANDOM_INIT") == "1"


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """Frechet distance between two Gaussians (host-side sqrtm, as the
    reference does via scipy.linalg.sqrtm; called without ``disp``, which
    SciPy 1.18 removes: the same matrix square root)."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = feats1.mean(0), np.cov(feats1, rowvar=False)
    mu2, s2 = feats2.mean(0), np.cov(feats2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def fid(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray],
        device: DeviceLike = None) -> float:
    """Dataset FID via InceptionV3 pool3 features (imported weights, or the
    explicit IRET_FID_RANDOM_INIT=1 weights-pending mode)."""
    if not fid_available() and not fid_random_init_ok():
        raise RuntimeError("InceptionV3 weights not imported; FID unavailable")
    from .inception import inception_features

    return fid_from_features(inception_features(preds, device=device),
                             inception_features(gts, device=device))

