"""Checkpoint I/O for the port: its own safetensors reader and writer, the JAX
pipeline directory layout, the weight bridge between flax paths and the
port's (diffusers) parameter names, and the import of a diffusers pipeline
directory.

Pipeline directory (as the JAX package's ``core/checkpoint.py`` writes it)::

    <dir>/model_index.json                 {"components": [...], "config": {...}}
    <dir>/<component>/model.safetensors     flax paths as keys, e.g.
                                            "down_blocks_0/resnets_0/conv1/kernel"

Conv kernels are HWIO and Dense kernels [in, out] there; ``params_from_flax``
renames and transposes them to the port's state dict (OIHW convs, [out, in]
Linear weights), and ``flax_from_params`` is its inverse. A kernel's rank
tells the two apart, as in the JAX package's ``export_torch_state_dict``: a
Transformer2D's ``proj_in``/``proj_out`` is a 4-D 1x1 conv in SD-1.5 and a
2-D Linear in SDXL under the same name. An SDXL pipeline directory also holds
``text_encoder_2`` (the bigG tower, with its ``text_projection``); the
diffusers import reads no second tower, as in the JAX package.

A diffusers directory (``unet/`` and ``vae/diffusion_pytorch_model.safetensors``,
``text_encoder/model.safetensors`` from transformers) already uses the port's
names, apart from transformers' CLIP prefixes; ``import_hf_pipeline`` reads it
with the reader below (the counterpart of the JAX package's
``load_torch_safetensors``).

The safetensors format is an 8-byte little-endian header length, a JSON header
of {name: {dtype, shape, data_offsets}}, then the raw bytes. The reader and
writer below handle F32, F16, BF16 (and I64) with ``torch.frombuffer``, so neither the
safetensors package nor numpy's missing bfloat16 is needed. Saves make every
tensor contiguous and read the file back to verify it, as the JAX package's
``save_params`` does.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

TensorLike = Union[torch.Tensor, np.ndarray]

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64}  # I64: transformers' position_ids buffer
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
COMPONENTS = ("unet", "vae", "text_encoder", "text_encoder_2")  # the last: SDXL's bigG

# ---------------------------------------------------------------------------
# safetensors reader / writer
# ---------------------------------------------------------------------------


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into CPU tensors."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            # One buffer per tensor: offsets in the file need not be multiples
            # of the element size, a fresh buffer is aligned.
            buf = bytearray(end - start)
            f.seek(8 + n + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name} is truncated")
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, TensorLike], path: str) -> None:
    """Write tensors (contiguous, on the host), then read the file back and
    compare every tensor: a write that does not read back equal raises."""
    host = {k: torch.as_tensor(v).detach().to("cpu").contiguous() for k, v in tensors.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(host):
        t = host[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name} has unsupported dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)
    reread = load_safetensors(path)
    bad = [k for k, t in host.items() if k not in reread or not torch.equal(reread[k], t)]
    if bad:
        raise RuntimeError(f"checkpoint write verification failed for {len(bad)} "
                           f"tensors in {path} (first: {bad[0]})")


# ---------------------------------------------------------------------------
# Weight bridge: flax paths <-> diffusers names
# ---------------------------------------------------------------------------

_INDEXED = re.compile(
    r"\b(down_blocks|up_blocks|resnets|attentions|transformer_blocks|"
    r"downsamplers|upsamplers|layers)_(\d+)"
)
_DOTTED = re.compile(
    r"\b(down_blocks|up_blocks|resnets|attentions|transformer_blocks|"
    r"downsamplers|upsamplers|layers)\.(\d+)"
)


def _torch_module_name(flax_prefix: str) -> str:
    name = _INDEXED.sub(r"\1.\2", flax_prefix.replace("/", "."))
    name = name.replace("ff.proj_in", "ff.net.0.proj").replace("ff.proj_out", "ff.net.2")
    if name.endswith("to_out"):
        name += ".0"
    return name


def flax_module_path(torch_name: str) -> str:
    """A module's dotted name in the port -> its flax module path (the inverse
    of ``_torch_module_name``): ``down_blocks.0.attentions.0.proj_in`` ->
    ``down_blocks_0/attentions_0/proj_in``, ``...to_out.0`` -> ``.../to_out``,
    ``ff.net.0.proj`` -> ``ff/proj_in``, ``ff.net.2`` -> ``ff/proj_out``."""
    mod = torch_name
    if mod.endswith("to_out.0"):
        mod = mod[: -len(".0")]
    mod = mod.replace("ff.net.0.proj", "ff.proj_in").replace("ff.net.2", "ff.proj_out")
    return _DOTTED.sub(r"\1_\2", mod).replace(".", "/")


def params_from_flax(flat: Mapping[str, TensorLike]) -> Dict[str, torch.Tensor]:
    """Flax-path params of one component -> the port's state dict.

    The renaming rules of the JAX package's ``export_torch_state_dict``: ``_N``
    -> ``.N`` for indexed module lists, ``ff.proj_in`` -> ``ff.net.0.proj``,
    ``ff.proj_out`` -> ``ff.net.2``, ``to_out`` -> ``to_out.0``, ``scale`` and
    ``embedding`` -> ``weight``; HWIO conv kernels -> OIHW; Dense kernels
    transposed.
    """
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        t = torch.as_tensor(arr)
        prefix, _, leaf = path.rpartition("/")
        if leaf == "position_embedding":
            out["position_embedding.weight"] = t
            continue
        name = _torch_module_name(prefix)
        if leaf in ("scale", "embedding"):
            out[f"{name}.weight"] = t
        elif leaf == "kernel":
            out[f"{name}.weight"] = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
        else:
            out[f"{name}.{leaf}"] = t
    return {k: v.contiguous() for k, v in out.items()}


def flax_from_params(state: Mapping[str, torch.Tensor], norm_modules=()) -> Dict[str, torch.Tensor]:
    """The port's state dict of one component -> flax-path params (the inverse
    of ``params_from_flax``). ``norm_modules`` names the modules whose
    ``weight`` is a flax ``scale``; embeddings are recognised by name."""
    norm_modules = set(norm_modules)
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name == "position_embedding.weight":
            out["position_embedding"] = t
            continue
        mod, _, leaf = name.rpartition(".")
        path = flax_module_path(mod)
        if leaf == "bias":
            out[f"{path}/bias"] = t
        elif mod == "token_embedding":
            out[f"{path}/embedding"] = t
        elif mod in norm_modules:
            out[f"{path}/scale"] = t
        elif t.dim() == 4:
            out[f"{path}/kernel"] = t.permute(2, 3, 1, 0)
        else:
            out[f"{path}/kernel"] = t.T
    return {k: v.contiguous() for k, v in out.items()}


def norm_module_names(module: torch.nn.Module):
    """Names of the normalisation submodules (their ``weight`` is a flax ``scale``)."""
    from ..models.layers import FusedGroupNorm, FusedLayerNorm

    norms = (torch.nn.LayerNorm, FusedGroupNorm, FusedLayerNorm)
    return [name for name, m in module.named_modules() if isinstance(m, norms)]


# ---------------------------------------------------------------------------
# Pipeline directory layout
# ---------------------------------------------------------------------------


def save_pipeline(directory: str, modules: Mapping[str, torch.nn.Module], config,
                  dtype: Optional[torch.dtype] = None, extra_meta: Optional[dict] = None,
                  skip_existing=(), states: Optional[Mapping[str, Mapping]] = None) -> None:
    """Write ``modules`` ({component: nn.Module}) in the JAX pipeline layout,
    each tensor cast to ``dtype`` when given. ``states`` ({component: {name:
    tensor}}) replaces a module's own tensors by name (the trainer's fp32
    masters); a component in ``skip_existing`` whose file exists is not
    written again; ``extra_meta`` joins model_index.json."""
    os.makedirs(directory, exist_ok=True)
    for comp, module in modules.items():
        path = os.path.join(directory, comp, "model.safetensors")
        if comp in skip_existing and os.path.exists(path):
            continue
        state = {**module.state_dict(), **((states or {}).get(comp) or {})}
        state = {k: (v.to(dtype) if dtype is not None else v) for k, v in state.items()}
        flat = flax_from_params(state, norm_module_names(module))
        save_safetensors(flat, path)
    meta = {
        "_framework": "image_restoration_and_enhancement_torch",
        "components": [c for c in COMPONENTS if c in modules],
        "config": dataclasses.asdict(config) if dataclasses.is_dataclass(config) else config,
        **(extra_meta or {}),
    }
    with open(os.path.join(directory, "model_index.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_pipeline(directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-component flax-path params from a pipeline directory."""
    params = {}
    for comp in COMPONENTS:
        p = os.path.join(directory, comp, "model.safetensors")
        if os.path.exists(p):
            params[comp] = load_safetensors(p)
    if not params:
        raise FileNotFoundError(f"No component checkpoints under {directory}")
    return params


def load_pipeline_model_config(directory: str):
    """The SDModelConfig stored in model_index.json, or None when absent or
    unparseable."""
    path = os.path.join(directory, "model_index.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cfg = json.load(f).get("config")
        if not isinstance(cfg, dict):
            return None
        from ..config import model_config_from_dict

        return model_config_from_dict(cfg)
    except (OSError, ValueError, TypeError, KeyError):
        logger.exception("Unparseable model config in %s", path)
        return None


# ---------------------------------------------------------------------------
# diffusers pipeline directories
# ---------------------------------------------------------------------------

_HF_FILES = {"unet": os.path.join("unet", "diffusion_pytorch_model.safetensors"),
             "vae": os.path.join("vae", "diffusion_pytorch_model.safetensors"),
             "text_encoder": os.path.join("text_encoder", "model.safetensors")}
_CLIP_PREFIXES = ("text_model.embeddings.", "text_model.encoder.", "text_model.")


def port_name(torch_key: str) -> Optional[str]:
    """A diffusers or transformers parameter name -> the port's, or None for
    ``position_ids`` (a buffer the port does not keep: its positions are
    0..76). transformers' CLIP prefixes and ``mlp.`` go, as in the JAX
    package's ``translate_torch_key``; every other name is the port's own."""
    if torch_key.endswith("position_ids"):
        return None
    for prefix in _CLIP_PREFIXES:
        torch_key = torch_key.replace(prefix, "")
    return torch_key.replace(".mlp.", ".")


def import_hf_pipeline(directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's state dict of each component found in a diffusers pipeline
    directory (the JAX package's ``import_hf_pipeline`` without the flax
    layout: the names and OIHW/[out, in] layouts are the port's already)."""
    out = {}
    for comp, rel in _HF_FILES.items():
        path = os.path.join(directory, rel)
        if os.path.exists(path):
            state = {}
            for key, t in load_safetensors(path).items():
                name = port_name(key)
                if name is not None:
                    state[name] = t
            out[comp] = state
    if not out:
        raise FileNotFoundError(f"No torch safetensors found under {directory}")
    return out


def is_pipeline_layout(directory: str) -> bool:
    """Whether ``directory`` holds the JAX pipeline layout's UNet or VAE file
    (a diffusers directory's text encoder file has the same name)."""
    return any(os.path.exists(os.path.join(directory, c, "model.safetensors"))
               for c in ("unet", "vae"))


def load_state_dicts(directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's state dict of each component: from the pipeline layout where
    it is present, else imported from a diffusers directory."""
    if is_pipeline_layout(directory):
        return {c: params_from_flax(p) for c, p in load_pipeline(directory).items()}
    return import_hf_pipeline(directory)


def pipeline_exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "model_index.json")) or any(
        os.path.exists(os.path.join(directory, c, "model.safetensors")) for c in COMPONENTS
    )


def find_latest_checkpoint(model_dir: str) -> Optional[str]:
    """Prefer ``best/``, else the numerically largest ``checkpoint-*``, else ``final/``."""
    if not os.path.isdir(model_dir):
        return None
    best = os.path.join(model_dir, "best")
    if pipeline_exists(best):
        return best
    cands = []
    for name in os.listdir(model_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and pipeline_exists(os.path.join(model_dir, name)):
            cands.append((int(m.group(1)), name))
    if cands:
        return os.path.join(model_dir, max(cands)[1])
    final = os.path.join(model_dir, "final")
    if pipeline_exists(final):
        return final
    return None
