"""What a rank of a multi-device serve runs: ``run_cases``, the function that
``launch.launch`` starts on every rank (the tests' gloo ranks and the card
check's NCCL ranks), and ``unsharded``, the same request on one device and no
mesh.

A case is a dict:
  mesh        (shape, axis names) of the mesh the case is served on
  config      a preset name of ``config.PRESETS``
  dtype       "float32" or "bfloat16"
  weights     {component: full state dict} (numpy arrays pickle to spawned
              ranks faster than tensors, which go one descriptor each), or a
              pipeline directory
  kind        "img2img", "inpaint" (the sharded factories), "unet" (one UNet
              call under tensor parallelism), "denoise" (a
              ``RestorationPipeline`` request on the mesh) or "halo" (one conv
              of ``inputs["geometry"]``: "stride1" (``Conv2d``), "down"
              (``Downsample2D``) or "vae_down" (the VAE's downsample), with
              weights from ``inputs["seed"]``, on the height-sharded NHWC
              ``inputs["x"]``, quantized under ``inputs["quant"]`` (a mode)
              where given; ``out`` is its largest difference from the
              unsharded conv on every rank), "qlinear" (a row-parallel
              ``QLinear`` of ``inputs["out_features"]`` under
              ``inputs["quant"]`` on ``inputs["x"]`` [B, N, K], rows over
              the data axis and features over the model axis; ``out``:
              {"sharded", "unsharded"}) or "int8_attention" (the plain int8
              attention on ``inputs`` "q", "k", "v" [B, N, H, D], rows over
              the data axis, heads over the model axis and queries over the
              spatial axis; ``out``: {"sharded", "unsharded"})
  axes        {"data_axis", "model_axis", "spatial_axis"} for the factories
              (data_axis defaults to None), or the pipeline's
  sampling    {"num_inference_steps", "strength", "guidance_scale",
              "sampler", "cfg_cache_interval"} for the factories
  inputs      numpy arrays: "image" (and "mask"), "ctx" and "uncond" (and
              "pooled" for SDXL) or token "ids" and "uncond_ids", "noise" (a
              tuple; else "seed" seeds a generator on the device), for "unet"
              "x", "t", "ctx"; for "denoise" a uint8 "image"
  requests    how many times to serve it (each timed; default 1)
  backend     the attention backend (default None)
  quant       int8 serving: (mode, {site: absmax}) for ``QuantState``
              (default: full precision)
  audit       True: check every dynamic activation scale of the requests
              against the absmax of the whole mesh's input (``_Audited``)
  tome        token merging: (ratio, min_tokens) for ``TomeState``
  pipeline    extra RestorationPipeline arguments ("denoise")

Each rank returns, per case: "out" (rank 0 only; numpy), "seconds" per
request, "peak_bytes" (CUDA), "collectives" made by the requests and
"loop_collectives" made between the first UNet call's start and the last
one's end, the kernel launches of the requests ("launch_shapes",
"launch_paths") and, for an audited case, "scale_audit".
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import config as C
from ..core import checkpoint as ckpt
from ..core import sampling
from ..ops import _build, quant, token_merge
from . import collectives
from .mesh import Mesh, make_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_stack(case: Dict[str, Any], device) -> sampling.SDModules:
    """The case's SD stack, on ``device``, with its full weights (and its
    quantization and ToMe states)."""
    modules = sampling.SDModules.create(C.PRESETS[case["config"]], _DTYPES[case["dtype"]],
                                        device, attention_backend=case.get("backend"))
    weights = case["weights"]
    states = ckpt.load_state_dicts(weights) if isinstance(weights, str) else weights
    for comp, module in modules.components().items():
        module.load_state_dict({k: torch.as_tensor(v) for k, v in states[comp].items()},
                               strict=True)
    if case.get("quant"):
        mode, table = case["quant"]
        modules.set_quant((_Audited if case.get("audit") else quant.QuantState)(mode, table))
    if case.get("tome"):
        modules.set_tome(token_merge.TomeState(*case["tome"]))
    return modules


class _Audited(quant.QuantState):
    """A QuantState that checks each dynamic activation scale it makes
    against the scale of the activation's absmax over every axis of the mesh
    (``groups``: data, model and height, whether the activation is sharded
    on it or not): a scale that misses an axis on which its tensor is
    sharded is smaller. Counts {"checked", "mismatched", "local_below"} (the
    last: calls whose rank-local absmax was below the global one, where a
    rank-local scale would have been another function)."""

    groups: tuple = ()

    def __post_init__(self):
        super().__post_init__()
        self.audit = {"checked": 0, "mismatched": 0, "local_below": 0}

    def quantize_activation(self, x, site):
        xq, s = super().quantize_activation(x, site)
        if isinstance(s, torch.Tensor):
            import torch.distributed as dist

            local = x.float().abs().amax()
            full = local.clone()
            for g in self.groups:
                dist.all_reduce(full, op=dist.ReduceOp.MAX, group=g)
            want = torch.clamp(quant.div127(full), min=quant.EPS)
            self.audit["checked"] += 1
            self.audit["mismatched"] += int(not bool(torch.equal(want, s)))
            self.audit["local_below"] += int(bool(local < full))
        return xq, s


def _tensor(a, device):
    return None if a is None else torch.as_tensor(np.asarray(a)).to(device)


def _contexts(modules, inputs, device):
    """(prompt, uncond) contexts: given ("ctx", "uncond", and for SDXL
    "pooled"), or encoded from token "ids" and "uncond_ids" (None: no CFG)."""
    if "ids" in inputs:
        encode = sampling.encode_text_sdxl if modules.is_sdxl else sampling.encode_text
        with torch.inference_mode():
            return tuple(None if ids is None else encode(modules, torch.as_tensor(ids))
                         for ids in (inputs["ids"], inputs.get("uncond_ids")))
    ctx, uncond = _tensor(inputs["ctx"], device), _tensor(inputs.get("uncond"), device)
    if modules.is_sdxl:
        pooled = _tensor(inputs["pooled"], device)
        return (ctx, pooled), (None if uncond is None else (uncond, pooled))
    return ctx, uncond


def _halo_fn(case, mesh: Mesh):
    from ..models import layers, vae
    from . import spatial

    inputs = case["inputs"]
    x = torch.as_tensor(np.asarray(inputs["x"])).to(mesh.device)
    c, h = x.shape[-1], x.shape[1]
    torch.manual_seed(int(inputs["seed"]))
    module = {"stride1": lambda: layers.QConv2d(c, c, 3, padding=1),
              "down": lambda: layers.Downsample2D(c),
              "vae_down": lambda: vae._VAEDownsample(c)}[inputs["geometry"]]().to(mesh.device)
    if inputs.get("quant"):
        layers.set_quant(module, quant.QuantState(inputs["quant"]))
    x = layers.from_nhwc(x.contiguous())
    axis = case["axes"]["spatial_axis"]

    def request():
        with torch.inference_mode():
            full = module(x)
            with spatial.spatial_sharding(mesh, axis), collectives.sharded_over(mesh.group(axis)):
                spatial.request(h, h)
                spatial.begin("image")
                y = module(spatial.scatter_rows(x, dim=2))
                y = spatial.gather_rows(y, full.shape[2], dim=2)
        return float((y - full).abs().max())
    return request


def _axis_slice(t: torch.Tensor, mesh: Mesh, axis: Optional[str], dim: int) -> torch.Tensor:
    n = mesh.size(axis)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coordinate(axis) * size, size).contiguous()


def _gather(t: torch.Tensor, mesh: Mesh, axis: Optional[str], dim: int) -> torch.Tensor:
    return t if axis is None else collectives.all_gather(t, mesh.group(axis), dim)


def _qlinear_fn(case, mesh: Mesh):
    from ..models import layers

    inputs, axes = case["inputs"], case["axes"]
    data, model = axes.get("data_axis"), axes["model_axis"]
    x = torch.as_tensor(np.asarray(inputs["x"])).to(mesh.device)
    torch.manual_seed(int(inputs["seed"]))
    full = layers.QLinear(x.shape[-1], int(inputs["out_features"])).to(mesh.device)
    part = layers.QLinear(x.shape[-1] // mesh.size(model), full.out_features).to(mesh.device)
    with torch.no_grad():
        part.weight.copy_(_axis_slice(full.weight, mesh, model, 1))
        part.bias.copy_(full.bias)
    part.row_group = mesh.group(model)
    for m in (full, part):
        m.site = "row"
        m.set_quant(quant.QuantState(inputs["quant"]))

    def request():
        with torch.inference_mode():
            want = full(x)
            local = _axis_slice(_axis_slice(x, mesh, data, 0), mesh, model, 2)
            group = mesh.group(data) if data else None
            with collectives.sharded_over(group):
                y = layers.row_parallel(part, local, mesh.group(model))
            got = _gather(y, mesh, data, 0)
        return {"sharded": got.cpu().numpy(), "unsharded": want.cpu().numpy()}
    return request


def _int8_attention_fn(case, mesh: Mesh):
    from ..ops.attention import int8_attention_reference

    inputs, axes = case["inputs"], case["axes"]
    data, model, sp = (axes.get(k) for k in ("data_axis", "model_axis", "spatial_axis"))
    q, k, v = (torch.as_tensor(np.asarray(inputs[n])).to(mesh.device) for n in "qkv")

    def local(t, queries):
        t = _axis_slice(_axis_slice(t, mesh, data, 0), mesh, model, 2)
        return _axis_slice(t, mesh, sp, 1) if queries else t

    def request():
        with torch.inference_mode():
            want = int8_attention_reference(q, k, v)
            groups = [mesh.group(a) for a in (data, model, sp) if a is not None]
            with collectives.sharded_over(*groups):
                o = int8_attention_reference(local(q, True), local(k, False), local(v, False))
            got = _gather(_gather(_gather(o, mesh, sp, 1), mesh, model, 2), mesh, data, 0)
        return {"sharded": got.cpu().numpy(), "unsharded": want.cpu().numpy()}
    return request


def _request_fn(case, modules, mesh: Mesh):
    """A zero-argument function serving the case once, returning numpy."""
    inputs, kind = case["inputs"], case["kind"]
    if kind in _UNIT_KINDS:
        return _UNIT_KINDS[kind](case, mesh)
    dev = mesh.device
    if kind == "unet":
        from .sharding_rules import shard_module

        shard_module(modules.unet, mesh, case["axes"]["model_axis"])
        x, t, ctx = (_tensor(inputs[k], dev) for k in ("x", "t", "ctx"))

        def unet():
            with torch.inference_mode():
                return modules.unet(x, t, ctx).cpu().numpy()
        return unet
    if kind == "denoise":
        pipe = _pipeline(case, dev, mesh=mesh, **case["axes"])
        return lambda: pipe.denoise(inputs["image"])
    maker = (sampling.make_sharded_inpaint_fn if kind == "inpaint"
             else sampling.make_sharded_img2img_fn)
    fn, shard_params = maker(modules, mesh, **case["sampling"],
                             **{"data_axis": None, **case["axes"]})
    shard_params()
    ctx, uncond = _contexts(modules, inputs, dev)
    spatial_args = [_tensor(inputs["image"], dev)]
    if kind == "inpaint":
        spatial_args.append(_tensor(inputs["mask"], dev))
    noise = inputs.get("noise")

    def request():
        gen = None
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(int(inputs["seed"]))
        out = fn(*spatial_args, ctx, uncond, generator=gen,
                 noise=None if noise is None else tuple(_tensor(n, dev) for n in noise))
        return out.cpu().numpy()
    return request


_UNIT_KINDS = {"halo": _halo_fn, "qlinear": _qlinear_fn, "int8_attention": _int8_attention_fn}


def _pipeline(case, device, **mesh_kw):
    from ..infer.pipeline import RestorationPipeline

    return RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": case["weights"], "default_backend": "diffusion"}},
        dtype=_DTYPES[case["dtype"]], device=device, attention_backend=case.get("backend"),
        **mesh_kw, **case.get("pipeline", {}))


def _timed(request, device, n: int):
    """(seconds of each of ``n`` requests, closed by a synchronize; the last
    output)."""
    seconds, out = [], None
    for _ in range(n):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = request()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return seconds, out


def run_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Serve each case on this rank (every rank calls it with the same cases,
    in the same order); see the module docstring."""
    import torch.distributed as dist

    results = []
    for case in cases:
        mesh = make_mesh(*case["mesh"])
        modules = (None if case["kind"] in ("denoise", *_UNIT_KINDS)
                   else load_stack(case, mesh.device))
        if isinstance(getattr(modules, "quant", None), _Audited):
            modules.quant.groups = tuple(mesh.group(a) for a in mesh.axis_names
                                         if mesh.size(a) > 1)
        request = _request_fn(case, modules, mesh)
        marks: List[int] = []
        hooks = []
        if modules is not None:
            total = lambda: sum(collectives.counts.values())  # noqa: E731
            hooks = [modules.unet.register_forward_pre_hook(lambda *a: marks.append(total())),
                     modules.unet.register_forward_hook(lambda *a: marks.append(total()))]
        before = collections.Counter(collectives.counts)
        _build.reset_launch_counts()
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        seconds, out = _timed(request, mesh.device, int(case.get("requests", 1)))
        for h in hooks:
            h.remove()
        made = collections.Counter(collectives.counts)
        made.subtract(before)
        results.append({
            "out": out if dist.get_rank() == 0 else None,
            "seconds": seconds,
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if mesh.device.type == "cuda" else None),
            "collectives": {k: v for k, v in made.items() if v},
            "loop_collectives": marks[-1] - marks[0] if marks else None,
            "launch_shapes": dict(_build.launch_shapes),
            "launch_paths": dict(_build.launch_paths),
            "scale_audit": getattr(getattr(modules, "quant", None), "audit", None),
        })
        del request, modules
    return results


def unsharded(case: Dict[str, Any], device) -> Dict[str, Any]:
    """The case's request served on ``device`` alone, with no mesh (the
    factories' unsharded functions in the "interleaved" layout, or a plain
    pipeline): {"out", "seconds"}."""
    dev = torch.device(device)
    inputs = case["inputs"]
    if case["kind"] == "denoise":
        pipe = _pipeline(case, dev)
        request = lambda: pipe.denoise(inputs["image"])  # noqa: E731
    else:
        modules = load_stack(case, dev)
        maker = sampling.make_inpaint_fn if case["kind"] == "inpaint" else sampling.make_img2img_fn
        fn = maker(modules, **case["sampling"], cfg_layout="interleaved")
        ctx, uncond = _contexts(modules, inputs, dev)
        args = [_tensor(inputs["image"], dev)]
        if case["kind"] == "inpaint":
            args.append(_tensor(inputs["mask"], dev))

        def request():
            gen = torch.Generator(device=dev).manual_seed(int(inputs["seed"]))
            return fn(*args, ctx, uncond, generator=gen).cpu().numpy()
    seconds, out = _timed(request, dev, int(case.get("requests", 1)))
    return {"out": out, "seconds": seconds}
