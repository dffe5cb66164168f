"""The serving functions' CUDA-graph region and the graph wrapper's host logic,
on the CPU (TINY stacks, fp32, random weights).

A CUDA graph (``core/graphs.py``) replays the device work of a sampling
function's ``run`` part; a host-to-device copy or a device-to-host read in it
cannot be captured (the card refuses it during capture) or would be skipped
at every replay. The audit runs ``run`` of every serving form the graphs
cover (img2img PLMS and DDIM with CFG and with gs <= 1, int8_static with int8
attention and a missing table site, ToMe at ratio 0.5, the CFG cache at
interval 2, the CFG dedup, inpaint, SDXL) with the host-copy and host-read
entry points made to raise, after one unaudited call, as the graph wrapper's
warm-up precedes its capture. The audited call must also give the warm-up's
output bitwise: nothing in ``run`` depends on host state the first call
changed.

The host logic: ``graph=None`` resolves to the eager function on the CPU,
``graph=True`` raises there, and the sharded factories take no ``graph``;
the key separates the shapes, dtypes and CFG and SDXL forms and nothing else;
the int8 graphs follow the quantized weights' versions; the launch-counter and
int8_static-miss bookkeeping takes out what a capture recorded and adds back
exactly that at each replay. The card's side (graphed equals eager bitwise,
fresh inputs refresh the static buffers) is in ``test_torch_cuda.py``.
"""
import collections

import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as C
from image_restoration_and_enhancement_torch.core import graphs
from image_restoration_and_enhancement_torch.core import sampling
from image_restoration_and_enhancement_torch.models.layers import init_random_
from image_restoration_and_enhancement_torch.ops import _build
from image_restoration_and_enhancement_torch.ops import quant
from image_restoration_and_enhancement_torch.ops import token_merge
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)

STEPS, STRENGTH = 4, 0.75  # 3 DDIM rows; 4 PLMS rows (order codes 0, 1, 2, 3)
SIZE = 64


def _stack(config, seed, **kw):
    mods = sampling.SDModules.create(config, torch.float32, "cpu", **kw)
    gen = torch.Generator().manual_seed(seed)
    for m in mods.components().values():
        init_random_(m, gen)
    return mods


@pytest.fixture(scope="module")
def stacks():
    rng = np.random.default_rng(0)
    out = {"sd": _stack(C.TINY_SD, 1), "int8": _stack(C.TINY_SD, 1, attention_backend="int8"),
           "inpaint": _stack(C.TINY_SD_INPAINT, 2), "sdxl": _stack(C.TINY_SDXL, 3)}
    ids = torch.from_numpy(rng.integers(3, 128, (2, 77)).astype(np.int32))
    with torch.inference_mode():
        for name in ("sd", "int8", "inpaint"):
            ctx = sampling.encode_text(out[name], ids)
            out[name + "_ctx"] = (ctx[:1], ctx[1:])
        ctx, pooled = sampling.encode_text_sdxl(out["sdxl"], ids)
        out["sdxl_ctx"] = ((ctx[:1], pooled[:1]), (ctx[1:], pooled[1:]))
    out["image"] = torch.from_numpy(rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32))
    mask = np.zeros((1, SIZE, SIZE, 1), np.float32)
    mask[:, 16:44, 8:40] = 1.0
    out["mask"] = torch.from_numpy(mask)
    sites = []
    out["int8"].set_quant(quant.QuantState("int8"))
    for m in list(out["int8"].unet.modules()) + list(out["int8"].vae.modules()):
        if getattr(m, "site", None):
            sites.append(m.site)
    assert len(sites) > 10
    # every site calibrated but one: the static path and a miss
    out["table"] = {s: 2.0 for s in sorted(sites)[1:]}
    out["missing"] = sorted(sites)[0]
    return out


class HostTransfer(AssertionError):
    pass


def _refuse(name):
    def raiser(*args, **kwargs):
        raise HostTransfer(f"{name} inside the captured region")
    return raiser


@pytest.fixture
def audited(monkeypatch):
    """A context in which the host-copy and host-read entry points raise."""
    def enter():
        for name in ("tensor", "as_tensor", "from_numpy", "nonzero"):
            monkeypatch.setattr(torch, name, _refuse(f"torch.{name}"))
        for name in ("item", "tolist", "cpu", "numpy", "nonzero"):
            monkeypatch.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
    return enter


MODES = {
    "plms_cfg": ("sd", "img2img", dict(sampler="plms", guidance_scale=5.0), {}),
    "ddim_cfg": ("sd", "img2img", dict(sampler="ddim", guidance_scale=5.0), {}),
    "plms_gs1": ("sd", "img2img", dict(sampler="plms", guidance_scale=1.0), {}),
    "ddim_gs1": ("sd", "img2img", dict(sampler="ddim", guidance_scale=1.0), {}),
    "int8_static": ("int8", "img2img", dict(sampler="plms", guidance_scale=5.0), {}),
    "tome": ("sd", "img2img", dict(sampler="plms", guidance_scale=5.0), {"tome": 0.5}),
    "cfg_cache": ("sd", "img2img", dict(sampler="plms", guidance_scale=5.0,
                                        cfg_cache_interval=2), {}),
    "dedup": ("sd", "img2img", dict(sampler="ddim", guidance_scale=5.0), {"dedup": True}),
    "inpaint": ("inpaint", "inpaint", dict(sampler="ddim", guidance_scale=5.0), {}),
    "sdxl": ("sdxl", "img2img", dict(sampler="plms", guidance_scale=5.0), {}),
}


def _serving(stacks, mode, monkeypatch):
    """(eager function, its call arguments, modules) of one serving form."""
    name, kind, kw, extra = MODES[mode]
    mods = stacks[name]
    if name == "int8":
        mods.set_quant(quant.QuantState("int8_static", stacks["table"]))
    mods.set_tome(token_merge.TomeState(extra["tome"], 16) if "tome" in extra else None)
    monkeypatch.setenv("IRET_CFG_DEDUP", "1" if extra.get("dedup") else "0")
    maker = sampling.make_inpaint_fn if kind == "inpaint" else sampling.make_img2img_fn
    fn = maker(mods, STEPS, STRENGTH, **kw)
    ctx, uncond = stacks[name + "_ctx"]
    if kw["guidance_scale"] <= 1.0:
        uncond = None
    args = ((stacks["image"], stacks["mask"]) if kind == "inpaint" else (stacks["image"],))
    return fn, args + (ctx, uncond), mods


@pytest.mark.parametrize("mode", list(MODES))
def test_captured_region_makes_no_host_transfer(stacks, mode, audited, monkeypatch):
    fn, args, mods = _serving(stacks, mode, monkeypatch)
    assert not isinstance(fn, graphs.GraphedServe)  # graph=None on the CPU: eager
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
        inputs = fn.prepare(*args, generator=gen)
        warm = fn.run(*inputs)
        if mods.quant is not None:
            mods.quant.misses.clear()
        audited()
        got = fn.run(*inputs)
    assert torch.equal(got, warm)
    assert got.shape == (1, SIZE, SIZE, 3) and torch.isfinite(got).all()
    if mode == "int8_static":
        assert mods.quant.misses == {stacks["missing"]}
        mods.set_quant(None)
    mods.set_tome(None)


def test_audit_catches_a_host_copy(stacks, audited, monkeypatch):
    """The audit's control: the step functions as they were (a timestep
    copied to the device at every step) fail it."""
    from image_restoration_and_enhancement_torch.core import schedulers as sched

    fn, args, _ = _serving(stacks, "ddim_gs1", monkeypatch)
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
        inputs = fn.prepare(*args, generator=gen)
        audited()
        monkeypatch.setattr(sched, "_index", lambda table, t: table[
            torch.as_tensor(t, device=table.device).long()])
        with pytest.raises(HostTransfer, match="torch.as_tensor"):
            fn.run(*inputs)


def test_graph_resolves_by_device(stacks):
    assert graphs.resolve(None, torch.device("cuda")) is True
    assert graphs.resolve(None, torch.device("cpu")) is False
    assert graphs.resolve(False, torch.device("cuda")) is False
    with pytest.raises(ValueError, match="graph=True needs a CUDA stack"):
        graphs.resolve(True, torch.device("cpu"))
    mods = stacks["sd"]
    for maker in (sampling.make_img2img_fn, sampling.make_inpaint_fn):
        with pytest.raises(ValueError, match="graph=True needs a CUDA stack"):
            maker(mods, STEPS, STRENGTH, 5.0, graph=True)
        assert not isinstance(maker(mods, STEPS, STRENGTH, 5.0, graph=False),
                              graphs.GraphedServe)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA stack"):
        graphs.GraphedServe(mods, lambda: (), lambda: None)


@pytest.mark.parametrize("maker", [sampling.make_sharded_img2img_fn,
                                   sampling.make_sharded_inpaint_fn])
def test_sharded_factories_refuse_graph(stacks, maker):
    with pytest.raises(TypeError, match="graph"):
        maker(stacks["sd"], None, STEPS, STRENGTH, 5.0, graph=True)


def test_signature_separates_what_a_graph_freezes(stacks, monkeypatch):
    fn, (image, ctx, uncond), _ = _serving(stacks, "plms_cfg", monkeypatch)
    gen = torch.Generator().manual_seed(5)

    def key(*args):
        with torch.inference_mode():
            return graphs.signature(fn.prepare(*args, generator=gen))

    base = key(image, ctx, uncond)
    assert key(image * 0.5, ctx, uncond) == base  # new values, same graph
    assert key(-image, uncond, ctx) == base
    others = [key(torch.cat([image, image]), ctx, uncond),       # batch
              key(image[:, :32], ctx, uncond),                    # height
              key(image[:, :, :32].contiguous(), ctx, uncond),    # width
              key(image.double(), ctx, uncond),                   # dtype
              key(image, ctx, None)]                              # no CFG
    assert len({base, *others}) == 6
    xl, (xl_image, xl_ctx, xl_uncond), _ = _serving(stacks, "sdxl", monkeypatch)
    with torch.inference_mode():
        xl_key = graphs.signature(xl.prepare(xl_image, xl_ctx, xl_uncond, generator=gen))
    assert len(xl_key) == len(base) and xl_key[3] is not None and base[3] is None  # pooled


def test_graph_settings_follow_the_serving_modes(stacks):
    mods = stacks["sd"]
    base = mods.graph_settings()
    mods.set_tome(token_merge.TomeState(0.5, 16))
    tome = mods.graph_settings()
    mods.set_tome(None)
    state = quant.QuantState("int8")
    mods.set_quant(state)
    int8 = mods.graph_settings()
    mods.set_quant(None)
    mods.set_attn_int8(64)
    attn = mods.graph_settings()
    mods.set_attn_int8(0)
    assert len({base, tome, int8, attn}) == 4 and mods.graph_settings() == base


def test_quantized_weights_follow_the_weights_an_int8_graph_reads(stacks):
    """A graph of an int8 serve reads the s8 copies of the weights, which are
    remade when a weight changes: the token that drops a function's graphs
    changes with any quantized weight's version, and is empty without an
    active mode (a full-precision graph reads the weights themselves)."""
    mods = stacks["sd"]
    assert mods.quantized_weights() == ()
    mods.set_quant(quant.QuantState("int8_static", dict.fromkeys(stacks["table"], 1.0)))
    try:
        before = mods.quantized_weights()
        layers = [m for m in mods.unet.modules() if hasattr(m, "quantized_weight")]
        assert len(before) == len(layers) + sum(
            1 for m in mods.vae.modules() if hasattr(m, "quantized_weight")) > 10
        assert mods.quantized_weights() == before
        with torch.no_grad():
            layers[3].weight.mul_(1.0)
        after = mods.quantized_weights()
        assert after != before and sum(a != b for a, b in zip(after, before)) == 1
    finally:
        mods.set_quant(None)
    assert mods.quantized_weights() == ()


def test_bookkeeping_replays_exactly_the_captured_deltas():
    _build.launch_counts["attention"] += 3
    _build.launch_shapes[("attention", (1,))] += 3
    before = [collections.Counter(c) for c in (_build.launch_counts, _build.launch_shapes,
                                                _build.launch_paths)]
    state = quant.QuantState("int8_static", {"a": 1.0})
    state.misses.add("earlier")
    with graphs.Bookkeeping.capture(state) as book:
        _build.record_launch("attention", (1,), "sm90")
        _build.record_launch("attention", (2,), "sm90")
        _build.record_launch("group_norm", (4,), "onchip")
        assert state.static_scale("b") is None and state.static_scale("a") is not None
        state.static_scale("earlier")
    after = [collections.Counter(c) for c in (_build.launch_counts, _build.launch_shapes,
                                               _build.launch_paths)]
    assert after == before  # a captured launch did not run
    assert state.misses == {"earlier"}
    assert book.counts == {"attention": 2, "group_norm": 1}
    assert book.shapes == {("attention", (1,)): 1, ("attention", (2,)): 1,
                           ("group_norm", (4,)): 1}
    assert book.paths == {("attention", "sm90"): 2, ("group_norm", "onchip"): 1}
    assert book.misses == {"b", "earlier"}
    state.misses.clear()
    for replays in (1, 2):
        book.replay(state)
        assert _build.launch_counts["attention"] == before[0]["attention"] + 2 * replays
        assert _build.launch_counts["group_norm"] == before[0]["group_norm"] + replays
        assert _build.launch_paths[("group_norm", "onchip")] == (
            before[2][("group_norm", "onchip")] + replays)
        assert state.misses == {"b", "earlier"}
    for counter, old in zip((_build.launch_counts, _build.launch_shapes, _build.launch_paths),
                            before):
        counter.clear()
        counter.update(old)


def test_bookkeeping_rolls_back_a_failed_capture():
    before = collections.Counter(_build.launch_counts)
    state = quant.QuantState("int8_static")
    with pytest.raises(RuntimeError, match="capture failed"):
        with graphs.Bookkeeping.capture(state):
            _build.record_launch("attention", (1,))
            state.static_scale("x")
            raise RuntimeError("capture failed")
    assert collections.Counter(_build.launch_counts) == before and not state.misses
