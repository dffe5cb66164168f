"""The port's ``eval_quant_quality`` against the JAX package's script (CPU, TINY).

- ``load_batch``: the same arrays as JAX's on the same PNG files, at an
  off size (PIL BICUBIC for images, NEAREST for masks, through the port's
  own resizes), bitwise.
- ``metrics_vs``: JAX's PSNR within 1e-4 dB and SSIM within 1e-5 (the same
  float32 sums in another order).
- every ``run`` composition against the port's sampling functions called
  directly with the same generators, bitwise (mirroring
  ``tests/test_eval_gate_compositions.py``): the exact run, int8_static with
  ToMe and with the CFG cache (one calibration on the first chunk, reused
  through ``tables``), the chunked gate, the inpaint gate with ToMe and its
  int8_static error; the modules left with quantization, ToMe and the
  attention threshold off.
- ``attn_int8_min``: attention with Nq and Nk at or above the threshold is
  JAX's ``xla_attention_int8_pv``, within the limit of
  ``tests/test_torch_int8_attention.py`` (2e-3); below it
  the exact function; in ``run`` only the serving of a quantized run takes it
  (never the calibration or the exact run).
- the report: JAX's lines, label for label, from the same outputs.
- ``main`` needs CUDA unless ``--device cpu``.
"""
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch import eval_quant_quality as eqq
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.models.layers import init_random_
from image_restoration_and_enhancement_torch.ops import attention as ta
from image_restoration_and_enhancement_torch.ops import quant, token_merge
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.ops import attention as ja
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

_SPEC = importlib.util.spec_from_file_location(
    "eval_quant_quality_jax",
    os.path.join(os.path.dirname(__file__), "..", "scripts", "eval_quant_quality.py"))
jeqq = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jeqq)

STEPS, STRENGTH, GS, SAMPLER = 3, 0.8, 5.0, "ddim"


def _pairs(root, n, hw, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    for kind in ("input", "gt") + (("mask",) if with_mask else ()):
        os.makedirs(os.path.join(root, kind))
    for i in range(n):
        name = f"p{i}.png"
        for kind in ("input", "gt"):
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
                os.path.join(root, kind, name))
        if with_mask:
            Image.fromarray((rng.random(hw) > 0.5).astype(np.uint8) * 255).save(
                os.path.join(root, "mask", name))


@pytest.mark.parametrize("hw,size", [((70, 90), 64), ((48, 48), 64), ((64, 64), 64)])
def test_load_batch_matches_jax(tmp_path, hw, size):
    _pairs(str(tmp_path), 3, hw, True)
    got = eqq.load_batch(str(tmp_path), 2, size, with_mask=True)
    want = jeqq.load_batch(str(tmp_path), 2, size, with_mask=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), np.asarray(w))
    x, gt, mask = eqq.load_batch(str(tmp_path), 5, size)
    assert x.shape == gt.shape == (3, size, size, 3) and mask is None


def test_metrics_vs_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.random((3, 48, 40, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    (p, s), (pj, sj) = eqq.metrics_vs(a, b), jeqq.metrics_vs(a, b)
    assert abs(p - pj) <= 1e-4 and abs(s - sj) <= 1e-5


@pytest.fixture(scope="module")
def tiny():
    mods = {}
    for name, cfg in (("sd", TC.TINY_SD), ("inpaint", TC.TINY_SD_INPAINT)):
        m = ts.SDModules.create(cfg, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(3)
        for module in m.components().values():
            init_random_(module, gen)
        mods[name] = m
    ctx = ts.encode_text(mods["sd"], torch.zeros((1, 77), dtype=torch.int32))
    x = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, (3, 64, 64, 3))
                         .astype(np.float32))
    return mods, ctx, x


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _direct(mods, ctx, x, mode=None, cfg_cache=1, tome=0.0, mask=None, batch=0):
    """The sampling functions called directly, as ``run`` should call them."""
    b = batch or len(x)
    table = {}
    if mode == "int8_static":
        _, table = ts.make_calib_img2img_fn(mods, STEPS, STRENGTH, GS, SAMPLER)(
            x[:b], ctx, ctx, _gen(42))
    mods.set_quant(quant.QuantState(mode, table) if mode else None)
    mods.set_tome(token_merge.state_from_env(tome) if tome else None)
    make = ts.make_inpaint_fn if mask is not None else ts.make_img2img_fn
    fn = make(mods, STEPS, STRENGTH, GS, SAMPLER, cfg_cache_interval=cfg_cache)
    outs = []
    for i in range(0, len(x), b):
        args = (x[i:i + b],) + ((mask[i:i + b],) if mask is not None else ())
        outs.append(fn(*args, ctx, ctx, _gen(42 + i)).numpy())
    mods.set_quant(None)
    mods.set_tome(None)
    return np.concatenate(outs)


def _run(mods, ctx, x, **kw):
    return eqq.run(mods, ctx, ctx, x, STEPS, STRENGTH, GS, SAMPLER, **kw)


def _clean(mods):
    assert mods.quant is None
    for m in mods.unet.modules():
        assert getattr(m, "tome", None) is None
        assert getattr(m, "attn_int8_min", 0) == 0


@pytest.mark.parametrize("kw", [
    dict(mode=None),
    dict(mode="int8"),
    dict(mode="int8_static", tome=0.5),
    dict(mode="int8_static", cfg_cache=2),
    dict(mode=None, batch=2),
    dict(mode="int8_static", batch=2, cfg_cache=2, tome=0.5),
], ids=["exact", "int8", "static_tome", "static_turbo", "chunked", "combo_chunked"])
def test_run_compositions_match_the_sampling_functions(tiny, monkeypatch, kw):
    monkeypatch.setenv("IRET_TOME_MIN", "64")   # the TINY sites qualify
    mods, ctx, x = tiny
    x = x if kw.get("batch") else x[:1]
    got = _run(mods["sd"], ctx, x, **kw)
    _clean(mods["sd"])
    assert got.shape == tuple(x.shape) and np.isfinite(got).all()
    assert np.array_equal(got, _direct(mods["sd"], ctx, x, **kw))
    if kw.get("tome"):   # the TINY self-attention sites did merge
        assert not np.array_equal(got, _run(mods["sd"], ctx, x, **dict(kw, tome=0.0)))


def test_serving_tome_switch_stays_out_of_the_gate(tiny, monkeypatch):
    """IRET_TOME turns ToMe on for serving; the gate ignores it, as JAX's
    ``tome_mode(None)`` forces the ratio to 0: the exact run is the run
    without the variable, and only the runs given ``tome`` merge tokens."""
    monkeypatch.setenv("IRET_TOME_MIN", "64")   # the TINY sites qualify
    mods, ctx, x = tiny
    sd = mods["sd"]
    exact = _run(sd, ctx, x[:1], mode=None)
    monkeypatch.setenv("IRET_TOME", "0.5")
    ratios = []
    real = sd.set_tome
    monkeypatch.setattr(sd, "set_tome", lambda s: ratios.append(s and s.ratio) or real(s))
    assert np.array_equal(_run(sd, ctx, x[:1], mode=None), exact)
    for kw in (dict(mode="int8"), dict(mode="int8_static", cfg_cache=2),
               dict(mode="int8_static", tome=0.25), dict(mode=None, cfg_cache=2, tome=0.25)):
        _run(sd, ctx, x[:1], **kw)
    assert ratios[0::2] == [None, None, None, 0.25, 0.25]   # each run, then its reset
    assert ratios[1::2] == [None] * 5
    _clean(sd)


def test_static_calibration_runs_once_per_settings(tiny, monkeypatch):
    mods, ctx, x = tiny
    calls = []
    real = ts.make_calib_img2img_fn
    monkeypatch.setattr(ts, "make_calib_img2img_fn",
                        lambda *a, **k: calls.append(a[1:]) or real(*a, **k))
    tables = {}
    first = _run(mods["sd"], ctx, x[:1], mode="int8_static", tables=tables)
    _run(mods["sd"], ctx, x[:1], mode="int8_static", cfg_cache=2, tables=tables)
    assert len(calls) == 1 and len(tables) == 1
    assert np.array_equal(first, _run(mods["sd"], ctx, x[:1], mode="int8_static",
                                      tables=tables))


def test_inpaint_gate(tiny, monkeypatch):
    monkeypatch.setenv("IRET_TOME_MIN", "64")
    mods, ctx, x = tiny
    mask = torch.ones(x[:1].shape[:3] + (1,))
    got = _run(mods["inpaint"], ctx, x[:1], mode=None, tome=0.5, mask=mask)
    assert np.array_equal(got, _direct(mods["inpaint"], ctx, x[:1], tome=0.5, mask=mask))
    with pytest.raises(ValueError, match="no inpaint calib twin"):
        _run(mods["inpaint"], ctx, x[:1], mode="int8_static", mask=mask)


def _qkv(b, nq, nk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize("nq,nk,threshold", [(256, 256, 256), (256, 256, 64), (100, 64, 64)])
def test_threshold_routes_to_jax_int8_functions(nq, nk, threshold):
    q, k, v = _qkv(2, nq, nk, 2, 40, seed=nq + threshold)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(ta.attention(tq, tk, tv, None, threshold).numpy(),
                               np.asarray(ja.xla_attention_int8_pv(jq, jk, jv)),
                               atol=2e-3, rtol=0)
    exact = ta.attention_reference(tq, tk, tv)
    assert torch.equal(ta.attention(tq, tk, tv, None, min(nq, nk) + 1), exact)
    assert torch.equal(ta.attention(tq, tk, tv, "xla", threshold), exact)


def test_threshold_reaches_only_the_quantized_serving(tiny, monkeypatch):
    mods, ctx, x = tiny
    calls = []
    real_pv = ta._BACKENDS["xla_int8_pv"]
    monkeypatch.setitem(ta._BACKENDS, "xla_int8_pv",
                        lambda q, k, v: calls.append(q.shape[1]) or real_pv(q, k, v))
    real_calib = ts.make_calib_img2img_fn

    def calib(*a, **kw):
        fn = real_calib(*a, **kw)

        def wrapped(*args, **kws):
            out = fn(*args, **kws)
            assert not calls, "the calibration took the int8 attention"
            return out
        return wrapped

    monkeypatch.setattr(ts, "make_calib_img2img_fn", calib)
    exact = _run(mods["sd"], ctx, x[:1], mode=None)   # main's exact run takes no threshold
    assert calls == []
    _run(mods["sd"], ctx, x[:1], mode="int8_static", attn_int8_min=64)
    assert calls and min(calls) >= 64
    _clean(mods["sd"])
    assert np.array_equal(exact, _direct(mods["sd"], ctx, x[:1]))


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    modules = js.SDModules.create(JC.TINY_SD)
    shapes = jax.eval_shape(lambda k: js.init_params(modules, k, 64), jax.random.PRNGKey(0))
    jck.save_pipeline(d, fill_params(shapes, seed=2), JC.TINY_SD)
    return d


def _report(main, module, cfg, outputs, capsys, monkeypatch):
    """The lines ``main`` prints with ``module``'s task on ``cfg`` and its runs
    returning ``outputs``, numbers masked."""
    real = module.get_task
    monkeypatch.setattr(module, "get_task",
                        lambda name: dataclasses.replace(real(name), model_config=cfg))
    it = iter(outputs)
    monkeypatch.setattr(module, "run", lambda *a, **kw: next(it))
    main()
    return [re.sub(r"[-+]?\d+\.\d+", "#", line) for line in capsys.readouterr().out.splitlines()]


def test_report_lines_match_jax(tmp_path, tiny_checkpoint, capsys, monkeypatch):
    _pairs(str(tmp_path / "pairs"), 2, (64, 64), False, seed=4)
    rng = np.random.default_rng(5)
    outputs = [rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(6)]
    argv = ["--checkpoint", tiny_checkpoint, "--pairs", str(tmp_path / "pairs"), "--n", "2",
            "--size", "64", "--batch", "2", "--cfg_cache", "2", "--tome", "0.5"]
    got = _report(lambda: eqq.main(argv + ["--device", "cpu"]), eqq, TC.TINY_SD, outputs,
                  capsys, monkeypatch)
    monkeypatch.setattr("sys.argv", ["eval_quant_quality.py"] + argv)
    want = _report(jeqq.main, jeqq, JC.TINY_SD, outputs, capsys, monkeypatch)
    assert got == want and len(got) == 1 + 1 + 3 * 5
    assert [line.split(" vs ")[0].strip() for line in got[2::3]] == [
        "int8", "int8_static", "turbo(k=2)", "tome(#)", "combo(k2+t#)"]


def test_main_needs_cuda_unless_cpu_is_asked(tiny_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eqq.main(["--checkpoint", tiny_checkpoint])
