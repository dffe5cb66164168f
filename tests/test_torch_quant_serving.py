"""PyTorch port int8 serving (w8a8, int8 attention) against the JAX package on
TINY_SD (fp32, CPU).

- calibration: the port's ``make_calib_img2img_fn`` reports the same 200
  sites as JAX's, with the same activation absmax;
- int8_static img2img with JAX's table: the port's plain K3 and K4 against
  JAX with the Pallas conv kernel (``IRET_CONV_KERNEL=1``, interpret mode
  patched in as ``tests/test_quant.py`` does) and the Pallas int8 attention
  kernel (``attention_backend="int8_interpret"``);
- ``RestorationPipeline(quant="int8_static", quant_calib=..., attention_backend=
  "int8")`` serves a table written by ``calibrate_quant`` with no misses, and
  a table missing a site raises ``StrictQuantError`` under IRET_QUANT_STRICT.

Tolerances: calibration absmax 1e-5 relative and the calibration image 1e-5;
int8_static images 2e-4 absolute, the bound of ``test_torch_serving.py`` (the
same fp32 sums in another order, amplified a little by the PLMS updates).
Both sides quantize to the same s8 values; only an fp32 difference of a few
ulps right at a rounding boundary flips one of them by one step.

Both functions run 4 steps (3 UNet calls). On this random TINY stack the w8a8
output is dominated by quantization noise, so one such flip redraws the noise
of every later layer and grows over later steps: at 10 steps the port and JAX
drift far apart, and so do two JAX runs that differ only in XLA's fusion
(with and without ``IRET_CONV_KERNEL``), while single UNet calls agree to
fp32 rounding. ``chip_smoke.py`` measures the size of that noise beside its
CUDA-against-CPU int8 checks.
"""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import calibrate_quant
from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import (
    RestorationPipeline,
    StrictQuantError,
)
from image_restoration_and_enhancement_torch.ops import quant as tq
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.ops import conv_int8 as jconv
from image_restoration_and_enhancement_tpu.ops import quant as jq
from test_torch_serving import _jax_encode_text, fill_params
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)

STEPS = 4


@pytest.fixture(scope="module")
def int8_stacks():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32, attention_backend="int8_interpret")
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=11)
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu",
                             attention_backend="int8")
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])),
                            strict=True)
    rng = np.random.default_rng(12)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(jm, params, ids)
    key = jax.random.PRNGKey(7)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in jax.random.split(key))
    out, stats = js.make_calib_img2img_fn(jm, STEPS, 0.5, 5.0, "plms")(
        params, image, ctx[:1], ctx[1:], key)
    return {"jm": jm, "params": params, "tm": tm, "image": image, "ids": ids, "ctx": ctx,
            "key": key, "noise": noise, "calib_image": np.asarray(out),
            "table": {k: float(v) for k, v in stats.items()}}


def _port_ctx(s):
    return ts.encode_text(s["tm"], torch.from_numpy(s["ids"]))


def test_calibration_matches_jax(int8_stacks):
    s = int8_stacks
    tctx = _port_ctx(s)
    out, stats = ts.make_calib_img2img_fn(s["tm"], STEPS, 0.5, 5.0, "plms")(
        torch.from_numpy(s["image"]), tctx[:1], tctx[1:], noise=s["noise"])
    sites = {m.site for c in (s["tm"].unet, s["tm"].vae) for m in c.modules()
             if hasattr(m, "quantized_weight")}
    assert len(sites) == 200 and set(stats) == set(s["table"]) == sites
    for site, value in s["table"].items():
        assert stats[site] == pytest.approx(value, rel=1e-5), site
    np.testing.assert_allclose(out.numpy(), s["calib_image"], atol=1e-5, rtol=0)
    assert s["tm"].quant is None  # the calibration put the modules' state back


def test_int8_static_img2img_matches_jax(int8_stacks, monkeypatch):
    s = int8_stacks
    real = jconv.conv3x3_same_int8

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(jconv, "conv3x3_same_int8", interpret)
    monkeypatch.setenv("IRET_CONV_KERNEL", "1")
    jq.load_static_table(s["table"])
    try:
        with jq.quant_mode("int8_static"):
            fn = js.make_img2img_fn(s["jm"], STEPS, 0.5, 5.0, "plms")
            ref = np.asarray(fn(s["params"], s["image"], s["ctx"][:1], s["ctx"][1:], s["key"]))
        assert jq.static_misses() == set()
    finally:
        jq.load_static_table({})

    tm = s["tm"]
    tm.set_quant(tq.QuantState("int8_static", s["table"]))
    try:
        tctx = _port_ctx(s)
        got = ts.make_img2img_fn(tm, STEPS, 0.5, 5.0, "plms")(
            torch.from_numpy(s["image"]), tctx[:1], tctx[1:], noise=s["noise"])
        assert tm.quant.misses == set()
    finally:
        tm.set_quant(None)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def _save(s, tmp_path):
    jck.save_pipeline(str(tmp_path / "model"), s["params"], JC.TINY_SD)
    return str(tmp_path / "model")


def _pipe(model_dir, **kw):
    return RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": model_dir, "default_backend": "diffusion"}},
        dtype=torch.float32, device="cpu", attention_backend="int8", **kw)


def test_pipeline_serves_int8_static_from_calibrate_quant(int8_stacks, tmp_path, caplog):
    model_dir = _save(int8_stacks, tmp_path)
    table_path = str(tmp_path / "calib.json")
    assert calibrate_quant.main(
        ["--out", table_path, "--checkpoint", model_dir, "--size", "64", "--batch", "1",
         "--steps", "4", "--seeds", "0", "--device", "cpu"]) == 0
    with open(table_path) as f:
        written = json.load(f)
    assert len(written["sites"]) == 200 and all(v > 0 for v in written["sites"].values())

    image = np.random.default_rng(13).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pipe = _pipe(model_dir, quant="int8_static", quant_calib=table_path)
    with caplog.at_level(logging.WARNING):
        out = pipe.denoise(image)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == (64, 64, 3)
    assert pipe.quant.mode == "int8_static" and pipe.quant.misses == set()
    assert not caplog.records
    modules = pipe._stacks["denoise"]["modules"]
    assert modules.quant is pipe.quant and modules.unet.mid_block.attentions[0] \
        .transformer_blocks[0].attn1.attention_backend == "int8"

    # a flat {site: absmax} table loads the same way
    flat = str(tmp_path / "flat.json")
    with open(flat, "w") as f:
        json.dump(written["sites"], f)
    assert _pipe(model_dir, quant="int8_static", quant_calib=flat).quant.table == pipe.quant.table


def test_missing_site_warns_or_raises_in_strict_mode(int8_stacks, tmp_path, monkeypatch, caplog):
    model_dir = _save(int8_stacks, tmp_path)
    table = dict(int8_stacks["table"])
    missing = "down_blocks_0/resnets_0/conv1"
    del table[missing]
    path = str(tmp_path / "partial.json")
    with open(path, "w") as f:
        json.dump({"sites": table}, f)
    image = np.random.default_rng(14).integers(0, 256, (64, 64, 3), dtype=np.uint8)

    pipe = _pipe(model_dir, quant="int8_static", quant_calib=path)
    with caplog.at_level(logging.WARNING):
        out = pipe.denoise(image)
    assert out.shape == (64, 64, 3) and pipe.quant.misses == {missing}
    assert [r for r in caplog.records if missing in r.getMessage()]

    monkeypatch.setenv("IRET_QUANT_STRICT", "1")
    strict = _pipe(model_dir, quant="int8_static", quant_calib=path)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for call in (lambda: strict.denoise(image), lambda: strict.process(image, ["denoise"])):
            with pytest.raises(StrictQuantError, match=missing):
                call()
    assert not [r for r in caplog.records if "fallback" in r.getMessage()]


def test_quant_mode_defers_to_env(monkeypatch):
    monkeypatch.setenv("IRET_QUANT", "int8")
    assert RestorationPipeline(device="cpu").quant.mode == "int8"
    assert RestorationPipeline(device="cpu", quant="").quant.mode is None
    monkeypatch.delenv("IRET_QUANT")
    assert RestorationPipeline(device="cpu").quant.mode is None
    # the backend is checked when the pipeline is built: K5's is ported, a
    # JAX interpret-mode test backend is not
    assert RestorationPipeline(device="cpu", attention_backend="flash").attention_backend == "flash"
    with pytest.raises(ValueError, match="Unknown"):
        RestorationPipeline(device="cpu", attention_backend="flash_interpret")
