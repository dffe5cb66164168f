"""The port's VAE probe and the demo's serving sweep against the JAX
package's scripts (loaded by path), on the CPU, on a checkpoint the JAX
``save_pipeline`` wrote (the demo config at random, numpy values from a seed)
and the demo's val pairs (``test_torch_demo.py``'s fixture).

- ``probe_vae_roundtrip`` at ``--dtype float32`` and through the LANCZOS
  resize (64 -> 32 px): each of the JAX script's four figures within 1e-3 dB
  (both print them rounded to 1e-3; the fp32 VAEs differ by a few 1e-6).
- The sweep's round trip within 1e-3 dB of the JAX sweep's, its images within
  ATOL; one strength point (PLMS, strength 0.3, 10 steps, no CFG) with the
  noise the JAX function draws from its key passed in as ``noise=``: images
  within ATOL, PSNR within 1e-3 dB.

ATOL: 1e-4 on images in [-1, 1]: the fp32 VAE and the 4 UNet calls take the
same sums in another order in the two frameworks (per-op differences of a few
1e-6); measured 9.1e-6 for the round trip and 4.0e-6 for the strength point,
so the limit keeps a 10x margin.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import demo_eval_sweep as tsweep
from image_restoration_and_enhancement_torch import probe_vae_roundtrip as tprobe
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.metrics import functional as JF
from image_restoration_and_enhancement_tpu.models.tokenizer import load_tokenizer as j_tokenizer
from image_restoration_and_enhancement_tpu.tasks.registry import get_task as j_get_task
from test_torch_demo import data, jdemo, load_script  # noqa: F401  (fixtures)
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-4
DB = 1e-3


@pytest.fixture(scope="module")
def jax_checkpoint(jdemo, tmp_path_factory):
    """The demo config at random (numpy values from a seed), written by the
    JAX save_pipeline; (directory, JAX modules, JAX params)."""
    cfg = jdemo.demo_model_config()
    jm = js.SDModules.create(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=21)
    directory = str(tmp_path_factory.mktemp("demo_ckpt"))
    jck.save_pipeline(directory, params, cfg)
    return directory, jm, params


def test_probe_matches_jax(data, jax_checkpoint, capsys, monkeypatch):
    directory = jax_checkpoint[0]
    pairs = str(data / "torch" / "pairs" / "denoise" / "val")
    args = ["--checkpoint", directory, "--pairs", pairs, "--n", "2", "--size", "32",
            "--batch", "2", "--dtype", "float32"]
    jprobe = load_script("probe_vae_roundtrip")
    update = jax.config.update

    def no_cache_dir(name, value):   # the script's compile cache would land in /tmp
        if name != "jax_compilation_cache_dir":
            update(name, value)

    monkeypatch.setattr(jax.config, "update", no_cache_dir)
    monkeypatch.setattr(sys, "argv", ["probe_vae_roundtrip.py"] + args)
    capsys.readouterr()
    jprobe.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tprobe.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n"] == ref["n"] == 2 and got["dtype"] == "float32"
    for key in ("rt_input_vs_gt", "rt_input_vs_input", "rt_gt_vs_gt", "input_vs_gt"):
        assert abs(got[key] - ref[key]) <= DB + 1e-9, (key, got[key], ref[key])


@pytest.fixture(scope="module")
def sweep_inputs(data, jax_checkpoint):
    directory, jm, params = jax_checkpoint
    x, gt = tsweep.load_val(str(data / "torch"))
    tm = tsweep.load_stack(directory, "cpu")
    return directory, jm, params, tm, x, gt


def test_sweep_roundtrip_matches_jax(sweep_inputs):
    _, jm, params, tm, x, gt = sweep_inputs
    ref = jax.jit(lambda p, im: js.decode_latents(
        jm, p, js.encode_image(jm, p, im, jax.random.PRNGKey(0), sample=False)))(params, x)
    got = tsweep.roundtrip(tm, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref_psnr = np.mean([float(JF.psnr(jnp.asarray((o + 1) / 2), jnp.asarray((g + 1) / 2)))
                        for o, g in zip(np.asarray(ref), gt)])
    assert abs(tsweep.metrics(got, gt)[0] - ref_psnr) <= DB


def test_sweep_strength_point_matches_jax(sweep_inputs):
    directory, jm, params, tm, x, gt = sweep_inputs
    steps, strength = 10, 0.3
    tok = j_tokenizer(directory, vocab_size=jm.config.text_encoder.vocab_size)
    jctx = js.encode_text(jm, params, jnp.asarray(tok([j_get_task("denoise").prompt])))
    jctx = jnp.broadcast_to(jctx, (x.shape[0],) + jctx.shape[1:])
    key = jax.random.PRNGKey(42)
    ref = js.make_img2img_fn(jm, steps, strength, 0.0, "plms")(params, x, jctx, None, key)

    ctx = tsweep.task_context(tm, directory, x.shape[0])
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=ATOL, rtol=0)
    lat_shape = (x.shape[0], 8, 8, 4)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, lat_shape, jnp.float32)))
                  for k in jax.random.split(key))
    got = tsweep.serve(tm, x, ctx, strength, steps, 42, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref_psnr = np.mean([float(JF.psnr(jnp.asarray((o + 1) / 2), jnp.asarray((g + 1) / 2)))
                        for o, g in zip(np.asarray(ref), gt)])
    assert abs(tsweep.metrics(got, gt)[0] - ref_psnr) <= DB


