"""The port's CFG cache and CFG prefix dedup against the JAX package's, on
TINY_SD and TINY_SD_INPAINT (fp32, CPU).

Both are loops of exact steps (the cache reuses an uncond eps, the dedup runs
a shared prefix once), so each is held to the img2img parity limit,
``test_torch_serving.ATOL`` (2e-4 on images in [-1, 1]), against JAX run in
the same mode. The dedup is also held to the port's own run without it, at
the same limit: it changes only the batch the prefix runs at.

The UNet's batch at each call is counted with a forward hook: under the cache
with interval k, rows i % k == 0 and the last row run the pair (batch 2) and
the others the cond half (batch 1); under the dedup every call takes batch 1
(the half batch) and returns batch 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.core import schedulers as tsch
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models.layers import init_random_
from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from test_torch_inpaint import _hole
from test_torch_sdxl import load_jax_weights
from test_torch_serving import ATOL, _jax_encode_text, fill_params
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)

STEPS, STRENGTH = 10, 0.6  # 6 DDIM rows, 7 PLMS rows


@pytest.fixture(scope="module")
def modes():
    out = {}
    for name, cfg_j, cfg_t, seed in (("sd", JC.TINY_SD, TC.TINY_SD, 101),
                                     ("inpaint", JC.TINY_SD_INPAINT, TC.TINY_SD_INPAINT, 102)):
        jm = js.SDModules.create(cfg_j, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                                jax.random.PRNGKey(0))
        params = fill_params(shapes, seed=seed)
        tm = ts.SDModules.create(cfg_t, dtype=torch.float32, device="cpu")
        load_jax_weights(tm, params)
        out[name] = (jm, params, tm)
    rng = np.random.default_rng(103)
    out["image"] = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    out["ids"] = rng.integers(3, 128, (2, 77)).astype(np.int32)
    return out


def _batches(unet):
    """A list that a forward hook fills with the batch of every UNet call (in,
    out), and the hook's handle."""
    seen = []
    handle = unet.register_forward_hook(
        lambda m, args, out: seen.append((args[0].shape[0], out.shape[0])))
    return seen, handle


def _run(modes, kind, sampler, k, key_seed):
    """(port image, JAX image, UNet (in, out) batches) of one img2img or
    inpaint run at CFG interval ``k``, gs 5.0, the same noise."""
    jm, params, tm = modes["sd" if kind == "img2img" else "inpaint"]
    image, ids = modes["image"], modes["ids"]
    ctx = _jax_encode_text(jm, params, ids)
    key = jax.random.PRNGKey(key_seed)
    tctx = ts.encode_text(tm, torch.from_numpy(ids))
    seen, handle = _batches(tm.unet)
    try:
        if kind == "img2img":
            ref = js.make_img2img_fn(jm, STEPS, STRENGTH, 5.0, sampler, cfg_cache_interval=k)(
                params, image, ctx[:1], ctx[1:], key)
            noise = tuple(torch.from_numpy(np.array(jax.random.normal(kk, (1, 8, 8, 4))))
                          for kk in jax.random.split(key))
            got = ts.make_img2img_fn(tm, STEPS, STRENGTH, 5.0, sampler, cfg_cache_interval=k)(
                torch.from_numpy(image), tctx[:1], tctx[1:], noise=noise)
        else:
            mask = _hole(64, 64)
            ref = js.make_inpaint_fn(jm, STEPS, STRENGTH, 5.0, sampler, cfg_cache_interval=k)(
                params, image, mask, ctx[:1], ctx[1:], key)
            noise = tuple(torch.from_numpy(np.array(jax.random.normal(kk, (1, 8, 8, 4))))
                          for kk in jax.random.split(key, 3))
            got = ts.make_inpaint_fn(tm, STEPS, STRENGTH, 5.0, sampler, cfg_cache_interval=k)(
                torch.from_numpy(image), torch.from_numpy(mask), tctx[:1], tctx[1:],
                noise=noise)
    finally:
        handle.remove()
    return got.numpy(), np.asarray(ref), seen


def _rows(sampler):
    plan_fn = tsch.plms_step_plan if sampler == "plms" else tsch.ddim_step_plan
    return plan_fn(TC.TINY_SD.scheduler, STEPS, STRENGTH).num_calls


def _expected(sampler, k):
    """The UNet's (in, out) batch at each row: the pair at rows i % k == 0
    and at the last row, the cond half elsewhere."""
    n = _rows(sampler)
    return [(2, 2) if i % k == 0 or i == n - 1 else (1, 1) for i in range(n)]


@pytest.mark.parametrize("kind,sampler", [("img2img", "plms"), ("img2img", "ddim"),
                                          ("inpaint", "ddim")])
@pytest.mark.parametrize("k", [2, 3])
def test_cfg_cache_matches_jax(modes, kind, sampler, k):
    got, ref, seen = _run(modes, kind, sampler, k, key_seed=31 + k)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    assert seen == _expected(sampler, k)
    if (_rows(sampler) - 1) % k:  # the last row is off the interval: refreshed anyway
        assert seen[-1] == (2, 2)


@pytest.mark.parametrize("kind,sampler", [("img2img", "plms"), ("img2img", "ddim"),
                                          ("inpaint", "ddim")])
def test_cfg_cache_interval_1_is_the_exact_loop(modes, kind, sampler):
    """k = 1 is the loop that ``test_torch_serving.py``, ``test_torch_sampling.py``
    and ``test_torch_inpaint.py`` hold against JAX: bitwise the port's default."""
    _, _, tm = modes["sd" if kind == "img2img" else "inpaint"]
    image = torch.from_numpy(modes["image"])
    ctx = ts.encode_text(tm, torch.from_numpy(modes["ids"]))
    args = (image,) if kind == "img2img" else (image, torch.from_numpy(_hole(64, 64)))
    maker = ts.make_img2img_fn if kind == "img2img" else ts.make_inpaint_fn
    outs = []
    for kwargs in ({}, {"cfg_cache_interval": 1}):
        seen, handle = _batches(tm.unet)
        try:
            outs.append(maker(tm, STEPS, STRENGTH, 5.0, sampler, **kwargs)(
                *args, ctx[:1], ctx[1:], generator=torch.Generator().manual_seed(4)))
        finally:
            handle.remove()
        assert seen == _expected(sampler, 1) == [(2, 2)] * _rows(sampler)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("kind,sampler", [("img2img", "plms"), ("inpaint", "ddim")])
def test_cfg_dedup_matches_jax_and_the_exact_loop(modes, monkeypatch, kind, sampler):
    """img2img against JAX's dedup; both against the port's own run without
    the dedup (the exact loop, held against JAX by the older tests)."""
    _, _, tm = modes["sd" if kind == "img2img" else "inpaint"]
    monkeypatch.setenv("IRET_CFG_DEDUP", "1")
    n = _rows(sampler)
    if kind == "img2img":
        got, ref, seen = _run(modes, kind, sampler, 1, key_seed=41)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
        assert seen == [(1, 2)] * n
    image = torch.from_numpy(modes["image"])
    ctx = ts.encode_text(tm, torch.from_numpy(modes["ids"]))
    args = (image,) if kind == "img2img" else (image, torch.from_numpy(_hole(64, 64)))
    maker = ts.make_img2img_fn if kind == "img2img" else ts.make_inpaint_fn

    def run(k):
        seen, handle = _batches(tm.unet)
        try:
            out = maker(tm, STEPS, STRENGTH, 5.0, sampler, cfg_cache_interval=k)(
                *args, ctx[:1], ctx[1:], generator=torch.Generator().manual_seed(6))
        finally:
            handle.remove()
        return out.numpy(), seen

    dedup, seen = run(1)
    assert seen == [(1, 2)] * n
    cached, seen = run(2)  # the cache is off under the dedup, as in JAX
    assert seen == [(1, 2)] * n
    np.testing.assert_array_equal(cached, dedup)
    monkeypatch.delenv("IRET_CFG_DEDUP")
    exact, seen = run(1)
    assert seen == [(2, 2)] * n
    np.testing.assert_allclose(dedup, exact, atol=ATOL, rtol=ATOL)


def test_cfg_dedup_read_when_the_function_is_built(modes, monkeypatch):
    _, _, tm = modes["sd"]
    image = torch.from_numpy(modes["image"])
    ctx = ts.encode_text(tm, torch.from_numpy(modes["ids"]))
    monkeypatch.setenv("IRET_CFG_DEDUP", "1")
    fn = ts.make_img2img_fn(tm, STEPS, STRENGTH, 5.0, "ddim")
    monkeypatch.delenv("IRET_CFG_DEDUP")
    seen, handle = _batches(tm.unet)
    try:
        fn(image, ctx[:1], ctx[1:], generator=torch.Generator().manual_seed(0))
        fn(image, ctx[:1], None, generator=torch.Generator().manual_seed(0))  # no CFG
    finally:
        handle.remove()
    n = _rows("ddim")
    assert seen == [(1, 2)] * n + [(1, 1)] * n


def test_cfg_dedup_refused_for_sdxl_and_without_level_0_attention(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    xl = ts.SDModules.create(TC.TINY_SDXL, torch.float32, "cpu")
    for m in xl.components().values():
        init_random_(m, gen)
    x, t = torch.randn((1, 8, 8, 4), generator=gen), torch.tensor([500])
    ctx = torch.randn((2, 77, 16), generator=gen)
    added = {"text_embeds": torch.randn((2, 8), generator=gen), "time_ids": torch.ones((2, 6))}
    with pytest.raises(ValueError, match="text_time"):
        xl.unet(x, t, ctx, added, cfg_dedup=True)
    # the loop leaves the dedup off for SDXL: full CFG pairs at every call
    monkeypatch.setenv("IRET_CFG_DEDUP", "1")
    ids = torch.randint(3, 128, (2, 77), generator=gen)
    c, p = ts.encode_text_sdxl(xl, ids)
    seen, handle = _batches(xl.unet)
    try:
        ts.make_img2img_fn(xl, 4, 0.5, 5.0, "ddim")(
            torch.rand((1, 64, 64, 3), generator=gen) * 2 - 1, (c[:1], p[:1]), (c[1:], p[1:]),
            generator=gen)
    finally:
        handle.remove()
    assert seen == [(2, 2)] * 2

    no_level0 = dataclasses.replace(TC.TINY_UNET, attn_levels=(False, True, True, False))
    unet = UNet2DCondition(no_level0).eval()
    with pytest.raises(ValueError, match="level 0"):
        unet(x, t, torch.randn((2, 77, 16)), cfg_dedup=True)


def test_cfg_cache_interval_in_the_sampler_key(modes, tmp_path):
    _, params, _ = modes["sd"]
    jck.save_pipeline(str(tmp_path), params, JC.TINY_SD)
    config = {"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}}
    image = np.random.default_rng(104).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    outs, keys = {}, {}
    for k in (1, 2):
        pipe = RestorationPipeline(config=config, dtype=torch.float32, device="cpu",
                                   cfg_cache_interval=k)
        assert pipe.cfg_cache_interval == k
        seen, handle = _batches(pipe._load_stack("denoise")["modules"].unet)
        try:
            outs[k] = pipe.denoise(image)
        finally:
            handle.remove()
        keys[k] = list(pipe._fn_cache)
        assert len(keys[k]) == 1 and keys[k][0][-1] == k
        # the task default: 20-step PLMS at strength 0.5, 11 UNet calls
        assert seen == ([(2, 2)] * 11 if k == 1 else
                        [(2, 2) if i % 2 == 0 or i == 10 else (1, 1) for i in range(11)])
    assert keys[1][0][:-1] == keys[2][0][:-1]
    assert outs[1].shape == outs[2].shape == (64, 64, 3)
    assert not np.array_equal(outs[1], outs[2])
