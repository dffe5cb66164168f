"""The port's SDXL stack against the JAX package on TINY_SDXL (fp32, CPU), and
its full-width parameter counts.

Weights are the JAX package's, initialised at random and exported through
``export_torch_state_dict``; both sides take the same numpy inputs and the
same noise (the port is handed what the JAX function draws from its key).

Tolerances, those of the SD-1.5 parity tests and for the same reasons (the
same fp32 sums in another order):
- the CLIP towers' outputs, ``encode_text_sdxl`` and the UNet call:
  ``test_torch_models.ATOL`` (1e-4);
- img2img images in [-1, 1] and the pipeline's conditioning:
  ``test_torch_serving.ATOL`` (2e-4);
- the pipeline's image feed: one uint8 level, as ``test_torch_tasks.py``;
- the step plans, time ids and parameter counts: exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models.clip_text import CLIPTextModel
from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
from image_restoration_and_enhancement_torch.models.vae import AutoencoderKL
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.infer.pipeline import (
    RestorationPipeline as JaxPipeline,
)
from test_torch_models import ATOL as MODEL_ATOL
from test_torch_serving import ATOL, fill_params, one_torch_thread  # noqa: F401  (autouse)
from test_torch_tasks import IMAGE_TOL


def exported(params):
    """A JAX component's params through the weight bridge, as torch tensors."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in jck.export_torch_state_dict(params).items()}


def load_jax_weights(tm, params):
    for comp, mod in tm.components().items():
        mod.load_state_dict(exported(params[comp]), strict=True)


@pytest.fixture(scope="module")
def sdxl():
    jm = js.SDModules.create(JC.TINY_SDXL, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=81)
    tm = ts.SDModules.create(TC.TINY_SDXL, dtype=torch.float32, device="cpu")
    load_jax_weights(tm, params)
    return jm, params, tm


def _ids(rng, b):
    """Token ids with the tiny vocabulary's eos (2) at a few positions, and one
    row without any (its pooled row is position 0 on both sides)."""
    ids = rng.integers(3, 128, (b, 77)).astype(np.int32)
    for row, pos in zip(range(b - 1), (5, 40, 76)):
        ids[row, pos] = ids[row, pos + 1:pos + 3] = 2
    return ids


def test_sdxl_stack_has_both_towers(sdxl):
    _, params, tm = sdxl
    assert tm.is_sdxl and set(tm.components()) == set(params) == {
        "unet", "vae", "text_encoder", "text_encoder_2"}
    assert tm.text_encoder_2.text_projection is not None
    assert tm.text_encoder.text_projection is None
    assert not ts.SDModules.create(TC.TINY_SD, torch.float32, "cpu").is_sdxl


@pytest.mark.parametrize("tower", ["text_encoder", "text_encoder_2"])
def test_clip_return_dict_matches_jax(sdxl, tower):
    """Without a projection (the L tower) and with one (bigG)."""
    jm, params, tm = sdxl
    ids = _ids(np.random.default_rng(82), 3)
    ref = jax.jit(lambda p: getattr(jm, tower).apply({"params": p}, ids, return_dict=True))(
        params[tower])
    with torch.inference_mode():
        got = getattr(tm, tower)(torch.from_numpy(ids), return_dict=True)
        plain = getattr(tm, tower)(torch.from_numpy(ids))
    assert set(got) == set(ref) == {"last_hidden_state", "penultimate_hidden_state", "pooled"}
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=MODEL_ATOL,
                                   rtol=MODEL_ATOL, err_msg=k)
    torch.testing.assert_close(plain, got["last_hidden_state"], rtol=0, atol=0)


def test_sdxl_unet_with_added_cond_matches_jax(sdxl):
    jm, params, tm = sdxl
    rng = np.random.default_rng(83)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((2, 8)).astype(np.float32),
             "time_ids": np.array([[64, 64, 0, 0, 64, 64], [1024, 768, 16, 8, 512, 512]],
                                  np.float32)}
    ref = jax.jit(lambda p: jm.unet.apply({"params": p}, x, t, ctx, added))(params["unet"])
    with torch.inference_mode():
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      {k: torch.from_numpy(v) for k, v in added.items()})
        with pytest.raises(ValueError, match="added_cond"):
            tm.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=MODEL_ATOL)


def test_encode_text_sdxl_and_time_ids_match_jax(sdxl):
    jm, params, tm = sdxl
    ids = _ids(np.random.default_rng(84), 2)
    ctx_j, pooled_j = jax.jit(lambda p: js.encode_text_sdxl(jm, p, jnp.asarray(ids)))(params)
    ctx_t, pooled_t = ts.encode_text_sdxl(tm, torch.from_numpy(ids))
    assert ctx_t.shape == (2, 77, 16) and pooled_t.shape == (2, 8)
    np.testing.assert_allclose(ctx_t.detach().numpy(), np.asarray(ctx_j), atol=MODEL_ATOL,
                               rtol=MODEL_ATOL)
    np.testing.assert_allclose(pooled_t.detach().numpy(), np.asarray(pooled_j),
                               atol=MODEL_ATOL, rtol=MODEL_ATOL)
    for b, size in ((1, 1024), (3, 64)):
        np.testing.assert_array_equal(ts.sdxl_time_ids(b, size).numpy(),
                                      np.asarray(js.sdxl_time_ids(b, size)))


@pytest.mark.parametrize("sampler,gs", [("plms", 5.0), ("ddim", 1.0)])
def test_sdxl_img2img_matches_jax(sdxl, sampler, gs):
    """Under CFG both halves take the cond pooled embedding, as in JAX."""
    jm, params, tm = sdxl
    rng = np.random.default_rng(85)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = _ids(rng, 2)
    ctx, pooled = jax.jit(lambda p: js.encode_text_sdxl(jm, p, jnp.asarray(ids)))(params)
    prompt = (ctx[:1], pooled[:1])
    uncond = (ctx[1:], pooled[1:]) if gs > 1.0 else None
    key = jax.random.PRNGKey(17)
    ref = js.make_img2img_fn(jm, 10, 0.5, gs, sampler)(params, image, prompt, uncond, key)

    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in jax.random.split(key))
    tctx, tpooled = ts.encode_text_sdxl(tm, torch.from_numpy(ids))
    fn = ts.make_img2img_fn(tm, 10, 0.5, gs, sampler)
    got = fn(torch.from_numpy(image), (tctx[:1], tpooled[:1]),
             (tctx[1:], tpooled[1:]) if gs > 1.0 else None, noise=noise)
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def _capture(pipe, feeds, jax_side):
    """Wrap ``pipe._sampler_fn``: record the image and the conditioning each
    call of the sampling function takes; the JAX side returns its image."""
    orig = pipe._sampler_fn

    def sampler_fn(stack, kind, steps, strength, gs, sampler):
        real = None if jax_side else orig(stack, kind, steps, strength, gs, sampler)

        def fn(*args, **kwargs):
            image, prompt, uncond = args[1:4] if jax_side else args[:3]
            feeds.append({"plan": (kind, steps, strength, gs, sampler),
                          "image": np.asarray(image),
                          "cond": [np.asarray(t) for t in prompt + (uncond or ())]})
            return image if jax_side else real(*args, **kwargs)
        return fn

    pipe._sampler_fn = sampler_fn


def test_pipeline_serves_jax_sdxl_directory(sdxl, tmp_path):
    """A TINY_SDXL directory written by the JAX ``save_pipeline`` describes
    itself (no model_config given): the port serves it, feeding its sampling
    function what the JAX pipeline feeds its own."""
    _, params, tm = sdxl
    jck.save_pipeline(str(tmp_path), params, JC.TINY_SDXL)
    with open(tmp_path / "model_index.json") as f:
        assert "text_encoder_2" in json.load(f)["components"]
    config = {"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}}
    port = RestorationPipeline(config=config, dtype=torch.float32, device="cpu")
    ref = JaxPipeline(config=config, dtype=jnp.float32)
    feeds = {"port": [], "jax": []}
    _capture(port, feeds["port"], jax_side=False)
    _capture(ref, feeds["jax"], jax_side=True)
    image = np.random.default_rng(86).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out = port.denoise(image)
    out_nocfg = port.denoise(image, guidance=1.0)
    ref.denoise(image)
    ref.denoise(image, guidance=1.0)

    stack = port._stacks["denoise"]
    assert stack["modules"].is_sdxl and stack["spec"].model_config == TC.TINY_SDXL
    for o in (out, out_nocfg):
        assert o.dtype == np.uint8 and o.shape == (64, 64, 3)
    assert not np.array_equal(out, out_nocfg)
    loaded = stack["modules"].text_encoder_2.state_dict()
    for k, v in exported(params["text_encoder_2"]).items():
        assert torch.equal(loaded[k], v), k
    assert len(feeds["port"]) == len(feeds["jax"]) == 2
    for g, w in zip(feeds["port"], feeds["jax"]):
        assert g["plan"] == w["plan"]
        np.testing.assert_allclose(g["image"], w["image"], atol=IMAGE_TOL, rtol=0)
        assert len(g["cond"]) == len(w["cond"]) == (4 if g["plan"][3] > 1.0 else 2)
        for a, b in zip(g["cond"], w["cond"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)


def test_text_encoder_2_through_the_weight_bridge(sdxl):
    """``text_encoder_2`` (with ``text_projection``) and the UNet's Linear
    ``proj_in``/``proj_out`` load strictly from the JAX export, and the
    port's flax-path bridge gives the same tensors both ways."""
    _, params, tm = sdxl
    for comp in ("text_encoder_2", "unet"):
        flat = jck.flatten_params(params[comp])
        ours = tck.params_from_flax(flat)
        theirs = exported(params[comp])
        assert set(ours) == set(theirs)
        for k in theirs:
            assert torch.equal(ours[k], theirs[k]), k
        mod = tm.components()[comp]
        back = tck.flax_from_params(mod.state_dict(), tck.norm_module_names(mod))
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), err_msg=k)
    assert tuple(ours["down_blocks.1.attentions.0.proj_in.weight"].shape) == (16, 16)
    assert "text_projection.weight" in exported(params["text_encoder_2"])
    fresh = CLIPTextModel(TC.TINY_SDXL.text_encoder_2, with_projection=True)
    fresh.load_state_dict(exported(params["text_encoder_2"]), strict=True)
    with pytest.raises(RuntimeError, match="text_projection"):
        CLIPTextModel(TC.TINY_SDXL.text_encoder_2).load_state_dict(
            exported(params["text_encoder_2"]), strict=True)


def test_sdxl_parameter_counts_match_jax():
    """config.SDXL at full width, on the meta device, against the JAX
    package's ``eval_shape``; ``chip_smoke.py`` asserts the same constants
    on the card."""
    jm = js.SDModules.create(JC.SDXL, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    want = {c: int(sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(p)))
            for c, p in shapes.items()}
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(TC.SDXL_UNET), "vae": AutoencoderKL(TC.SDXL_VAE),
                "text_encoder": CLIPTextModel(TC.SDXL.text_encoder),
                "text_encoder_2": CLIPTextModel(TC.SDXL.text_encoder_2, with_projection=True)}
    got = {c: sum(p.numel() for p in m.parameters()) for c, m in mods.items()}
    assert got == want == chip_smoke.SDXL_PARAMS
    assert got["unet"] == 2_567_463_684
    cfg = TC.SDXL_UNET
    assert [cfg.heads_at(i) for i in range(3)] == [5, 10, 20]
    assert [cfg.tx_depth_at(i) for i in range(3)] == [1, 2, 10]
    assert {c // cfg.heads_at(i) for i, c in enumerate(cfg.block_out_channels)} == {64}
    assert cfg.attn_levels == (False, True, True)
    blocks = [m for m in mods["unet"].modules() if type(m).__name__ == "BasicTransformerBlock"]
    assert len(blocks) == 70


def test_inpaint_refuses_an_sdxl_stack(sdxl):
    with pytest.raises(ValueError, match="SDXL"):
        ts.make_inpaint_fn(sdxl[2], 4, 0.6, 5.0)
