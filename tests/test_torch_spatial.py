"""Height-sharded (spatial) serving in the port against the JAX package, on gloo
ranks on the CPU (fp32).

The JAX references are the UNSHARDED functions in the "interleaved" CFG layout
with XLA attention: TINY_SD img2img, TINY_SD_INPAINT inpaint and TINY_SDXL
img2img at 128 px. The port's 8 gloo ranks are spawned once for the module
(``parallel/launch.py`` running ``parallel/serve.run_cases``, a function of the
port) and serve, after ``tests/test_tensor_parallel.py``:

- img2img over (data 4, sp 2): latent levels 16/8/4/2, of which 16 and 8 keep
  >= 4 rows a shard and stay height-sharded; over (data 2, sp 4), the gate's
  boundary (level 16 holds exactly 4 rows a shard; 8/4/2 hold 2, 1 and 0.5 and
  run gathered); over (data 1, sp 8), where only the VAE's levels are sharded;
- inpaint (9-channel UNet, mask and masked-image latents) over (data 4, sp 2);
- TINY_SDXL (two text towers, text_time conditioning) over (data 4, sp 2);
- the three halo geometries alone, each against the unsharded conv on the same
  input: 3x3 stride 1 (``Conv2d``), ``Downsample2D`` (stride 2, pad 1: a row
  from above) and the VAE's downsample ((0, 1) pad, stride 2: a row from
  below), at shards of 8, 6, 5 (odd: gathered first) and 4 rows.

In the test process: the gate's rule (the JAX unit's table), GroupNorm's
sharded split of the statistics against the unsharded reference, the image
height that does not divide, and ToMe turned off under spatial sharding.

Tolerance: 2e-4 absolute on images in [-1, 1], as ``test_torch_serving.py``
states it for the unsharded port; the halo convs and the GroupNorm split to
1e-5 (one layer: the same fp32 products, the sums in another order at most).
"""
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.ops import groupnorm as G
from image_restoration_and_enhancement_torch.parallel import launch, serve, spatial
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (fixture)

ATOL = 2e-4
LAYER_ATOL = 1e-5
B, SIZE = 4, 128
WORLD = 8
IMG2IMG = dict(num_inference_steps=3, strength=0.8, guidance_scale=5.0, sampler="ddim")
INPAINT = dict(num_inference_steps=3, strength=0.9, guidance_scale=5.0, sampler="ddim")
SDXL = dict(num_inference_steps=2, strength=0.8, guidance_scale=5.0, sampler="ddim")
SP = {"data_axis": "data", "spatial_axis": "sp"}
# name -> (model, mesh shape, sampling)
SERVES = {
    "dp_sp": ("sd", (4, 2), IMG2IMG),
    "dp_sp4_gate_boundary": ("sd", (2, 4), IMG2IMG),
    "sp8_vae_only": ("sd", (1, 8), IMG2IMG),
    "inpaint_dp_sp": ("inpaint", (4, 2), INPAINT),
    "sdxl_dp_sp": ("sdxl", (4, 2), SDXL),
}
# (mesh shape, geometry, height): shards of 8, 6, 5 and 4 rows
HALOS = [((4, 2), g, h) for g in ("stride1", "down", "vae_down") for h in (16, 12, 10)]
HALOS += [((2, 4), g, 16) for g in ("stride1", "down", "vae_down")]


def _stack(config, seed):
    jm = js.SDModules.create(config, dtype=jnp.float32, attention_backend="xla")
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=seed)
    weights = {comp: {k: v.numpy() for k, v in
                      tck.params_from_flax(jck.flatten_params(params[comp])).items()}
               for comp in params}
    return jm, params, weights


def _noise(key, n):
    return tuple(np.array(jax.random.normal(k, (B, SIZE // 8, SIZE // 8, 4), jnp.float32))
                 for k in jax.random.split(key, n))


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(41)
    image = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((B, SIZE, SIZE, 1), np.float32)
    mask[:, 32:96, 24:104] = 1.0
    ids = [jnp.asarray(rng.integers(3, 128, (B, 77)), jnp.int32) for _ in range(2)]
    key = jax.random.PRNGKey(42)
    refs, inputs, weights = {}, {}, {}
    for model, config, seed in (("sd", JC.TINY_SD, 43), ("inpaint", JC.TINY_SD_INPAINT, 44),
                                ("sdxl", JC.TINY_SDXL, 45)):
        jm, params, weights[model] = _stack(config, seed)
        if model == "sdxl":
            enc = jax.jit(lambda p, i, jm=jm: js.encode_text_sdxl(jm, p, i))
            (ctx, pooled), (unc, _) = (enc(params, i) for i in ids)
            ctx_j, unc_j = (ctx, pooled), (unc, pooled)
        else:
            enc = jax.jit(lambda p, i, jm=jm: js.encode_text(jm, p, i))
            ctx, unc = (enc(params, i) for i in ids)
            ctx_j, unc_j, pooled = ctx, unc, None
        samp = {"sd": IMG2IMG, "inpaint": INPAINT, "sdxl": SDXL}[model]
        steps, strength, gs, sampler = samp.values()
        if model == "inpaint":
            fn = js.make_inpaint_fn(jm, steps, strength, gs, sampler, cfg_layout="interleaved")
            refs[model] = np.asarray(fn(params, image, mask, ctx_j, unc_j, key))
        else:
            fn = js.make_img2img_fn(jm, steps, strength, gs, sampler, cfg_layout="interleaved")
            refs[model] = np.asarray(fn(params, image, ctx_j, unc_j, key))
        inputs[model] = dict(image=image, ctx=np.asarray(ctx), uncond=np.asarray(unc),
                             noise=_noise(key, 3 if model == "inpaint" else 2))
        if model == "inpaint":
            inputs[model]["mask"] = mask
        if pooled is not None:
            inputs[model]["pooled"] = np.asarray(pooled)
    configs = {"sd": "tiny_sd", "inpaint": "tiny_sd_inpaint", "sdxl": "tiny_sdxl"}
    cases = [dict(config=configs[model], dtype="float32", weights=weights[model],
                  backend="xla", kind="inpaint" if model == "inpaint" else "img2img",
                  mesh=(shape, ("data", "sp")), axes=SP, sampling=samp, inputs=inputs[model])
             for model, shape, samp in SERVES.values()]
    x_rng = np.random.default_rng(46)
    cases += [dict(kind="halo", mesh=(shape, ("data", "sp")), axes=SP,
                   inputs=dict(x=x_rng.standard_normal((2, h, 6, 8)).astype(np.float32),
                               geometry=g, seed=47))
              for shape, g, h in HALOS]
    ranks = launch.launch(serve.run_cases, WORLD, "gloo", (cases,))
    return {"refs": refs, "ranks": ranks, "names": list(SERVES) + HALOS}


def _result(served, name, rank=0):
    return served["ranks"][rank][served["names"].index(name)]


@pytest.mark.parametrize("name", list(SERVES))
def test_sharded_serve_matches_jax(served, name):
    out = _result(served, name)["out"]
    assert out.shape == (B, SIZE, SIZE, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, served["refs"][SERVES[name][0]], atol=ATOL, rtol=0)
    # every rank returns the whole image: the halos and gathers ran
    assert _result(served, name, WORLD - 1)["collectives"].get("halo", 0) > 0


@pytest.mark.parametrize("case", HALOS, ids=[f"{g}-h{h}-sp{s[1]}" for s, g, h in HALOS])
def test_halo_geometries_match_unsharded_conv(served, case):
    assert _result(served, case)["out"] <= LAYER_ATOL


def test_gate_policy_unit():
    """Height-sharded while H % sp == 0 and H / sp >= 4 (the JAX unit's table
    at sp 2, and the sp 4 boundary)."""
    pol2 = spatial.Policy(group=None, size=2, index=0)
    for h, want in [(16, True), (8, True), (4, False), (2, False), (6, False)]:
        assert pol2.gate(h) == want, h
    pol4 = spatial.Policy(group=None, size=4, index=0)
    for h, want in [(16, True), (8, False), (4, False), (2, False)]:
        assert pol4.gate(h) == want, h
    assert spatial.active() is None and spatial.sharded() is None
    x = torch.zeros(1, 16, 4, 3)
    assert spatial.scatter_rows(x) is x and spatial.gather_rows(x, 16) is x


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_sharded_split(act):
    """Each shard's partial statistics, gathered in rank order and reduced by
    the apply entry over the global count, give the unsharded GroupNorm."""
    gen = torch.Generator().manual_seed(48)
    x = torch.randn((2, 16, 5, 24), generator=gen) * 3 + 1
    scale, bias = torch.randn(24, generator=gen), torch.randn(24, generator=gen)
    want = G.group_norm_reference(x, scale, bias, 4, 1e-6, act)
    shards = x.chunk(4, dim=1)
    parts = torch.cat([G.group_norm_stats(s, 4) for s in shards], dim=1)
    assert parts.shape == (2, 4, 4, 2)
    count = float(16 * 5 * 24 // 4)
    got = torch.cat([G.group_norm_apply(s, scale, bias, parts, count, 4, 1e-6, act)
                     for s in shards], dim=1)
    torch.testing.assert_close(got, want, atol=LAYER_ATOL, rtol=LAYER_ATOL)
    # a shard normalised with its own statistics alone is another function
    alone = G.group_norm_reference(shards[0], scale, bias, 4, 1e-6, act)
    assert (alone - want[:, :4]).abs().max() > 1e-2


def test_uneven_height_raises():
    fake = types.SimpleNamespace(device=torch.device("cpu"),
                                 size=lambda axis: 2 if axis == "sp" else 1)
    modules = ts.SDModules.create(TC.TINY_SD, torch.float32, "cpu")
    fn, _ = ts.make_sharded_img2img_fn(modules, fake, 3, 0.8, 5.0, "ddim", data_axis=None,
                                       spatial_axis="sp")
    image = torch.zeros(1, 63, 64, 3)
    with pytest.raises(ValueError, match="image height"):
        fn(image, torch.zeros(1, 77, 16), None)


def test_tome_off_under_spatial_sharding(caplog):
    fake = types.SimpleNamespace(device=torch.device("cpu"))
    with caplog.at_level(logging.WARNING):
        pipe = RestorationPipeline(mesh=fake, spatial_axis="sp", tome_ratio=0.5)
    assert not pipe.tome.active
    assert "token merging disabled" in caplog.text
