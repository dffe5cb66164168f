"""PyTorch port models against the JAX package on the TINY_* configs.

Parameters come from the JAX modules' own parameter tree (``jax.eval_shape`` of
their init, filled from a seeded numpy generator with non-trivial norm scales
and biases), go to the port through ``params_from_flax`` and are checked
against the JAX package's ``export_torch_state_dict``. Both sides then run the
same numpy inputs in fp32.

Tolerance: 1e-4 absolute on outputs of magnitude ~1-5. The two frameworks take
the same fp32 sums in another order (convolutions, matmuls, the GroupNorm and
LayerNorm statistics); observed differences are a few 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.models import layers as tl
from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.models import layers as jl
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-4


def fill_params(shapes, seed):
    """Random values for a flax parameter tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        shape = s.shape
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "embedding" in name:
            return (0.5 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_flax(module, *args, seed=0):
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0))
    return fill_params(shapes["params"], seed)


@pytest.fixture(scope="module")
def stacks():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=0)
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu")
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])))
    return jm, params, tm


@pytest.mark.parametrize("comp", ["unet", "vae", "text_encoder"])
def test_bridge_strict_load_matches_export(stacks, comp):
    jm, params, tm = stacks
    flat = jck.flatten_params(params[comp])
    bridged = tck.params_from_flax(flat)
    exported = jck.export_torch_state_dict(params[comp])
    assert set(bridged) == set(exported)
    for k, v in bridged.items():
        np.testing.assert_array_equal(v.numpy(), exported[k], err_msg=k)
    fresh = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu")
    result = fresh.components()[comp].load_state_dict(bridged, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # and back: the port's state dict -> flax paths is the identity on the tree
    mod = tm.components()[comp]
    back = tck.flax_from_params(mod.state_dict(), tck.norm_module_names(mod))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_unet_eps_matches_jax(stacks):
    jm, params, tm = stacks
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    ref = jax.jit(lambda p: jm.unet.apply({"params": p}, x, t, ctx))(params["unet"])
    with torch.inference_mode():
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_vae_encode_decode_match_jax(stacks):
    jm, params, tm = stacks
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    enc = jax.jit(lambda p: jm.vae.apply({"params": p}, img, method=jm.vae.encode))(params["vae"])
    dec = jax.jit(lambda p: jm.vae.apply({"params": p}, z, method=jm.vae.decode))(params["vae"])
    with torch.inference_mode():
        tenc = tm.vae.encode(torch.from_numpy(img))
        tdec = tm.vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(tenc.mean.numpy(), np.asarray(enc.mean), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tenc.logvar.numpy(), np.asarray(enc.logvar), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=ATOL, rtol=ATOL)
    noise = rng.standard_normal(tenc.mean.shape).astype(np.float32)
    ref_sample = np.asarray(enc.mean) + np.exp(0.5 * np.asarray(enc.logvar)) * noise
    np.testing.assert_allclose(tenc.sample(torch.from_numpy(noise)).numpy(), ref_sample,
                               atol=ATOL, rtol=ATOL)


def test_clip_hidden_state_matches_jax(stacks):
    jm, params, tm = stacks
    ids = np.random.default_rng(3).integers(0, 128, (2, 77)).astype(np.int32)
    ref = jax.jit(lambda p: jm.text_encoder.apply({"params": p}, ids))(params["text_encoder"])
    with torch.inference_mode():
        got = tm.text_encoder(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def _load(module, flax_params):
    module.load_state_dict(tck.params_from_flax(jck.flatten_params(flax_params)), strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_resnet_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jb = jl.ResnetBlock2D(16, groups=4, eps=1e-5)
    p = init_flax(jb, x, temb)
    ref = jax.jit(lambda p: jb.apply({"params": p}, x, temb))(p)
    tb = _load(tl.ResnetBlock2D(8, 16, groups=4, eps=1e-5, temb_channels=32), p)
    with torch.inference_mode():
        got = tb(_nchw(x), torch.from_numpy(temb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_transformer2d_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 12)).astype(np.float32)
    jb = jl.Transformer2D(heads=2, head_dim=8, groups=4)
    p = init_flax(jb, x, ctx)
    ref = jax.jit(lambda p: jb.apply({"params": p}, x, ctx))(p)
    tb = _load(tl.Transformer2D(16, heads=2, head_dim=8, context_dim=12, groups=4), p)
    with torch.inference_mode():
        got = tb(_nchw(x), torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_vae_attention_block_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    jb = jl.VAEAttentionBlock(groups=4)
    p = init_flax(jb, x)
    ref = jax.jit(lambda p: jb.apply({"params": p}, x))(p)
    tb = _load(tl.VAEAttentionBlock(16, groups=4), p)
    with torch.inference_mode():
        got = tb(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_geglu_uses_tanh_gelu_like_jax():
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2, 5, 8))).astype(np.float32)
    jb = jl.GEGLUFeedForward(8)
    p = init_flax(jb, x)
    ref = np.asarray(jax.jit(lambda p: jb.apply({"params": p}, x))(p))
    tb = tl.GEGLUFeedForward(8)
    tb.load_state_dict({k.replace("ff.", "", 1): v for k, v in tck.params_from_flax(
        {"ff/" + k: v for k, v in jck.flatten_params(p).items()}).items()}, strict=True)
    with torch.inference_mode():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    # the erf GELU (diffusers' choice) would not match
    proj = tb.net[0].proj
    with torch.inference_mode():
        h, gate = proj(torch.from_numpy(x)).chunk(2, dim=-1)
        erf = tb.net[2](h * torch.nn.functional.gelu(gate)).numpy()
    assert np.abs(erf - ref).max() > 10 * ATOL


def test_layer_norm_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(8)
    # A moderate mean: E[x^2]-E[x]^2 in fp32 loses digits as mean/std grows, in
    # both frameworks alike, in a summation order each picks.
    x = (3.0 + rng.standard_normal((3, 5, 16))).astype(np.float32)
    jb = jl.FusedLayerNorm()
    p = init_flax(jb, x)
    ref = np.asarray(jb.apply({"params": p}, x))
    ln = tl.FusedLayerNorm(16)
    ln.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"])})
    with torch.inference_mode():
        np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), ref, atol=ATOL, rtol=ATOL)
    t = np.array([0, 1, 999, 500], np.int32)
    for flip in (True, False):
        ref = np.asarray(jl.timestep_embedding(jnp.asarray(t), 33, flip_sin_to_cos=flip))
        got = tl.timestep_embedding(torch.from_numpy(t), 33, flip_sin_to_cos=flip)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_sd15_unet_parameter_count():
    with torch.device("meta"):
        unet = UNet2DCondition(TC.SD15_UNET)
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964
