"""The port's int8 (dynamic w8a8) inpaint against the JAX package, call by call
and layer by layer, on TINY_SD_INPAINT (CPU).

A 4-step DDIM inpaint run at gs 5.0 (strength 1.0: four 9-channel UNet calls
at the CFG batch) is replayed from the JAX package's own modules: the two VAE
encodes (the image and the masked image, each with its posterior sample),
every UNet call and the decode, each jitted under ``quant_mode("int8")`` with
the Pallas int8 conv (``IRET_CONV_KERNEL=1``, interpret mode patched in as
``tests/test_quant.py`` does) and the Pallas int8 attention
(``attention_backend="int8_interpret"``). Every quantized layer (``QConv``,
``QDense``) records its input and output. The replay is first shown to be the
inpaint function: in full precision its image agrees with
``make_inpaint_fn``'s to the inpaint parity limit. The port's quantized
modules (``QuantState("int8")``, ``attention_backend="int8"``: K3's and K4's
plain versions on the CPU) are then held to each call.

Checks and tolerances, for each call:
- layer parity, at every quantized layer of the call (163 in each UNet
  call): the port's layer on the JAX layer's own input gives its output to
  within 4 float32 roundings of the layer's largest output. Both quantize
  the same input to the same s8 values and take exact int32 sums; JAX's
  jitted call fuses the rescale and bias with its neighbours.
- the call's output, the port's modules fed the call's JAX input, agrees to
  ``test_torch_models.ATOL`` (1e-4; the decoded image to
  ``test_torch_serving.ATOL``, 2e-4), unless an s8 rounding flip occurred
  in the call: the first layer whose input quantizes to other s8 values on
  the two sides must then differ by one step there, with float inputs equal
  to fp32 noise (1e-5 of their largest), i.e. a value that the two
  frameworks' summation orders put on either side of a rounding boundary.
  From such a flip on the random-weight network amplifies the difference
  (``test_torch_quant_serving``'s docstring), and layer parity, not the
  call's output, is what holds the code to JAX there.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.models import layers as tl
from image_restoration_and_enhancement_torch.ops import quant as tq
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.core import schedulers as jsch
from image_restoration_and_enhancement_tpu.models import layers as jl
from image_restoration_and_enhancement_tpu.ops import conv_int8 as jconv
from image_restoration_and_enhancement_tpu.ops import quant as jq
from test_torch_inpaint import _hole
from test_torch_models import ATOL as MODEL_ATOL
from test_torch_sdxl import load_jax_weights
from test_torch_serving import ATOL, _jax_encode_text, fill_params
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)

STEPS, STRENGTH, GS = 4, 1.0, 5.0
LAYER_ROUNDINGS = 4
CALLS = ["encode_image", "encode_masked", "unet_0", "unet_1", "unet_2", "unet_3", "decode"]


def _record(next_fun, args, kwargs, context):
    """flax method interceptor: every quantized layer sows (input, output)."""
    out = next_fun(*args, **kwargs)
    if isinstance(context.module, (jl._SiteConv, jl._SiteDense)) \
            and context.method_name == "__call__":
        context.module.sow("intermediates", "io", (args[0], out))
    return out


def _layers(state):
    """{site: [(input, output) of each of its calls]} from the sown
    intermediates (numpy, NHWC)."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "io":
                out[prefix] = [(np.asarray(x), np.asarray(y)) for x, y in v]
            else:
                walk(v, f"{prefix}/{k}" if prefix else k)
    walk(state.get("intermediates", {}), "")
    return out


def _replay(jm, params, image, mask, ctx, key):
    """The JAX inpaint function (DDIM, halves layout) call by call, under the
    current quant mode: {call: {"args", "out", "layers"}}, numpy."""
    sc, vcfg = jm.config.scheduler, jm.config.vae
    ac = jnp.asarray(jsch.make_alphas_cumprod(sc), jnp.float32)
    fa = jsch.final_alpha_cumprod(sc)
    plan = jsch.ddim_step_plan(sc, STEPS, STRENGTH)
    ctx_all = jnp.concatenate([ctx[1:], ctx[:1]], axis=0)  # [uncond; cond]

    def traced(fn):
        def run(*args):
            with nn.intercept_methods(_record):
                return fn(*args)
        return jax.jit(run)

    vae_apply = lambda p, x, method: jm.vae.apply(  # noqa: E731
        {"params": p["vae"]}, x, method=method, mutable=["intermediates"])
    encode = traced(lambda p, x, k: (lambda r: (r[0].sample(k) * vcfg.scaling_factor, r[1]))(
        vae_apply(p, x, jm.vae.encode)))
    unet = traced(lambda p, x, t, c: jm.unet.apply({"params": p["unet"]}, x, t, c,
                                                  mutable=["intermediates"]))
    decode = traced(lambda p, lat: (lambda r: (jnp.clip(r[0], -1.0, 1.0), r[1]))(
        vae_apply(p, lat / vcfg.scaling_factor, jm.vae.decode)))
    calls = {}

    def record(name, fn, *args):
        out, state = fn(params, *args)
        calls[name] = {"args": [np.asarray(a) for a in args], "out": np.asarray(out),
                       "layers": _layers(state)}
        return out

    k_enc, k_mask_enc, k_noise = jax.random.split(key, 3)
    masked_latents = record("encode_masked", encode, image * (1.0 - mask), k_mask_enc)
    mask_lat = jax.image.resize(mask, (1, 8, 8, 1), method="nearest")
    latents0 = record("encode_image", encode, image, k_enc)
    noise = jax.random.normal(k_noise, latents0.shape, jnp.float32)
    lat = jsch.add_noise(ac, latents0, noise, jnp.asarray(plan.init_timestep))
    for i, (t, prev_t) in enumerate(zip(plan.timesteps.tolist(),
                                        plan.prev_timesteps.tolist())):
        model_in = jnp.concatenate([lat, mask_lat, masked_latents], axis=-1)
        model_in = jnp.concatenate([model_in, model_in], axis=0)
        eps = record(f"unet_{i}", unet, model_in, jnp.full((2,), t, jnp.int32), ctx_all)
        eps_u, eps_c = jnp.split(eps, 2, axis=0)
        lat = jsch.ddim_step(ac, fa, lat, eps_u + GS * (eps_c - eps_u), t, prev_t)
    record("decode", decode, lat)
    return calls


@pytest.fixture(scope="module")
def replay():
    rng = np.random.default_rng(111)
    plain = js.SDModules.create(JC.TINY_SD_INPAINT, dtype=jnp.float32)
    jm = js.SDModules.create(JC.TINY_SD_INPAINT, dtype=jnp.float32,
                             attention_backend="int8_interpret")
    shapes = jax.eval_shape(lambda k: js.init_params(plain, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=112)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = _hole(64, 64)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(plain, params, ids)
    key = jax.random.PRNGKey(113)
    tm, exact = (ts.SDModules.create(TC.TINY_SD_INPAINT, dtype=torch.float32, device="cpu",
                                     attention_backend=b) for b in ("int8", None))
    load_jax_weights(tm, params)
    load_jax_weights(exact, params)

    # the replay is the inpaint function: in full precision (exact attention)
    # its image is make_inpaint_fn's, here the port's (test_torch_inpaint.py
    # holds that one to JAX's at the same limit), on JAX's three draws
    fp32 = _replay(plain, params, image, mask, ctx, key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in jax.random.split(key, 3))
    tctx = torch.from_numpy(np.array(ctx))
    ref = ts.make_inpaint_fn(exact, STEPS, STRENGTH, GS, "ddim")(
        torch.from_numpy(image), torch.from_numpy(mask), tctx[:1], tctx[1:], noise=noise)
    np.testing.assert_allclose(fp32["decode"]["out"], ref.numpy(), atol=ATOL, rtol=ATOL)
    assert len([c for c in fp32 if c.startswith("unet")]) == 4

    real = jconv.conv3x3_same_int8

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "conv3x3_same_int8", interpret)
        mp.setenv("IRET_CONV_KERNEL", "1")
        with jq.quant_mode("int8"):
            calls = _replay(jm, params, image, mask, ctx, key)
    tm.set_quant(tq.QuantState("int8"))
    return calls, fp32, tm


def _port_call(tm, name, args):
    """The port's modules on a call's JAX input: (output, [(site, index of the
    site's call, input)] in the order the layers ran)."""
    inputs, count = [], {}

    def hook(mod, a, out):
        x = a[0].detach()
        count[mod.site] = count.get(mod.site, -1) + 1
        inputs.append((mod.site, count[mod.site],
                       (tl.to_nhwc(x) if x.dim() == 4 else x).numpy().copy()))

    root = tm.unet if name.startswith("unet") else tm.vae
    hooks = [m.register_forward_hook(hook) for m in root.modules()
             if isinstance(m, tl._Quantized)]
    t = [torch.from_numpy(a.copy()) for a in args]
    try:
        with torch.inference_mode():
            if name.startswith("encode"):
                noise = torch.from_numpy(np.array(jax.random.normal(args[1], (1, 8, 8, 4))))
                out = ts.encode_image(tm, t[0], noise)
            elif name == "decode":
                out = ts.decode_latents(tm, t[0])
            else:
                out = tm.unet(*t)
    finally:
        for h in hooks:
            h.remove()
    return out.numpy(), inputs


def _port_layer(tm, site, x):
    """The port's quantized layer at ``site`` (UNet or VAE) on ``x`` (NHWC)."""
    mod = next(m for root in (tm.unet, tm.vae) for m in root.modules()
               if isinstance(m, tl._Quantized) and m.site == site)
    xt = torch.from_numpy(x.copy())
    with torch.inference_mode():
        y = mod(tl.from_nhwc(xt) if xt.dim() == 4 else xt)
    return (tl.to_nhwc(y) if y.dim() == 4 else y).numpy()


@pytest.mark.parametrize("name", CALLS)
def test_int8_inpaint_layers_match_jax(replay, name):
    calls, _, tm = replay
    layers = calls[name]["layers"]
    root = tm.unet if name.startswith("unet") else tm.vae
    sites = {m.site for m in root.modules() if isinstance(m, tl._Quantized)}
    assert layers and set(layers) <= sites
    if root is tm.unet:
        assert set(layers) == sites and len(sites) == 163
    for site, records in layers.items():
        for x, y in records:
            got = _port_layer(tm, site, x)
            limit = LAYER_ROUNDINGS * np.finfo(np.float32).eps * np.abs(y).max()
            assert got.shape == y.shape, site
            assert np.abs(got - y).max() <= limit, (site, np.abs(got - y).max(), limit)


@pytest.mark.parametrize("name", CALLS)
def test_int8_inpaint_calls_match_jax_up_to_a_rounding_flip(replay, name):
    calls, fp32, tm = replay
    call = calls[name]
    got, inputs = _port_call(tm, name, call["args"])
    want = call["out"]
    assert got.shape == want.shape
    assert np.abs(want - fp32[name]["out"]).max() > 100 * MODEL_ATOL  # int8 is not fp32
    quantize = tq.QuantState("int8").quantize_activation
    first_flip = None
    for site, index, xp in inputs:  # in the order the port's layers ran
        xj = call["layers"][site][index][0]
        qp, qj = (quantize(torch.from_numpy(x), None)[0].numpy().astype(int) for x in (xp, xj))
        if not np.array_equal(qp, qj):
            first_flip = (site, xp, xj, qp, qj)
            break
    limit = ATOL if name == "decode" else MODEL_ATOL
    if first_flip is None:
        np.testing.assert_allclose(got, want, atol=limit, rtol=limit)
        return
    site, xp, xj, qp, qj = first_flip
    assert np.abs(qp - qj).max() == 1, site
    assert np.abs(xp - xj).max() <= 1e-5 * np.abs(xj).max(), site
