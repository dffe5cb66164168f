"""PyTorch port inpaint loop and 9-channel UNet against the JAX package on
TINY_SD_INPAINT (fp32, CPU).

``make_inpaint_fn`` runs end to end on both sides with the same parameters
(VAE encode of the image and of the masked image, each with a posterior
sample, the nearest-resized mask, add_noise, the DDIM or PLMS loop over the
9-channel input [latents, mask, masked-image latents] with and without CFG,
VAE decode); the port is handed the three noise tensors the JAX function
draws from its own key splits.

Tolerances: the inpaint function at ``test_torch_serving.ATOL`` (2e-4 on
images in [-1, 1], the img2img parity limit, for the same reasons: the same
fp32 sums in another order, amplified a little by the late steps); the UNet
call alone at ``test_torch_models.ATOL`` (1e-4 on eps of magnitude ~1-5); the
mask resize exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from test_torch_models import ATOL as UNET_ATOL
from test_torch_serving import ATOL, _jax_encode_text, fill_params
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def inpaint_stacks():
    jm = js.SDModules.create(JC.TINY_SD_INPAINT, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=21)
    tm = ts.SDModules.create(TC.TINY_SD_INPAINT, dtype=torch.float32, device="cpu")
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])),
                            strict=True)
    return jm, params, tm


def _hole(h, w):
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, h // 4: 3 * h // 4 - 3, w // 8: w // 2 + 5] = 1.0
    return mask


@pytest.mark.parametrize("sampler,gs", [("ddim", 5.0), ("ddim", 1.0), ("plms", 5.0)])
def test_inpaint_fn_matches_jax(inpaint_stacks, sampler, gs):
    jm, params, tm = inpaint_stacks
    rng = np.random.default_rng(22)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = _hole(64, 64)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(jm, params, ids)
    prompt, uncond = ctx[:1], (ctx[1:] if gs > 1.0 else None)
    key = jax.random.PRNGKey(9)
    ref = js.make_inpaint_fn(jm, 10, 0.6, gs, sampler)(params, image, mask, prompt, uncond, key)

    # the JAX function's draws: k_enc (image posterior), k_mask_enc (masked
    # image posterior), k_noise (add_noise), handed over in the port's order
    k_enc, k_mask_enc, k_noise = jax.random.split(key, 3)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in (k_enc, k_mask_enc, k_noise))
    tctx = ts.encode_text(tm, torch.from_numpy(ids))
    fn = ts.make_inpaint_fn(tm, 10, 0.6, gs, sampler)
    got = fn(torch.from_numpy(image), torch.from_numpy(mask), tctx[:1],
             tctx[1:] if gs > 1.0 else None, noise=noise)
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)

    # without noise=, the three draws come from the generator in that order
    gen_out = fn(torch.from_numpy(image), torch.from_numpy(mask), tctx[:1],
                 tctx[1:] if gs > 1.0 else None, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    drawn = tuple(torch.randn((1, 8, 8, 4), generator=g) for _ in range(3))
    same = fn(torch.from_numpy(image), torch.from_numpy(mask), tctx[:1],
              tctx[1:] if gs > 1.0 else None, noise=drawn)
    torch.testing.assert_close(gen_out, same, rtol=0, atol=0)


def test_inpaint_unet_matches_jax(inpaint_stacks):
    jm, params, tm = inpaint_stacks
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    ref = jax.jit(lambda p: jm.unet.apply({"params": p}, x, t, ctx))(params["unet"])
    with torch.inference_mode():
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert tm.unet.conv_in.weight.shape[1] == 9 and got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=UNET_ATOL, rtol=UNET_ATOL)


def test_sd15_inpaint_unet_parameter_count():
    """SD-1.5's 859,520,964 plus conv_in's five extra input channels (5 x 320 x 9)."""
    with torch.device("meta"):
        unet = UNet2DCondition(TC.SD15_INPAINT_UNET)
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964 + 5 * 320 * 9


@pytest.mark.parametrize("src,dst", [((64, 48), (8, 6)), ((40, 56), (5, 7)),
                                     ((72, 24), (9, 3)), ((30, 50), (7, 11))])
def test_mask_resize_nearest_exact_matches_jax(src, dst):
    """JAX's "nearest" samples each output cell at its centre, as torch's
    "nearest-exact" does; torch's "nearest" differs (top-left of the cell)."""
    rng = np.random.default_rng(24)
    mask = (rng.random((1,) + src + (1,)) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(mask), (1,) + dst + (1,), method="nearest"))
    t = torch.from_numpy(mask).permute(0, 3, 1, 2)
    got = F.interpolate(t, size=dst, mode="nearest-exact").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    plain = F.interpolate(t, size=dst, mode="nearest").permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(plain, ref)
