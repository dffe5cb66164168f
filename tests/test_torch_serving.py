"""PyTorch port serving path against the JAX package on TINY_SD (fp32, CPU).

``make_img2img_fn`` runs end to end (VAE encode + posterior sample, add_noise,
the PLMS or DDIM loop with and without CFG, VAE decode) on both sides with the
same parameters; the port is handed the noise the JAX function draws from its
own key splits. ``RestorationPipeline.denoise`` then reads a pipeline
directory written by the JAX ``save_pipeline``.

Tolerance: 2e-4 absolute on images in [-1, 1]. Each of the 5 loop steps and
the VAE take the same fp32 sums in another order in the two frameworks
(per-op differences of a few 1e-6), and the PLMS/DDIM updates divide by
sqrt(alpha_bar) of late timesteps, which amplifies them a little.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer import fallbacks as tfallbacks
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models import layers as tlayers
from image_restoration_and_enhancement_torch.ops._build import KernelError
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.models.tokenizer import HashTokenizer

ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the whole module: TINY pipelines are thousands
    of tiny ops, whose thread-pool barriers stall when the Tier-1 command's
    parallel workers share the CPU's cores. Files that import this fixture
    get it too."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def fill_params(shapes, seed):
    """Random values for a flax parameter tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "embedding" in name:
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_ENCODERS = {}   # id(modules) -> (modules, jitted encode_text): one compile per stack


def _jax_encode_text(jm, params, ids):
    # jitted: one compile instead of one per op of the eager flax apply
    entry = _ENCODERS.get(id(jm))
    if entry is None or entry[0] is not jm:
        entry = _ENCODERS[id(jm)] = (jm, jax.jit(lambda p, i: js.encode_text(jm, p, i)))
    return entry[1](params, jnp.asarray(ids))


@pytest.fixture(scope="module")
def stacks():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=11)
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu")
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])),
                            strict=True)
    return jm, params, tm


@pytest.mark.parametrize("gs", [5.0, 1.0])
def test_img2img_plms_matches_jax(stacks, gs):
    check_img2img(stacks, "plms", gs)


def check_img2img(stacks, sampler, gs):
    jm, params, tm = stacks
    rng = np.random.default_rng(12)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(jm, params, ids)
    prompt, uncond = ctx[:1], (ctx[1:] if gs > 1.0 else None)
    key = jax.random.PRNGKey(7)
    ref = js.make_img2img_fn(jm, 10, 0.5, gs, sampler)(params, image, prompt, uncond, key)

    k_enc, k_noise = jax.random.split(key)
    lat_shape = (1, 8, 8, 4)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, lat_shape, jnp.float32)))
                  for k in (k_enc, k_noise))
    tctx = ts.encode_text(tm, torch.from_numpy(ids))
    np.testing.assert_allclose(tctx.detach().numpy(), np.asarray(ctx), atol=ATOL, rtol=ATOL)
    fn = ts.make_img2img_fn(tm, 10, 0.5, gs, sampler)
    got = fn(torch.from_numpy(image), tctx[:1], tctx[1:] if gs > 1.0 else None, noise=noise)
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_pipeline_denoise_reads_jax_checkpoint(stacks, tmp_path, caplog):
    jm, params, tm = stacks
    jck.save_pipeline(str(tmp_path), params, JC.TINY_SD)
    pipe = RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}},
        dtype=torch.float32, device="cpu")
    image = np.random.default_rng(13).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    with caplog.at_level(logging.INFO):
        out = pipe.denoise(image)
        out_nocfg = pipe.denoise(image, guidance=1.0)
    assert not [r for r in caplog.records if "failed" in r.getMessage()]
    for o in (out, out_nocfg):
        assert isinstance(o, np.ndarray) and o.dtype == np.uint8 and o.shape == (64, 64, 3)
    assert not np.array_equal(out, out_nocfg)

    stack = pipe._stacks["denoise"]
    assert stack["spec"].model_config == TC.TINY_SD
    loaded = stack["modules"].unet.state_dict()
    for k, v in tck.params_from_flax(jck.flatten_params(params["unet"])).items():
        assert torch.equal(loaded[k], v), k
    # the prompt context: the port's tokenizer copy and text encoder against JAX's
    prompt = pipe.prompts["denoise"]
    ids = HashTokenizer(vocab_size=JC.TINY_CLIP_TEXT.vocab_size)([prompt])
    ref = _jax_encode_text(jm, params, ids)
    np.testing.assert_allclose(pipe._context(stack, prompt).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=ATOL)

    # same seed, same request -> same answer; a ragged size is bucketed and restored
    np.testing.assert_array_equal(pipe.denoise(image), out)
    odd = pipe.process(image[:50, :60], ["denoise"])
    assert odd["final"].shape == (50, 60, 3) and set(odd) == {"original", "denoised", "final"}


def _tiny_pipeline(stacks, tmp_path):
    _, params, _ = stacks
    jck.save_pipeline(str(tmp_path), params, JC.TINY_SD)
    return RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}},
        dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("entry", ["denoise", "process"])
def test_pipeline_kernel_failure_propagates(stacks, tmp_path, monkeypatch, caplog, entry):
    """A kernel that fails to launch raises out of the pipeline: it is never
    served by the OpenCV fallback."""
    pipe = _tiny_pipeline(stacks, tmp_path)

    def failing_attention(*args):
        raise KernelError("attention kernel launch failed: cudaError 1 (invalid argument)")

    monkeypatch.setattr(tlayers, "attention", failing_attention)
    image = np.random.default_rng(15).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    call = {"denoise": lambda: pipe.denoise(image),
            "process": lambda: pipe.process(image, ["denoise"])}[entry]
    with caplog.at_level(logging.INFO), pytest.raises(KernelError, match="launch failed"):
        call()
    assert not [r for r in caplog.records if "fallback" in r.getMessage()
                or "Error processing" in r.getMessage()]


def test_pipeline_falls_back_only_on_the_cpu(stacks, tmp_path, monkeypatch, caplog):
    """The JAX pipeline's catch-all stays for a CPU pipeline; on the card any
    failure of the SD run raises."""
    pipe = _tiny_pipeline(stacks, tmp_path)

    def broken_attention(*args):
        raise ValueError("broken attention")

    monkeypatch.setattr(tlayers, "attention", broken_attention)
    image = np.random.default_rng(16).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    with caplog.at_level(logging.ERROR):
        out = pipe.denoise(image)
    assert out.dtype == np.uint8 and out.shape == (64, 64, 3)
    assert [r for r in caplog.records if "SD denoise failed" in r.getMessage()]
    assert not pipe._fallback_allowed(KernelError("x"))
    pipe.device = torch.device("cuda")  # a device descriptor only: nothing runs
    assert not pipe._fallback_allowed(ValueError("x"))


def test_pipeline_classical_fallback_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path))  # no RRDBNet weights
    pipe = RestorationPipeline(models_root=str(tmp_path), device="cpu")
    image = np.random.default_rng(14).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    out = pipe.denoise(image)
    assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
    # no SD stack and no RRDBNet weights: super-resolution is LANCZOS x4
    res = pipe.process(image, ["sr"])
    assert set(res) == {"original", "super_resolved", "final"}
    np.testing.assert_array_equal(res["final"], tfallbacks.sr_lanczos(image, 4))
    assert res["final"].shape == (128, 128, 3)
