"""The port's token merging (``ops/token_merge.py``) against the JAX package's
(CPU, fp32).

- ``plan`` and ``merge_count``: equal.
- ``build_merge``: merge, unmerge and the row map (unmerge of each merged
  row's index) agree to 1e-6 on a random fp32 [2, 64, 8] metric, and
  exactly on a one-hot metric whose scores tie exactly (the first maximum
  and the stable sort decide there, as in JAX).
- A Transformer2D with the site threshold lowered to its 64 tokens, as
  ``tests/test_token_merge.py`` lowers it, at ``test_torch_models.ATOL``
  (1e-4).
- TINY_SD img2img under ratio 0.5 at ``test_torch_serving.ATOL`` (2e-4).
  Which tokens merge is a discrete choice made on fp32 scores; the two
  frameworks' scores differ by a few ulps, far less than the gaps between
  the ranked scores of random data, so both pick the same tokens and the
  merged run differs from JAX's only as the exact run does. (Were a choice
  to flip, the error would be of the size of the merge itself, orders of
  magnitude above the limit.)
- The pipeline's ``tome_ratio`` and the ``IRET_TOME`` / ``IRET_TOME_MIN``
  variables, read once when the pipeline is built.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models import layers as tl
from image_restoration_and_enhancement_torch.ops import token_merge as ttm
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.models.layers import Transformer2D as JTransformer2D
from image_restoration_and_enhancement_tpu.ops import token_merge as jtm
from test_torch_models import ATOL as MODEL_ATOL
from test_torch_sdxl import exported, load_jax_weights
from test_torch_serving import ATOL, _jax_encode_text, fill_params
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 5), (64, 64), (32, 48), (1, 3)])
def test_plan_and_merge_count_equal_jax(h, w):
    for a, b in zip(ttm.plan(h, w), jtm.plan(h, w)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ratio in (0.0, 0.25, 0.5, 0.75, 0.9, 1.0):
        assert ttm.merge_count(h, w, ratio) == jtm.merge_count(h, w, ratio)


def _both(metric, x, y, h, w, r):
    """(port, JAX) merge(x), unmerge(y) and the row of every token."""
    mt, ut, nt = ttm.build_merge(torch.from_numpy(metric), h, w, r)
    mj, uj, nj = jtm.build_merge(jnp.asarray(metric), h, w, r)
    assert nt == nj
    rows = np.broadcast_to(np.arange(nt, dtype=np.float32)[None, :, None],
                           (metric.shape[0], nt, 1)).copy()
    port = [t.numpy() for t in (mt(torch.from_numpy(x)), ut(torch.from_numpy(y)),
                                ut(torch.from_numpy(rows)))]
    ref = [np.asarray(a) for a in (mj(jnp.asarray(x)), uj(jnp.asarray(y)), uj(jnp.asarray(rows)))]
    return port, ref


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 0.75])
def test_build_merge_matches_jax(ratio):
    rng = np.random.default_rng(91)
    metric = rng.standard_normal((2, 64, 8)).astype(np.float32)
    x = rng.standard_normal((2, 64, 8)).astype(np.float32)
    r = ttm.merge_count(8, 8, ratio)
    y = rng.standard_normal((2, 64 - r, 8)).astype(np.float32)
    port, ref = _both(metric, x, y, 8, 8, r)
    for name, a, b in zip(("merge", "unmerge", "rows"), port, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=name)
    assert np.array_equal(port[2], ref[2])


def test_build_merge_ties_break_as_jax():
    """One-hot rows: every score is exactly 0 or 1, so most sources tie for
    their best destination and with each other."""
    rng = np.random.default_rng(92)
    metric = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 64))]
    x = rng.standard_normal((2, 64, 8)).astype(np.float32)
    r = ttm.merge_count(8, 8, 0.5)
    y = rng.standard_normal((2, 64 - r, 8)).astype(np.float32)
    port, ref = _both(metric, x, y, 8, 8, r)
    np.testing.assert_array_equal(port[2], ref[2])
    np.testing.assert_allclose(port[0], ref[0], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(port[1], ref[1])


def _transformers():
    jmod = JTransformer2D(heads=2, head_dim=4, groups=4, dtype=jnp.float32)
    rng = np.random.default_rng(93)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 8)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jmod.init(k, x, ctx), jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=94)
    tmod = tl.Transformer2D(8, 2, 4, 8, groups=4).eval()
    tmod.load_state_dict(exported(params["params"]), strict=True)
    return jmod, params, tmod, x, ctx


def test_transformer_block_with_tome_matches_jax(monkeypatch):
    jmod, params, tmod, x, ctx = _transformers()
    xt = tl.from_nhwc(torch.from_numpy(x))

    def port(state):
        tl.set_tome(tmod, state)
        with torch.inference_mode():
            return tl.to_nhwc(tmod(xt, torch.from_numpy(ctx))).numpy()

    def ref(ratio, min_tokens):
        monkeypatch.setenv("IRET_TOME_MIN", str(min_tokens))
        with jtm.tome_mode(ratio):
            return np.asarray(jmod.apply(params, x, ctx))

    exact = port(None)
    np.testing.assert_allclose(exact, ref(None, 16), atol=MODEL_ATOL, rtol=MODEL_ATOL)
    merged = port(ttm.TomeState(0.5, 16))
    np.testing.assert_allclose(merged, ref(0.5, 16), atol=MODEL_ATOL, rtol=MODEL_ATOL)
    assert np.abs(merged - exact).max() > 100 * MODEL_ATOL  # the merge is not a no-op
    # a ratio of 0, or a site below the threshold, is the exact block
    np.testing.assert_array_equal(port(ttm.TomeState(0.0, 16)), exact)
    np.testing.assert_array_equal(port(ttm.TomeState(0.5, 4096)), exact)


@pytest.fixture(scope="module")
def sd_stacks():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=95)
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu")
    load_jax_weights(tm, params)
    return jm, params, tm


def test_img2img_with_tome_matches_jax(sd_stacks, monkeypatch):
    """Ratio 0.5 at the level-0 sites (N = 64 at 64 px, the threshold lowered
    to 64): TINY_SD's 3 level-0 self-attention sites (of 10) merge at every
    call."""
    jm, params, tm = sd_stacks
    rng = np.random.default_rng(96)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(jm, params, ids)
    key = jax.random.PRNGKey(19)
    monkeypatch.setenv("IRET_TOME_MIN", "64")
    with jtm.tome_mode(0.5):
        ref = js.make_img2img_fn(jm, 10, 0.5, 5.0, "plms")(params, image, ctx[:1], ctx[1:], key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in jax.random.split(key))
    tctx = ts.encode_text(tm, torch.from_numpy(ids))
    fn = ts.make_img2img_fn(tm, 10, 0.5, 5.0, "plms")
    exact = fn(torch.from_numpy(image), tctx[:1], tctx[1:], noise=noise)
    sites = []
    hooks = [b.attn1.register_forward_hook(lambda m, a, o: sites.append(a[0].shape[1]))
             for b in tm.unet.modules() if isinstance(b, tl.BasicTransformerBlock)]
    tm.set_tome(ttm.TomeState(0.5, 64))
    try:
        got = fn(torch.from_numpy(image), tctx[:1], tctx[1:], noise=noise)
    finally:
        tm.set_tome(None)
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)
    assert np.abs(got.numpy() - exact.numpy()).max() > 100 * ATOL
    assert sites.count(32) == 3 * 6 and sites.count(64) == 0  # 3 sites x 6 UNet calls


def test_pipeline_tome_ratio_and_env(sd_stacks, tmp_path, monkeypatch):
    _, params, _ = sd_stacks
    for var in ("IRET_TOME", "IRET_TOME_MIN"):
        monkeypatch.delenv(var, raising=False)
    assert RestorationPipeline(device="cpu").tome == ttm.TomeState(0.0, 4096)
    assert not RestorationPipeline(device="cpu").tome.active
    assert RestorationPipeline(device="cpu", tome_ratio=0.25).tome == ttm.TomeState(0.25, 4096)
    monkeypatch.setenv("IRET_TOME", "0.5")
    monkeypatch.setenv("IRET_TOME_MIN", "64")
    assert RestorationPipeline(device="cpu").tome == ttm.TomeState(0.5, 64)
    assert RestorationPipeline(device="cpu", tome_ratio=0.75).tome == ttm.TomeState(0.75, 64)
    monkeypatch.setenv("IRET_TOME", "bogus")
    assert RestorationPipeline(device="cpu").tome.ratio == 0.0

    jck.save_pipeline(str(tmp_path), params, JC.TINY_SD)
    config = {"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}}
    monkeypatch.setenv("IRET_TOME", "0.5")
    pipe = RestorationPipeline(config=config, dtype=torch.float32, device="cpu")
    plain = RestorationPipeline(config=config, dtype=torch.float32, device="cpu", tome_ratio=0.0)
    monkeypatch.setenv("IRET_TOME", "0")  # read once, when each pipeline was built
    plain.tome = ttm.TomeState()
    image = np.random.default_rng(97).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out, ref = pipe.denoise(image), plain.denoise(image)
    blocks = [m for m in pipe._stacks["denoise"]["modules"].unet.modules()
              if isinstance(m, tl.BasicTransformerBlock)]
    assert blocks and all(b.tome == ttm.TomeState(0.5, 64) for b in blocks)
    assert all(b.tome is None for b in plain._stacks["denoise"]["modules"].unet.modules()
               if isinstance(b, tl.BasicTransformerBlock))
    assert out.shape == ref.shape == (64, 64, 3) and not np.array_equal(out, ref)
    np.testing.assert_array_equal(pipe.denoise(image), out)
