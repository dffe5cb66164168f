"""The port's plain versions of K1 (``pallas_attention_reference``), K5
(``flash_attention_reference``) and K6a/K6b (``packed_attention_reference``)
against the JAX package's Pallas kernels in interpret mode (CPU), on the same
numpy inputs; and the ``"flash"`` / ``"pallas_packed"`` backends through the
TINY_SD img2img function and ``RestorationPipeline``.

Tolerances:
- fp32: 2e-5 absolute and relative, as the JAX package's own Pallas-vs-XLA
  tests. The functions are equal; the sums run in another order.
- bf16: at least 99% of the output elements bitwise equal, and the largest
  difference within one bf16 step of the largest output. Both sides round
  Q*(1/sqrt(D)), P and the output at the same places; an fp32 exp or sum that
  differs in its last bit can still move one rounding of P by one step, which
  moves an output by about 2**-9 of one P.V term. A control with the
  roundings of another function must fail the same check: ``attention_reference``
  (xla_attention's placement) against the Pallas K1 (about 45% equal), and K1's
  plain version against K5 with 128-key chunks (about 80%).
- img2img: 2e-4 on images in [-1, 1], the bound of ``test_torch_serving.py``.
"""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models.layers import CrossAttention
from image_restoration_and_enhancement_torch.ops import _build
from image_restoration_and_enhancement_torch.ops import attention as ta
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.ops import attention as ja
from test_torch_serving import ATOL, _jax_encode_text, fill_params, one_torch_thread  # noqa: F401  (fixture)

BF16_MIN_SHARE = 0.99


def _qkv(b, nq, nk, h, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, n, h, d)) * scale).astype(np.float32)
                 for n in (nq, nk, nk))


def _jax(fn, arrays, dtype):
    out = fn(*(jnp.asarray(a, dtype) for a in arrays))
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


def _port(fn, arrays, dtype):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in arrays))
    assert out.dtype == dtype
    return out.float()


def bf16_check(got, ref):
    """(share bitwise equal, max abs error within one bf16 step of max|ref|)."""
    _, exp = torch.frexp(ref.abs().max())
    step = float(torch.ldexp(torch.ones(()), exp - 8))
    return float((got == ref).float().mean()), float((got - ref).abs().max()) <= step


def assert_bf16_match(got, ref):
    share, steps = bf16_check(got, ref)
    assert share >= BF16_MIN_SHARE and steps, (share, steps)


PALLAS = lambda q, k, v: ja.pallas_attention(q, k, v, interpret=True)  # noqa: E731
FLASH = lambda q, k, v: ja.pallas_flash_attention(q, k, v, interpret=True)  # noqa: E731


def _packed(variant):
    return lambda q, k, v: ja._packed_call(q, k, v, interpret=True, variant=variant)


K1_CASES = [(1, 64, 64, 2, 40), (2, 64, 77, 2, 80), (1, 100, 200, 1, 160)]
FLASH_CASES = [  # (shape, IRET_FLASH_BLOCK_K or None for the default 1024)
    ((1, 256, 256, 2, 40), "128"),   # two chunks: the online rescale
    ((1, 200, 200, 1, 80), "128"),   # ragged: the last chunk masked
    ((2, 128, 77, 2, 40), None),     # cross-attention, one masked chunk
    ((1, 64, 256, 1, 160), None),
]
PACKED_CASES = [(2, 64, 64, 8, 40), (1, 64, 77, 4, 80), (1, 100, 100, 2, 160)]


@pytest.mark.parametrize("b,nq,nk,h,d", K1_CASES)
def test_pallas_reference_matches_jax(b, nq, nk, h, d):
    arrays = _qkv(b, nq, nk, h, d, seed=d + nk)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = _jax(PALLAS, arrays, jdt)
        got = _port(lambda q, k, v: ta.attention(q, k, v, backend="pallas"), arrays, dtype)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
        else:
            assert_bf16_match(got, ref)
            # control: xla_attention's placement fails the same check
            share, _ = bf16_check(_port(ta.attention_reference, arrays, dtype), ref)
            assert share < BF16_MIN_SHARE, share


@pytest.mark.parametrize("shape,block_k", FLASH_CASES)
def test_flash_reference_matches_jax(shape, block_k, monkeypatch):
    if block_k is not None:
        monkeypatch.setenv("IRET_FLASH_BLOCK_K", block_k)
        monkeypatch.setenv("IRET_FLASH_BLOCK_Q", "64")
    arrays = _qkv(*shape, seed=shape[-1] + 1)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = _jax(FLASH, arrays, jdt)
        got = _port(lambda q, k, v: ta.attention(q, k, v, backend="flash"), arrays, dtype)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
        else:
            assert_bf16_match(got, ref)


def test_flash_control_k1_placement_fails():
    """K1's plain version is not K5's: at Nk = 256 in 128-key chunks it fails
    the bf16 check against the Pallas K5, which K5's plain version passes."""
    arrays = _qkv(1, 256, 256, 2, 40, seed=41)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IRET_FLASH_BLOCK_K", "128")
        mp.setenv("IRET_FLASH_BLOCK_Q", "64")
        ref = _jax(FLASH, arrays, jnp.bfloat16)
    assert_bf16_match(ta.flash_attention_reference(q, k, v, block_k=128).float(), ref)
    share, _ = bf16_check(ta.pallas_attention_reference(q, k, v).float(), ref)
    assert share < BF16_MIN_SHARE, share


@pytest.mark.parametrize("b,nq,nk,h,d", PACKED_CASES)
@pytest.mark.parametrize("variant", ["grid", "packed"])
def test_packed_reference_matches_jax(b, nq, nk, h, d, variant):
    arrays = _qkv(b, nq, nk, h, d, seed=h * d)
    port = (lambda q, k, v: ta.attention(q, k, v, backend="pallas_packed")) \
        if variant == "grid" else (lambda q, k, v: ta.packed_call(q, k, v, variant="packed"))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = _jax(_packed(variant), arrays, jdt)
        got = _port(port, arrays, dtype)
        assert got.shape == (b, nq, h, d)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
        else:
            assert_bf16_match(got, ref)


def test_packed_entry_points_take_the_projection_layout():
    """``pallas_attention_packed(_grid)`` take [B, N, H*D] as the JAX ones do,
    and ``packed_call`` hands them views of [B, N, H, D] projections."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 77, 4, 40, seed=3))
    ref = ta.pallas_attention_reference(q, k, v).reshape(2, 64, 160)
    for fn in (ta.pallas_attention_packed, ta.pallas_attention_packed_grid):
        got = fn(q.reshape(2, 64, 160), k.reshape(2, 77, 160), v.reshape(2, 77, 160), heads=4)
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    seen = []

    def spy(q, k, v, heads):
        seen.extend(t.data_ptr() for t in (q, k, v))
        return ta.packed_attention_reference(q, k, v, heads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta, "pallas_attention_packed_grid", spy)
        ta.packed_call(q, k, v)
    assert seen == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    with pytest.raises(ValueError, match="H = 3"):
        ta.pallas_attention_packed(q.reshape(2, 64, 160), k.reshape(2, 77, 160),
                                   v.reshape(2, 77, 160), heads=3)
    with pytest.raises(ValueError, match="variant"):
        ta.packed_call(q, k, v, variant="slice")


@pytest.mark.parametrize("env", ["IRET_ATTN_SCORES_BF16", "IRET_ATTN_NORM_BOUND"])
def test_k1_branches_match_jax(env, monkeypatch):
    """K1's opt-in branches, read at call time by both packages (as
    tests/test_attention.py's ``test_pallas_scores_bf16_close`` and
    ``test_pallas_norm_bound_extreme`` set them)."""
    monkeypatch.setenv(env, "1")
    arrays = _qkv(1, 128, 128, 2, 40, seed=4)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = _jax(PALLAS, arrays, jdt)
        got = _port(ta.pallas_attention_reference, arrays, dtype)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
        else:
            assert_bf16_match(got, ref)
    monkeypatch.delenv(env)
    off = _port(ta.pallas_attention_reference, arrays, torch.bfloat16)
    assert not torch.equal(off, got)  # the variable changed the function


def test_k1_norm_bound_extreme_logits(monkeypatch):
    """At |logit| ~ 150 the norm bound underflows exp and zeroes confident rows
    (the JAX test's cliff); the port's plain version does the same, finite."""
    monkeypatch.setenv("IRET_ATTN_NORM_BOUND", "1")
    q, k, v = _qkv(1, 32, 64, 1, 40, seed=5)
    arrays = (q * 12, k * 12, v)
    ref = _jax(PALLAS, arrays, jnp.float32)
    got = _port(ta.pallas_attention_reference, arrays, torch.float32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_flash_extreme_logits(monkeypatch):
    """The online rescale stays exact at huge logits (tests/test_attention.py's
    ``test_flash_extreme_logits_exact``), against the JAX kernel and xla."""
    monkeypatch.setenv("IRET_FLASH_BLOCK_Q", "64")
    monkeypatch.setenv("IRET_FLASH_BLOCK_K", "128")
    rng = np.random.default_rng(6)
    q = np.full((1, 128, 1, 40), 8.0, np.float32)
    k = (rng.standard_normal((1, 256, 1, 40)) * 8.0).astype(np.float32)
    v = rng.standard_normal((1, 256, 1, 40)).astype(np.float32)
    got = _port(lambda q, k, v: ta.attention(q, k, v, backend="flash"), (q, k, v),
                torch.float32)
    for ref in (_jax(FLASH, (q, k, v), jnp.float32), _jax(ja.xla_attention, (q, k, v),
                                                          jnp.float32)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("backend", ["pallas", "xla", "flash", "pallas_packed"])
def test_backends_route_and_differentiate(backend):
    """On the CPU each backend runs its plain version, launches nothing, and
    its gradient is exact attention's, as in the JAX package."""
    plain = {"pallas": ta.pallas_attention_reference, "xla": ta.attention_reference,
             "flash": ta.flash_attention_reference,
             "pallas_packed": lambda q, k, v: ta.packed_attention_reference(
                 q.flatten(2), k.flatten(2), v.flatten(2), q.shape[2]).unflatten(-1, q.shape[2:])}
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_() for a in _qkv(1, 32, 48, 2, 8, 7))
    before = sum(_build.launch_counts.values())
    out = ta.attention(q, k, v, backend=backend)
    assert sum(_build.launch_counts.values()) == before
    assert torch.equal(out, plain[backend](q, k, v))
    out.float().sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ta.attention_reference(q2, k2, v2).float().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad)


# ---------------------------------------------------------------------------
# TINY_SD img2img and the pipeline with attention_backend "flash" / "pallas_packed"
# ---------------------------------------------------------------------------

JAX_BACKEND = {"flash": "flash_interpret", "pallas_packed": "pallas_packed_interpret"}


@pytest.fixture(scope="module")
def tiny_params():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    return fill_params(shapes, seed=11)


@pytest.mark.parametrize("backend", ["flash", "pallas_packed"])
def test_img2img_matches_jax(backend, tiny_params):
    """Same weights, prompt context and noise: the port's TINY_SD img2img with
    the backend against the JAX one with its Pallas kernel in interpret mode
    (3 steps, CFG)."""
    params = tiny_params
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32,
                             attention_backend=JAX_BACKEND[backend])
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu",
                             attention_backend=backend)
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])),
                            strict=True)
    rng = np.random.default_rng(12)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 128, (2, 77)).astype(np.int32)
    ctx = _jax_encode_text(jm, params, ids)
    key = jax.random.PRNGKey(7)
    ref = js.make_img2img_fn(jm, 6, 0.5, 5.0, "plms")(params, image, ctx[:1], ctx[1:], key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (1, 8, 8, 4), jnp.float32)))
                  for k in jax.random.split(key))
    tctx = ts.encode_text(tm, torch.from_numpy(ids))
    got = ts.make_img2img_fn(tm, 6, 0.5, 5.0, "plms")(
        torch.from_numpy(image), tctx[:1], tctx[1:], noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("backend", ["flash", "pallas_packed"])
def test_pipeline_serves_backend(backend, tiny_params, tmp_path, monkeypatch, caplog):
    """``RestorationPipeline(attention_backend=...)`` builds its UNet with the
    backend at every attention site and serves a denoise request on the CPU."""
    jck.save_pipeline(str(tmp_path), tiny_params, JC.TINY_SD)
    pipe = RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": str(tmp_path), "default_backend": "diffusion"}},
        dtype=torch.float32, device="cpu", attention_backend=backend)
    calls = []
    real = ta._BACKENDS[backend]
    monkeypatch.setitem(ta._BACKENDS, backend, lambda q, k, v: calls.append(1) or real(q, k, v))
    image = np.random.default_rng(13).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    with caplog.at_level(logging.INFO):
        out = pipe.denoise(image, guidance=1.0)
    assert not [r for r in caplog.records if "failed" in r.getMessage()]
    assert out.dtype == np.uint8 and out.shape == (64, 64, 3)
    sites = [m for m in pipe._stacks["denoise"]["modules"].unet.modules()
             if isinstance(m, CrossAttention)]
    assert sites and all(m.attention_backend == backend for m in sites)
    assert len(calls) % len(sites) == 0 and calls
    assert math.isfinite(float(out.mean()))
