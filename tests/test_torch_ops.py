"""PyTorch port ops (CPU path) against the JAX package: attention and GroupNorm.

On a CPU tensor the port's ``attention`` and ``group_norm`` use their plain
PyTorch versions; these tests hold them against the JAX reference path
(``xla_attention``, ``_reference_group_norm``) and against the Pallas kernels
run in interpret mode, on the same numpy inputs.

Tolerances: fp32 inputs, the same formula summed in another order, so 2e-5
(attention, as the JAX package's own Pallas-vs-XLA test) and 2e-4 (GroupNorm,
as the JAX package's own kernel test). bf16 cases allow one bf16 rounding step
of the output (about 1e-2 relative at |y| < 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.ops import attention as tattn
from image_restoration_and_enhancement_torch.ops import groupnorm as tgn
from image_restoration_and_enhancement_tpu.ops import attention as jattn
from image_restoration_and_enhancement_tpu.ops import groupnorm as jgn
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

ATTN_CASES = [
    (1, 64, 64, 2, 40),     # SD level-0 head_dim
    (2, 64, 77, 2, 40),     # cross-attention against 77 text tokens
    (1, 100, 100, 1, 80),   # ragged sequence length
    (1, 64, 64, 1, 160),    # widest UNet head_dim
    (1, 64, 77, 1, 512),    # VAE mid-block head (1 head, d=512), ragged Nk
]


def _qkv(b, nq, nk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize("b,nq,nk,h,d", ATTN_CASES)
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_attention_matches_jax(b, nq, nk, h, d, backend):
    q, k, v = _qkv(b, nq, nk, h, d, seed=d + nk)
    ref = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     backend=backend))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == (b, nq, h, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_attention_bf16_matches_xla():
    q, k, v = _qkv(2, 64, 77, 2, 40, seed=7)
    ref = np.asarray(jattn.xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                     np.float32)
    got = tattn.attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_attention_extreme_logits():
    """Large logits: the fp32 row max keeps the softmax exact (as the JAX test)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 32, 1, 40)).astype(np.float32) * 12.0
    k = rng.standard_normal((1, 64, 1, 40)).astype(np.float32) * 12.0
    v = rng.standard_normal((1, 64, 1, 40)).astype(np.float32)
    ref = np.asarray(jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        tattn.attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))
    with pytest.raises(ValueError):
        tattn.attention(q, q.double(), q)
    with pytest.raises(ValueError):
        tattn.attention(q.to("meta"), q.to("meta"), q.to("meta"))


GN_CASES = [
    ((2, 8, 8, 32), 4, 1e-5, None),
    ((1, 16, 16, 40), 8, 1e-6, "silu"),   # gc = 5
    ((1, 3, 5, 16), 4, 1e-5, "silu"),     # odd spatial
    ((2, 4, 4, 64), 32, 1e-6, None),      # SD's 32 groups
]


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups,eps,act", GN_CASES)
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_group_norm_matches_jax(shape, groups, eps, act, backend):
    x, scale, bias = _gn_inputs(shape, seed=sum(shape))
    if backend == "xla":
        ref = jgn._reference_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), groups, eps, act or "none")
    else:
        ref = jgn.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
                             eps=eps, act=act, backend="pallas_interpret")
    got = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), groups, eps, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_group_norm_bf16_io():
    x, scale, bias = _gn_inputs((2, 8, 8, 32), seed=4)
    ref = jgn._reference_group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                                    jnp.asarray(bias), 8, 1e-5, "silu")
    got = tgn.group_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                         torch.from_numpy(bias), 8, 1e-5, "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=1e-2)


def test_group_norm_large_mean_no_nan():
    """E[x^2]-E[x]^2 cancels below zero in fp32 at mean 5000 / std 0.1; the
    clamp keeps rsqrt finite, in the port as in both JAX paths."""
    rng = np.random.default_rng(0)
    x = (5000.0 + 0.1 * rng.standard_normal((2, 8, 8, 16))).astype(np.float32)
    ones, zeros = np.ones(16, np.float32), np.zeros(16, np.float32)
    got = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(ones), torch.from_numpy(zeros), 4)
    assert np.isfinite(got.numpy()).all()
    for backend in (None, "pallas_interpret"):
        ref = jgn.group_norm(jnp.asarray(x), jnp.asarray(ones), jnp.asarray(zeros), 4,
                             backend=backend)
        assert np.isfinite(np.asarray(ref)).all()


def test_group_norm_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 6)
    with pytest.raises(ValueError):
        tgn.group_norm(x, torch.ones(6), torch.zeros(6), 4)      # 6 channels, 4 groups
    with pytest.raises(ValueError):
        tgn.group_norm(x, torch.ones(6), torch.zeros(6), 3, act="gelu")
    with pytest.raises(ValueError):
        tgn.group_norm(x.to("meta"), torch.ones(6, device="meta"),
                       torch.zeros(6, device="meta"), 3)


def test_gradients_match_jax():
    """The port's ops are differentiable on the CPU path like the JAX ones."""
    q, k, v = _qkv(1, 16, 16, 2, 8, seed=3)
    jg = jax.grad(lambda q_: jnp.sum(jattn.xla_attention(q_, jnp.asarray(k),
                                                         jnp.asarray(v)) ** 2))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    (tattn.attention(tq, torch.from_numpy(k), torch.from_numpy(v)) ** 2).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)
