"""PyTorch port int8 attention (the plain version of K4, and the plain XLA int8
variants) against the JAX package (CPU).

``attention(..., backend="int8")`` on a CPU tensor is ``int8_attention_reference``;
it is held against the JAX Pallas int8 kernel in interpret mode
(``backend="int8_interpret"``), and ``"xla_int8"``/``"xla_int8_pv"`` against
their JAX counterparts, on the same numpy inputs. The other cases mirror
``tests/test_attention.py``'s int8 tests.

Tolerances:
- s8 Q and K and their scale: bitwise equal.
- fp32 against JAX: 1e-5 absolute and relative. Both quantize Q and K to the
  same s8 values and take the same exact s8 sums; the fp32 exp2, sums and
  divide differ only in order.
- bf16 against JAX: one bf16 step of the largest output (2**-7 * max|ref|):
  both round P and the output to bf16, at the same places.
- ``xla_int8_pv``: 2e-3. P is quantized as round(exp(s - max) * 127), and an
  exp that differs in its last bit between the frameworks can move a P value
  across a rounding boundary: one step of 1/127 on one weight of a row.
- against full precision: the JAX package's own bounds (relative Frobenius
  error below 0.03, and 0.04 with s8 P.V).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.ops import attention as ta
from image_restoration_and_enhancement_tpu.ops import attention as ja
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)


def _qkv(b, nq, nk, h, d, seed, k_shift=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h, d)).astype(np.float32) * scale
    k = (rng.standard_normal((b, nk, h, d)) * scale + k_shift).astype(np.float32)
    v = rng.standard_normal((b, nk, h, d)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, backend, dtype=jnp.float32):
    out = ja.attention(*(jnp.asarray(a, dtype) for a in (q, k, v)), backend=backend)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, backend, dtype=torch.float32):
    out = ta.attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), backend=backend)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


CASES = [
    (2, 256, 256, 4, 40),   # self-attention at SD's level-0 head_dim
    (1, 100, 77, 2, 40),    # cross-attention against 77 tokens, ragged Nq
    (1, 64, 64, 2, 80),
    (2, 64, 77, 1, 160),
    (1, 64, 64, 2, 4),      # TINY_SD head_dim
]


@pytest.mark.parametrize("b,nq,nk,h,d", CASES)
def test_int8_attention_matches_jax_kernel(b, nq, nk, h, d):
    q, k, v = _qkv(b, nq, nk, h, d, seed=d + nk, k_shift=0.3)
    ref = _jax(q, k, v, "int8_interpret")
    np.testing.assert_allclose(_port(q, k, v, "int8"), ref, atol=1e-5, rtol=1e-5)
    refb = _jax(q, k, v, "int8_interpret", jnp.bfloat16)
    gotb = _port(q, k, v, "int8", torch.bfloat16)
    np.testing.assert_allclose(gotb, refb, atol=2.0**-7 * np.abs(refb).max(), rtol=0)


@pytest.mark.parametrize("b,nq,nk,h,d", CASES[:2])
def test_xla_int8_variants_match_jax(b, nq, nk, h, d):
    q, k, v = _qkv(b, nq, nk, h, d, seed=3 + d, k_shift=0.3)
    np.testing.assert_allclose(_port(q, k, v, "xla_int8"), _jax(q, k, v, "xla_int8"),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_port(q, k, v, "xla_int8_pv"), _jax(q, k, v, "xla_int8_pv"),
                               atol=2e-3, rtol=0)


def test_smooth_quantize_matches_jax():
    q, k, _ = _qkv(2, 64, 77, 2, 40, seed=4, k_shift=0.5)
    bh = lambda a: a.transpose(0, 2, 1, 3).reshape(4, -1, 40)  # noqa: E731
    q8_j, k8_j, s_j = ja._smooth_quantize_qk(jnp.asarray(bh(q)), jnp.asarray(bh(k)))
    q8_t, k8_t, s_t = ta.smooth_quantize_qk(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_array_equal(bh(q8_t.numpy()), np.asarray(q8_j))
    np.testing.assert_array_equal(bh(k8_t.numpy()), np.asarray(k8_j))
    assert float(s_t) == float(s_j)


def test_int8_attention_close_to_exact():
    """Quantization noise is bounded, and the kernel's function and the XLA
    s8 variant agree (same quantized operands)."""
    for b, n, h, d, nk in [(2, 256, 4, 40, 256), (1, 100, 2, 40, 77)]:
        q, k, v = _qkv(b, n, nk, h, d, seed=5, k_shift=0.3)
        ref = _port(q, k, v, None)
        got = _port(q, k, v, "int8")
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.03
        np.testing.assert_allclose(got, _port(q, k, v, "xla_int8"), atol=1e-4, rtol=1e-4)


def test_int8_pv_attention_close_to_exact():
    for b, n, h, d, nk in [(2, 256, 4, 40, 256), (1, 512, 2, 40, 512)]:
        q, k, v = _qkv(b, n, nk, h, d, seed=8, k_shift=0.3)
        ref, got = _port(q, k, v, None), _port(q, k, v, "xla_int8_pv")
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.04


def test_int8_pv_normalization_row_sum():
    """The 127-valued ones column normalizes exactly: constant V passes through."""
    q, k, _ = _qkv(1, 64, 64, 2, 40, seed=9, scale=4.0)
    v = np.full(q.shape, 0.7, np.float32)
    np.testing.assert_allclose(_port(q, k, v, "xla_int8_pv"), 0.7, atol=1e-3)


def test_int8_attention_k_smoothing_invariance():
    """Adding one vector to every K token changes nothing (softmax shift)."""
    q, k, v = _qkv(1, 64, 64, 2, 40, seed=6)
    shifted = k + np.full((1, 1, 2, 40), 5.0, np.float32)
    for backend in ("int8", "xla_int8"):
        np.testing.assert_allclose(_port(q, k, v, backend), _port(q, shifted, v, backend),
                                   atol=2e-2)


def test_int8_attention_matches_chunked_jax_kernel(monkeypatch):
    """The JAX kernel walks KV in chunks with an online rescale; at 128-key
    chunks it still equals the port's single-pass plain version (fp32, so P
    is not rounded between chunks)."""
    q, k, v = _qkv(1, 128, 256, 2, 40, seed=7, scale=3.0)
    monkeypatch.setenv("IRET_ATTN_INT8_CHUNK", "128")
    np.testing.assert_allclose(_port(q, k, v, "int8"), _jax(q, k, v, "int8_interpret"),
                               atol=1e-4, rtol=1e-4)


def test_int8_attention_gradient_is_exact_attention():
    """As in the JAX package, the gradient runs through exact attention."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 16, 16, 1, 8, seed=2))
    ta.attention(q, k, v, backend="int8").sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ta.attention_reference(q2, k2, v2).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad)


def test_unported_backends_raise():
    """Every backend of the JAX package's ``attention`` is ported except its
    interpret-mode test backends; those and unknown names raise."""
    q = torch.zeros((1, 8, 1, 16))
    for backend in ("flash", "pallas_packed"):
        assert ta.attention(q, q, q, backend=backend).shape == q.shape
    for backend in ("int4", "pallas_interpret", "flash_interpret", "int8_interpret",
                    "pallas_packed_interpret"):
        with pytest.raises(ValueError, match="Unknown"):
            ta.attention(q, q, q, backend=backend)
