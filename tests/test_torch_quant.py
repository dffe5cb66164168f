"""PyTorch port int8 (w8a8) quantization against the JAX package (CPU).

The port's ``ops/quant.py``, its quantized layers (``QConv2d``, ``QLinear``)
and the plain version of K3 (``conv3x3_same_int8_reference``) are held
against the JAX package's ``ops/quant.py`` and its Pallas conv kernel in
interpret mode, on the same numpy inputs.

Tolerances:
- quantized values and scales: bitwise equal (the same fp32 divide or
  multiply, round half to even, clip);
- s8 products: exact int32 sums on both sides, and the same fp32 rescale,
  cast and bias add in the layer dtype, so the layer outputs are bitwise
  equal in fp32 and bf16, and K3's plain version equals the Pallas kernel
  bitwise;
- error bounds against full precision: the JAX package's own
  (``tests/test_quant.py``): relative Frobenius error below 0.02.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from image_restoration_and_enhancement_torch.models import layers as tl
from image_restoration_and_enhancement_torch.ops import conv_int8 as tconv
from image_restoration_and_enhancement_torch.ops import quant as tq
from image_restoration_and_enhancement_tpu.models.layers import QConv, QDense
from image_restoration_and_enhancement_tpu.ops import conv_int8 as jconv
from image_restoration_and_enhancement_tpu.ops import quant as jq
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)


def _rng(seed):
    return np.random.default_rng(seed)


def test_quantizers_bitwise_equal_jax(monkeypatch):
    rng = _rng(0)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32) * 3.0
    xq_j, s_j = jq._quantize_per_tensor(jnp.asarray(x))
    xq_t, s_t = tq.QuantState("int8").quantize_activation(torch.from_numpy(x), None)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    assert float(s_t) == float(s_j)

    w = (rng.standard_normal((3, 3, 64, 32)) * 0.05).astype(np.float32)
    wq_j, sw_j = jq._quantize_weight_out_channel(jnp.asarray(w))
    wq_t, sw_t = tq.quantize_weight_out_channel(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(wq_t.permute(2, 3, 1, 0).numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))
    d = (rng.standard_normal((48, 24)) * 0.1).astype(np.float32)
    dq_j, sd_j = jq._quantize_weight_out_channel(jnp.asarray(d))
    dq_t, sd_t = tq.quantize_weight_out_channel(torch.from_numpy(d).T)
    np.testing.assert_array_equal(dq_t.T.numpy(), np.asarray(dq_j))
    np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))

    # static scales, with the margin from the environment as the JAX package reads it
    monkeypatch.setenv("IRET_QUANT_STATIC_MARGIN", "1.25")
    table = {"site_a": 2.7}
    state = tq.QuantState("int8_static", table)
    jq.load_static_table(table)
    try:
        with jq.quant_mode("int8_static"), jq.at_site("site_a"):
            q_j, s_j = jq._quantize_activation(jnp.asarray(x))
        with jq.quant_mode("int8_static"), jq.at_site("missing"):
            jq._quantize_activation(jnp.asarray(x))
        assert jq.static_misses() == {"missing"}
    finally:
        jq.load_static_table({})
    q_t, s_t = state.quantize_activation(torch.from_numpy(x), "site_a")
    assert s_t == s_j
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    q_m, s_m = state.quantize_activation(torch.from_numpy(x), "missing")
    assert state.misses == {"missing"}
    np.testing.assert_array_equal(q_m.numpy(), xq_t.numpy())  # dynamic fallback


def _flax_apply(module, params, x, mode):
    with jq.quant_mode(mode):
        return np.asarray(module.apply({"params": params}, jnp.asarray(x)))


LAYER_CASES = [
    # kind, input shape, out channels, kernel, stride, padding
    ("dense", (2, 77, 48), 40, None, None, None),
    ("conv", (2, 8, 8, 96), 32, 1, 1, 0),      # Transformer2D proj / conv_shortcut
    ("conv", (2, 9, 9, 16), 24, 3, 2, 1),      # Downsample2D, odd size
    ("conv", (2, 8, 6, 32), 16, 3, 1, 1),      # the 3x3 stride-1 path (K3's plain version)
]


@pytest.mark.parametrize("kind,shape,out,k,stride,pad", LAYER_CASES)
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_layers_match_jax(kind, shape, out, k, stride, pad, mode, dtype):
    rng = _rng(len(shape) + out)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    b = (0.1 * rng.standard_normal(out)).astype(np.float32)
    if kind == "dense":
        w = (rng.standard_normal((cin, out)) / np.sqrt(cin)).astype(np.float32)
        jmod = QDense(out, dtype=getattr(jnp, dtype))
        tmod = tl.QLinear(cin, out)
        tw = torch.from_numpy(w).T
    else:
        w = (rng.standard_normal((k, k, cin, out)) / np.sqrt(k * k * cin)).astype(np.float32)
        jmod = QConv(out, (k, k), strides=(stride, stride), padding=pad,
                     dtype=getattr(jnp, dtype))
        tmod = tl.QConv2d(cin, out, k, stride=stride, padding=pad)
        tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    tdtype = getattr(torch, dtype)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    params = {"kernel": jnp.asarray(w, getattr(jnp, dtype)), "bias": jnp.asarray(b, getattr(jnp, dtype))}
    # A standalone flax module's site is its empty scope path. The table clips
    # the largest inputs.
    table = {"": float(np.abs(x).max()) * 0.8}
    jq.load_static_table(table)
    try:
        ref = _flax_apply(jmod, params, xj, mode)
        assert not jq.static_misses()
    finally:
        jq.load_static_table({})
    ref = ref.astype(np.float32)
    with torch.no_grad():
        tmod.weight.copy_(tw)
        tmod.bias.copy_(torch.from_numpy(b))
    tmod = tmod.to(tdtype)
    tmod.site = ""
    state = tq.QuantState(mode, table)
    tmod.set_quant(state)
    tx = torch.from_numpy(x).to(tdtype)
    if kind == "conv":
        tx = tx.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = tmod(tx)
    got = (got.permute(0, 2, 3, 1) if kind == "conv" else got).float().numpy()
    assert got.shape == ref.shape and not state.misses
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("b,h,w,c,n", [(2, 8, 8, 32, 16), (1, 16, 6, 16, 8), (1, 5, 5, 8, 8),
                                       (1, 10, 7, 16, 24)])
def test_conv3x3_reference_equals_pallas_interpret(b, h, w, c, n):
    """K3's plain version against the Pallas kernel in interpret mode (and so
    against XLA's int8 conv, which ``tests/test_quant.py`` holds it to)."""
    rng = _rng(h * w + c)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, c, n)) * 0.1).astype(np.float32)
    xq, sx = jq._quantize_per_tensor(jnp.asarray(x))
    wq, sw = jq._quantize_weight_out_channel(jnp.asarray(wgt))
    xp = jnp.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = jconv.conv3x3_same_int8(xp, wq, sx * sw, out_dtype=jdt, interpret=True)
        got = tconv.conv3x3_same_int8(torch.from_numpy(np.array(xp)),
                                      torch.from_numpy(np.array(wq)),
                                      torch.from_numpy(np.array(sx * sw)), tdt)
        assert got.dtype == tdt and got.shape == (b, h, w, n)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_conv3x3_reference_is_exact_at_wide_channels():
    """At C = 2560 the sums reach ~1e8, past fp32's 2**24: the plain version
    must still equal an int64 sum exactly."""
    g = torch.Generator().manual_seed(0)
    x = torch.full((1, 4, 4, 2560), 127, dtype=torch.int8)
    x[0, 1:3, 1:3, ::2] = torch.randint(-127, 128, (2, 2, 1280), generator=g, dtype=torch.int8)
    w = torch.full((3, 3, 2560, 8), 127, dtype=torch.int8)
    w[..., 1] = -127
    w[..., 2] = torch.randint(-127, 128, (3, 3, 2560), generator=g, dtype=torch.int8)
    acc = torch.zeros((1, 2, 2, 8), dtype=torch.int64)
    for dy in range(3):
        for dx in range(3):
            acc += torch.einsum("bhwc,cn->bhwn", x[:, dy:dy + 2, dx:dx + 2].long(), w[dy, dx].long())
    assert int(acc.abs().max()) > 2**24
    got = tconv.conv3x3_same_int8(x, w, torch.ones(8), torch.float32)
    np.testing.assert_array_equal(got.numpy(), acc.float().numpy())


def test_off_mode_is_the_plain_layer():
    """No state, or mode None: QConv2d and QLinear are nn.Conv2d and nn.Linear
    bitwise, with the same state_dict keys."""
    torch.manual_seed(0)
    x = torch.randn(2, 16, 8, 8)
    qc, pc = tl.QConv2d(16, 32, 3, padding=1), nn.Conv2d(16, 32, 3, padding=1)
    pc.load_state_dict(qc.state_dict())
    assert qc.state_dict().keys() == pc.state_dict().keys()
    xd = torch.randn(4, 16)
    qd, pd = tl.QLinear(16, 32), nn.Linear(16, 32)
    pd.load_state_dict(qd.state_dict())
    for state in (None, tq.QuantState(None)):
        qc.set_quant(state)
        qd.set_quant(state)
        assert torch.equal(qc(x), pc(x)) and torch.equal(qd(xd), pd(xd))


def test_weights_quantized_once_and_state_dict_unchanged():
    torch.manual_seed(1)
    lin = tl.QLinear(32, 16)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    lin.set_quant(tq.QuantState("int8"))
    wq, sw = lin.quantized_weight()
    assert wq.dtype == torch.int8 and sw.shape == (16,)
    assert lin.quantized_weight()[0] is wq  # cached
    assert lin.state_dict().keys() == before.keys()
    for k, v in lin.state_dict().items():
        assert torch.equal(v, before[k])
    with torch.no_grad():
        lin.weight.mul_(2.0)
    wq2, sw2 = lin.quantized_weight()
    assert wq2 is not wq and torch.allclose(sw2, sw * 2)  # a changed weight is quantized again


def test_int8_linear_error_bound():
    rng = _rng(1)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 256)) * 0.05).astype(np.float32))
    lin = tl.QLinear(256, 128, bias=False)
    with torch.no_grad():
        lin.weight.copy_(w)
    lin.set_quant(tq.QuantState("int8"))
    got, ref = lin(x), x @ w.T
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 0.02


def test_int8_conv_error_bound():
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 16, 16)).astype(np.float32))
    conv = tl.QConv2d(64, 64, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal((64, 64, 3, 3)) * 0.05))
    ref = nn.functional.conv2d(x, conv.weight.detach(), padding=1)
    conv.set_quant(tq.QuantState("int8"))
    got = conv(x.contiguous(memory_format=torch.channels_last))
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 0.02


def test_int8_per_channel_scales_handle_skewed_weights():
    """A channel 100x larger than the rest must not wipe out the small
    channels' precision (per-output-channel weight scales)."""
    rng = _rng(5)
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((8, 64)) * 0.01).astype(np.float32))
    w[0] *= 100.0
    lin = tl.QLinear(64, 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(w)
    lin.set_quant(tq.QuantState("int8"))
    got, ref = lin(x), x @ w.T
    rel = torch.linalg.norm(got[:, 1:] - ref[:, 1:]) / torch.linalg.norm(ref[:, 1:])
    assert float(rel) < 0.02


def test_quant_mode_from_env(monkeypatch):
    monkeypatch.setenv("IRET_QUANT", "int8_static")
    assert tq.mode_from_env(None) == "int8_static"
    assert tq.mode_from_env("") is None
    assert tq.mode_from_env("int8") == "int8"
    with pytest.raises(ValueError):
        tq.mode_from_env("int4")
