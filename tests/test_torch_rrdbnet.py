"""PyTorch port RRDBNet (Real-ESRGAN's x4 generator) against the JAX package.

The JAX ``RRDBNet``'s parameter tree is filled at random from a seeded numpy
generator and carried to the port by the weight bridge (``body_N`` ->
``body.N``); both run the same [0, 1] images in fp32 (the full 23 blocks).
Tolerance: relative 1e-4 of the output's largest magnitude: the two
frameworks take the same fp32 conv sums in another order through 350 convs.
The weight files and the Real-ESRGAN name mapping are checked bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.models import rrdbnet as trr
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.models import rrdbnet as jrr
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (fixture)

REL = 1e-4


@pytest.fixture(scope="module")
def rrdb():
    jmodel = jrr.RRDBNet()
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 8, 8, 3))),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes["params"], seed=41)
    tmodel = trr.RRDBNet().eval()
    tmodel.load_state_dict(trr.params_from_flax(jck.flatten_params(params)), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_rrdbnet_matches_jax(rrdb, hw):
    jmodel, params, tmodel = rrdb
    x = np.random.default_rng(42).random((1,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, x))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 4 * hw[0], 4 * hw[1], 3) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * np.abs(ref).max())


def test_rrdbnet_reads_jax_weights_file(rrdb, tmp_path, monkeypatch):
    """A file written by the JAX package's ``save_params`` loads strictly into
    the port, ``save_weights`` writes the same tensors back, and
    ``upscale_x4`` finds the file under $IRET_WEIGHTS_DIR."""
    _, params, tmodel = rrdb
    path = str(tmp_path / trr.WEIGHTS_FILE)
    jck.save_params(params, path)
    loaded = trr.load_weights(path, device="cpu")
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    again = str(tmp_path / "again.safetensors")
    trr.save_weights(loaded, again)
    back = jck.flatten_params(jck.load_params(again))
    for k, v in jck.flatten_params(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path))
    assert trr.weights_available()
    img = np.random.default_rng(43).random((6, 5, 3)).astype(np.float32)
    out = trr.upscale_x4(img, device="cpu")
    with torch.inference_mode():
        ref = tmodel(torch.from_numpy(img)[None])[0].clamp(0, 1).numpy()
    assert out.shape == (24, 20, 3)
    np.testing.assert_array_equal(out, ref)
    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path / "absent"))
    assert not trr.weights_available()


def test_realesrgan_state_dict_matches_jax_import(rrdb):
    """A state dict under Real-ESRGAN's torch names: the port loads it
    strictly, and its parameters equal what the JAX package's
    ``import_rrdb_torch_state`` makes of it, carried over by the bridge."""
    _, _, tmodel = rrdb
    state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert {"conv_first.weight", "body.22.rdb3.conv5.bias", "conv_body.weight",
            "conv_up1.weight", "conv_up2.weight", "conv_hr.weight",
            "conv_last.bias"} <= set(state)
    fresh = trr.RRDBNet()
    result = fresh.load_state_dict(trr.import_rrdb_torch_state(state), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    via_jax = trr.params_from_flax(jck.flatten_params(jrr.import_rrdb_torch_state(state)))
    assert set(via_jax) == set(state)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), via_jax[k].numpy(), err_msg=k)
