"""The port's LPIPS-Alex and InceptionV3 (``metrics/perceptual.py``,
``metrics/inception.py``) against the JAX package's, with random JAX
parameters carried across by the port's bridge (``params_from_flax``).

Limits: LPIPS 1e-5 relative; Inception pool3 features 1e-4 of their largest
value (fp32 convolutions in another order through ~50 layers);
``fid_from_features`` and ``frechet_distance`` exactly equal on the same
features (the same float64 numpy and scipy code). The bridges and the
torch-state importers are held exactly: JAX's importer and the port's give
the same parameters from one torch state dict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.metrics import inception as TI
from image_restoration_and_enhancement_torch.metrics import perceptual as TP
from image_restoration_and_enhancement_tpu.core.checkpoint import flatten_params, unflatten_params
from image_restoration_and_enhancement_tpu.metrics import inception as JI
from image_restoration_and_enhancement_tpu.metrics import perceptual as JP
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)


def jax_lpips_flat(seed):
    """Random LPIPSAlex params in the JAX layout (flat flax paths, numpy);
    the lin heads signed, so that the |w| of both sides is exercised."""
    rng = np.random.default_rng(seed)
    shapes = flatten_dict(jax.eval_shape(
        lambda k: JP.LPIPSAlex().init(k, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3))),
        jax.random.PRNGKey(0))["params"], sep="/")
    out = {}
    for k, s in shapes.items():
        if k.endswith("kernel"):
            v = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        else:
            v = rng.standard_normal(s.shape) * (1.0 if k.startswith("lin") else 0.1)
        out[k] = v.astype(np.float32)
    return out


def jax_inception_flat(seed):
    """Random InceptionV3Features params in the JAX layout, BN statistics
    included (the default zeros and ones would pass broken BN math)."""
    rng = np.random.default_rng(seed)
    shapes = flatten_dict(jax.eval_shape(
        lambda k: JI.InceptionV3Features().init(k, jnp.zeros((1, 96, 96, 3))),
        jax.random.PRNGKey(0))["params"], sep="/")
    out = {}
    for k, s in shapes.items():
        if k.endswith("kernel"):
            v = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif k.endswith(("bn_var", "bn_scale")):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A weights directory with both files in the JAX layout."""
    d = tmp_path_factory.mktemp("weights")
    lp, inc = jax_lpips_flat(91), jax_inception_flat(92)
    tck.save_safetensors(lp, str(d / TP.LPIPS_FILE))
    tck.save_safetensors(inc, str(d / TP.INCEPTION_FILE))
    return {"dir": str(d), "lpips": lp, "inception": inc}


@pytest.fixture
def jax_weights(weights, monkeypatch):
    """Point the JAX package (module constants, cached loaders) and the port
    (IRET_WEIGHTS_DIR, read at each call) at the weights directory."""
    monkeypatch.setenv("IRET_WEIGHTS_DIR", weights["dir"])
    monkeypatch.setattr(JP, "_LPIPS_PATH", f"{weights['dir']}/{TP.LPIPS_FILE}")
    monkeypatch.setattr(JP, "_INCEPTION_PATH", f"{weights['dir']}/{TP.INCEPTION_FILE}")
    caches = (JP._lpips_params, JP._lpips_fn, JI._inception_fn)
    for c in caches:
        c.cache_clear()
    yield weights
    for c in caches:
        c.cache_clear()


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def test_lpips_matches_jax(weights):
    rng = np.random.default_rng(93)
    a = rng.uniform(-1, 1, (2, 64, 72, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    want = np.asarray(JP.LPIPSAlex().apply({"params": unflatten_params(weights["lpips"])}, a, b))
    model = TP.LPIPSAlex()
    model.load_state_dict(TP.params_from_flax(weights["lpips"]), strict=True)
    with torch.no_grad():
        got = model.eval()(nchw(a), nchw(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert (want > 0).all()


def test_lpips_bridges_and_importers_agree(weights):
    model = TP.LPIPSAlex()
    model.load_state_dict(TP.params_from_flax(weights["lpips"]), strict=True)
    state = model.state_dict()
    back = TP.flax_from_params(state)
    assert set(back) == set(weights["lpips"])
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), weights["lpips"][k])
    # a torchvision-named trunk and lins.N heads, as JAX's importer reads them
    slice_of = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    tv = {f"net.features.{i}.{leaf}": state[f"net.slice{s}.{i}.{leaf}"].numpy()
          for i, s in slice_of.items() for leaf in ("weight", "bias")}
    tv.update({f"lins.{n}.model.1.weight": state[f"lin{n}.model.1.weight"].numpy()
               for n in range(5)})
    jax_tree = flatten_params(JP.import_lpips_torch_state(tv))
    assert set(jax_tree) == set(weights["lpips"])
    for k, v in TP.params_from_flax(jax_tree).items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    # the port's importer: lpips names (with its extra buffers), torchvision names
    lp = {k: v.numpy() for k, v in state.items()}
    lp.update({"scaling_layer.shift": np.zeros((1, 3, 1, 1)),
               "lins.0.model.1.weight": lp["lin0.model.1.weight"]})
    for source in (lp, tv):
        imported = TP.import_lpips_torch_state(source)
        assert set(imported) == set(state)
        for k, v in imported.items():
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_lpips_pairs_matches_jax(jax_weights):
    rng = np.random.default_rng(94)
    preds = [rng.uniform(0, 1, (48, 56, 3)).astype(np.float32) for _ in range(2)]
    gts = [np.clip(p + rng.normal(0, 0.1, p.shape), 0, 1).astype(np.float32) for p in preds]
    assert TP.lpips_available() and JP.lpips_available()
    np.testing.assert_allclose(TP.lpips_pairs(preds, gts, device="cpu"),
                               JP.lpips_pairs(preds, gts), rtol=1e-5)


def test_inception_features_match_jax(jax_weights):
    """Two images of other sizes (each resized to 299 by ``jax.image.resize``
    bilinear and its port), through InceptionV3 with the carried weights."""
    rng = np.random.default_rng(95)
    ims = [rng.uniform(0, 1, (64, 80, 3)).astype(np.float32),
           rng.uniform(0, 1, (120, 90, 3)).astype(np.float32)]
    want = JI.inception_features(ims)
    got = TI.inception_features(ims, device="cpu")
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_inception_bridges_and_importer(weights):
    model = TI.InceptionV3Features()
    model.load_state_dict(TI.params_from_flax(weights["inception"]), strict=True)
    back = TI.flax_from_params(model.state_dict())
    assert set(back) == set(weights["inception"])
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), weights["inception"][k])
    # a torchvision state dict (with the heads FID drops) through both importers
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state.update({"fc.weight": np.zeros((1000, 2048), np.float32), "fc.bias": np.zeros(1000),
                  "AuxLogits.fc.weight": np.zeros((1000, 768), np.float32)})
    jax_tree = flatten_params(JI.import_inception_torch_state(state))
    assert set(jax_tree) == set(weights["inception"])
    for k, v in jax_tree.items():
        np.testing.assert_array_equal(v, weights["inception"][k])
    imported = TI.import_inception_torch_state(state)
    assert set(imported) == set(model.state_dict())


def test_fid_math_matches_jax():
    rng = np.random.default_rng(96)
    f1 = rng.normal(size=(40, 64)).astype(np.float32)
    f2 = (rng.normal(size=(40, 64)) * 1.2 + 0.3).astype(np.float32)
    assert TP.fid_from_features(f1, f2) == JP.fid_from_features(f1, f2) > 0
    assert abs(TP.fid_from_features(f1, f1)) < 1e-6
    mu, s = f1.mean(0), np.cov(f1, rowvar=False)
    assert TP.frechet_distance(mu, s, mu + 1, s) == JP.frechet_distance(mu, s, mu + 1, s)


def test_weights_gating_and_random_init(tmp_path, monkeypatch):
    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("IRET_FID_RANDOM_INIT", raising=False)
    assert not TP.lpips_available() and not TP.fid_available()
    with pytest.raises(RuntimeError, match="FID unavailable"):
        TP.fid([np.zeros((8, 8, 3))], [np.zeros((8, 8, 3))], device="cpu")
    monkeypatch.setenv("IRET_FID_RANDOM_INIT", "1")
    assert TP.fid_random_init_ok()
    a, b = TI.random_init_model(), TI.random_init_model()   # seeded: the same weights
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    x = torch.rand(1, 3, 96, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        f = a(x)
    assert f.shape == (1, 2048) and torch.isfinite(f).all() and f.abs().max() > 0
