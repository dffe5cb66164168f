"""The port's ``import_weights`` against the JAX package's script (CPU, TINY).

- The rehearsal directory: the port's (TINY_SD, the port's seeded init)
  against JAX's ``make_rehearsal_dir`` (its flax init swapped for random
  values of the same tree, as in ``tests/test_torch_import.py``): the same
  files, the same JSON (the port's text-encoder config.json holds the
  fields JAX passes to ``transformers.CLIPTextConfig``, equal to JAX's), the
  same tensor names, shapes and dtypes; the text encoder's names are
  ``transformers.CLIPTextModel``'s own, ``position_ids`` left out.
- ``import_sd_dir`` on JAX's rehearsal: every tensor of the written
  pipeline bitwise the JAX import's, and the same model config. The port's
  rehearsal imports and loads in JAX.
- The scheduler overrides, and the loud error on an unsupported value.
- ``import_metric_weights``: the same files as JAX's for LPIPS, InceptionV3
  and RRDBNet weights, from .pth (with ``params_ema`` / ``state_dict``
  wrappers) and .safetensors.
- The four deterministic probes (text encoder, VAE posterior mode, VAE
  decode, UNet) against JAX's ``run_our_probes`` on one TINY_SD pipeline
  directory, fp32, within 1e-5 absolute (the same fp32 sums in another
  order). The img2img probe draws its noise from a torch CPU generator and
  JAX from its own key, so it is held only against itself (JAX's img2img
  probe is replaced by zeros here, which saves compiling it).
- The goldens round trip, and a perturbed UNet weight failing the gate.
- The probes and the rehearsal's init need CUDA unless the CPU is asked for.
"""
import dataclasses
import json
import os
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch import import_weights as iw
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.metrics import inception as tinc
from image_restoration_and_enhancement_torch.metrics import perceptual as tper
from image_restoration_and_enhancement_torch.models import rrdbnet as trrdb
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import import_weights as jiw  # noqa: E402

PROBE_ATOL = 1e-5
PROBE_SIZE = 64


_REAL_INIT = js.init_params


def _random_init(modules, key, image_size=256, seq_len=77):
    return fill_params(jax.eval_shape(
        lambda k: _REAL_INIT(modules, k, image_size, seq_len), key), seed=5)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """JAX's and the port's TINY_SD rehearsal directories, and their configs."""
    root = tmp_path_factory.mktemp("rehearsals")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "init_params", _random_init)
        jcfg = jiw.make_rehearsal_dir(str(root / "jax"), JC.TINY_SD, seed=5)
    tcfg = iw.make_rehearsal_dir(str(root / "port"), TC.TINY_SD, seed=5, device="cpu")
    return root, jcfg, tcfg


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_rehearsal_dir_matches_jax(dirs):
    root, jcfg, tcfg = dirs
    jdir, tdir = root / "jax", root / "port"
    assert _files(jdir) == _files(tdir)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        TC.model_config_from_dict(dataclasses.asdict(jcfg)))
    assert tcfg.text_encoder.vocab_size == 552
    for rel in _files(jdir):
        if rel.endswith(".json"):
            want, got = _json(jdir / rel), _json(tdir / rel)
            if rel == os.path.join("text_encoder", "config.json"):
                want = {k: want[k] for k in got}   # transformers' defaults besides
            assert got == want, rel
        elif rel.endswith(".safetensors"):
            want = st_numpy.load_file(str(jdir / rel))
            got = tck.load_safetensors(str(tdir / rel))
            assert sorted(got) == sorted(want), rel
            for k, v in want.items():
                assert tuple(got[k].shape) == v.shape and str(got[k].dtype) == f"torch.{v.dtype}"
        else:
            assert (jdir / rel).read_bytes() == (tdir / rel).read_bytes(), rel


def test_rehearsal_text_encoder_names_are_transformers(dirs):
    transformers = pytest.importorskip("transformers")
    root, _, tcfg = dirs
    tc = tcfg.text_encoder
    model = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
        intermediate_size=tc.intermediate_size, num_hidden_layers=tc.num_hidden_layers,
        num_attention_heads=tc.num_attention_heads,
        max_position_embeddings=tc.max_position_embeddings, hidden_act=tc.hidden_act))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items() if "position_ids" not in k}
    got = tck.load_safetensors(str(root / "port" / "text_encoder" / "model.safetensors"))
    assert {k: tuple(v.shape) for k, v in got.items()} == want


def _pipeline_tensors(d):
    return {c: tck.load_safetensors(os.path.join(d, c, "model.safetensors"))
            for c in ("unet", "vae", "text_encoder")}


def test_import_of_jax_rehearsal_is_bitwise_jax(dirs, tmp_path, capsys):
    root, jcfg, _ = dirs
    src = str(root / "jax")
    jiw.import_sd_dir(src, str(tmp_path / "jax"), jcfg)
    iw.import_sd_dir(src, str(tmp_path / "port"),
                     TC.model_config_from_dict(dataclasses.asdict(jcfg)))
    out = capsys.readouterr().out.splitlines()   # the same lines, the paths aside
    assert out[-2] == out[-4]
    assert out[-1] == out[-3].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    want, got = _pipeline_tensors(tmp_path / "jax"), _pipeline_tensors(tmp_path / "port")
    for comp in want:
        assert sorted(got[comp]) == sorted(want[comp]), comp
        for k, v in want[comp].items():
            assert got[comp][k].dtype == v.dtype and torch.equal(got[comp][k], v), (comp, k)
    assert _json(tmp_path / "port" / "model_index.json")["config"] == \
        _json(tmp_path / "jax" / "model_index.json")["config"]
    for f in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_port_rehearsal_loads_in_jax(dirs, tmp_path):
    root, _, tcfg = dirs
    jcfg = dataclasses.replace(JC.TINY_SD, text_encoder=dataclasses.replace(
        JC.TINY_SD.text_encoder, **{k: getattr(tcfg.text_encoder, k) for k in (
            "vocab_size", "bos_token_id", "eos_token_id", "pad_token_id")}))
    jiw.import_sd_dir(str(root / "port"), str(tmp_path / "out"), jcfg)
    params = jck.load_pipeline(str(tmp_path / "out"))
    modules = js.SDModules.create(jcfg)
    shapes = jax.eval_shape(lambda k: _REAL_INIT(modules, k, 64), jax.random.PRNGKey(0))
    for comp in ("unet", "vae", "text_encoder"):
        want = jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes[comp])
        assert jax.tree_util.tree_map(lambda x: tuple(x.shape), params[comp]) == want, comp


def _copy_with_scheduler(src, dst, **values):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "scheduler", "scheduler_config.json")
    sc = _json(path)
    sc.update(values)
    with open(path, "w") as f:
        json.dump(sc, f)


def test_scheduler_overrides_and_unsupported_values(dirs, tmp_path, capsys):
    root, _, tcfg = dirs
    src = str(tmp_path / "linear")
    _copy_with_scheduler(root / "port", src, beta_schedule="linear", beta_end=0.02)
    iw.import_sd_dir(src, str(tmp_path / "out"), tcfg)
    sched = _json(tmp_path / "out" / "model_index.json")["config"]["scheduler"]
    assert sched["beta_schedule"] == "linear" and sched["beta_end"] == 0.02
    assert "scheduler config from" in capsys.readouterr().out
    for key, value in (("beta_schedule", "squaredcos_cap_v2"),
                       ("prediction_type", "v_prediction"), ("timestep_spacing", "trailing")):
        bad = str(tmp_path / key)
        _copy_with_scheduler(root / "port", bad, **{key: value})
        with pytest.raises(ValueError, match=f"unsupported scheduler {key}"):
            iw.import_sd_dir(bad, str(tmp_path / "never"), tcfg)
        with pytest.raises(ValueError, match=f"unsupported scheduler {key}"):
            jiw.import_sd_dir(bad, str(tmp_path / "never_jax"), JC.TINY_SD)


def _random_state(module, seed, extra=()):
    rng = np.random.default_rng(seed)
    state = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
             for k, v in module.state_dict().items() if v.is_floating_point()}
    for k, shape in extra:
        state[k] = torch.zeros(shape)
    return state


@pytest.mark.parametrize("kind,fname,fmt", [
    ("lpips", "lpips_alex.safetensors", "pth"),
    ("inception", "inception_v3.safetensors", "safetensors"),
    ("rrdb", "realesrgan_x4.safetensors", "pth_ema"),
])
def test_metric_weights_equal_jax(kind, fname, fmt, tmp_path):
    module = {"lpips": tper.LPIPSAlex, "inception": tinc.InceptionV3Features,
              "rrdb": trrdb.RRDBNet}[kind]()
    extra = {"inception": (("fc.weight", (1000, 2048)), ("fc.bias", (1000,)))}.get(kind, ())
    state = _random_state(module, 3, extra)
    if kind == "lpips":   # the AlexNet trunk under torchvision's names, which both read
        state = {re.sub(r"^net\.slice\d\.", "net.features.", k): v for k, v in state.items()}
    src = str(tmp_path / f"w.{fmt.split('_')[0]}")
    if fmt == "safetensors":
        tck.save_safetensors(state, src)
    else:
        torch.save({"params_ema": state} if fmt == "pth_ema" else {"state_dict": state}, src)
    iw.import_metric_weights(kind, src, str(tmp_path / "port"))
    jiw.import_metric_weights(kind, src, str(tmp_path / "jax"))
    want = st_numpy.load_file(str(tmp_path / "jax" / fname))
    got = tck.load_safetensors(str(tmp_path / "port" / fname))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A TINY_SD pipeline directory written by the JAX package."""
    d = str(tmp_path_factory.mktemp("pretrained") / "sd15")
    modules = js.SDModules.create(JC.TINY_SD)
    params = fill_params(jax.eval_shape(lambda k: _REAL_INIT(modules, k, 64),
                                        jax.random.PRNGKey(0)), seed=9)
    jck.save_pipeline(d, params, JC.TINY_SD)
    return d


class _Jitted:
    """A flax module whose ``apply`` is jitted (one compile instead of one per
    eager op); every other attribute is the module's."""

    def __init__(self, module):
        self._module = module
        self.apply = jax.jit(module.apply, static_argnames=("method",))

    def __getattr__(self, name):
        return getattr(self._module, name)


def test_probes_match_jax(tiny_dir, monkeypatch):
    got = iw.run_our_probes(tiny_dir, config=TC.TINY_SD, image_size=PROBE_SIZE, device="cpu")
    assert set(got) == set(iw.THRESHOLDS)
    real_create = js.SDModules.create

    def jitted_create(*a, **kw):
        m = real_create(*a, **kw)
        return dataclasses.replace(m, unet=_Jitted(m.unet), vae=_Jitted(m.vae),
                                   text_encoder=_Jitted(m.text_encoder))

    monkeypatch.setattr(js.SDModules, "create", jitted_create)
    monkeypatch.setattr(js, "make_img2img_fn",
                        lambda *a, **kw: lambda params, image, *r: np.zeros_like(image))
    want = jiw.run_our_probes(tiny_dir, config=JC.TINY_SD, image_size=PROBE_SIZE)
    for name in ("text_encoder", "vae_encode", "vae_decode", "unet"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PROBE_ATOL, err_msg=name)
    assert got["img2img"].shape == (1, PROBE_SIZE, PROBE_SIZE, 3)
    assert np.isfinite(got["img2img"]).all()
    again = iw.run_our_probes(tiny_dir, config=TC.TINY_SD, image_size=PROBE_SIZE, device="cpu")
    for name in got:
        assert np.array_equal(got[name], again[name]), name


def test_goldens_round_trip_and_a_perturbed_weight_fails(tiny_dir, tmp_path, capsys):
    goldens = str(tmp_path / "goldens")
    iw.record_goldens(tiny_dir, goldens, device="cpu", image_size=PROBE_SIZE)
    assert iw.check_goldens(tiny_dir, goldens, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum("[OK]" in line for line in lines) == len(iw.THRESHOLDS)
    bad = str(tmp_path / "bad")
    shutil.copytree(tiny_dir, bad)
    path = os.path.join(bad, "unet", "model.safetensors")
    unet = tck.load_safetensors(path)
    first = sorted(unet)[0]
    unet[first] = unet[first] + 0.05   # as a transposed or wrong import would
    tck.save_safetensors(unet, path)
    assert iw.check_goldens(bad, goldens, device="cpu") >= 1
    fails = [line for line in capsys.readouterr().out.splitlines() if "[FAIL]" in line]
    assert fails and fails[0].split()[0] == "unet"


def test_load_torch_file_unwraps(tmp_path):
    state = {"a": torch.arange(3.0), "b": torch.ones(2, 2)}
    for name, obj in (("ema", {"params_ema": state}), ("sd", {"state_dict": state}),
                      ("plain", state)):
        torch.save(obj, tmp_path / f"{name}.pth")
        got = iw._load_torch_file(str(tmp_path / f"{name}.pth"))
        assert set(got) == {"a", "b"} and all(torch.equal(got[k], state[k]) for k in state)
    tck.save_safetensors(state, str(tmp_path / "w.safetensors"))
    got = iw._load_torch_file(str(tmp_path / "w.safetensors"))
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_probes_and_rehearsal_need_cuda_unless_cpu_is_asked(tiny_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iw.run_our_probes(tiny_dir, config=TC.TINY_SD, image_size=PROBE_SIZE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iw.make_rehearsal_dir(str(tmp_path / "r"), TC.TINY_SD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iw.main(["--make_rehearsal", str(tmp_path / "r2")])
