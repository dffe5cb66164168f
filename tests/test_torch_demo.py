"""The port's restoration-learning demo against the JAX package's script
(loaded by path), on the CPU.

- ``demo_image`` bitwise; ``gen_data``'s PNGs (the port's codec) decode to the
  pixels of the JAX script's PNGs (PIL), under the same names;
  ``demo_model_config`` equal field by field; the input baseline within 1e-4
  dB of the JAX-computed one (the same fp32 PSNR, summed in another order).
- The whole chain at 64 px (the demo UNet's three downsamples need a latent of
  at least 8x8; neither package's stack runs at 32 px), then a rerun after
  the train state is removed: stages 1 and 2 are skipped and the summary
  reads only the rerun's CSV rows. After the sweep the summary has the keys
  of the committed JAX record.

The probe and the sweep against JAX: ``test_torch_demo_sweep.py``.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from image_restoration_and_enhancement_torch import demo_eval_sweep
from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo
from image_restoration_and_enhancement_torch.data.png import read_png
from image_restoration_and_enhancement_tpu.metrics import functional as JF
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jdemo():
    return load_script("demo_restoration_learning")


@pytest.fixture(scope="module")
def data(jdemo, tmp_path_factory):
    """The demo's pairs at 64 px (2 train, 2 val) from both scripts, seed 3."""
    root = tmp_path_factory.mktemp("demo_data")
    for name, mod in (("jax", jdemo), ("torch", tdemo)):
        mod.gen_data(str(root / name), 64, 80.0, 2, 2, 3)
    return root


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 64), (7, 32), (42, 256)])
def test_demo_image_bitwise(jdemo, seed, size):
    a = jdemo.demo_image(np.random.default_rng(seed), size)
    b = tdemo.demo_image(np.random.default_rng(seed), size)
    assert b.dtype == np.uint8 and b.shape == (size, size, 3)
    np.testing.assert_array_equal(b, a)


def test_gen_data_decodes_to_the_jax_files(data):
    files = sorted(str(p.relative_to(data / "jax")) for p in (data / "jax").rglob("*.png"))
    assert len(files) == 3 * 4   # clean, input, gt per image; 2 train + 2 val
    assert sorted(str(p.relative_to(data / "torch"))
                  for p in (data / "torch").rglob("*.png")) == files
    for f in files:
        np.testing.assert_array_equal(read_png(str(data / "torch" / f)),
                                      np.asarray(Image.open(data / "jax" / f)), err_msg=f)


def test_demo_model_config_equals_jax(jdemo):
    a, b = jdemo.demo_model_config(), tdemo.demo_model_config()
    for part in ("unet", "vae", "text_encoder", "scheduler", "text_encoder_2"):
        ja, tb = getattr(a, part), getattr(b, part)
        if ja is None:
            assert tb is None, part
            continue
        assert dataclasses.asdict(tb) == dataclasses.asdict(ja), part
    assert b.unet.block_out_channels == (32, 64, 64, 64) and b.unet.num_attention_heads == 4
    assert b.vae.block_out_channels == (16, 32, 32, 32)


def test_input_baseline_matches_jax(data):
    vdir = data / "jax" / "pairs" / "denoise" / "val"
    base = []   # the JAX script's stage 4
    for f in sorted(os.listdir(vdir / "gt")):
        g = np.asarray(Image.open(vdir / "gt" / f), np.float32) / 255
        i = np.asarray(Image.open(vdir / "input" / f), np.float32) / 255
        base.append(float(JF.psnr(jnp.asarray(i), jnp.asarray(g))))
    got = tdemo.input_baseline(str(data / "torch" / "pairs" / "denoise" / "val"))
    assert abs(got - float(np.mean(base))) <= 1e-4


def test_demo_chain_rerun_and_summary_keys(tmp_path, capsys):
    out = str(tmp_path / "demo")
    args = ["--out", out, "--size", "64", "--n_train", "8", "--n_val", "2",
            "--vae_epochs", "1", "--batch_size", "4", "--device", "cpu"]
    assert tdemo.main(args + ["--epochs", "2"]) == 0
    first = capsys.readouterr().out
    assert "== stage 1" in first and "== stage 2" in first
    assert demo_eval_sweep.main(["--out", out, "--strengths", "0.1", "--ensemble", "2",
                                 "--device", "cpu"]) == 0
    with open(os.path.join(out, "artifacts", "summary.json")) as f:
        summary = json.load(f)
    with open(REPO / "docs" / "artifacts" / "demo_learning" / "summary.json") as f:
        assert sorted(summary) == sorted(json.load(f))
    assert sorted(summary["serving_sweep"]) == ["ensemble_2_strength_0.1", "strength_0.1",
                                                "vae_roundtrip"]
    assert summary["epochs"] == 2 and np.isfinite(summary["best_serving_psnr"])
    assert sorted(os.listdir(os.path.join(out, "artifacts"))) == [
        "epoch_1.png", "epoch_2.png", "metrics_denoise.csv", "metrics_vae.csv",
        "summary.json", "training_denoise.log"]

    # a rerun without the train state starts the epoch counter again: the CSV
    # holds both runs, the summary the rerun's single row
    os.remove(os.path.join(out, "model", "train_state", "state.pt"))
    assert tdemo.main(args + ["--epochs", "1"]) == 0
    again = capsys.readouterr().out
    assert "== stage 1" not in again and "== stage 2" not in again
    rows = tdemo.last_run_rows(os.path.join(out, "model", "metrics_denoise.csv"))
    with open(os.path.join(out, "model", "metrics_denoise.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
    with open(os.path.join(out, "artifacts", "summary.json")) as f:
        rerun = json.load(f)
    assert len(rows) == 1 and rerun["epochs"] == 1 and rerun["best_epoch"] == 1
    assert rerun["epoch1_psnr"] == round(float(rows[0]["psnr"]), 4)
    assert rerun["input_baseline_psnr"] == summary["input_baseline_psnr"]
