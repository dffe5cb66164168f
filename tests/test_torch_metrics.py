"""The port's metrics (``metrics/functional.py``, ``calculator.py``,
``evaluate.py``, ``evaluate_model.py``) against the JAX package's on seeded
images.

Limits (fp32 on both sides, sums in another order): PSNR 1e-4 dB, SSIM 2e-6,
ΔE 1e-4, LPIPS 1e-5 relative; the evaluation JSON holds every statistic of
each metric to that metric's limit and its counts, win rates and verdicts
exactly. The JSON comparison runs without FID: one 2048-d ``sqrtm`` takes
~14 s on this CPU (``test_torch_perceptual.py`` holds FID's parts, and
``test_evaluate_task_keys_fid`` its wiring).
"""
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_and_enhancement_torch import evaluate_model as port_eval_model
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.data.png import write_png
from image_restoration_and_enhancement_torch.metrics import calculator as TC
from image_restoration_and_enhancement_torch.metrics import evaluate as TE
from image_restoration_and_enhancement_torch.metrics import functional as TF
from image_restoration_and_enhancement_torch.metrics import perceptual as TP
from image_restoration_and_enhancement_tpu.metrics import calculator as JC
from image_restoration_and_enhancement_tpu.metrics import evaluate as JE
from image_restoration_and_enhancement_tpu.metrics import functional as JF
from image_restoration_and_enhancement_tpu.metrics import perceptual as JP
from test_torch_perceptual import jax_lpips_flat
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = {"psnr": 1e-4, "ssim": 2e-6, "delta_e": 1e-4}


def limit(name):
    for key in ("psnr", "ssim", "delta_e"):
        if name.startswith(key):
            return LIMITS[key]
    raise KeyError(name)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(101)
    smooth = np.cumsum(rng.uniform(-0.04, 0.04, (4, 30, 38, 3)), axis=2)
    gt = ((smooth - smooth.min()) / np.ptp(smooth)).astype(np.float32)
    noisy = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    return gt, noisy


def test_functional_metrics_match_jax_per_image(pairs):
    gt, pred = pairs
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    for name in ("psnr", "ssim", "delta_e76", "psnr_y", "ssim_y", "psnr_l", "ssim_l"):
        got = getattr(TF, name)(tp, tg).numpy()
        want = np.array([getattr(JF, name)(jnp.asarray(p), jnp.asarray(g))
                         for p, g in zip(pred, gt)])
        assert got.shape == (len(gt),)
        np.testing.assert_allclose(got, want, rtol=0, atol=limit(name.replace("76", "")),
                                   err_msg=name)
    # one HWC image, and one grey HW image, give a scalar as in JAX
    assert abs(float(TF.ssim(tp[0], tg[0])) - float(JF.ssim(jnp.asarray(pred[0]),
                                                            jnp.asarray(gt[0])))) <= 2e-6
    for fn in ("psnr", "ssim"):
        got = float(getattr(TF, fn)(tp[1, ..., 0], tg[1, ..., 0]))
        want = float(getattr(JF, fn)(jnp.asarray(pred[1, ..., 0]), jnp.asarray(gt[1, ..., 0])))
        assert abs(got - want) <= LIMITS[fn]


@pytest.mark.parametrize("with_color,with_y", [(False, False), (True, False), (False, True)])
def test_calculate_all_matches_jax_vmapped_bundle(pairs, with_color, with_y):
    gt, pred = pairs
    want = JE._metric_fn(with_color, with_y)(jnp.asarray(pred), jnp.asarray(gt))
    got = TF.calculate_all(torch.from_numpy(pred), torch.from_numpy(gt), with_color, with_y)
    assert set(got) == set(want)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[name]), rtol=0, atol=limit(name))


def test_ssim_of_identical_smooth_images_is_one(pairs):
    gt, _ = pairs
    s = TF.ssim(torch.from_numpy(gt), torch.from_numpy(gt))
    assert (s <= 1.0).all() and (s > 1 - 1e-6).all()


def test_metrics_calculator_matches_jax(pairs):
    gt, pred = pairs
    g8 = (gt[0] * 255).astype(np.uint8)
    p8 = (pred[0] * 255).astype(np.uint8)
    big = np.asarray(Image.fromarray(p8).resize((76, 60), Image.BICUBIC))   # resized to gt
    port = TC.MetricsCalculator(use_lpips=False, use_fid=False, device="cpu")
    ref = JC.MetricsCalculator(use_lpips=False, use_fid=False)
    for p in (p8, big, pred[0]):
        assert abs(port.calculate_psnr(p, g8) - ref.calculate_psnr(p, g8)) <= 1e-4
        assert abs(port.calculate_ssim(p, g8) - ref.calculate_ssim(p, g8)) <= 2e-6
        assert abs(port.calculate_delta_e(p, g8) - ref.calculate_delta_e(p, g8)) <= 1e-4
        assert port.calculate_all(p, g8).keys() == ref.calculate_all(p, g8).keys()


# --- directory evaluation, against the JAX package's script -------------------------


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """A test split per task (PNG; 3 images of 32x40; sr_x4 inputs at 8x10)
    and predictions (sr_x4's at 64x80, so that both sides resize them to the
    gt with LANCZOS; one denoise prediction a JPEG, matched by stem), and an
    LPIPS weights file in the JAX layout."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(102)
    for task in ("denoise", "sr_x4", "colorize", "inpaint"):
        split = root / "data" / task / "test"
        for sub in ("input", "gt") + (("mask",) if task == "inpaint" else ()):
            (split / sub).mkdir(parents=True)
        (root / "pred" / task).mkdir(parents=True)
        for i in range(3):
            base = np.cumsum(rng.integers(-6, 7, (32, 40, 3)), axis=1)
            gt = np.clip(base - base.min() + 40, 0, 255).astype(np.uint8)
            pred = np.clip(gt + rng.normal(0, 6, gt.shape), 0, 255).astype(np.uint8)
            inp = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
            if task == "sr_x4":
                inp = inp[::4, ::4]
                pred = np.asarray(Image.fromarray(pred).resize((80, 64), Image.BICUBIC))
            if task == "colorize":
                inp = np.repeat(inp[..., :1], 3, axis=-1)
            write_png(str(split / "gt" / f"im{i}.png"), gt)
            write_png(str(split / "input" / f"im{i}.png"), inp)
            if task == "inpaint":
                write_png(str(split / "mask" / f"im{i}.png"),
                          np.where(rng.random((32, 40)) < 0.2, 255, 0).astype(np.uint8))
            if task == "denoise" and i == 2:
                Image.fromarray(pred).save(str(root / "pred" / task / f"im{i}.jpg"))
            else:
                write_png(str(root / "pred" / task / f"im{i}.png"), pred)
    wdir = root / "weights"
    tck.save_safetensors(jax_lpips_flat(103), str(wdir / TP.LPIPS_FILE))
    return root


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_json_close(got, want, path=""):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_json_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        names = [p for p in path.split("/") if p]
        metric = next(n for n in reversed(names) if n.startswith(("psnr", "ssim", "delta",
                                                                   "lpips", "win")))
        if metric == "win_rate":
            assert got == want, path
        elif metric == "lpips":
            assert abs(got - want) <= 1e-5 * abs(want), (path, got, want)
        else:
            assert abs(got - want) <= 2 * limit(metric), (path, got, want)
    else:
        assert got == want, path


def test_evaluate_model_json_matches_jax(eval_dirs, monkeypatch, capsys):
    """Both scripts on the same directories, LPIPS on, FID off: the same JSON
    (keys, counts, verdicts) within the metric limits (a difference of two
    means, a paired delta, gets twice the limit)."""
    root = eval_dirs
    wdir = str(root / "weights")
    monkeypatch.setenv("IRET_WEIGHTS_DIR", wdir)
    monkeypatch.setattr(JP, "_LPIPS_PATH", os.path.join(wdir, TP.LPIPS_FILE))
    JP._lpips_params.cache_clear()
    JP._lpips_fn.cache_clear()
    common = ["--pred_root", str(root / "pred"), "--data_root", str(root / "data"),
              "--no-use_fid"]
    monkeypatch.setattr(sys, "argv", ["evaluate_model.py", *common,
                                      "--out_json", str(root / "jax.json")])
    try:
        _jax_script("evaluate_model").main()
    finally:
        JP._lpips_params.cache_clear()
        JP._lpips_fn.cache_clear()
    rc = port_eval_model.main([*common, "--out_json", str(root / "port.json"),
                               "--device", "cpu"])
    assert rc == 0
    want = json.loads((root / "jax.json").read_text())
    got = json.loads((root / "port.json").read_text())
    assert set(want) == {"denoise", "sr_x4", "colorize", "inpaint"}
    assert "lpips" in want["denoise"]["metrics"] and "delta_e" in want["colorize"]["metrics"]
    assert_json_close(got, want)
    assert "paired Δpsnr" in capsys.readouterr().out


def test_evaluate_model_fails_loud_on_missing_dirs(eval_dirs, tmp_path):
    args = ["--pred_root", str(tmp_path / "nothing"), "--data_root", str(eval_dirs / "data"),
            "--out_json", str(tmp_path / "r.json"), "--device", "cpu", "--tasks", "denoise"]
    assert port_eval_model.main(args) == 1
    assert port_eval_model.main(args + ["--allow_missing"]) == 0
    assert json.loads((tmp_path / "r.json").read_text()) == {}


def test_evaluate_task_keys_fid(eval_dirs, monkeypatch, tmp_path):
    """FID's wiring in evaluate_task: the pairs reach ``perceptual.fid`` in
    stem order, and the result is keyed ``fid_random_init_weights_pending``
    without the Inception file (IRET_FID_RANDOM_INIT=1), ``fid`` with it, and
    absent otherwise, as in the JAX package."""
    seen = []

    def fake_fid(preds, gts, device=None):
        seen.append((len(preds), preds[0].shape, str(device)))
        return 1.5

    monkeypatch.setattr(TP, "fid", fake_fid)
    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path))
    pred, gt = str(eval_dirs / "pred" / "inpaint"), str(eval_dirs / "data" / "inpaint" / "test"
                                                          / "gt")
    monkeypatch.delenv("IRET_FID_RANDOM_INIT", raising=False)
    assert "fid" not in TE.evaluate_task(pred, gt, use_fid=True, device="cpu")
    monkeypatch.setenv("IRET_FID_RANDOM_INIT", "1")
    res = TE.evaluate_task(pred, gt, use_fid=True, device="cpu")
    assert res["fid_random_init_weights_pending"] == 1.5 and "fid" not in res
    (tmp_path / TP.INCEPTION_FILE).write_bytes(b"")
    assert TE.evaluate_task(pred, gt, use_fid=True, device="cpu")["fid"] == 1.5
    assert seen == [(3, (32, 40, 3), "cpu")] * 2


def test_paired_delta_stats_match_jax():
    rng = np.random.default_rng(104)
    out = {f"s{i}": float(v) for i, v in enumerate(rng.normal(30, 2, 9))}
    base = {f"s{i}": float(v) for i, v in enumerate(rng.normal(29, 2, 10))}
    assert TE.paired_delta_stats(out, base) == JE.paired_delta_stats(out, base)
    assert TE.paired_delta_stats({"a": 1.0}, {"a": 0.0}) is None
