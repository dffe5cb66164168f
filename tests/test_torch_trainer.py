"""The port's trainer (``train/trainer.py``, ``train/vae_pretrain.py`` and the
train entry points) end to end on TINY_SD and 64 px pairs written with the
port's PNG codec, on the CPU.

Checked against the JAX package: the CSV columns (its ``_csv_columns``) for
the four tasks, and that its ``load_pipeline`` reads the port's ``best/`` with
the keys and shapes its own ``train_task`` writes (those of its
``init_params``), and that a pipeline it wrote starts ``train_task``
(``init_from``) with its weights bit for bit. Checked on the port alone: the output layout (best, final,
step checkpoints, strips, log, train state), ``state_save_epochs=-1``, exact
resume (an interrupted run resumed from its train state ends bitwise equal
to the uninterrupted one: the draws are seeded from (seed, step) and the
optimizer state is saved whole), the bf16 CLI run (fp32 masters beside a bf16
compute UNet), and ``pretrain_vae`` seeding ``train_task``'s frozen VAE.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch import pretrain_vae as pretrain_cli
from image_restoration_and_enhancement_torch import train_cli
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.data.png import write_png
from image_restoration_and_enhancement_torch.tasks.registry import TASKS as T_TASKS
from image_restoration_and_enhancement_torch.train import trainer as T
from image_restoration_and_enhancement_torch.train.loop import TrainConfig
from image_restoration_and_enhancement_torch.train.vae_pretrain import (VAEPretrainConfig,
                                                                        pretrain_vae)
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.tasks.registry import TASKS as J_TASKS
from image_restoration_and_enhancement_tpu.train import trainer as JT
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

SIZE = 64
BASE = dict(batch_size=2, gradient_accumulation_steps=2, lambda_img=0.05, image_size=SIZE,
            save_steps=2, learning_rate=1e-3)



@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Denoise pairs (4 train, 2 val) and clean images (4 train, 2 val)."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        base = root / "pairs" / "denoise" / split
        clean = root / "clean" / split
        for d in (base / "input", base / "gt", clean):
            d.mkdir(parents=True)
        for i in range(n):
            img = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
            noisy = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
            write_png(str(base / "gt" / f"i{i}.png"), img)
            write_png(str(base / "input" / f"i{i}.png"), noisy)
            write_png(str(clean / f"c{i}.png"), img)
    return {"pairs": str(root / "pairs"), "clean": str(root / "clean")}


def _train(data, out, **kw):
    cfg = TrainConfig(**{**BASE, **kw.pop("cfg", {})})
    return T.train_task("denoise", data_root=data["pairs"], output_dir=str(out), cfg=cfg,
                        dtype=torch.float32, model_config=TC.TINY_SD, device="cpu", **kw)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_csv_columns_match_jax():
    assert set(T_TASKS) == set(J_TASKS)
    for name in T_TASKS:
        assert T._csv_columns(T_TASKS[name]) == JT._csv_columns(J_TASKS[name]), name


def test_train_task_layout_and_jax_readable(data, tmp_path):
    out = tmp_path / "run"
    metrics = _train(data, out, cfg=dict(num_epochs=2, state_save_epochs=1))
    assert np.isfinite(metrics["psnr"]) and {"ssim", "psnr_y", "ssim_y"} <= set(metrics)
    names = set(os.listdir(out))
    # 2 steps an epoch, save_steps 2: checkpoint-2 and checkpoint-4
    assert {"best", "final", "checkpoint-2", "checkpoint-4", "val_samples", "train_state",
            "metrics_denoise.csv", "training_denoise.log"} <= names
    assert sorted(os.listdir(out / "val_samples")) == ["epoch_1.png", "epoch_2.png"]
    rows = _rows(out / "metrics_denoise.csv")
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert list(rows[0]) == JT._csv_columns(J_TASKS["denoise"])
    assert all(np.isfinite(float(r["train_loss"])) for r in rows)
    assert T.latest_step(str(out / "train_state")) == 4
    assert set(os.listdir(out / "checkpoint-2")) == {"unet", "model_index.json"}

    # JAX reads best/ with the keys and shapes its own train_task writes
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=SIZE),
                            jax.random.PRNGKey(0))
    loaded = jck.load_pipeline(str(out / "best"))
    assert set(loaded) == {"unet", "vae", "text_encoder"}
    for comp, tree in loaded.items():
        flat = jck.flatten_params(tree)
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes[comp])
        want = {k: tuple(v.shape) for k, v in jck.flatten_params(zeros).items()}
        assert {k: tuple(np.shape(v)) for k, v in flat.items()} == want, comp
        assert all(np.asarray(v).dtype == np.float32 for v in flat.values())
    # best/ holds the last validation's weights when it was the best, final/ always
    final = tck.load_pipeline(str(out / "final"))["unet"]
    state = torch.load(out / "train_state" / "state.pt", weights_only=True)
    bridged = tck.params_from_flax(final)
    assert all(torch.equal(bridged[n], p) for n, p in state["params"].items())
    assert jck.load_pipeline_model_config(str(out / "best")) == JC.TINY_SD


def test_init_from_a_jax_pipeline(data, tmp_path):
    """``init_from`` a pipeline that the JAX package wrote: the first optimizer
    step has rate 0 (the warmup's first value), so checkpoint-2 holds JAX's
    UNet bit for bit, and final/ JAX's frozen VAE."""
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=SIZE),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=31)
    jck.save_pipeline(str(tmp_path / "jax"), params, JC.TINY_SD)
    out = tmp_path / "from_jax"
    _train(data, out, cfg=dict(num_epochs=1, state_save_epochs=-1),
           init_from=str(tmp_path / "jax"))
    for comp, ckpt_dir in (("unet", "checkpoint-2"), ("vae", "final")):
        got = jck.flatten_params(jck.load_pipeline(str(out / ckpt_dir))[comp])
        want = jck.flatten_params(params[comp])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), comp
    assert "initializing from" in open(out / "training_denoise.log").read()


def test_lpips_column_and_epoch_checkpoints(data, tmp_path, monkeypatch):
    """With LPIPS weights present (stubbed) the CSV's lpips column is filled;
    save_steps 0 writes one checkpoint-epoch-N per epoch; state_save_epochs 0
    writes the train state at the last epoch only."""
    monkeypatch.setattr(T.perceptual, "lpips_available", lambda: True)
    monkeypatch.setattr(T.perceptual, "lpips_pairs",
                        lambda preds, gts, device=None: [0.123 for _ in preds])
    out = tmp_path / "lpips"
    _train(data, out, cfg=dict(num_epochs=1, save_steps=0, state_save_epochs=0))
    rows = _rows(out / "metrics_denoise.csv")
    assert len(rows) == 1 and abs(float(rows[0]["lpips"]) - 0.123) < 1e-6
    assert os.path.isdir(out / "checkpoint-epoch-1")
    assert T.latest_step(str(out / "train_state")) == 2


def test_state_save_epochs_never(data, tmp_path):
    out = tmp_path / "nostate"
    _train(data, out, cfg=dict(num_epochs=1, state_save_epochs=-1, save_steps=-1))
    assert os.path.isdir(out / "best") and os.path.isdir(out / "final")
    assert not os.path.exists(out / "train_state")
    assert not [n for n in os.listdir(out) if n.startswith("checkpoint-")]


def test_exact_resume(data, tmp_path, monkeypatch):
    """Two epochs straight through, against one epoch, a crash in the second
    epoch's validation, and a resume: the same masters, bit for bit, and a
    CSV numbered 1, 2."""
    cfg = dict(num_epochs=2, state_save_epochs=1, save_steps=-1)
    whole = tmp_path / "whole"
    _train(data, whole, cfg=cfg)

    broken = tmp_path / "broken"
    real = T.run_validation

    class Crash(Exception):
        pass

    def crash_in_epoch_2(*args, **kw):
        if args[5] == 2:
            raise Crash
        return real(*args, **kw)

    monkeypatch.setattr(T, "run_validation", crash_in_epoch_2)
    with pytest.raises(Crash):
        _train(data, broken, cfg=cfg)
    assert T.latest_step(str(broken / "train_state")) == 2
    monkeypatch.setattr(T, "run_validation", real)
    _train(data, broken, cfg=cfg, resume=True)

    a = torch.load(whole / "train_state" / "state.pt", weights_only=True)
    b = torch.load(broken / "train_state" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 4
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    for n in a["opt_state"]["inner"]["mu"]:
        assert torch.equal(a["opt_state"]["inner"]["mu"][n], b["opt_state"]["inner"]["mu"][n])
    assert [r["epoch"] for r in _rows(broken / "metrics_denoise.csv")] == ["1", "2"]


def test_cli_bf16_masters(data, tmp_path):
    """The denoise CLI on the CPU in the default bf16 compute dtype: fp32
    masters in best/, finite losses."""
    out = tmp_path / "cli"
    rc = train_cli.run("denoise", "unused", [
        "--base_model", "tiny_sd", "--data_root", data["pairs"], "--output_dir", str(out),
        "--num_epochs", "1", "--batch_size", "2", "--gradient_accumulation_steps", "1",
        "--image_size", str(SIZE), "--save_steps", "-1", "--no_mesh", "--device", "cpu",
        "--val_steps", "4", "--learning_rate", "1e-3"])
    assert rc == 0
    rows = _rows(out / "metrics_denoise.csv")
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"]))
    best = tck.load_pipeline(str(out / "best"))
    assert best["unet"]["conv_in/kernel"].dtype == torch.float32
    assert best["vae"]["decoder/conv_in/kernel"].dtype == torch.bfloat16


def test_train_entry_points_need_cuda_unless_cpu_is_asked(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_task("denoise", data_root=data["pairs"], output_dir=str(tmp_path / "t"),
                     model_config=TC.TINY_SD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_vae(data["clean"], str(tmp_path / "v"), model_config=TC.TINY_SD)
    assert not os.listdir(tmp_path)


def test_multi_device_request_raises(monkeypatch, caplog):
    """The trainer's mesh rule (the JAX trainer's): four cards and batch 4
    train over 4 data ranks; batch 3, or the mesh turned off, on one device,
    each logged; more ranks than cards raises (one rank a card)."""
    from image_restoration_and_enhancement_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    with caplog.at_level("INFO", logger=T.logger.name):
        assert T.data_parallel_ranks(True, 4, cuda) == 4
        assert T.data_parallel_ranks(True, 3, cuda) == 1
        assert "batch 3 does not divide by 4 devices" in caplog.text
        assert T.data_parallel_ranks(False, 4, cuda) == 1
        assert "the mesh is off" in caplog.text
    assert T.data_parallel_ranks(True, 4, torch.device("cpu")) == 1
    assert T.data_parallel_ranks(True, 4, torch.device("cpu"), num_devices=2) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="8 NCCL ranks need 8 cards"):
        launch.launch(print, 8, "nccl")


def test_pretrain_vae_seeds_train_task(data, tmp_path):
    vae_out = tmp_path / "vae"
    rc = pretrain_cli.main(["--data_root", data["clean"], "--output_dir", str(vae_out),
                            "--num_epochs", "2", "--batch_size", "2", "--image_size", str(SIZE),
                            "--base_model", "tiny_sd", "--device", "cpu"])
    assert rc == 0
    rows = _rows(vae_out / "metrics_vae.csv")
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[c])) for r in rows for c in ("psnr", "latent_std",
                                                                  "train_loss"))
    assert set(os.listdir(vae_out / "best")) == {"vae", "model_index.json"}
    vae = tck.load_pipeline(str(vae_out / "best"))["vae"]
    # the fp32 run end to end (the objective and its steps are held against
    # JAX in test_torch_train.py)
    first = pretrain_vae(data["clean"], str(tmp_path / "vae_fp32"),
                         VAEPretrainConfig(num_epochs=1, batch_size=2, image_size=SIZE),
                         model_config=TC.TINY_SD, dtype=torch.float32, device="cpu")
    assert np.isfinite(first["psnr"])

    out = tmp_path / "seeded"
    _train(data, out, cfg=dict(num_epochs=1, save_steps=-1, state_save_epochs=-1),
           vae_init=str(vae_out / "best"))
    best = tck.load_pipeline(str(out / "best"))
    assert set(best["vae"]) == set(vae)
    assert all(torch.equal(best["vae"][k], vae[k].to(best["vae"][k].dtype)) for k in vae)
    log = open(out / "training_denoise.log").read()
    assert "seeded frozen ['vae']" in log
