"""The port's summarize_workflow against the JAX package's script (loaded by
path).

On the committed ``docs/artifacts/realrun_full`` record the JAX script stops
on the evaluation JSON's "_provenance" note (a string among the tasks'
results); the port skips it, and its text equals the JAX script's on a copy
of the record without the note. On the output directory of a run of the
port's trainer (TINY_SD, 64 px, two epochs) the two scripts print the same
text and find its epoch rows (the warm epoch's seconds) and the input-vs-gt
baseline line in its log."""
import importlib.util
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch import summarize_workflow as tsw
from image_restoration_and_enhancement_torch.data.png import save_image
from image_restoration_and_enhancement_torch.train.loop import TrainConfig
from image_restoration_and_enhancement_torch.train.trainer import train_task
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jsw():
    spec = importlib.util.spec_from_file_location(
        "jax_script_summarize_workflow", REPO / "scripts" / "summarize_workflow.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_summary_of_the_committed_record_equals_jax(jsw, tmp_path):
    record = REPO / "docs" / "artifacts" / "realrun_full"
    rest = (str(tmp_path / "models"), str(tmp_path / "evaluation_results.json"))
    with pytest.raises(AttributeError):
        jsw.summarize(str(record), *rest)
    copy = tmp_path / "record"
    shutil.copytree(record, copy, ignore=shutil.ignore_patterns("val_samples_*"))
    with open(record / "evaluation_results.json") as f:
        ev = json.load(f)
    assert isinstance(ev.pop("_provenance"), str)
    with open(copy / "evaluation_results.json", "w") as f:
        json.dump(ev, f)
    text = tsw.summarize(str(record), *rest)
    assert text == jsw.summarize(str(copy), *rest)
    assert "| denoise (run-2 retrain) |" in text and "Test-split evaluation" in text
    assert all(f"| {task} | " in text for task in ev)


def test_summary_of_a_port_training_run(jsw, tmp_path):
    rng = np.random.default_rng(5)
    pairs = tmp_path / "pairs"
    for split, n in (("train", 4), ("val", 2)):
        for kind in ("input", "gt"):
            os.makedirs(pairs / "denoise" / split / kind)
        for i in range(n):
            gt = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            noisy = np.clip(gt + rng.normal(0, 20, gt.shape), 0, 255).astype(np.uint8)
            save_image(str(pairs / "denoise" / split / "gt" / f"p{i}.png"), gt)
            save_image(str(pairs / "denoise" / split / "input" / f"p{i}.png"), noisy)
    models = tmp_path / "models"
    train_task("denoise", data_root=str(pairs), output_dir=str(models / "denoising"),
               cfg=TrainConfig(num_epochs=2, batch_size=2, gradient_accumulation_steps=1,
                               image_size=64, save_steps=-1, state_save_epochs=-1),
               use_mesh=False, dtype=torch.float32, model_config=TC.TINY_SD, device="cpu")
    args = (str(tmp_path / "artifacts"), str(models), str(tmp_path / "evaluation_results.json"))
    text = tsw.summarize(*args)
    assert text == jsw.summarize(*args)
    row = next(line for line in text.splitlines() if line.startswith("| denoise |"))
    cells = [c.strip() for c in row.strip("|").split("|")]
    # task, epochs, PSNR, SSIM, Y-PSNR, input PSNR, final loss, warm epoch (s), ...
    assert cells[1] == "2"
    assert float(cells[5]) > 0 and float(cells[7]) >= 0, cells
    assert "(no artifacts)" in text   # the other three tasks
