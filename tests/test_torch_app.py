"""The port's app and observability modules (CPU).

- ``tests/test_app.py``'s two tests on the port's ``app``: ``process_image``
  keeps the gallery contract without gradio and without checkpoints (the
  classical fallbacks on a CPU pipeline), and the pretrained mode's pipeline
  is cached while the mode is unchanged.
- ``StepTimer`` against the JAX package's on the same patched clock: equal
  step times and throughputs.
- ``trace`` writes a trace that TensorBoard's profiler plugin reads, with the
  ``annotate`` region in it; ``debug_nans`` raises ``FloatingPointError`` at
  the first NaN while on and is silent when off.
"""
import glob
import json
import time

import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_and_enhancement_torch import app
from image_restoration_and_enhancement_torch.infer import pipeline as pl
from image_restoration_and_enhancement_torch.utils import observability as obs
from image_restoration_and_enhancement_tpu.utils import observability as jobs
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)


def test_process_image_gallery_contract(tmp_path, monkeypatch):
    # no checkpoints anywhere -> classical fallbacks
    monkeypatch.setattr(app, "_pipeline", None)
    monkeypatch.setattr(pl, "DEFAULT_MODEL_ROOT", str(tmp_path / "none"), raising=False)
    monkeypatch.setenv("IRET_PRETRAINED_ROOT", str(tmp_path / "none"))
    rng = np.random.RandomState(0)
    img = Image.fromarray(rng.randint(0, 255, (96, 96, 3), np.uint8))

    gallery, final = app.process_image(img, ["denoise", "colorize"], mode="pretrained",
                                       device="cpu")
    captions = [c for _, c in gallery]
    assert captions[0] == "original" and captions[-1] == "final"
    assert "denoised" in captions
    assert final is not None and np.asarray(final).shape[2] == 3

    # None image contract
    gallery, final = app.process_image(None, ["denoise"])
    assert gallery == [] and final is None


def test_pretrained_mode_reinitializes(monkeypatch):
    monkeypatch.setattr(app, "_pipeline", None)
    p1 = app.initialize_pipeline("pretrained", device="cpu")
    p2 = app.initialize_pipeline("pretrained", device="cpu")
    assert p1 is p2  # cached while the mode is unchanged
    p3 = app.initialize_pipeline("fine_tuned", device="cpu")
    assert p3 is not p2
    assert app.TASK_LABELS == [("Denoise", "denoise"), ("Super-resolution x4", "sr_x4"),
                               ("Colorize", "colorize"), ("Inpaint", "inpaint")]


def test_pipeline_is_rebuilt_for_another_device(monkeypatch):
    monkeypatch.setattr(app, "_pipeline", None)
    p1 = app.initialize_pipeline("pretrained", device="cpu")
    monkeypatch.setattr(p1, "device", torch.device("cuda"))   # as if built on the card
    p2 = app.initialize_pipeline("pretrained", device="cpu")
    assert p2 is not p1 and p2.device == torch.device("cpu")
    assert app.initialize_pipeline("pretrained", device="cpu") is p2


def test_app_serves_on_cuda_unless_cpu_is_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    monkeypatch.setattr(app, "_pipeline", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.initialize_pipeline("pretrained")


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.5, 0.75, 1.5, 1.6, 2.6, 2.65])
    now = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    ours, theirs = obs.StepTimer(ema=0.8), jobs.StepTimer(ema=0.8)
    assert ours.throughput(4) is None and theirs.throughput(4) is None
    for t in clock:
        now["t"] = t
        assert ours.tick() == theirs.tick()
        assert ours.throughput(8) == theirs.throughput(8)
    assert ours.steps == theirs.steps == 7 and ours.step_time > 0


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with obs.trace(str(tmp_path)):
        with obs.annotate("port_region"):
            torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)


def test_debug_nans_raises_while_on():
    x = torch.tensor([0.0, 1.0])
    try:
        obs.debug_nans(True)
        assert torch.equal(x + 1, torch.tensor([1.0, 2.0]))
        with pytest.raises(FloatingPointError, match="NaN"):
            x / x
    finally:
        obs.debug_nans(False)
    assert torch.isnan(x / x)[0]   # silent when off
    obs.debug_nans(False)          # off twice is fine
    if not torch.cuda.is_available():
        assert obs.device_memory_stats() == {"cpu": {}}
