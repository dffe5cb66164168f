"""The port's ``super_resolve``, ``colorize``, ``inpaint`` and ``process``
against the JAX package's pipeline, on CPU pipelines loaded from JAX-saved
TINY_SD and TINY_SD_INPAINT pipeline directories.

Each pipeline's ``_sampler_fn`` is wrapped to capture what it feeds its
sampling function: the kind, steps, strength, guidance scale and sampler
(exactly), the image (within one uint8 level, 1/127.5: cv2's LANCZOS4 and
its numpy counterpart may differ by one, see ``test_torch_imaging.py``) and
the inpaint mask (exactly). The JAX sampling function is replaced by the
identity (its parity is ``test_torch_serving.py``'s and
``test_torch_inpaint.py``'s); the port's runs for real, except in the
``process`` case, where both sides take the identity so that each task
feeds the next the same image.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models import layers as tlayers
from image_restoration_and_enhancement_torch.ops._build import KernelError
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.infer.pipeline import (
    RestorationPipeline as JaxPipeline,
)
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

IMAGE_TOL = 1.0 / 127.5 + 1e-6


@pytest.fixture(scope="module")
def task_config(tmp_path_factory):
    """Per-task pipeline config: TINY_SD for denoise, sr_x4 and colorize,
    TINY_SD_INPAINT for inpaint, each a directory the JAX package saved."""
    root = tmp_path_factory.mktemp("tasks")
    dirs = {}
    for name, cfg, seed in (("sd", JC.TINY_SD, 61), ("inpaint", JC.TINY_SD_INPAINT, 62)):
        jm = js.SDModules.create(cfg, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                                jax.random.PRNGKey(0))
        dirs[name] = str(root / name)
        jck.save_pipeline(dirs[name], fill_params(shapes, seed), cfg)
    return {task: {"fine_tuned_dir": dirs["inpaint" if task == "inpaint" else "sd"],
                   "default_backend": "diffusion"}
            for task in ("denoise", "sr_x4", "colorize", "inpaint")}


def _capture(pipe, feeds, jax_side, run_real):
    """Wrap ``pipe._sampler_fn``: each call of the sampling function appends
    {kind, steps, strength, gs, sampler, image[, mask]} to ``feeds``."""
    orig = pipe._sampler_fn

    def sampler_fn(stack, kind, steps, strength, gs, sampler):
        real = orig(stack, kind, steps, strength, gs, sampler) if run_real else None

        def fn(*args, **kwargs):
            tensors = args[1:] if jax_side else args
            feed = {"kind": kind, "steps": steps, "strength": strength, "gs": gs,
                    "sampler": sampler, "image": np.asarray(tensors[0])}
            if kind == "inpaint":
                feed["mask"] = np.asarray(tensors[1])
            feeds.append(feed)
            return real(*args, **kwargs) if real is not None else tensors[0]
        return fn

    pipe._sampler_fn = sampler_fn


def _pipelines(task_config, run_real):
    port = RestorationPipeline(config=task_config, dtype=torch.float32, device="cpu")
    ref = JaxPipeline(config=task_config, dtype=jnp.float32)
    feeds = {"port": [], "jax": []}
    _capture(port, feeds["port"], jax_side=False, run_real=run_real)
    _capture(ref, feeds["jax"], jax_side=True, run_real=False)
    return port, ref, feeds


def _same_feeds(feeds):
    got, want = feeds["port"], feeds["jax"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("kind", "steps", "strength", "gs", "sampler")} == \
               {k: w[k] for k in ("kind", "steps", "strength", "gs", "sampler")}
        assert g["image"].shape == w["image"].shape
        np.testing.assert_allclose(g["image"], w["image"], atol=IMAGE_TOL, rtol=0)
        assert ("mask" in g) == ("mask" in w)
        if "mask" in g:
            np.testing.assert_array_equal(g["mask"], w["mask"])
            assert 0.0 < g["mask"].mean() < 1.0  # a hole, and something around it


def _grey_with_damage(h, w, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(70, 190, (h, w), dtype=np.uint8)
    g[h // 4: h // 4 + 5, w // 8: 3 * w // 4] = 8            # a dark scratch
    g[h // 2: h // 2 + 7, w // 2: w // 2 + 9] = 245          # a bright blotch
    return np.stack([g] * 3, -1)


def test_tasks_feed_their_sampling_function_like_jax(task_config):
    port, ref, feeds = _pipelines(task_config, run_real=True)
    rng = np.random.default_rng(63)
    small = rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)   # x4 -> 80x112, bucket 64x128
    grey = _grey_with_damage(64, 64, 64)
    colour = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((48, 48, 3), np.uint8)                     # HWC, another size, <10% white
    mask[10:14, 8:20] = 255
    calls = [("super_resolve", (small,), {}, (80, 112, 3)),
             ("colorize", (grey,), {}, (64, 64, 3)),
             ("inpaint", (colour,), {"mask": mask}, (64, 64, 3)),
             ("inpaint", (grey,), {}, (64, 64, 3))]            # the auto mask
    for method, args, kwargs, shape in calls:
        out = getattr(port, method)(*args, **kwargs)
        getattr(ref, method)(*args, **kwargs)
        assert out.dtype == np.uint8 and out.shape == shape, method
    _same_feeds(feeds)
    kinds = [(f["kind"], f["steps"], f["strength"], f["gs"], f["sampler"]) for f in feeds["port"]]
    assert kinds == [("img2img", 20, 0.8, 0.0, "plms"), ("img2img", 30, 0.75, 7.5, "plms"),
                     ("inpaint", 30, 0.6, 5.0, "ddim"), ("inpaint", 30, 0.6, 5.0, "ddim")]

    # a colour image is not colorized; an undamaged image is not inpainted
    np.testing.assert_array_equal(port.colorize(colour), colour)
    clean = np.full((64, 64, 3), 128, np.uint8)
    np.testing.assert_array_equal(port.inpaint(clean), clean)
    assert len(feeds["port"]) == 4


def test_process_matches_jax(task_config):
    port, ref, feeds = _pipelines(task_config, run_real=False)
    image = _grey_with_damage(32, 32, 65)
    tasks = ["denoise", "sr", "colorize", "inpaint"]
    got = port.process(image, tasks)
    want = {k: np.asarray(v) for k, v in ref.process(image, tasks).items()}
    assert set(got) == set(want) == {"original", "denoised", "super_resolved", "colorized",
                                     "inpainted", "final"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
    _same_feeds(feeds)
    assert [f["kind"] for f in feeds["port"]] == ["img2img", "img2img", "img2img", "inpaint"]
    assert got["final"].shape == (128, 128, 3)


@pytest.mark.parametrize("task", ["sr", "colorize", "inpaint"])
def test_kernel_failure_propagates_from_every_task(task_config, monkeypatch, caplog, task):
    """A kernel that fails to launch raises out of each task and out of
    ``process``: never served by the task's next backend, even on the CPU."""
    port = RestorationPipeline(config=task_config, dtype=torch.float32, device="cpu")

    def failing_attention(q, k, v, *args):
        raise KernelError("attention kernel launch failed: cudaError 1 (invalid argument)")

    monkeypatch.setattr(tlayers, "attention", failing_attention)
    image = _grey_with_damage(64, 64, 66)
    method = {"sr": port.super_resolve, "colorize": port.colorize, "inpaint": port.inpaint}
    with caplog.at_level(logging.INFO):
        for call in (lambda: method[task](image), lambda: port.process(image, [task])):
            with pytest.raises(KernelError, match="launch failed"):
                call()
    assert not [r for r in caplog.records if "fallback" in r.getMessage()
                or "failed" in r.getMessage() or "Error processing" in r.getMessage()]
