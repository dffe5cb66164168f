"""PyTorch port schedulers and DDIM img2img against the JAX package, plus the
port's package rules (no JAX imports, GPU by default).

Schedulers: the step plans are copied code and must be exactly equal; the step
functions run in fp32 on both sides and agree to 1e-6 (same formula, the
float32 alpha_bar table indexed the same way). The DDIM img2img cases reuse
the TINY_SD fixture and the check of ``test_torch_serving.py`` (tolerance
stated there).
"""
import ast
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.core import schedulers as tsch
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import schedulers as jsch
from test_torch_serving import check_img2img, one_torch_thread, stacks  # noqa: F401  (fixtures)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("gs", [5.0, 1.0])
def test_img2img_ddim_matches_jax(stacks, gs):  # noqa: F811
    check_img2img(stacks, "ddim", gs)


@pytest.mark.parametrize("steps,strength", [(20, 0.5), (20, 1.0), (30, 0.75), (10, 0.3),
                                            (50, 0.0)])
def test_step_plans_equal_jax(steps, strength):
    cfg_j, cfg_t = JC.SD15_SCHEDULER, TC.SD15_SCHEDULER
    for name in ("ddim_step_plan", "plms_step_plan"):
        a = getattr(jsch, name)(cfg_j, steps, strength)
        b = getattr(tsch, name)(cfg_t, steps, strength)
        for field in ("timesteps", "prev_timesteps", "order_codes", "append"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert (b.init_timestep, b.num_inference_steps) == (a.init_timestep,
                                                             a.num_inference_steps)
    np.testing.assert_array_equal(tsch.make_alphas_cumprod(cfg_t),
                                  jsch.make_alphas_cumprod(cfg_j))
    assert tsch.final_alpha_cumprod(cfg_t) == jsch.final_alpha_cumprod(cfg_j)


def test_step_functions_match_jax():
    cfg = TC.SD15_SCHEDULER
    rng = np.random.default_rng(0)
    ac_j = jnp.asarray(jsch.make_alphas_cumprod(JC.SD15_SCHEDULER), jnp.float32)
    ac_t = tsch.alphas_cumprod_tensor(cfg)
    fa = tsch.final_alpha_cumprod(cfg)
    x0 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    np.testing.assert_allclose(
        tsch.add_noise(ac_t, torch.from_numpy(x0), torch.from_numpy(noise), 501).numpy(),
        np.asarray(jsch.add_noise(ac_j, jnp.asarray(x0), jnp.asarray(noise),
                                  jnp.asarray(501))), atol=1e-6, rtol=1e-6)

    for name in ("ddim", "plms"):
        plan = getattr(tsch, f"{name}_step_plan")(cfg, 20, 0.6)
        lat_j, lat_t = jnp.asarray(x0), torch.from_numpy(x0)
        carry_j, carry_t = jsch.plms_init_carry(lat_j), tsch.plms_init_carry(lat_t)
        for i in range(plan.num_calls):
            eps = rng.standard_normal(x0.shape).astype(np.float32)
            t, prev_t = int(plan.timesteps[i]), int(plan.prev_timesteps[i])
            if name == "ddim":
                lat_j = jsch.ddim_step(ac_j, fa, lat_j, jnp.asarray(eps), t, prev_t)
                lat_t = tsch.ddim_step(ac_t, fa, lat_t, torch.from_numpy(eps), t, prev_t)
            else:
                code, append = int(plan.order_codes[i]), bool(plan.append[i])
                carry_j, lat_j = jsch.plms_step(ac_j, fa, carry_j, lat_j, jnp.asarray(eps), t,
                                                prev_t, code, append)
                carry_t, lat_t = tsch.plms_step(ac_t, fa, carry_t, lat_t, torch.from_numpy(eps),
                                                t, prev_t, code, append)
            np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), atol=1e-5,
                                       rtol=1e-5, err_msg=f"{name} call {i}")


def _port_files():
    files = sorted((REPO / "image_restoration_and_enhancement_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax, flax, optax, the
    JAX package or safetensors (the port has its own reader); at module top they
    import only torch, numpy, the standard library and the port itself, and
    so never PIL, cv2 or gradio, which the card's machine lacks (the port has
    its own resizes and its PNG codec; cv2 is imported only inside the
    classical fallbacks and the JPEG degradation, PIL only to decode image
    files for calibration and other formats than PNG, gradio only by the
    app's interface, scipy only inside FID's matrix square root)."""
    banned = ("jax", "flax", "optax", "image_restoration_and_enhancement_tpu", "safetensors")
    not_at_top = ("PIL", "cv2", "safetensors", "gradio")
    top_ok = {"torch", "numpy", "image_restoration_and_enhancement_torch"}
    top_ok |= set(sys.stdlib_module_names) | {"__future__"}
    files = _port_files()
    assert len(files) > 15
    port = REPO / "image_restoration_and_enhancement_torch"
    for module in ("ops/token_merge.py", "ops/image.py", "metrics/functional.py",
                   "metrics/perceptual.py", "metrics/inception.py", "metrics/calculator.py",
                   "metrics/evaluate.py", "data/png.py", "data/native.py", "data/datasets.py",
                   "data/degradations.py", "data/synthetic.py", "generate_predictions.py",
                   "evaluate_model.py", "train/loop.py", "train/optim.py", "train/trainer.py",
                   "train/vae_pretrain.py", "train_cli.py", "train_denoising.py",
                   "train_super_resolution.py", "train_colorization.py", "train_inpainting.py",
                   "pretrain_vae.py", "data/host_degradations.py", "make_synthetic_pairs.py",
                   "make_demo_data.py", "import_weights.py", "eval_quant_quality.py",
                   "utils/observability.py", "app.py", "make_procedural_clean.py",
                   "demo_restoration_learning.py", "demo_eval_sweep.py",
                   "probe_vae_roundtrip.py", "summarize_workflow.py"):
        assert port / module in files, module
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
        for node in tree.body:
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for root in roots:
                assert root not in not_at_top, f"{path}: module-top import of {root}"
                assert root in top_ok, f"{path}: module-top import of {root}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RestorationPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.SDModules.create(TC.TINY_SD, dtype=torch.float32)
    mods = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu")
    assert mods.device.type == "cpu"
