"""The port's training step (``train/loop.py``, ``train/optim.py`` and the
scheduler functions it adds) against the JAX package on the CPU, in fp32.

- ``pred_x0_from_eps`` and ``ddpm_step``: the same fp32 formulas on the same
  float32 table, within 1e-6.
- The loss and its gradients: JAX's ``make_loss_fn`` under
  ``jax.value_and_grad`` and the port's ``make_loss_fn`` + ``backward`` on the
  same TINY weights (``fill_params`` values bridged by ``params_from_flax``),
  the same batch, the same context and JAX's own draws (its ``split(key, 4)``
  in the order t, noise, enc1, enc2). The loss, "mse" and "img_l1" agree to
  1e-5 relative; every UNet gradient tensor to 2e-4 of its largest entry
  (fp32 sums in another order through the UNet's forward and backward and a
  differentiated VAE decode: measured differences are a few 1e-6 of the
  largest entry). JAX's TINY attention and GroupNorm take their XLA paths on
  the CPU, as the JAX package's training tests do.
- The optimizer against optax on a small dict with one 128 x 160 tensor (the
  factored Adafactor case): parameters within 1e-6 relative (1e-7 absolute)
  after 6 micro-steps under MultiSteps(2) with clipping active, for AdamW and
  Adafactor, with a NaN micro-step under apply_if_finite and an Inf one under
  zero_grads (NaN where optax gives NaN).
- ``make_train_step`` against JAX's over two optimizer steps (k = 1): the
  parameters to 1e-5 of each tensor's largest entry and grad_norm to 1e-5
  relative.
- The UNet's activation checkpointing: under autograd each block runs again in
  the backward pass, and the gradients equal those of a run without the
  recompute (bitwise, on the CPU).
- The VAE pretrain (``train/vae_pretrain.py``) against the JAX module's own
  ``loss_fn`` and ``step``, on TINY_SD's VAE with the same weights, images and
  JAX's posterior draw: the loss, "recon_mse" and "scaled_msq" to 1e-5
  relative and every VAE gradient to 2e-4 of its largest entry (the
  attention's key bias, whose gradient is zero in exact arithmetic, to 2e-4
  of the largest entry of all VAE gradients), at the
  default weights and at heavy KL and scale weights (where a wrong term would
  show); over two steps the first (learning rate 0) leaves the parameters as
  they were and the second moves them, to 1e-5 of each tensor's largest entry
  of JAX's (the key bias, stepped by Adam on rounding noise, within 3 x the
  learning rate of its start on both sides).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.core import schedulers as tsch
from image_restoration_and_enhancement_torch.models import unet as tunet
from image_restoration_and_enhancement_torch.models.layers import CL
from image_restoration_and_enhancement_torch.models.vae import AutoencoderKL
from image_restoration_and_enhancement_torch.tasks.registry import get_task as t_get_task
from image_restoration_and_enhancement_torch.train import loop as tloop
from image_restoration_and_enhancement_torch.train import optim as toptim
from image_restoration_and_enhancement_torch.train import vae_pretrain as tvp
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.core import schedulers as jsch
from image_restoration_and_enhancement_tpu.tasks.registry import get_task as j_get_task
from image_restoration_and_enhancement_tpu.train import loop as jloop
from image_restoration_and_enhancement_tpu.train import vae_pretrain as jvp
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4    # of each gradient tensor's largest |entry|
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
STEP_TOL = 1e-5    # of each parameter tensor's largest |entry|; grad_norm relative
SIZE = 64


def _stack(jcfg, tcfg, seed):
    jm = js.SDModules.create(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=SIZE),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, fill_params(shapes, seed=seed))
    tm = ts.SDModules.create(tcfg, dtype=torch.float32, device="cpu")
    for comp, mod in tm.components().items():
        mod.load_state_dict(tck.params_from_flax(jck.flatten_params(params[comp])), strict=True)
    tm.freeze_all_but_unet()
    return jm, params, tm


@pytest.fixture(scope="module")
def stacks():
    """TINY_SD, TINY_SD_INPAINT and TINY_SDXL, each on both sides with the
    same weights, built once for the file."""
    return {"sd": _stack(JC.TINY_SD, TC.TINY_SD, 21),
            "inpaint": _stack(JC.TINY_SD_INPAINT, TC.TINY_SD_INPAINT, 22),
            "sdxl": _stack(JC.TINY_SDXL, TC.TINY_SDXL, 23)}


def _batch(task, seed, b=2):
    rng = np.random.default_rng(seed)
    out = {"input": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
           "gt": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)}
    if task == "inpaint":
        mask = np.zeros((b, SIZE, SIZE, 1), np.float32)
        mask[:, 13:41, 7:50] = 1.0
        out["mask"] = mask
    return out


def _context(jm, params, sdxl, seed):
    ids = jnp.asarray(np.random.default_rng(seed).integers(3, 128, (1, 77)).astype(np.int32))
    if sdxl:
        return jax.jit(lambda p, i: js.encode_text_sdxl(jm, p, i))(params, ids)
    return jax.jit(lambda p, i: js.encode_text(jm, p, i))(params, ids)


def _torch_context(ctx):
    if isinstance(ctx, tuple):
        return tuple(torch.from_numpy(np.asarray(c)) for c in ctx)
    return torch.from_numpy(np.asarray(ctx))


def jax_draws(jm, key, b):
    """The draws JAX's loss makes from ``key``, as the port's draws dict."""
    k_t, k_noise, k_enc1, k_enc2 = jax.random.split(key, 4)
    f = 2 ** (len(jm.config.vae.block_out_channels) - 1)
    shape = (b, SIZE // f, SIZE // f, jm.config.vae.latent_channels)
    t = jax.random.randint(k_t, (b,), 0, jm.config.scheduler.num_train_timesteps)
    return {"t": torch.from_numpy(np.asarray(t)).long(),
            **{name: torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
               for name, k in (("noise", k_noise), ("enc1", k_enc1), ("enc2", k_enc2))}}


def _port_grads(flat_grads):
    return tck.params_from_flax({k: np.asarray(v) for k, v in flat_grads.items()})


def _assert_rel_max(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def test_pred_x0_and_ddpm_step_match_jax():
    cfg = TC.SD15_SCHEDULER
    ac_j = jnp.asarray(jsch.make_alphas_cumprod(JC.SD15_SCHEDULER), jnp.float32)
    ac_t = tsch.alphas_cumprod_tensor(cfg)
    rng = np.random.default_rng(3)
    x, eps, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    t = np.array([0, 17, 999], np.int32)
    np.testing.assert_allclose(
        tsch.pred_x0_from_eps(ac_t, torch.from_numpy(x), torch.from_numpy(eps),
                              torch.from_numpy(t)).numpy(),
        np.asarray(jsch.pred_x0_from_eps(ac_j, jnp.asarray(x), jnp.asarray(eps),
                                         jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    for tt in (t, np.int32(0), np.int32(500)):
        got = tsch.ddpm_step(ac_t, torch.from_numpy(x), torch.from_numpy(eps),
                             torch.as_tensor(tt), torch.from_numpy(noise))
        ref = jsch.ddpm_step(ac_j, jnp.asarray(x), jnp.asarray(eps),
                             jnp.asarray(tt)[..., None, None, None] if np.ndim(tt) else
                             jnp.asarray(tt), jnp.asarray(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=f"t={tt}")


LOSS_CASES = {
    "denoise": ("sd", "denoise", dict(lambda_img=0.05)),
    "inpaint": ("inpaint", "inpaint", dict(lambda_img=0.05)),
    "sdxl": ("sdxl", "denoise", dict(lambda_img=0.05)),
    "stop_image_grad": ("sd", "denoise", dict(lambda_img=0.05, stop_image_grad=True)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(stacks, case):
    stack, task, kw = LOSS_CASES[case]
    jm, params, tm = stacks[stack]
    model = {"sd": (JC.TINY_SD, TC.TINY_SD), "inpaint": (JC.TINY_SD_INPAINT, TC.TINY_SD_INPAINT),
             "sdxl": (JC.TINY_SDXL, TC.TINY_SDXL)}[stack]
    jspec = dataclasses.replace(j_get_task(task), model_config=model[0])
    tspec = dataclasses.replace(t_get_task(task), model_config=model[1])
    jcfg, tcfg = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    batch = _batch(task, 5)
    ctx = _context(jm, params, stack == "sdxl", 6)
    key = jax.random.PRNGKey(41)

    jloss = jloop.make_loss_fn(jm, jspec, jcfg)
    (ref_loss, ref_metrics), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
            params["unet"], {"vae": params["vae"]}, jax.tree_util.tree_map(jnp.asarray, batch),
            ctx, key)

    tm.unet.zero_grad(set_to_none=True)
    loss, metrics = tloop.make_loss_fn(tm, tspec, tcfg)(
        batch, _torch_context(ctx), jax_draws(jm, key, 2))
    loss.backward()
    for name in ("loss", "mse", "img_l1"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(ref_metrics[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    ref = _port_grads(jck.flatten_params(ref_grads))
    got = {n: p.grad for n, p in tm.unet.named_parameters()}
    assert set(got) == set(ref)
    for n in sorted(ref):
        _assert_rel_max(got[n].numpy(), ref[n].numpy(), GRAD_TOL, f"{case} grad {n}")
    tm.unet.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# optimizer against optax
# ---------------------------------------------------------------------------


def _opt_params(seed):
    rng = np.random.default_rng(seed)
    return {"big": rng.standard_normal((128, 160)).astype(np.float32) * 0.05,
            "conv": rng.standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.2,
            "bias": rng.standard_normal((16,)).astype(np.float32) * 0.01}


def _grads(params, rng, scale):
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in params.items()}


OPT_CASES = {
    "adamw": ("adamw", "apply_if_finite", None),
    "adafactor": ("adafactor", "apply_if_finite", None),
    "adamw_nan_skipped": ("adamw", "apply_if_finite", (3, np.nan)),
    "adafactor_nan_skipped": ("adafactor", "apply_if_finite", (2, np.nan)),
    "adamw_zero_grads_inf": ("adamw", "zero_grads", (2, np.inf)),
    "adamw_zero_grads_nan": ("adamw", "zero_grads", (3, np.nan)),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    kind, guard, bad = OPT_CASES[case]
    kw = dict(num_epochs=1, gradient_accumulation_steps=2, learning_rate=3e-2,
              optimizer=kind, nan_guard=guard, max_grad_norm=1.0)
    n_steps = 8
    tx = jloop.make_optimizer(jloop.TrainConfig(**kw), n_steps)
    ours = tloop.make_optimizer(tloop.TrainConfig(**kw), n_steps)
    p_np = _opt_params(0)
    p_j = jax.tree_util.tree_map(jnp.asarray, p_np)
    state_j = tx.init(p_j)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    state_t = ours.init(p_t)
    rng = np.random.default_rng(1)
    update = jax.jit(tx.update)
    clipped = 0
    for i in range(6):
        g = _grads(p_np, rng, 0.5 if i % 2 else 0.02)   # large ones are clipped
        clipped += float(optax.global_norm(g)) > 1.0
        if bad is not None and i == bad[0]:
            g["conv"][1, 2, 0, 1] = bad[1]
        upd, state_j = update(jax.tree_util.tree_map(jnp.asarray, g), state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        ours.update({k: torch.from_numpy(v) for k, v in g.items()}, state_t, p_t)
        for k in p_np:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=f"{case} step {i} {k}")
    assert clipped >= 2
    moved = max(float(np.abs(p_t[k].numpy() - p_np[k]).max()) for k in p_np)
    assert moved > 1e-4
    if guard == "apply_if_finite":
        assert state_t["guard"]["total_notfinite"] == int(state_j.total_notfinite)
        inner_j = state_j.inner_state
        assert state_t["multi"]["gradient_step"] == int(inner_j.gradient_step)
        assert state_t["multi"]["mini_step"] == int(inner_j.mini_step)


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 5e-6, 3, 40, 0.0)
    ours = toptim.warmup_cosine_decay(5e-6, 3, 40)
    assert ours(0) == 0.0
    for c in (0, 1, 2, 3, 4, 17, 39, 40, 45):
        np.testing.assert_allclose(ours(c), float(sched(c)), rtol=1e-6, atol=1e-13)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_train_step_matches_jax(stacks):
    jm, params, tm = stacks["sd"]
    kw = dict(gradient_accumulation_steps=1, lambda_img=0.0, learning_rate=1e-3)
    jcfg, tcfg = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    jspec = dataclasses.replace(j_get_task("denoise"), model_config=JC.TINY_SD)
    tspec = dataclasses.replace(t_get_task("denoise"), model_config=TC.TINY_SD)
    ctx = _context(jm, params, False, 7)
    jstate = jloop.create_train_state(jcfg, params["unet"], 4)
    jstep = jloop.make_train_step(jm, jspec, jcfg, donate=False)

    saved = {n: p.detach().clone() for n, p in tm.unet.named_parameters()}
    try:
        tstate = tloop.create_train_state(tcfg, tm.unet, 4)
        tstep = tloop.make_train_step(tm, tspec, tcfg)
        for i in range(2):
            batch = _batch("denoise", 30 + i)
            key = jax.random.PRNGKey(100 + i)
            jstate, jm_metrics = jstep(jstate, {"vae": params["vae"]},
                                       jax.tree_util.tree_map(jnp.asarray, batch), ctx, key)
            tm_metrics = tstep(tstate, batch, _torch_context(ctx), jax_draws(jm, key, 2))
            for name in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(tm_metrics[name]), float(jm_metrics[name]),
                                           rtol=STEP_TOL, err_msg=f"step {i} {name}")
        assert tstate.step == int(jstate.step) == 2
        ref = tck.params_from_flax(jck.flatten_params(jstate.params))
        moved = 0.0
        for n, p in tstate.params.items():
            _assert_rel_max(p.numpy(), ref[n].numpy(), STEP_TOL, f"param {n}")
            moved = max(moved, float((p - saved[n]).abs().max()))
        assert moved > 1e-5  # the second step (lr > 0) moved the weights
    finally:
        with torch.no_grad():
            for n, p in tm.unet.named_parameters():
                p.copy_(saved[n])


# ---------------------------------------------------------------------------
# the UNet's activation checkpointing
# ---------------------------------------------------------------------------


def test_unet_checkpoints_blocks_under_autograd(stacks, monkeypatch):
    """The trainer's path: each block runs once forward and once more in the
    backward recompute (none under no_grad), with the gradients of a run
    that keeps every activation."""
    jm, params, tm = stacks["sd"]
    spec = dataclasses.replace(t_get_task("denoise"), model_config=TC.TINY_SD)
    loss_fn = tloop.make_loss_fn(tm, spec, tloop.TrainConfig(lambda_img=0.05))
    ctx = _torch_context(_context(jm, params, False, 8))
    draws = jax_draws(jm, jax.random.PRNGKey(43), 2)
    batch = _batch("denoise", 9)
    blocks = [*tm.unet.down_blocks, tm.unet.mid_block, *tm.unet.up_blocks]
    calls = [0] * len(blocks)
    hooks = [b.register_forward_pre_hook(lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
             for i, b in enumerate(blocks)]

    def grads():
        tm.unet.zero_grad(set_to_none=True)
        loss_fn(batch, ctx, draws)[0].backward()
        out = {n: p.grad.clone() for n, p in tm.unet.named_parameters()}
        tm.unet.zero_grad(set_to_none=True)
        return out

    try:
        with torch.no_grad():
            loss_fn(batch, ctx, draws)
        assert calls == [1] * len(blocks)
        calls[:] = [0] * len(blocks)
        recomputed = grads()
        assert calls == [2] * len(blocks)
        monkeypatch.setattr(tunet, "checkpoint", lambda block, *a, **kw: block(*a))
        calls[:] = [0] * len(blocks)
        kept = grads()
        assert calls == [1] * len(blocks)
    finally:
        for h in hooks:
            h.remove()
    assert set(recomputed) == set(kept)
    for n in kept:
        assert torch.equal(recomputed[n], kept[n]), n


# ---------------------------------------------------------------------------
# the VAE pretrain against the JAX module
# ---------------------------------------------------------------------------


def _vae_pair(stacks):
    """JAX's TINY_SD VAE module and a copy of its params; the port's
    AutoencoderKL (fp32, trainable) with the same weights."""
    jm, params, _ = stacks["sd"]
    vae = AutoencoderKL(TC.TINY_SD.vae).to(memory_format=CL)
    vae.load_state_dict(tck.params_from_flax(jck.flatten_params(params["vae"])), strict=True)
    return jm.vae, jax.tree_util.tree_map(jnp.array, params["vae"]), vae


def _vae_images(seed, b=2):
    return {"image": np.random.default_rng(seed).uniform(-1, 1, (b, SIZE, SIZE, 3))
            .astype(np.float32)}


def _vae_noise(key, b=2):
    """JAX's posterior draw from ``key`` (its ``DiagonalGaussian.sample``)."""
    vc = TC.TINY_SD.vae
    f = 2 ** (len(vc.block_out_channels) - 1)
    return np.asarray(jax.random.normal(key, (b, SIZE // f, SIZE // f, vc.latent_channels),
                                        jnp.float32))


VAE_CASES = {"defaults": {}, "heavy_kl_and_scale": dict(kl_weight=0.5, scale_weight=2.0)}


@pytest.mark.parametrize("case", list(VAE_CASES))
def test_vae_loss_and_grads_match_jax(stacks, case):
    jvae, jparams, vae = _vae_pair(stacks)
    sf = TC.TINY_SD.vae.scaling_factor
    kw = VAE_CASES[case]
    _, jstep = jvp.make_vae_train_step(jvae, sf, jvp.VAEPretrainConfig(**kw), 4)
    jloss = inspect.getclosurevars(jstep.__wrapped__).nonlocals["loss_fn"]
    batch, key = _vae_images(11), jax.random.PRNGKey(44)
    (_, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), key)

    loss, metrics = tvp.make_vae_loss_fn(vae, sf, tvp.VAEPretrainConfig(**kw))(
        batch, torch.from_numpy(_vae_noise(key)))
    loss.backward()
    for name in ("loss", "recon_mse", "scaled_msq"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(ref_metrics[name]),
                                   rtol=LOSS_RTOL, err_msg=f"{case} {name}")
    ref = _port_grads(jck.flatten_params(ref_grads))
    got = {n: p.grad for n, p in vae.named_parameters()}
    assert set(got) == set(ref)
    largest = max(float(g.abs().max()) for g in ref.values())
    for n in sorted(ref):
        if n.endswith("to_k.bias"):
            # zero in exact arithmetic (softmax ignores a shift shared by all
            # keys): both sides hold rounding noise, held to the largest
            # gradient entry of the VAE
            for side in (got[n], ref[n]):
                assert float(side.abs().max()) <= GRAD_TOL * largest, f"{case} grad {n}"
            continue
        _assert_rel_max(got[n].numpy(), ref[n].numpy(), GRAD_TOL, f"{case} grad {n}")


def test_vae_train_step_matches_jax(stacks):
    jvae, jparams, vae = _vae_pair(stacks)
    sf = TC.TINY_SD.vae.scaling_factor
    kw = dict(learning_rate=1e-3, kl_weight=0.5, scale_weight=2.0, weight_decay=0.01)
    jtx, jstep = jvp.make_vae_train_step(jvae, sf, jvp.VAEPretrainConfig(**kw), 4)
    jopt = jtx.init(jparams)
    tx, step = tvp.make_vae_train_step(vae, sf, tvp.VAEPretrainConfig(**kw), 4)
    state = tloop.TrainState.create(vae, tx)
    initial = {n: p.clone() for n, p in state.params.items()}
    for i in range(2):
        batch, key = _vae_images(50 + i), jax.random.PRNGKey(200 + i)
        jparams, jopt, ref_metrics = jstep(jparams, jopt,
                                           jax.tree_util.tree_map(jnp.asarray, batch), key)
        metrics = step(state, batch, torch.from_numpy(_vae_noise(key)))
        for name in ("loss", "recon_mse", "scaled_msq"):
            np.testing.assert_allclose(float(metrics[name]), float(ref_metrics[name]),
                                       rtol=LOSS_RTOL, err_msg=f"step {i} {name}")
        if i == 0:  # learning rate 0 at the schedule's first count
            assert all(torch.equal(p, initial[n]) for n, p in state.params.items())
    assert state.step == 2
    ref = tck.params_from_flax(jck.flatten_params(jparams))
    moved = 0.0
    for n, p in state.params.items():
        if n.endswith("to_k.bias"):
            # its gradient is rounding noise (see above), which Adam scales to
            # steps of about the learning rate on either side
            for side in (p, ref[n]):
                assert float((side - initial[n]).abs().max()) <= 3 * kw["learning_rate"], n
            continue
        _assert_rel_max(p.numpy(), ref[n].numpy(), STEP_TOL, f"param {n}")
        moved = max(moved, float((p - initial[n]).abs().max()))
    assert moved > 1e-4  # the second step moved the weights
