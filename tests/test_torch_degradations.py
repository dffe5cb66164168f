"""The port's degradations (``data/degradations.py``) and synthetic batches
(``data/synthetic.py``) against the JAX package's, given JAX's draws.

The JAX functions draw from keys; the port's take the draws explicitly. Each
test makes JAX's draws with JAX's own key splits (``jax_*_draws`` below
mirror ``degradations.py``'s ``jax.random`` calls) and feeds them to the
port. Limits:
- noise and the LAB-L input: equal within 1e-6 (the same fp32 operations);
- blur, motion blur, the SR input (blur, then ``jax.image.resize``): 1e-5 of
  the largest value (fp32 sums in another order);
- JPEG: within 1e-5 except in 8x8 blocks where a DCT coefficient lies within
  1e-4 of a quantization step of a rounding midpoint (the two sides' fp32
  DCTs may then round it to neighbouring steps); such blocks are few;
- masks: equal except at pixels whose squared distance to an active segment
  is within 1e-2 of (thickness / 2)^2 (fp32 rounding of d2 near 512^2 is
  ~1e-3), and such pixels are few.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.data import degradations as T
from image_restoration_and_enhancement_torch.data import synthetic as TS
from image_restoration_and_enhancement_tpu.data import degradations as J
from image_restoration_and_enhancement_tpu.data import synthetic as JS
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

H, W = 36, 44


@pytest.fixture(scope="module")
def clean():
    rng = np.random.default_rng(81)
    base = np.cumsum(rng.uniform(-0.08, 0.08, (3, H, W, 3)), axis=2)
    base = (base - base.min()) / np.ptp(base)
    return (0.8 * base + 0.2 * rng.uniform(0, 1, base.shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


# --- JAX's draws, with JAX's key splits -------------------------------------------


def jax_noise_draws(key, shape, sigma_range):
    k_sigma, k_noise = jax.random.split(key)
    sigma = jax.random.uniform(k_sigma, (), minval=sigma_range[0] / 255.0,
                               maxval=sigma_range[1] / 255.0)
    return {"sigma": float(sigma), "noise": np.asarray(jax.random.normal(k_noise, shape))}


def jax_motion_draws(key, kernel_size_range):
    k_size, k_angle = jax.random.split(key)
    length = jax.random.uniform(k_size, (), minval=float(kernel_size_range[0]),
                                maxval=float(kernel_size_range[1]))
    angle = jnp.deg2rad(jax.random.uniform(k_angle, (), minval=0.0, maxval=360.0))
    return {"length": float(length), "angle": float(angle)}


def jax_stroke_draws(key, hw, num_strokes, thickness_range, max_points=8):
    h, w = hw
    keys = jax.random.split(key, 3)
    out = {"n_strokes": int(jax.random.randint(keys[0], (), num_strokes[0], num_strokes[1] + 1)),
           "pts_x": [], "pts_y": [], "n_pts": [], "thick": []}
    for k in jax.random.split(keys[1], num_strokes[1]):
        kp, kn, kt = jax.random.split(k, 3)
        out["pts_x"].append(np.asarray(jax.random.uniform(kp, (max_points,), minval=0.0,
                                                          maxval=w - 1.0)))
        out["pts_y"].append(np.asarray(jax.random.uniform(jax.random.fold_in(kp, 1),
                                                          (max_points,), minval=0.0,
                                                          maxval=h - 1.0)))
        out["n_pts"].append(int(jax.random.randint(kn, (), 4, max_points + 1)))
        out["thick"].append(int(jax.random.randint(kt, (), thickness_range[0],
                                                   thickness_range[1] + 1)))
    return out


def jax_inpaint_draws(key, hw):
    k_mix, k_easy, k_hard = jax.random.split(key, 3)
    return {"u_mix": float(jax.random.uniform(k_mix)),
            "easy": jax_stroke_draws(k_easy, hw, (3, 7), (5, 20)),
            "hard": jax_stroke_draws(k_hard, hw, (8, 15), (20, 40))}


def stack(draws):
    """A list of per-image draws (dicts, nested once) -> batched tensors."""
    out = {}
    for k, v in draws[0].items():
        out[k] = stack([d[k] for d in draws]) if isinstance(v, dict) else \
            torch.as_tensor(np.array([d[k] for d in draws]))
    return out


def assert_masks_agree(got, want, near):
    diff = got[..., 0].numpy() != np.asarray(want)[..., 0]
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    assert near.mean() < 0.02
    assert 0.0 < np.asarray(want).mean() < 1.0


# --- the deterministic functions ---------------------------------------------------


def test_gaussian_noise_matches_jax(clean):
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    draws = stack([jax_noise_draws(k, clean.shape[1:], (5.0, 8.0)) for k in keys])
    want = np.stack([J.gaussian_noise(k, jnp.asarray(c)) for k, c in zip(keys, clean)])
    close(T.gaussian_noise(t(clean), draws["sigma"], draws["noise"]), want, rel=1e-6)


@pytest.mark.parametrize("shape", [(H, W), (32, 40)])
def test_jpeg_matches_jax_outside_midpoint_blocks(clean, shape):
    img = clean[:, : shape[0], : shape[1]]
    quality = np.array([31, 55, 90])
    want = np.stack([J.jpeg_quantize(jnp.asarray(c), jnp.asarray(q))
                     for c, q in zip(img, quality)])
    got = T.jpeg_quantize(t(img), t(quality)).numpy()
    mid_px = T.near_jpeg_midpoint(t(img), t(quality))
    bad = (np.abs(got - want) > 1e-5).any(axis=-1)
    assert not (bad & ~mid_px).any(), int((bad & ~mid_px).sum())
    assert mid_px.mean() < 0.1
    assert np.abs(want - img).max() > 1e-3    # lossy


def test_motion_blur_matches_jax(clean):
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    draws = stack([jax_motion_draws(k, (5, 15)) for k in keys])
    want = np.stack([J.motion_blur_random(k, jnp.asarray(c)) for k, c in zip(keys, clean)])
    close(T.motion_blur(t(clean), draws["length"], draws["angle"]), want)
    close(T.line_kernels(draws["length"], draws["angle"], 15)[1],
          J._line_kernel(jnp.float32(draws["length"][1]), jnp.float32(draws["angle"][1]), 15))


def test_sr_and_colorize_match_jax(clean):
    keys = jax.random.split(jax.random.PRNGKey(0), 3)   # kernel sizes 7, 5, 3
    ksize = [int(jax.random.choice(jax.random.split(k)[1], jnp.asarray([3, 5, 7])))
             for k in keys]
    assert len(set(ksize)) > 1
    want = np.stack([J.degrade_sr(k, jnp.asarray(c)) for k, c in zip(keys, clean)])
    close(T.degrade_sr(t(clean), torch.tensor(ksize)), want)
    close(T.degrade_colorize(t(clean)), J.degrade_colorize(jnp.asarray(clean)), rel=1e-6)


def test_denoise_with_artifacts_matches_jax(clean):
    """The artifact mode's noise and motion blur (JAX's key splits; JPEG's
    rounding is the test above's), at keys whose draws skip the JPEG."""
    cases = []
    for seed in range(40):
        k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
        if float(jax.random.uniform(k2)) >= 0.3:
            cases.append((seed, k1, k4, k5))
        if len(cases) == 3 and any(float(jax.random.uniform(c[2])) < 0.2 for c in cases):
            break
    draws, want = [], []
    for i, (seed, k1, k4, k5) in enumerate(cases):
        d = {**jax_noise_draws(k1, clean.shape[1:], (3.0, 15.0)),
             "use_jpeg": False, "quality": 50,
             "use_blur": float(jax.random.uniform(k4)) < 0.2, **jax_motion_draws(k5, (3, 8))}
        draws.append(d)
        want.append(J.degrade_denoise(jax.random.PRNGKey(seed), jnp.asarray(clean[i]),
                                      with_artifacts=True))
    assert any(d["use_blur"] for d in draws)
    close(T.degrade_denoise(t(clean), stack(draws)), np.stack(want))


def test_masks_match_jax_but_at_the_boundary(clean):
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    hw = (H, W)
    strokes = stack([jax_stroke_draws(k, hw, (5, 15), (10, 40)) for k in keys])
    want = jax.jit(jax.vmap(lambda k: J.free_form_mask(k, hw)))(keys)
    assert_masks_agree(T.free_form_mask(hw, strokes), want, T.near_mask_boundary(hw, strokes))

    draws = stack([jax_inpaint_draws(k, hw) for k in keys])
    assert len({bool(u < 0.7) for u in draws["u_mix"]}) == 2   # both easy and hard
    want = jax.jit(jax.vmap(lambda k: J.inpaint_mask(k, hw)))(keys)
    assert_masks_agree(T.inpaint_mask(hw, draws), want, T.near_inpaint_boundary(hw, draws))


# --- the synthetic batch -----------------------------------------------------------


@pytest.mark.parametrize("task", ["denoise", "sr_x4", "colorize", "inpaint"])
def test_degrade_batch_matches_jax(clean, task):
    size = 32
    batch = clean[:, :size, :size]
    key = jax.random.PRNGKey(9)
    want = JS._degrade_batch_fn(task, size, 4)(key, jnp.asarray(batch))
    keys = jax.random.split(key, len(batch))
    if task == "denoise":
        draws = stack([jax_noise_draws(k, batch.shape[1:], (5.0, 8.0)) for k in keys])
    elif task == "sr_x4":
        draws = {"ksize": torch.tensor([int(jax.random.choice(jax.random.split(k)[1],
                                                              jnp.asarray([3, 5, 7])))
                                        for k in keys])}
    elif task == "inpaint":
        draws = stack([jax_inpaint_draws(k, (size, size)) for k in keys])
    else:
        draws = {}
    got = TS.degrade_batch(task, t(batch), draws)
    assert set(got) == set(want)
    close(got["gt"], want["gt"], rel=1e-6)
    if task == "inpaint":
        near = T.near_inpaint_boundary((size, size), draws)
        assert_masks_agree(got["mask"], want["mask"], near)
        same = ~near[..., None]
        np.testing.assert_allclose(np.where(same, got["input"].numpy(), 0),
                                   np.where(same, np.asarray(want["input"]), 0), atol=1e-6)
    else:
        close(got["input"], want["input"], rel=1e-5 if task == "sr_x4" else 1e-6)


def test_draws_have_the_documented_ranges():
    gen = torch.Generator().manual_seed(0)
    d = T.draw_denoise(gen, (64, 8, 8, 3), with_artifacts=True)
    assert ((d["sigma"] >= 3 / 255) & (d["sigma"] <= 15 / 255)).all()
    assert d["quality"].min() >= 40 and d["quality"].max() <= 85
    assert ((d["length"] >= 3) & (d["length"] <= 8)).all()
    assert 0 < d["use_jpeg"].float().mean() < 1 and 0 < d["use_blur"].float().mean() < 1
    s = T.draw_inpaint(gen, 64, (20, 30))
    assert s["easy"]["n_strokes"].min() >= 3 and s["easy"]["n_strokes"].max() <= 7
    assert s["hard"]["thick"].min() >= 20 and s["hard"]["thick"].max() <= 40
    assert s["hard"]["pts_x"].max() <= 29 and s["hard"]["pts_y"].max() <= 19
    assert set(T.draw_sr(gen, 64)["ksize"].tolist()) == {3, 5, 7}
