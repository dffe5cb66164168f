"""The port's image ops (``ops/image.py``) and metrics (``metrics/functional.py``
run elsewhere) against the JAX package's ``ops/image.py`` on seeded inputs.

Limit: |port - JAX| <= 1e-5 x max |JAX| for every op (fp32 on both sides, the
same operations in another order). ``resize`` is held against
``jax.image.resize`` at shrinking, growing and non-square shapes for
bilinear, bicubic and lanczos3 with antialias on and off (and nearest, which
must be equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.ops import image as T
from image_restoration_and_enhancement_tpu.ops import image as J
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(71)
    smooth = np.cumsum(rng.uniform(-0.05, 0.05, (2, 40, 52, 3)), axis=1)
    smooth = (smooth - smooth.min()) / (np.ptp(smooth) + 1e-6)
    return {"noise": rng.uniform(0, 1, (2, 40, 52, 3)).astype(np.float32),
            "smooth": smooth.astype(np.float32)}


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_colour_spaces_match_jax(imgs, kind):
    x = imgs[kind]
    t = torch.from_numpy(x)
    close(T.rgb_to_lab(t), J.rgb_to_lab(jnp.asarray(x)))
    lab = np.array(J.rgb_to_lab(jnp.asarray(x)))
    close(T.lab_to_rgb(torch.from_numpy(lab)), J.lab_to_rgb(jnp.asarray(lab)))
    close(T.rgb_to_ycbcr(t), J.rgb_to_ycbcr(jnp.asarray(x)))
    close(T.y_channel(t), J.y_channel(jnp.asarray(x)))
    for mode in ("lab_l", "luma"):
        close(T.rgb_to_grayscale(t, mode), J.rgb_to_grayscale(jnp.asarray(x), mode))


RESIZE_SHAPES = [((40, 52), (20, 26)),     # shrink x2
                 ((40, 52), (13, 31)),     # shrink, non-integer, non-square
                 ((40, 52), (96, 80)),     # grow
                 ((40, 52), (25, 104))]    # shrink one axis, grow the other


@pytest.mark.parametrize("src,dst", RESIZE_SHAPES)
@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3"])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matches_jax_image_resize(imgs, src, dst, method, antialias):
    x = imgs["noise"][:, : src[0], : src[1]]
    want = J.resize(jnp.asarray(x), dst, method=method, antialias=antialias)
    close(T.resize(torch.from_numpy(x), dst, method=method, antialias=antialias), want)
    # one HWC image as well as the batch
    close(T.resize(torch.from_numpy(x[0]), dst, method=method, antialias=antialias), want[0])


@pytest.mark.parametrize("src,dst", RESIZE_SHAPES)
def test_resize_nearest_and_upscale_match_jax(imgs, src, dst):
    x = imgs["smooth"][:, : src[0], : src[1]]
    np.testing.assert_array_equal(
        T.resize(torch.from_numpy(x), dst, method="nearest").numpy(),
        np.asarray(J.resize(jnp.asarray(x), dst, method="nearest")))
    close(T.upscale_bicubic(torch.from_numpy(x[:, :10, :13]), 4),
          J.upscale_bicubic(jnp.asarray(x[:, :10, :13]), 4))


def test_resize_is_not_interpolate(imgs):
    """F.interpolate's bicubic (a = -0.75) is another function; the port must
    not be it (a control for the parity above)."""
    x = torch.from_numpy(imgs["noise"][:1])
    ours = T.resize(x, (80, 104), "bicubic", antialias=False)
    theirs = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(80, 104),
                                             mode="bicubic").permute(0, 2, 3, 1)
    assert (ours - theirs).abs().max() > 1e-3


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_blurs_and_uniform_filter_match_jax(imgs, kind):
    x = imgs[kind]
    t, j = torch.from_numpy(x), jnp.asarray(x)
    close(T.gaussian_blur(t, 1.5), J.gaussian_blur(j, 1.5))
    close(T.gaussian_blur(t[0], 0.8, radius=3), J.gaussian_blur(j[0], 0.8, radius=3))
    close(T.box_blur(t, 5), J.box_blur(j, 5))
    np.testing.assert_array_equal(T.motion_blur_kernel(9, 30.0), J.motion_blur_kernel(9, 30.0))
    close(T.motion_blur(t, 9, 30.0), J.motion_blur(j, 9, 30.0))
    close(T.uniform_filter(t, 7), J.uniform_filter(j, 7))
    close(T.uniform_filter(t[1], 7), J.uniform_filter(j[1], 7))


def test_per_image_kernels_match_one_at_a_time(imgs):
    """``depthwise_conv`` with a [B, kh, kw] kernel blurs each image with its
    own kernel, as the batched degradations need."""
    x = torch.from_numpy(imgs["noise"])
    ks = torch.from_numpy(np.stack([T.motion_blur_kernel(7, a) for a in (10.0, 100.0)]))
    got = T.depthwise_conv(x, ks)
    for i in range(2):
        close(got[i], T.depthwise_conv(x[i], ks[i]), rel=0)


def test_full_fp32_restores_the_callers_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with T.full_fp32():
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
