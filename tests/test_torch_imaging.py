"""The port's numpy image ops (``infer/imaging.py``) against PIL and cv2, and
the port's mask utilities against the JAX package's cv2-based fallbacks.

Limits (set by the port's contract, not by what the installed libraries
happen to give): the LANCZOS resizes within 1 of their library, with at most
1% (PIL) and 5% (cv2) of the values off by one; both follow their library's
fixed-point arithmetic, and with PIL 12.1 and OpenCV 5.0 they agree bitwise.
NEAREST, RGB2GRAY, the auto mask and the mask normalisation are integer
functions and must be bit-exact.
"""
import cv2
import numpy as np
import pytest
from PIL import Image

from image_restoration_and_enhancement_torch.infer import fallbacks as tfb
from image_restoration_and_enhancement_torch.infer import imaging
from image_restoration_and_enhancement_tpu.infer import fallbacks as jfb
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

SIZES = [((96, 80), (48, 40)),      # down x2
         ((40, 52), (160, 208)),    # up x4
         ((200, 120), (128, 64)),   # down, non-square
         ((33, 17), (20, 50)),      # down in one axis, up in the other
         ((64, 64), (64, 100))]     # one axis only


def _within_one(got, ref, max_share):
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() <= max_share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("src,dst", SIZES)
def test_lanczos_resizes_match_pil_and_cv2(src, dst):
    rng = np.random.default_rng(31)
    for channels in ((3,), ()):
        img = rng.integers(0, 256, src + channels, dtype=np.uint8)
        pil = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.LANCZOS))
        _within_one(imaging.resize_lanczos_pil(img, dst), pil, 0.01)
        cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LANCZOS4)
        _within_one(imaging.resize_lanczos4_cv2(img, dst), cv, 0.05)
        nearest = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.NEAREST))
        np.testing.assert_array_equal(imaging.resize_nearest_pil(img, dst), nearest)
    # same size: the identity
    np.testing.assert_array_equal(imaging.resize_lanczos_pil(img, src), img)


def test_gray_threshold_and_morphology_match_cv2():
    rng = np.random.default_rng(32)
    img = rng.integers(0, 256, (37, 41, 3), dtype=np.uint8)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(imaging.rgb_to_gray_cv2(img), gray)
    np.testing.assert_array_equal(imaging.threshold(gray, 30, inverse=True),
                                  cv2.threshold(gray, 30, 255, cv2.THRESH_BINARY_INV)[1])
    np.testing.assert_array_equal(imaging.threshold(gray, 225),
                                  cv2.threshold(gray, 225, 255, cv2.THRESH_BINARY)[1])
    kernel = np.ones((5, 5), np.uint8)
    for density in (0.3, 0.7):  # blobs touching the border, and holes in a field
        mask = np.where(rng.random((50, 60)) < density, 255, 0).astype(np.uint8)
        np.testing.assert_array_equal(imaging.morph_close(mask),
                                      cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel))
        np.testing.assert_array_equal(imaging.morph_open(mask),
                                      cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel))


def _damaged(h, w, seed):
    """A mid-grey photo-like image with a dark scratch and a bright blotch."""
    rng = np.random.default_rng(seed)
    img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
    img[h // 5: h // 5 + 4, w // 8: 3 * w // 4] = rng.integers(0, 25, (4, 3 * w // 4 - w // 8, 3))
    img[h // 2: h // 2 + 9, w // 2: w // 2 + 11] = 240
    return img


def test_mask_utilities_match_jax_fallbacks():
    for seed, (h, w) in enumerate([(64, 64), (50, 70), (96, 40)]):
        img = _damaged(h, w, seed)
        got, ref = tfb.auto_mask_from_image(img), jfb.auto_mask_from_image(img)
        assert got is not None
        np.testing.assert_array_equal(got, ref)
        # normalisation: RGB and grey masks, resized (LANCZOS4) and inverted
        for mask in (ref, np.stack([ref] * 3, -1), 255 - ref):
            for target in ((h, w), (h + 13, w - 7)):
                np.testing.assert_array_equal(tfb.normalize_mask(mask, target),
                                              jfb.normalize_mask(mask, target))
    clean = np.full((32, 32, 3), 128, np.uint8)
    assert tfb.auto_mask_from_image(clean) is None and jfb.auto_mask_from_image(clean) is None
    grey = _damaged(40, 40, 9)
    np.testing.assert_array_equal(tfb.gray_to_rgb(grey), jfb.gray_to_rgb(grey))
    np.testing.assert_array_equal(tfb.gray_to_rgb(grey[..., 1]), jfb.gray_to_rgb(grey[..., 1]))
    _within_one(tfb.sr_lanczos(grey, 4), jfb.sr_lanczos(grey, 4), 0.05)
