"""The port's offline pair factory against the JAX package (CPU).

What is held, and to what limit:
- ``data/native.add_gaussian_noise_u8`` against the JAX package's C++ library
  (``libpreprocess.so``, built here), byte for byte. glibc's ``logf``,
  ``sinf`` and ``cosf`` are not always correctly rounded and the port takes
  them in float64; so a byte may differ only where the port's float32 sum
  lies within 4 ulps of an integer (the truncation boundary). None differs
  on these inputs.
- ``rgb_to_lab_l`` against ``cv2.cvtColor(RGB2LAB)[..., 0]`` on all 2**24
  colours, bitwise.
- ``infer/imaging.py``'s cv2 and PIL operations at even and odd sizes:
  GaussianBlur (k = 3, 5, 7), PIL BICUBIC and NEAREST, and filter2D with
  kernels under 130 taps, and INTER_AREA, bitwise. INTER_CUBIC bitwise at
  integer ratios; at other ratios one u8 step at no more than 0.5% of the
  values, each where the port's float64 value lies within 0.01 of a half:
  cv2 with IPP sums in float32 in an order the port does not follow there.
  filter2D with 130 taps or more (cv2 correlates through the DFT): one
  step, only where the port's sum lies within 1e-4 of a half.
- every ``host_degradations`` function against JAX's from identically
  seeded ``np.random.Generator``s (the same draws, the generators left in
  the same state), under the limits above where the function reaches them;
- both packages' ``process_split`` in one process on PNG inputs (JAX seeds
  each split with ``hash(split)``, salted per process): the same files with
  the same pixels. The PNG streams themselves differ: PIL picks row filters,
  the port's codec writes unfiltered rows;
- ``make_demo_data`` against JAX's, pixel for pixel;
- the JPEG degradation's error naming its flags where cv2 is missing.
"""
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from image_restoration_and_enhancement_torch import make_demo_data as t_demo
from image_restoration_and_enhancement_torch import make_synthetic_pairs as t_pairs
from image_restoration_and_enhancement_torch.data import host_degradations as thd
from image_restoration_and_enhancement_torch.data import native as tn
from image_restoration_and_enhancement_torch.data.png import load_image, read_png
from image_restoration_and_enhancement_torch.infer import imaging as I
from image_restoration_and_enhancement_torch.ops.image import motion_blur_kernel
from image_restoration_and_enhancement_tpu import native as jn
from image_restoration_and_enhancement_tpu.data import host_degradations as jhd

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_demo_data as j_demo  # noqa: E402
import make_synthetic_pairs as j_pairs  # noqa: E402
from test_torch_serving import one_torch_thread  # noqa: F401  (fixture)

NOISE_ULPS = 4        # a differing noisy byte must lie this close to an integer
CUBIC_SHARE, CUBIC_HALF = 5e-3, 1e-2
DFT_HALF = 1e-4
DFT_TAPS = 130        # cv2 filters uint8 through the DFT from this kernel area on

SHAPES = [(64, 96, 3), (67, 91, 3), (33, 40), (101, 53, 3)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _scalar_xorshift(seed, count):
    s, out = seed, []
    for _ in range(count):
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        out.append(s)
    return np.array(out, np.uint64)


@pytest.mark.parametrize("count", [1, 255, 256, 257, 3001])
def test_xorshift_lanes_match_the_scalar_stream(count):
    assert np.array_equal(tn.xorshift64_stream(12345, count), _scalar_xorshift(12345, count))


def _near_integer(v, ulps):
    v = np.asarray(v, np.float32)
    return np.abs(v - np.round(v)) <= ulps * np.spacing(np.abs(v))


@pytest.mark.parametrize("shape,seed", [((64, 64, 3), 0), ((67, 91, 3), 1), ((5, 7), 2**62 - 5),
                                        ((256, 256, 3), 98765)])
def test_noise_matches_the_native_library(shape, seed):
    assert jn.get_lib() is not None, "the JAX package's C++ library must build here"
    img = _img(shape, seed % 1000)
    for sigma in (5.0, 7.31, 40.0):
        got = tn.add_gaussian_noise_u8(img, sigma, seed)
        want = jn.add_gaussian_noise_u8(img, sigma, seed)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = got != want
        v = tn.noisy_values(img, sigma, seed)
        assert _near_integer(v[diff], NOISE_ULPS).all(), v[diff]
        assert diff.sum() == 0, f"{diff.sum()} bytes differ, each at an integer boundary"


def test_lab_l_matches_cv2_on_every_colour():
    for r0 in range(0, 256, 64):   # four chunks of 2**22 colours
        c = np.arange(64 * 65536, dtype=np.uint32)
        rgb = np.stack([r0 + (c >> 16), (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(2048, 2048, 3)
        assert np.array_equal(tn.rgb_to_lab_l(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)[..., 0])
    img = _img((67, 91, 3), 3)
    assert np.array_equal(tn.rgb_to_lab_l(img), jn.rgb_to_lab_l(img))


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_blur_matches_cv2(shape):
    img = _img(shape, 4)
    for k in (3, 5, 7):
        assert np.array_equal(I.gaussian_blur_cv2(img, k), cv2.GaussianBlur(img, (k, k), 0)), k


def _within_halves(got, want, values, share, half):
    diff = got.astype(int) - want
    assert np.abs(diff).max(initial=0) <= 1
    assert (diff != 0).mean() <= share, (diff != 0).mean()
    assert (np.abs(values[diff != 0] % 1 - 0.5) <= half).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_cubic_and_area_resizes_match_cv2(shape):
    img = _img(shape, 5)
    h, w = shape[:2]
    for hw in ((h // 4, w // 4), (h // 2, w // 2), (h // 3 + 1, w // 3 + 2),
               (h * 2 // 3, w * 2 // 3)):
        want = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_CUBIC)
        got = I.resize_cubic_cv2(img, hw)
        if h % hw[0] == 0 and w % hw[1] == 0:
            assert np.array_equal(got, want), hw
        _within_halves(got, want, I.cubic_sums(img, hw), CUBIC_SHARE, CUBIC_HALF)
        want = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_AREA)
        assert np.array_equal(I.resize_area_cv2(img, hw), want), hw


@pytest.mark.parametrize("shape", SHAPES)
def test_filter2d_matches_cv2(shape):
    img = _img(shape, 6)
    rng = np.random.default_rng(7)
    for size in (3, 4, 5, 8, 10, 11, 12, 15):
        kern = motion_blur_kernel(size, float(rng.uniform(0, 360)))
        got, want = I.filter2d_cv2(img, kern), cv2.filter2D(img, -1, kern)
        if size * size < DFT_TAPS:
            assert np.array_equal(got, want), size
        else:
            _within_halves(got, want, I.filter2d_sums(img, kern), 1.0, DFT_HALF)


@pytest.mark.parametrize("shape", [(64, 96, 3), (67, 91, 3), (40, 33)])
def test_pil_bicubic_and_nearest_match_pil(shape):
    img = _img(shape, 8)
    for hw in ((32, 48), (70, 100), (shape[0], shape[1] + 7), (256, 256), (17, 19)):
        pil = Image.fromarray(img)
        assert np.array_equal(I.resize_bicubic_pil(img, hw), np.asarray(pil.resize(hw[::-1])))
        assert np.array_equal(I.resize_nearest_pil(img, hw),
                              np.asarray(pil.resize(hw[::-1], Image.NEAREST)))


def _both(fn_name, *args, seed=0, **kw):
    """(port output, JAX output) of one host_degradations function from two
    generators seeded alike; their states must agree after."""
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(thd, fn_name)(rt, *args, **kw)
    want = getattr(jhd, fn_name)(rj, *args, **kw)
    assert rt.random() == rj.random(), f"{fn_name} drew differently"
    return got, want


def _equal(got, want):
    if isinstance(got, tuple):
        return all(np.array_equal(a, b) for a, b in zip(got, want))
    return np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_host_degradations_match_jax(seed):
    img = _img((64, 96, 3), 10 + seed)
    for fn, args, kw in (("add_gaussian_noise", (img,), {}),
                         ("add_gaussian_noise", (img, (10.0, 12.0)), {}),
                         ("add_jpeg_compression", (img,), {}),
                         ("add_motion_blur", (img, (3, 11)), {}),
                         ("degrade_denoise", (img,), {}),
                         ("degrade_denoise", (img, False, (40.0, 50.0)), {}),
                         ("degrade_denoise", (img, True), {}),
                         ("degrade_sr", (img, 4), {}),
                         ("degrade_sr", (img, 4, True), {}),
                         ("degrade_sr", (img, 2, False, True), {}),
                         ("inpaint_pair", (img,), {}),
                         ("inpaint_pair", (img, 0.0), {}),
                         ("free_form_mask", ((48, 80),), {})):
        got, want = _both(fn, *args, seed=seed, **kw)
        assert _equal(got, want), (fn, args[1:])
    # a motion-blur kernel of 12x12 and up goes through cv2's DFT
    got, want = _both("add_motion_blur", img, (12, 15), seed=seed)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert np.array_equal(thd.to_grayscale(img), jhd.to_grayscale(img))
    for size in (32, 48, 64, 70, 100):
        got, want = thd.resize_to_max_size(img, size), jhd.resize_to_max_size(img, size)
        assert np.array_equal(got, want), size


def _write_clean(root, shapes):
    d = os.path.join(root, "val")
    os.makedirs(d)
    for i, shape in enumerate(shapes):
        Image.fromarray(_img(shape, 20 + i)).save(os.path.join(d, f"img_{i}.png"))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_process_split_matches_jax_file_by_file(tmp_path):
    clean = str(tmp_path / "clean")
    _write_clean(clean, [(64, 96, 3), (96, 64, 3), (128, 128, 3), (80, 120, 3)])
    args = t_pairs.build_parser().parse_args(["--splits", "val"])
    j_pairs.process_split(clean, str(tmp_path / "jax"), "val", args)
    t_pairs.process_split(clean, str(tmp_path / "port"), "val", args)
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port") and len(files) == 36
    for rel in files:
        want = np.asarray(Image.open(tmp_path / "jax" / rel))
        got = read_png(str(tmp_path / "port" / rel))
        assert got.dtype == want.dtype and np.array_equal(got, want), rel
    assert read_png(str(tmp_path / "port" / "sr_x4/val/input/img_0.png")).shape == (16, 24, 3)
    assert read_png(str(tmp_path / "port" / "colorize/val/input/img_0.png")).ndim == 2


def test_make_demo_data_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    j_demo.main()
    assert t_demo.main(["--out_root", str(tmp_path / "port")]) == 0
    jax_root = tmp_path / "data" / "demo"
    assert _tree(jax_root) == _tree(tmp_path / "port") == [
        "images/demo_0.png", "images/demo_1.png", "images/demo_2.png", "images/demo_3.png",
        "mask/demo_3.png"]
    for rel in _tree(jax_root):
        want = np.asarray(Image.open(jax_root / rel))
        assert np.array_equal(load_image(str(tmp_path / "port" / rel),
                                         "L" if want.ndim == 2 else "RGB"), want), rel


def test_jpeg_needs_cv2_and_says_which_flags(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--denoise_with_artifacts, --sr_with_jpeg"):
        thd.add_jpeg_compression(np.random.default_rng(0), _img((8, 8, 3), 0))
