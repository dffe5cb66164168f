"""The port's data layer (``data/png.py``, ``native.py``, ``datasets.py``,
``synthetic.py``) and ``generate_predictions`` against PIL, cv2 and the
JAX package.

Limits: the PNG codec bit for bit against PIL (decoding PIL's files and
files with each of the five row filters; PIL decoding the codec's files;
PIL's RGB and L conversions); ``resize_bicubic`` against
``cv2.resize(INTER_CUBIC)`` with IPP off bit for bit where cv2 sums whole
128-bit vectors and within 2e-7 of the largest value elsewhere (its scalar
tail adds a row's last values in the other order), and within 1e-5 of the
largest value with IPP on (IPP's weights differ from cv2's own by ~2e-6; the
JAX package's ``native.resize_bicubic`` is cv2 with IPP here); ``to_pm1``/``from_pm1``
equal to the JAX package's C++ library; ``PairDataset`` items equal to the
JAX package's (resized ones within 2e-5, the IPP difference in [-1, 1] units)
and ``BatchLoader`` batches index for index.
"""
import builtins
import functools
import os
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_and_enhancement_torch import config as C
from image_restoration_and_enhancement_torch import evaluate_model as port_eval_model
from image_restoration_and_enhancement_torch import generate_predictions as port_gen
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling
from image_restoration_and_enhancement_torch.data import datasets as TD
from image_restoration_and_enhancement_torch.data import native as TN
from image_restoration_and_enhancement_torch.data import png
from image_restoration_and_enhancement_torch.data import synthetic as TS
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.metrics import evaluate as TE
from image_restoration_and_enhancement_torch.models.layers import init_random_
from image_restoration_and_enhancement_tpu import native as JN
from image_restoration_and_enhancement_tpu.data import datasets as JD
from image_restoration_and_enhancement_tpu.data import synthetic as JS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS_HARD = os.path.join(REPO, "data", "pairs_hard")


# --- PNG -------------------------------------------------------------------------


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An RGB PNG whose row y is written with filter ``filters[y % 5]``."""
    h, w, c = img.shape
    rows, prior = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return len(body).to_bytes(4, "big") + kind + body + \
            (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_decodes_all_five_filters_like_pil(tmp_path):
    rng = np.random.default_rng(111)
    img = rng.integers(0, 256, (15, 13, 3), dtype=np.uint8)
    data = _filtered_png(img, [0, 1, 2, 3, 4])
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "f.png")), img)
    np.testing.assert_array_equal(png.read_png(data), img)


@pytest.mark.parametrize("mode,shape", [("L", (23, 31)), ("LA", (23, 31, 2)),
                                        ("RGB", (23, 31, 3)), ("RGBA", (23, 31, 4)),
                                        ("P", (23, 31, 3))])
def test_png_reads_and_writes_like_pil(tmp_path, mode, shape):
    rng = np.random.default_rng(112)
    for kind in ("noise", "smooth"):
        a = rng.integers(0, 256, shape, dtype=np.uint8) if kind == "noise" else \
            (np.cumsum(rng.integers(0, 3, shape), axis=0) % 256).astype(np.uint8)
        path = str(tmp_path / f"{mode}_{kind}.png")
        pil = Image.fromarray(a).quantize(16) if mode == "P" else Image.fromarray(a, mode)
        pil.save(path)
        for conv in ("RGB", "L"):
            np.testing.assert_array_equal(png.load_image(path, conv),
                                          np.array(Image.open(path).convert(conv)))
        if mode != "P":
            np.testing.assert_array_equal(png.read_png(path), a)
            mine = str(tmp_path / f"w_{mode}_{kind}.png")
            png.write_png(mine, a)
            np.testing.assert_array_equal(np.array(Image.open(mine)), a)


def test_other_formats_go_through_pil_and_raise_without_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(113)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    png.save_image(str(tmp_path / "a.jpg"), img)
    Image.fromarray(img).save(str(tmp_path / "b.jpg"))          # PIL's default quality 75
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    np.testing.assert_array_equal(png.load_image(str(tmp_path / "a.jpg"), "L"),
                                  np.array(Image.open(tmp_path / "a.jpg").convert("L")))
    png.save_image(str(tmp_path / "c.png"), img)
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"\.jpg format needs PIL"):
        png.load_image(str(tmp_path / "a.jpg"))
    with pytest.raises(RuntimeError, match=r"\.webp format needs PIL"):
        png.save_image(str(tmp_path / "d.webp"), img)
    np.testing.assert_array_equal(png.load_image(str(tmp_path / "c.png")), img)


# --- native ----------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((64, 64), (256, 256)), ((96, 80), (32, 40)),
                                     ((37, 53), (80, 21))])
def test_resize_bicubic_is_cv2_inter_cubic(src, dst):
    rng = np.random.default_rng(114)
    img = rng.uniform(0, 255, src + (3,)).astype(np.float32)
    got = TN.resize_bicubic(img, dst)
    ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
        assert np.abs(got - ref).max() <= 2e-7 * np.abs(ref).max()
        whole = (dst[1] * 3) // 4 * 4   # the columns cv2 sums in whole SIMD vectors
        np.testing.assert_array_equal(got.reshape(dst[0], -1)[:, :whole],
                                      ref.reshape(dst[0], -1)[:, :whole])
    finally:
        cv2.ipp.setUseIPP(ipp)
    for ref in (cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC),
                JN.resize_bicubic(img, dst)):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pm1_conversions_match_the_native_library():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(TN.to_pm1(u8), JN.to_pm1(u8))
    x = np.concatenate([np.random.default_rng(115).uniform(-1.2, 1.2, 5000),
                        (np.arange(-1, 257) + 0.5) / 127.5 - 1.0]).astype(np.float32)
    np.testing.assert_array_equal(TN.from_pm1(x), JN.from_pm1(x))


# --- PairDataset and BatchLoader -------------------------------------------------


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """A PNG train split per task: 5 pairs of 24x24 (sr_x4 inputs 6x6, one
    denoise stem with a _sigma suffix, inpaint masks 12x12, some inverted)."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(116)
    for task in ("denoise", "sr_x4", "colorize", "inpaint"):
        base = root / task / "train"
        for sub in ("input", "gt", "mask"):
            (base / sub).mkdir(parents=True)
        for i in range(5):
            stem = f"p{i}_sigma{10 + i}" if task == "denoise" and i == 1 else f"p{i}"
            gt = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
            inp = gt[::4, ::4] if task == "sr_x4" else rng.integers(0, 256, (24, 24, 3),
                                                                   dtype=np.uint8)
            png.write_png(str(base / "gt" / f"{stem}.png"), gt)
            png.write_png(str(base / "input" / f"{stem}.png"), inp)
            if task == "inpaint":
                m = np.where(rng.random((12, 12)) < (0.3 if i % 2 else 0.7), 255, 0)
                png.write_png(str(base / "mask" / f"{stem}.png"), m.astype(np.uint8))
    return str(root)


def _same_items(port, ref, atol):
    assert len(port) == len(ref) and port.sigmas == ref.sigmas
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("task", ["denoise", "sr_x4", "colorize", "inpaint"])
def test_pair_dataset_items_match_jax(pair_root, task):
    port = TD.PairDataset(task, root=pair_root, split="train", image_size=24)
    ref = JD.PairDataset(task, root=pair_root, split="train", image_size=24)
    _same_items(port, ref, atol=2e-5 if task == "sr_x4" else 0.0)
    if task == "inpaint":
        means = [port[i]["mask"].mean() for i in range(len(port))]
        assert max(means) <= 0.5 and min(means) > 0
    # another size: every image resized (cv2's bicubic), masks by NEAREST
    _same_items(TD.PairDataset(task, root=pair_root, split="train", image_size=32),
                JD.PairDataset(task, root=pair_root, split="train", image_size=32), atol=2e-5)


def test_pair_dataset_reads_the_repos_jpeg_split():
    """data/pairs_hard/denoise/test: 256 px JPEG pairs, decoded by PIL."""
    port = TD.PairDataset("denoise", root=PAIRS_HARD, split="test", image_size=256,
                          max_samples=3)
    ref = JD.PairDataset("denoise", root=PAIRS_HARD, split="test", image_size=256,
                         max_samples=3)
    assert port.items == ref.items
    _same_items(port, ref, atol=0.0)


@pytest.mark.parametrize("drop_last,prefetch", [(True, True), (False, False)])
def test_batch_loader_matches_jax_index_for_index(pair_root, drop_last, prefetch):
    port = TD.BatchLoader(TD.PairDataset("inpaint", root=pair_root, image_size=24), 2,
                          seed=3, drop_last=drop_last, prefetch=prefetch)
    ref = JD.BatchLoader(JD.PairDataset("inpaint", root=pair_root, image_size=24), 2,
                         seed=3, drop_last=drop_last, prefetch=prefetch)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


# --- SyntheticPairLoader -----------------------------------------------------------


def test_synthetic_loader_on_the_cpu(tmp_path):
    rng = np.random.default_rng(117)
    for i in range(5):
        png.write_png(str(tmp_path / f"c{i}.png"),
                      rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    paths = TS.list_clean_images(str(tmp_path))
    assert paths == JS.list_clean_images(str(tmp_path))
    for task in ("denoise", "sr_x4", "colorize", "inpaint"):
        loader = TS.SyntheticPairLoader(task, paths, image_size=32, batch_size=2, seed=1,
                                        device="cpu")
        ref = JS.SyntheticPairLoader(task, paths, image_size=32, batch_size=2, seed=1)
        np.testing.assert_allclose(loader._cache, ref._cache, rtol=0, atol=1e-5)
        assert len(loader) == 2
        e0, again, e1 = (list(loader.epoch(0)), list(loader.epoch(0)), list(loader.epoch(1)))
        assert set(e0[0]) == ({"input", "gt", "mask"} if task == "inpaint" else {"input", "gt"})
        for b in e0:
            assert b["input"].shape == b["gt"].shape == (2, 32, 32, 3)
            assert b["input"].min() >= -1 and b["input"].max() <= 1
        torch.testing.assert_close(e0[0]["input"], again[0]["input"], rtol=0, atol=0)
        if task != "colorize":   # fresh draws every epoch
            assert not torch.equal(torch.cat([b["input"] for b in e0]),
                                   torch.cat([b["input"] for b in e1]))


def test_new_entry_points_need_cuda_unless_cpu_is_asked(pair_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the test is about machines without one")
    base = os.path.join(pair_root, "denoise", "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.evaluate_task(os.path.join(base, "input"), os.path.join(base, "gt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SyntheticPairLoader("denoise", [os.path.join(base, "gt", "p0.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_gen.main(["--data_root", pair_root, "--split", "train",
                       "--out_root", str(tmp_path), "--models_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval_model.main(["--pred_root", pair_root,
                              "--data_root", pair_root, "--split", "train",
                              "--tasks", "denoise", "--out_json", str(tmp_path / "r.json")])


# --- generate_predictions ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """TINY_SD stacks for denoise, sr_x4 and colorize and a TINY_SD_INPAINT
    stack for inpaint under <root>/<model_dir>/best, initialised at random."""
    root = tmp_path_factory.mktemp("models")
    for model_dir, cfg, seed in (("denoising", C.TINY_SD, 121),
                                 ("super_resolution", C.TINY_SD, 122),
                                 ("colorization", C.TINY_SD, 123),
                                 ("inpainting", C.TINY_SD_INPAINT, 124)):
        mods = sampling.SDModules.create(cfg, torch.float32, "cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in mods.components().values():
                init_random_(m, gen)
        tck.save_pipeline(str(root / model_dir / "best"), mods.components(), cfg)
    return str(root)


def test_generate_predictions_on_tiny_stacks(tiny_models, tmp_path, monkeypatch):
    """The script's layout, names and formats on TINY stacks, in fp32 on one
    thread: thousands of tiny ops, whose thread-pool barriers stall when the
    test workers share the CPU's cores (~560 s instead of ~4 s with six
    workers)."""
    fp32 = functools.partial(RestorationPipeline, dtype=torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _generate_predictions_on_tiny_stacks(tiny_models, tmp_path, fp32)
    finally:
        torch.set_num_threads(threads)


def _generate_predictions_on_tiny_stacks(tiny_models, tmp_path, fp32):
    rng = np.random.default_rng(125)
    data = tmp_path / "data"
    layout = {"denoise": [("a.png", (64, 64)), ("b.jpg", (64, 64))],
              "sr_x4": [("a.png", (16, 16))], "colorize": [("a.png", (64, 64))],
              "inpaint": [("a.png", (64, 64))]}
    for task, files in layout.items():
        for sub in ("input", "mask"):
            (data / task / "test" / sub).mkdir(parents=True)
        for name, hw in files:
            img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            if task == "colorize":
                img = np.repeat(img[..., :1], 3, axis=-1)
            png.save_image(str(data / task / "test" / "input" / name), img)
            if task == "inpaint":
                mask = np.zeros(hw, np.uint8)
                mask[16:40, 8:48] = 255
                png.save_image(str(data / task / "test" / "mask" / name), mask)
    out = tmp_path / "pred"
    args = ["--data_root", str(data), "--models_root", tiny_models, "--device", "cpu",
            "--dtype", "float32"]
    assert port_gen.main(args + ["--out_root", str(out)]) == 0
    # --spatial_shards 2: two gloo ranks, each image's height sharded over them
    assert port_gen.main(args + ["--out_root", str(tmp_path / "sp"),
                                 "--spatial_shards", "2"]) == 0
    for task, files in layout.items():
        assert sorted(os.listdir(out / task)) == sorted(n for n, _ in files)
        for name, hw in files:
            pred = png.load_image(str(out / task / name))
            want_hw = (hw[0] * 4, hw[1] * 4) if task == "sr_x4" else hw
            assert pred.shape == want_hw + (3,) and pred.dtype == np.uint8
    # the two ranks wrote what one device wrote, within one uint8 level (the
    # shards' fp32 sums run in another order and can round a pixel the other way)
    for task, files in layout.items():
        for name, _ in files:
            one = png.load_image(str(out / task / name)).astype(int)
            two = png.load_image(str(tmp_path / "sp" / task / name)).astype(int)
            assert np.abs(one - two).max() <= 1 and (one != two).mean() < 1e-3, (task, name)
    # the saved PNG is the pipeline's output for that input
    pipe = fp32(models_root=tiny_models, device="cpu")
    inp = png.load_image(str(data / "denoise" / "test" / "input" / "a.png"))
    want = pipe.process(inp, ["denoise"], denoise_strength=0.5)["final"]
    np.testing.assert_array_equal(png.load_image(str(out / "denoise" / "a.png")), want)
