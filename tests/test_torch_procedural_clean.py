"""The port's make_procedural_clean against the JAX package's script (loaded by
path): the procedural images bitwise, for three seeds at three sizes, and the
whole CLI's files byte for byte (both write JPEG through PIL here, at quality
95). Without PIL (the GPU machine) the JPEG write raises an error that names
PIL; the script never falls back to another format."""
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest

from image_restoration_and_enhancement_torch import make_procedural_clean as tpc

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jpc():
    return load_script("make_procedural_clean")


@pytest.mark.parametrize("size", [32, 64, 256])
@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_procedural_image_bitwise(jpc, seed, size):
    a = jpc.procedural_image(np.random.default_rng(seed), size)
    b = tpc.procedural_image(np.random.default_rng(seed), size)
    assert b.dtype == np.uint8 and b.shape == (size, size, 3)
    np.testing.assert_array_equal(b, a)


def test_main_writes_the_same_jpegs(jpc, tmp_path, monkeypatch):
    args = ["--num_train", "2", "--num_val", "1", "--num_test", "1", "--size", "64"]
    monkeypatch.setattr(sys, "argv", ["make_procedural_clean.py", "--out_root",
                                      str(tmp_path / "jax")] + args)
    jpc.main()
    assert tpc.main(["--out_root", str(tmp_path / "torch")] + args) == 0
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert names == [f"{split}_{i:06d}.jpg" for i in range(n)]
        assert sorted(os.listdir(tmp_path / "torch" / split)) == names
        for name in names:
            assert ((tmp_path / "torch" / split / name).read_bytes()
                    == (tmp_path / "jax" / split / name).read_bytes()), name


def test_jpeg_without_pil_raises_naming_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL now fails
    with pytest.raises(RuntimeError, match="needs PIL"):
        tpc.main(["--out_root", str(tmp_path), "--num_train", "1", "--num_val", "0",
                  "--num_test", "0", "--size", "32"])
    assert not any(f for _, _, fs in os.walk(tmp_path) for f in fs)
