"""The port's import of a diffusers pipeline directory against the JAX package.

``scripts/import_weights.make_rehearsal_dir`` writes a diffusers-layout
directory (random weights under the real names and file formats: the UNet and
VAE from the JAX package's export, the text encoder from a real
``transformers.CLIPTextModel``) for TINY_SD and TINY_SD_INPAINT. Its JAX
initialisation is swapped for random values of the same parameter tree
(``jax.eval_shape`` of it, filled from numpy), which skips compiling every
init op eagerly and changes no name or shape. The port's
``import_hf_pipeline`` must give, bit for bit, the parameters the JAX
package's ``import_hf_pipeline`` gives carried over by the weight bridge; a
port pipeline then serves a denoise and an inpaint request from those
directories in pretrained mode.
"""
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.tasks.registry import get_task
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from scripts.import_weights import make_rehearsal_dir
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

SD_ID = "sd-legacy/stable-diffusion-v1-5"


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """{name: (directory, the port's model config)}; the SD-1.5 one sits where
    $IRET_PRETRAINED_ROOT/<pretrained_id with / as --> finds it."""
    root = tmp_path_factory.mktemp("pretrained")
    init = js.init_params

    def random_params(modules, key, image_size=256, seq_len=77):
        return fill_params(jax.eval_shape(lambda k: init(modules, k, image_size, seq_len), key),
                           seed=5)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "init_params", random_params)
        for name, cfg, sub in (("sd", JC.TINY_SD, SD_ID.replace("/", "--")),
                               ("inpaint", JC.TINY_SD_INPAINT, "inpaint")):
            used = make_rehearsal_dir(str(root / sub), cfg, seed=5)
            out[name] = (str(root / sub), TC.model_config_from_dict(dataclasses.asdict(used)))
    return root, out


@pytest.mark.parametrize("name", ["sd", "inpaint"])
def test_import_matches_jax_bitwise(rehearsal, name):
    _, dirs = rehearsal
    directory, cfg = dirs[name]
    assert not tck.is_pipeline_layout(directory) and tck.pipeline_exists(directory)
    got = tck.import_hf_pipeline(directory)
    ref = jck.import_hf_pipeline(directory)
    assert set(got) == set(ref) == {"unet", "vae", "text_encoder"}
    for comp in got:
        want = tck.params_from_flax(jck.flatten_params(ref[comp]))
        assert set(got[comp]) == set(want), comp
        for k, v in want.items():
            assert got[comp][k].dtype == v.dtype and torch.equal(got[comp][k], v), (comp, k)
    assert got["unet"]["conv_in.weight"].shape[1] == cfg.unet.in_channels
    # the state dicts fill the port's modules exactly (strict load)
    from image_restoration_and_enhancement_torch.core import sampling as ts

    mods = ts.SDModules.create(cfg, dtype=torch.float32, device="cpu")
    for comp, module in mods.components().items():
        module.load_state_dict(got[comp], strict=True)


def test_import_drops_position_ids_and_rejects_unknown_names(rehearsal, tmp_path):
    _, dirs = rehearsal
    directory, _ = dirs["sd"]
    te = st_numpy.load_file(f"{directory}/text_encoder/model.safetensors")
    te["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    (tmp_path / "text_encoder").mkdir()
    st_numpy.save_file(te, str(tmp_path / "text_encoder" / "model.safetensors"))
    state = tck.import_hf_pipeline(str(tmp_path))["text_encoder"]
    assert "position_ids" not in " ".join(state) and "final_layer_norm.weight" in state
    assert tck.port_name("text_model.encoder.layers.0.mlp.fc1.weight") == "layers.0.fc1.weight"
    te["text_model.encoder.layers.0.unknown.weight"] = np.zeros(3, np.float32)
    st_numpy.save_file(te, str(tmp_path / "text_encoder" / "model.safetensors"))
    from image_restoration_and_enhancement_torch.models.clip_text import CLIPTextModel

    model = CLIPTextModel(TC.TINY_CLIP_TEXT)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(tck.import_hf_pipeline(str(tmp_path))["text_encoder"],
                              strict=True)


def test_pipeline_serves_pretrained_diffusers_dirs(rehearsal, monkeypatch, caplog):
    root, dirs = rehearsal
    monkeypatch.setenv("IRET_PRETRAINED_ROOT", str(root))
    pipe = RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": "nonexistent", "default_backend": "diffusion",
                            "model_config": dirs["sd"][1]},
                "inpaint": {"fine_tuned_dir": "nonexistent", "default_backend": "diffusion",
                            "pretrained_dir": dirs["inpaint"][0],
                            "model_config": dirs["inpaint"][1]}},
        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(51)
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:40, 20:52] = 255
    with caplog.at_level(logging.INFO):
        den = pipe.denoise(image)
        inp = pipe.inpaint(image, mask=mask)
    assert not [r for r in caplog.records if "failed" in r.getMessage()]
    assert [r for r in caplog.records if "diffusers layout" in r.getMessage()]
    for out in (den, inp):
        assert out.dtype == np.uint8 and out.shape == (64, 64, 3)
    assert pipe._find_weights("denoise") == dirs["sd"][0]
    assert pipe._stacks["inpaint"]["modules"].unet.conv_in.weight.shape[1] == 9
    # a diffusers directory carries no model config: without "model_config"
    # the task's default loads (SD-1.5-inpaint for inpaint, SD-1.5 otherwise)
    assert tck.load_pipeline_model_config(dirs["inpaint"][0]) is None
    assert get_task("inpaint").model_config == TC.SD15_INPAINT
    assert get_task("denoise").model_config == TC.SD15
