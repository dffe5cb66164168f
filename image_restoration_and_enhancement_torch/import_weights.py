"""One-command weights import + numeric parity harness.

The port's counterpart of the JAX package's ``scripts/import_weights.py``,
with its flags plus ``--device``: converts external torch artifacts into the
pipeline layout and metric-weight files that both packages read, and records
or checks per-module output goldens, so that weight-import fidelity is a
measured number.

    # import everything + record goldens from the port's modules
    python -m image_restoration_and_enhancement_torch.import_weights \\
        --sd15 /path/to/stable-diffusion-v1-5 \\
        --sd_inpaint /path/to/stable-diffusion-inpainting \\
        --lpips /path/to/lpips_alex.(safetensors|pth) \\
        --inception /path/to/inception_v3.(safetensors|pth) \\
        --rrdb /path/to/RealESRGAN_x4plus.(safetensors|pth) \\
        --record_goldens goldens/

    # later / elsewhere: verify the imported stacks still reproduce them
    python -m image_restoration_and_enhancement_torch.import_weights \\
        --check_goldens goldens/ --pretrained_root outputs/pretrained

The imports are host work (the port's safetensors reader and writer); the
probes run on ``--device`` (``cuda`` unless ``cpu`` is asked for), in full
fp32 (no TF32). The img2img probe draws its noise from a CPU generator and
moves it to the device, so goldens recorded on the CPU can be checked on the
card. When ``diffusers`` is importable and ``--sd15`` is given, the probe
outputs of the diffusers UNet/VAE/text encoder are recorded alongside
(``*_torch`` keys) and the goldens pin cross-framework parity.

``--make_rehearsal DIR`` writes a diffusers-layout directory from random
weights (``make_rehearsal_dir``) to rehearse the import without real
weights: the UNet and VAE under diffusers names, the text encoder from the
port's CLIP module under transformers' ``text_model.*`` names.

Outputs:
    outputs/pretrained/sd15/        the pipeline layout (+ tokenizer files)
    outputs/pretrained/sd15_inpaint/
    weights/lpips_alex.safetensors
    weights/inception_v3.safetensors
    weights/realesrgan_x4.safetensors
    goldens/sd15_goldens.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from . import config as C
from .core import checkpoint as ckpt
from .device import DeviceLike, resolve_device

# parity gates: fp32 per-module thresholds (max abs delta on unit-scale
# activations). Loose enough for cross-backend matmul reassociation,
# tight enough to catch any wrong/missing/transposed weight.
THRESHOLDS = {
    "text_encoder": 5e-3,
    "vae_encode": 5e-3,
    "vae_decode": 5e-3,
    "unet": 5e-3,
    "img2img": 2e-2,  # 5 steps of accumulated error
}


def _load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch artifact as {name: CPU tensor}: .safetensors through the port's
    reader, .pth/.pt through ``torch.load(weights_only=True)``, unwrapping
    Real-ESRGAN's ``params_ema`` and a ``state_dict``."""
    if path.endswith(".safetensors"):
        return ckpt.load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "params_ema" in obj:  # Real-ESRGAN release zips
        obj = obj["params_ema"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def _sd_modules_meta(config) -> Dict[str, torch.nn.Module]:
    """The SD components of ``config`` on the meta device (names and shapes,
    no storage)."""
    from .models.clip_text import CLIPTextModel
    from .models.unet import UNet2DCondition
    from .models.vae import AutoencoderKL

    with torch.device("meta"):
        return {"unet": UNet2DCondition(config.unet), "vae": AutoencoderKL(config.vae),
                "text_encoder": CLIPTextModel(config.text_encoder)}


_SUPPORTED_SCHEDULER = {
    "beta_schedule": {"scaled_linear", "linear"},
    "prediction_type": {"epsilon"},
    "timestep_spacing": {"leading"},
}


def import_sd_dir(src: str, dst: str, config) -> None:
    """Import a diffusers SD directory to the pipeline layout at ``dst``."""
    # the source pipeline's scheduler config wins over the defaults: a
    # checkpoint trained with e.g. other betas must serve with those
    sched_path = os.path.join(src, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_path):
        with open(sched_path) as f:
            sc = json.load(f)
        fields = {f.name for f in dataclasses.fields(type(config.scheduler))}
        overrides = {k: v for k, v in sc.items() if k in fields}
        # fail the import loudly on values the samplers don't implement
        for key, allowed in _SUPPORTED_SCHEDULER.items():
            if key in overrides and overrides[key] not in allowed:
                raise ValueError(
                    f"unsupported scheduler {key}={overrides[key]!r} in "
                    f"{sched_path} (supported: {sorted(allowed)})"
                )
        if overrides:
            config = dataclasses.replace(
                config,
                scheduler=dataclasses.replace(config.scheduler, **overrides),
            )
            print(f"scheduler config from {sched_path}: {overrides}")

    states = ckpt.import_hf_pipeline(src)
    modules = _sd_modules_meta(config)
    modules = {comp: modules[comp] for comp in states}
    for comp, module in modules.items():
        # strict: a missing, extra or misshapen tensor fails the import here
        module.load_state_dict(states[comp], strict=True, assign=True)
    ckpt.save_pipeline(dst, modules, config)
    # tokenizer files ride along so load_tokenizer finds the real BPE
    tok_src = os.path.join(src, "tokenizer")
    for fname in ("vocab.json", "merges.txt"):
        for cand in (os.path.join(tok_src, fname), os.path.join(src, fname)):
            if os.path.exists(cand):
                shutil.copy(cand, os.path.join(dst, fname))
                break
    print(f"imported SD pipeline {src} -> {dst} "
          f"(components: {sorted(states)})")


_REHEARSAL_MERGES = [
    ("t", "h"), ("th", "e</w>"), ("i", "n"), ("r", "e"), ("o", "n"),
    ("a", "n"), ("e", "r"), ("s", "t"), ("e", "n"), ("o", "r"),
    ("a", "l"), ("d", "e"), ("de", "n"), ("den", "o"), ("deno", "i"),
    ("denoi", "s"), ("denois", "e</w>"), ("i", "m"), ("im", "a"),
    ("ima", "g"), ("imag", "e</w>"), ("c", "o"), ("co", "l"),
    ("col", "or"), ("q", "u"), ("qu", "al"), ("i", "t"), ("it", "y</w>"),
    ("h", "i"), ("hi", "g"), ("hig", "h</w>"), ("r", "es"),
    ("e", "s"), ("o", "t"), ("ot", "o</w>"), ("p", "h"), ("ph", "ot"),
]


def build_bpe_assets(tokdir: str, vocab_size=None) -> int:
    """Write CLIP-shaped BPE assets (vocab.json + merges.txt) to tokdir: the
    256 byte-unicode symbols, their </w> forms, a merge table that fires on
    the task prompts, optional <extra_N> padding up to exactly
    ``vocab_size``, and the CLIP special tokens LAST (eos is the largest id,
    as in the real CLIP vocab). Returns the final vocab size."""
    from .models.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    base = [b2u[i] for i in sorted(b2u)]
    vocab = {}
    for s in base:
        vocab[s] = len(vocab)
    for s in base:
        vocab[s + "</w>"] = len(vocab)
    for a, b in _REHEARSAL_MERGES:
        m = a + b
        if m not in vocab:
            vocab[m] = len(vocab)
    if vocab_size is not None:
        need = vocab_size - 2 - len(vocab)
        if need < 0:
            raise ValueError(
                f"vocab_size {vocab_size} < BPE base vocab {len(vocab) + 2}")
        for i in range(need):
            vocab[f"<extra_{i}>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(tokdir, exist_ok=True)
    with open(os.path.join(tokdir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tokdir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        for a, b in _REHEARSAL_MERGES:
            f.write(f"{a} {b}\n")
    return len(vocab)


def hf_clip_name(name: str) -> str:
    """A parameter name of the port's CLIP module -> transformers' (the
    inverse of ``core/checkpoint.port_name``)."""
    if name.startswith(("token_embedding.", "position_embedding.")):
        return "text_model.embeddings." + name
    if name.startswith("layers."):
        return "text_model.encoder." + name.replace(".fc1.", ".mlp.fc1.").replace(
            ".fc2.", ".mlp.fc2.")
    if name.startswith("final_layer_norm."):
        return "text_model." + name
    return name  # text_projection.weight: CLIPTextModelWithProjection's own


def _hf_clip_config(tc) -> dict:
    """text_encoder/config.json: the fields the JAX script passes to
    transformers' ``CLIPTextConfig`` (with its model type); transformers
    takes its defaults for the rest when it reads the file."""
    return {"vocab_size": tc.vocab_size, "hidden_size": tc.hidden_size,
            "intermediate_size": tc.intermediate_size,
            "num_hidden_layers": tc.num_hidden_layers,
            "num_attention_heads": tc.num_attention_heads,
            "max_position_embeddings": tc.max_position_embeddings,
            "bos_token_id": tc.bos_token_id, "eos_token_id": tc.eos_token_id,
            "pad_token_id": tc.pad_token_id, "hidden_act": tc.hidden_act,
            "layer_norm_eps": tc.layer_norm_eps, "model_type": "clip_text_model"}


def make_rehearsal_dir(dst: str, config=None, seed: int = 0, device: DeviceLike = None):
    """Build a FAKE diffusers-layout SD pipeline directory: random weights,
    real names, shapes and file formats.

    The exact directory shape ``import_sd_dir`` expects from a diffusers
    checkout: fp32 safetensors for the UNet and VAE under diffusers names
    (the port's own), the text encoder under transformers' ``text_model.*``
    names without ``position_ids``, tokenizer vocab/merges,
    scheduler/scheduler_config.json and model_index.json. The weights are
    the port's seeded init (``models/layers.init_random_``) on ``device``
    (``cuda`` unless ``"cpu"``). Returns the (possibly vocab-adjusted) config
    the fake pipeline was built with, so ``import_sd_dir(dst, out, cfg)``
    round-trips.
    """
    from .core import sampling
    from .models.layers import init_random_

    if config is None:
        config = C.TINY_SD
    dev = resolve_device(device)
    # tokenizer first: the BPE byte alphabet sets a floor of 551 entries;
    # grow the text tower (and keep eos/pad as the top ids) to fit.
    n_vocab = build_bpe_assets(
        os.path.join(dst, "tokenizer"),
        vocab_size=max(config.text_encoder.vocab_size, 552),
    )
    if n_vocab != config.text_encoder.vocab_size:
        config = dataclasses.replace(
            config,
            text_encoder=dataclasses.replace(
                config.text_encoder, vocab_size=n_vocab,
                bos_token_id=n_vocab - 2, eos_token_id=n_vocab - 1,
                pad_token_id=n_vocab - 1,
            ),
        )

    modules = sampling.SDModules.create(config, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for comp in ("unet", "vae"):
        module = init_random_(getattr(modules, comp), gen)
        os.makedirs(os.path.join(dst, comp), exist_ok=True)
        ckpt.save_safetensors(module.state_dict(), os.path.join(
            dst, comp, "diffusion_pytorch_model.safetensors"))
        with open(os.path.join(dst, comp, "config.json"), "w") as f:
            cls = ("UNet2DConditionModel" if comp == "unet"
                   else "AutoencoderKL")
            json.dump({"_class_name": cls,
                       "in_channels": getattr(config, comp).in_channels},
                      f, indent=2)
        setattr(modules, comp, None)   # free the device memory

    text = init_random_(modules.text_encoder, gen)
    os.makedirs(os.path.join(dst, "text_encoder"), exist_ok=True)
    ckpt.save_safetensors({hf_clip_name(k): v for k, v in text.state_dict().items()},
                          os.path.join(dst, "text_encoder", "model.safetensors"))
    with open(os.path.join(dst, "text_encoder", "config.json"), "w") as f:
        json.dump(_hf_clip_config(config.text_encoder), f, indent=2)
    del modules, text

    os.makedirs(os.path.join(dst, "scheduler"), exist_ok=True)
    with open(os.path.join(dst, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump({"_class_name": "PNDMScheduler",
                   "skip_prk_steps": True,
                   **dataclasses.asdict(config.scheduler)}, f, indent=2)
    with open(os.path.join(dst, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionPipeline",
                   "_diffusers_version": "0.0.0-rehearsal",
                   "unet": ["diffusers", "UNet2DConditionModel"],
                   "vae": ["diffusers", "AutoencoderKL"],
                   "text_encoder": ["transformers", "CLIPTextModel"],
                   "tokenizer": ["transformers", "CLIPTokenizer"],
                   "scheduler": ["diffusers", "PNDMScheduler"]},
                  f, indent=2)
    print(f"rehearsal pipeline dir -> {dst} (vocab {n_vocab})")
    return config


def import_metric_weights(kind: str, src: str, weights_dir: str) -> None:
    """LPIPS / InceptionV3 / RRDBNet torch weights -> the JAX-layout file
    under ``weights_dir`` that both packages load."""
    state = _load_torch_file(src)
    if kind == "lpips":
        from .metrics import perceptual as mod

        model, fname = mod.LPIPSAlex, "lpips_alex.safetensors"
        imported = mod.import_lpips_torch_state(state)
    elif kind == "inception":
        from .metrics import inception as mod

        model, fname = mod.InceptionV3Features, "inception_v3.safetensors"
        imported = mod.import_inception_torch_state(state)
    else:
        from .models import rrdbnet as mod

        model, fname = mod.RRDBNet, "realesrgan_x4.safetensors"
        imported = mod.import_rrdb_torch_state(state)
    with torch.device("meta"):
        module = model()
    # strict: a missing, extra or misshapen tensor fails the import here
    module.load_state_dict(imported, strict=True, assign=True)
    os.makedirs(weights_dir, exist_ok=True)
    out = os.path.join(weights_dir, fname)
    ckpt.save_safetensors(mod.flax_from_params(module.state_dict()), out)
    print(f"imported {kind} weights {src} -> {out}")


# ---------------------------------------------------------------------------
# parity probes
# ---------------------------------------------------------------------------


def _probe_inputs(config=None, image_size: int = 256):
    """Deterministic probe tensors (host-side, framework-agnostic)."""
    rng = np.random.default_rng(42)
    if config is None:
        config = C.SD15
    vs = config.text_encoder.vocab_size
    body = [min(320 + i, vs - 3) for i in range(75)]
    lat = image_size // 8
    return {
        "input_ids": np.array([[vs - 2] + body + [vs - 1]], dtype=np.int32),
        "image": (rng.random((1, image_size, image_size, 3),
                             dtype=np.float32) * 2 - 1),
        "latents": rng.standard_normal((1, lat, lat, 4), dtype=np.float32),
        "timestep": np.array([501], dtype=np.int32),
        "context": rng.standard_normal(
            (1, 77, config.unet.cross_attention_dim), dtype=np.float32) * 0.2,
    }


IMG2IMG_NOISE_SEED = 42


def run_our_probes(pipeline_dir: str, config=None, image_size: int = 256,
                   device: DeviceLike = None) -> dict:
    """Run every module of the imported SD stack on the fixed probes, in fp32
    on ``device`` (``cuda`` unless ``"cpu"``)."""
    from .core import sampling
    from .ops.image import full_fp32

    dev = resolve_device(device)
    if config is None:
        # prefer the config the pipeline was saved with (e.g. the tiny
        # rehearsal stack); fall back to SD1.5
        config = ckpt.load_pipeline_model_config(pipeline_dir) or C.SD15
    probes = {k: torch.from_numpy(v) for k, v in _probe_inputs(config, image_size).items()}
    modules = sampling.SDModules.create(config, dtype=torch.float32, device=dev)
    for comp, state in ckpt.load_state_dicts(pipeline_dir).items():
        modules.components()[comp].load_state_dict(state, strict=True)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    out = {}
    with torch.inference_mode(), full_fp32():
        ctx = sampling.encode_text(modules, probes["input_ids"])
        out["text_encoder"] = host(ctx)
        # deterministic VAE: posterior mode (no sampling) for comparability
        out["vae_encode"] = host(sampling.encode_image(modules, probes["image"].to(dev)))
        out["vae_decode"] = host(sampling.decode_latents(modules, probes["latents"].to(dev)))
        out["unet"] = host(modules.unet(probes["latents"].to(dev), probes["timestep"].to(dev),
                                        probes["context"].to(dev), None))
        fn = sampling.make_img2img_fn(modules, num_inference_steps=5, strength=0.8,
                                      guidance_scale=7.5, sampler="plms")
        vs = config.text_encoder.vocab_size
        uncond_ids = torch.tensor([[vs - 2, vs - 1] + [0] * 75], dtype=torch.int32)
        un = sampling.encode_text(modules, uncond_ids)
        # the noise comes from a CPU generator on every device, so goldens
        # recorded on one device can be checked on another
        gen = torch.Generator().manual_seed(IMG2IMG_NOISE_SEED)
        shape = sampling.latent_shape(modules, probes["image"].shape)
        noise = tuple(torch.randn(shape, generator=gen, dtype=torch.float32) for _ in range(2))
        out["img2img"] = host(fn(probes["image"], ctx, un, noise=noise))
    return out


def run_torch_probes(sd_dir: str) -> dict:
    """Same probes through diffusers/transformers, if importable. NCHW<->NHWC
    conversions at the boundary."""
    try:
        from diffusers import AutoencoderKL, UNet2DConditionModel
        from transformers import CLIPTextModel
    except Exception as e:  # pragma: no cover - env-dependent
        print(f"torch/diffusers unavailable ({e}); skipping torch goldens")
        return {}
    probes = _probe_inputs()
    out = {}
    with torch.no_grad():
        te = CLIPTextModel.from_pretrained(os.path.join(sd_dir, "text_encoder"))
        out["text_encoder_torch"] = te(
            torch.from_numpy(probes["input_ids"]).long()
        ).last_hidden_state.numpy()
        vae = AutoencoderKL.from_pretrained(os.path.join(sd_dir, "vae"))
        img = torch.from_numpy(probes["image"].transpose(0, 3, 1, 2))
        post = vae.encode(img).latent_dist
        out["vae_encode_torch"] = (
            post.mode().numpy().transpose(0, 2, 3, 1) * vae.config.scaling_factor
        )
        lat = torch.from_numpy(probes["latents"].transpose(0, 3, 1, 2))
        dec = vae.decode(lat / vae.config.scaling_factor).sample
        out["vae_decode_torch"] = dec.clamp(-1, 1).numpy().transpose(0, 2, 3, 1)
        unet = UNet2DConditionModel.from_pretrained(os.path.join(sd_dir, "unet"))
        eps = unet(
            lat, torch.from_numpy(probes["timestep"]).long(),
            torch.from_numpy(probes["context"]),
        ).sample
        out["unet_torch"] = eps.numpy().transpose(0, 2, 3, 1)
    return out


def record_goldens(pipeline_dir: str, goldens_dir: str, sd_dir=None,
                   device: DeviceLike = None, image_size: int = 256) -> None:
    os.makedirs(goldens_dir, exist_ok=True)
    arrays = run_our_probes(pipeline_dir, image_size=image_size, device=device)
    if sd_dir:
        arrays.update(run_torch_probes(sd_dir))
    path = os.path.join(goldens_dir, "sd15_goldens.npz")
    np.savez_compressed(path, **arrays)
    print(f"recorded goldens -> {path}: {sorted(arrays)}")
    # cross-framework deltas, when both sides present
    for name in ("text_encoder", "vae_encode", "vae_decode", "unet"):
        tk = f"{name}_torch"
        if tk in arrays:
            d = float(np.abs(arrays[name] - arrays[tk]).max())
            status = "OK" if d <= THRESHOLDS[name] else "FAIL"
            print(f"  {name:<14} ours-vs-torch max|Δ| = {d:.3e}  [{status}]")


def check_goldens(pipeline_dir: str, goldens_dir: str, device: DeviceLike = None) -> int:
    """Run the probes at the goldens' image size and print each max |Δ|;
    returns the number of probes past their threshold."""
    path = os.path.join(goldens_dir, "sd15_goldens.npz")
    ref = dict(np.load(path))
    size = ref["img2img"].shape[1] if "img2img" in ref else 256
    ours = run_our_probes(pipeline_dir, image_size=size, device=device)
    failures = 0
    for name, arr in ours.items():
        # prefer the torch-side golden (cross-framework), else our recording
        target = ref.get(f"{name}_torch", ref.get(name))
        if target is None:
            continue
        d = float(np.abs(arr - target).max())
        thr = THRESHOLDS.get(name, 1e-2)
        status = "OK" if d <= thr else "FAIL"
        failures += status == "FAIL"
        print(f"  {name:<14} max|Δ| = {d:.3e} (thr {thr:g})  [{status}]")
    return failures


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sd15", help="diffusers SD1.5 pipeline directory")
    p.add_argument("--sd_inpaint", help="diffusers SD-inpainting directory")
    p.add_argument("--lpips", help="LPIPS AlexNet torch weights")
    p.add_argument("--inception", help="torchvision inception_v3 weights")
    p.add_argument("--rrdb", help="Real-ESRGAN x4plus weights")
    p.add_argument("--pretrained_root", default="outputs/pretrained",
                   help="Where imported pipelines land (point "
                        "IRET_PRETRAINED_ROOT here to serve them)")
    p.add_argument("--weights_dir",
                   default=os.environ.get("IRET_WEIGHTS_DIR", "weights"))
    p.add_argument("--record_goldens", metavar="DIR",
                   help="Record parity goldens after import")
    p.add_argument("--check_goldens", metavar="DIR",
                   help="Check the imported sd15 stack against recorded goldens")
    p.add_argument("--make_rehearsal", metavar="DIR",
                   help="Build a FAKE diffusers-layout pipeline dir (random "
                        "weights, real names/shapes) to rehearse the import "
                        "path air-gapped; pair with --sd15 <DIR> afterwards")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the rehearsal's init and of the probes")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    rehearsal_cfg = None
    if args.make_rehearsal:
        rehearsal_cfg = make_rehearsal_dir(args.make_rehearsal, device=args.device)

    sd15_out = os.path.join(args.pretrained_root, "sd15")
    if args.sd15:
        cfg = C.SD15
        if rehearsal_cfg is not None and os.path.abspath(
                args.sd15) == os.path.abspath(args.make_rehearsal):
            cfg = rehearsal_cfg  # tiny rehearsal dir: import with its config
        import_sd_dir(args.sd15, sd15_out, cfg)
    if args.sd_inpaint:
        import_sd_dir(args.sd_inpaint,
                      os.path.join(args.pretrained_root, "sd15_inpaint"),
                      C.SD15_INPAINT)
    for kind in ("lpips", "inception", "rrdb"):
        if getattr(args, kind):
            import_metric_weights(kind, getattr(args, kind), args.weights_dir)

    if args.record_goldens:
        record_goldens(sd15_out, args.record_goldens, sd_dir=args.sd15, device=args.device)
    if args.check_goldens:
        if check_goldens(sd15_out, args.check_goldens, device=args.device):
            return 1
    if not any([args.sd15, args.sd_inpaint, args.lpips, args.inception,
                args.rrdb, args.record_goldens, args.check_goldens, args.make_rehearsal]):
        p.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
