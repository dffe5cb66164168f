"""The learning demo's exchange of VAEs and stage-3 trainers between the JAX
package and the port, on the CPU in fp32.

Each seed's directory holds the demo's data (``gen_data(out, 64, 80.0, 128,
8, seed)``), a VAE stage from each package (``vae_jax/``, ``vae_port/``;
the demo's stage 2: 40 epochs on the clean split, batch 8, lr 1e-3) and the
port's VAE written in the JAX package's own layout (``vae_port_as_jax/``:
the port's ``flax_from_params``, then JAX's ``unflatten_params`` and
``save_pipeline``). A stage-3 cell (``s3_{trainer}_on_{vae}/``) is the demo's
stage 3 (80 epochs at lr 2e-4 under the demo task spec) run by one
package's demo script on one package's VAE, copied in as
``vae_pretrained/`` beside a link to the seed's ``pairs/``, so stages 1 and
2 are skipped and the script trains from its own UNet and text init.

    python tests/demo_exchange.py vae --side {jax,port} --seed S --root D
    python tests/demo_exchange.py convert --seed S --root D
    python tests/demo_exchange.py stage3 --trainer {jax,port} --vae {jax,port} --seed S --root D
    python tests/demo_exchange.py stats --seed S --root D     # latent statistics, JSON
    python tests/demo_exchange.py table --root D              # every cell's readings, JSON

``--vae_epochs`` / ``--epochs`` cut the protocol (``test_torch_demo_exchange.py``'s
slow test runs it at a cut epoch count).
"""
from __future__ import annotations

import argparse
import csv
import functools
import importlib.util
import json
import os
import shutil
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

SIZE, SIGMA, N_TRAIN, N_VAL = 64, 80.0, 128, 8
VAE_EPOCHS, EPOCHS = 40, 80
SIDES = ("jax", "port")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


@functools.cache
def jax_demo():
    """The JAX package's demo script (``scripts/demo_restoration_learning.py``),
    loaded by path."""
    _jax()
    spec = importlib.util.spec_from_file_location(
        "jax_script_demo_restoration_learning",
        os.path.join(_ROOT, "scripts", "demo_restoration_learning.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seed_dir(root: str, seed: int) -> str:
    return os.path.join(root, f"seed{seed}")


def make_data(root: str, seed: int) -> str:
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo

    out = seed_dir(root, seed)
    if not os.path.isdir(os.path.join(out, "pairs", "denoise", "val", "gt")):
        tdemo.gen_data(out, SIZE, SIGMA, N_TRAIN, N_VAL, seed)
    return out


def vae_stage(side: str, root: str, seed: int, epochs: int = VAE_EPOCHS) -> dict:
    """One package's demo stage 2 into ``seed{seed}/vae_{side}``; its last
    validation metrics."""
    out = make_data(root, seed)
    dst = os.path.join(out, f"vae_{side}")
    kw = dict(num_epochs=epochs, batch_size=8, learning_rate=1e-3, image_size=SIZE, seed=seed)
    if side == "jax":
        _jax()
        import jax.numpy as jnp
        from image_restoration_and_enhancement_tpu.train import vae_pretrain as JV

        return JV.pretrain_vae(os.path.join(out, "clean"), dst, JV.VAEPretrainConfig(**kw),
                               model_config=jax_demo().demo_model_config(), use_mesh=False,
                               dtype=jnp.float32)
    import torch
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo
    from image_restoration_and_enhancement_torch.train import vae_pretrain as TV

    return TV.pretrain_vae(os.path.join(out, "clean"), dst, TV.VAEPretrainConfig(**kw),
                           model_config=tdemo.demo_model_config(), use_mesh=False,
                           dtype=torch.float32, device="cpu")


def port_vae_as_jax(src: str, dst: str) -> None:
    """The port's pipeline ``src`` (its ``vae``) rewritten by the JAX package's
    own ``save_pipeline``: the port's state dict through ``flax_from_params``
    into JAX's nested params."""
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo
    from image_restoration_and_enhancement_torch.core import checkpoint as tck
    from image_restoration_and_enhancement_torch.models.vae import AutoencoderKL
    from image_restoration_and_enhancement_tpu.core import checkpoint as jck

    config = jax_demo().demo_model_config()
    state = tck.load_state_dicts(src)["vae"]
    norms = tck.norm_module_names(AutoencoderKL(tdemo.demo_model_config().vae))
    flat = {k: v.numpy() for k, v in tck.flax_from_params(state, norms).items()}
    jck.save_pipeline(dst, {"vae": jck.unflatten_params(flat)}, config)


def convert(root: str, seed: int) -> str:
    out = seed_dir(root, seed)
    dst = os.path.join(out, "vae_port_as_jax", "best")
    port_vae_as_jax(os.path.join(out, "vae_port", "best"), dst)
    return dst


def _val_images(out: str) -> np.ndarray:
    from image_restoration_and_enhancement_torch.data.png import load_image

    d = os.path.join(out, "clean", "val")
    return np.stack([load_image(os.path.join(d, f)).astype(np.float32) / 127.5 - 1.0
                     for f in sorted(os.listdir(d))])


def port_round_trip(vae_best: str, images: np.ndarray):
    """The port's VAE from ``vae_best``: (decode(posterior mean), posterior
    mean) of ``images`` [N, H, W, 3] in [-1, 1], fp32 on the CPU."""
    import torch
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo
    from image_restoration_and_enhancement_torch.core import checkpoint as tck
    from image_restoration_and_enhancement_torch.models.vae import AutoencoderKL

    vae = AutoencoderKL(tdemo.demo_model_config().vae)
    vae.load_state_dict(tck.load_state_dicts(vae_best)["vae"], strict=True)
    with torch.no_grad():
        x = torch.from_numpy(images)
        z = vae.encode(x).mean
        return vae.decode(z).numpy(), z.numpy()


def jax_round_trip(vae_best: str, images: np.ndarray):
    """The same through the JAX package's VAE and its ``load_pipeline``."""
    config = jax_demo().demo_model_config()
    import jax.numpy as jnp
    from image_restoration_and_enhancement_tpu.core import checkpoint as jck
    from image_restoration_and_enhancement_tpu.models.vae import AutoencoderKL

    vae = AutoencoderKL(config.vae, dtype=jnp.float32)
    params = jck.load_pipeline(vae_best)["vae"]
    x = jnp.asarray(images)
    post = vae.apply({"params": params}, x, method=vae.encode)
    recon = vae.apply({"params": params}, post.mean, method=vae.decode)
    return np.asarray(recon), np.asarray(post.mean)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-image PSNR of two [-1, 1] batches, on [0, 1]."""
    a, b = (a.astype(np.float64) + 1) / 2, (b.astype(np.float64) + 1) / 2
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2, axis=(1, 2, 3))
    return float(np.mean(10 * np.log10(1.0 / np.maximum(mse, 1e-10))))


def latent_stats(vae_best: str, images: np.ndarray, sf: float) -> dict:
    """The val set's scaled posterior mean: pooled std (over the whole set),
    mean and std per latent channel, the second moment's two parts (the mean
    over channels of the within-channel variance, and of the squared channel
    mean); the round trip's PSNR."""
    recon, z = port_round_trip(vae_best, images)
    zs = z.astype(np.float64) * sf
    flat = zs.reshape(-1, zs.shape[-1])
    mean, std = flat.mean(0), flat.std(0)
    return {"pooled_std": float(zs.std()),
            "channel_mean": [float(v) for v in mean], "channel_std": [float(v) for v in std],
            "within_var": float(np.mean(std ** 2)), "mean_sq": float(np.mean(mean ** 2)),
            "round_trip_psnr": _psnr(recon, images)}


def stats(root: str, seed: int) -> dict:
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo

    out = seed_dir(root, seed)
    images = _val_images(out)
    sf = tdemo.demo_model_config().vae.scaling_factor
    res = {}
    for side in SIDES:
        best = os.path.join(out, f"vae_{side}", "best")
        if os.path.isdir(best):
            res[side] = latent_stats(best, images, sf)
    conv = os.path.join(out, "vae_port_as_jax", "best")
    if os.path.isdir(conv):
        p_recon, p_z = port_round_trip(os.path.join(out, "vae_port", "best"), images)
        j_recon, j_z = jax_round_trip(conv, images)
        res["conversion"] = {"max_abs_recon": float(np.abs(p_recon - j_recon).max()),
                             "max_abs_latent": float(np.abs(p_z - j_z).max()),
                             "port_psnr": _psnr(p_recon, images),
                             "jax_psnr": _psnr(j_recon, images)}
    return res


def stage3_dir(root: str, seed: int, trainer: str, vae: str) -> str:
    return os.path.join(seed_dir(root, seed), f"s3_{trainer}_on_{vae}")


def stage3(trainer: str, vae: str, root: str, seed: int, epochs: int = EPOCHS) -> dict:
    """One package's demo stage 3 on one package's VAE; the summary's curve."""
    out = seed_dir(root, seed)
    run = stage3_dir(root, seed, trainer, vae)
    os.makedirs(run, exist_ok=True)
    if not os.path.exists(os.path.join(run, "pairs")):
        os.symlink(os.path.join(out, "pairs"), os.path.join(run, "pairs"))
    # JAX's trainer reads a port VAE in JAX's own layout
    src = {("jax", "jax"): "vae_jax", ("port", "jax"): "vae_jax",
           ("port", "port"): "vae_port", ("jax", "port"): "vae_port_as_jax"}[(trainer, vae)]
    dst = os.path.join(run, "vae_pretrained", "best")
    if not os.path.isdir(dst):
        shutil.copytree(os.path.join(out, src, "best"), dst)
    argv = ["--out", run, "--seed", str(seed), "--epochs", str(epochs),
            "--vae_epochs", str(VAE_EPOCHS), "--artifact_dir", os.path.join(run, "artifacts")]
    if trainer == "jax":
        jdemo = jax_demo()
        saved = sys.argv
        sys.argv = ["demo_restoration_learning.py", *argv, "--platform", "cpu"]
        try:
            jdemo.main()
        finally:
            sys.argv = saved
    else:
        from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo

        tdemo.main([*argv, "--device", "cpu"])
    return curve(run)


def curve(run: str) -> dict:
    """Epoch 1, best (epoch) and final val PSNR of a stage-3 run's last
    training (its metrics CSV)."""
    from image_restoration_and_enhancement_torch.demo_restoration_learning import last_run_rows

    rows = last_run_rows(os.path.join(run, "model", "metrics_denoise.csv"))
    psnrs = [float(r["psnr"]) for r in rows]
    best = int(np.argmax(psnrs))
    return {"epoch1": psnrs[0], "best": psnrs[best], "best_epoch": int(float(rows[best]["epoch"])),
            "final": psnrs[-1], "epochs": len(psnrs)}


def vae_final(out: str, side: str) -> dict:
    with open(os.path.join(out, f"vae_{side}", "metrics_vae.csv")) as f:
        rows = list(csv.DictReader(f))
    return {k: float(rows[-1][k]) for k in ("psnr", "latent_std")} | {"epochs": len(rows)}


def table(root: str) -> dict:
    """Every seed's VAE finals, latent statistics and stage-3 curves; the
    decision rule over them ("rule") and how the stage-3 best follows each
    VAE ("relation")."""
    from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo

    res = {}
    for name in sorted(os.listdir(root)):
        out = os.path.join(root, name)
        if not name.startswith("seed"):
            continue
        entry = {}
        for side in SIDES:
            if os.path.exists(os.path.join(out, f"vae_{side}", "metrics_vae.csv")):
                entry[f"vae_{side}"] = vae_final(out, side)
                entry[f"latent_{side}"] = latent_stats(
                    os.path.join(out, f"vae_{side}", "best"), _val_images(out),
                    tdemo.demo_model_config().vae.scaling_factor)
        for run in sorted(os.listdir(out)):
            if run.startswith("s3_") and os.path.exists(
                    os.path.join(out, run, "model", "metrics_denoise.csv")):
                entry[run] = curve(os.path.join(out, run))
        res[name] = entry
    res["rule"] = decide(res)
    res["relation"] = relate(res)
    return res


def relate(cells: dict) -> dict:
    """Over the VAEs with both stage-3 codes run on them: the correlation of
    the two codes' bests, and of their mean best with each latent statistic."""
    rows = []
    for seed, entry in cells.items():
        for vae in SIDES if seed.startswith("seed") else ():
            runs = [entry.get(f"s3_{t}_on_{vae}") for t in SIDES]
            if all(runs) and f"latent_{vae}" in entry:
                rows.append((entry[f"latent_{vae}"], [r["best"] for r in runs]))
    if len(rows) < 3:
        return {}
    bests = np.array([b for _, b in rows])
    mean = bests.mean(1)
    r = lambda x, y: float(np.corrcoef(x, y)[0, 1])  # noqa: E731
    return {"vaes": len(rows), "jax_vs_port_best": r(bests[:, 0], bests[:, 1]),
            **{f"best_vs_{k}": r([lat[k] for lat, _ in rows], mean)
               for k in ("pooled_std", "within_var", "mean_sq", "round_trip_psnr")}}


def decide(cells: dict, margin: float = 0.5) -> dict:
    """The decision rule over the stage-3 bests of ``table``'s cells: JAX's
    spread (std, ddof 1, of its own chain's best over the seeds), the limit
    max(margin, spread), and whether (a) stage 3 or (b) the VAE stage is at
    fault; (c) when neither."""
    best = {(k[3:].split("_on_")[0], k.split("_on_")[1], seed): v["best"]
            for seed, entry in cells.items() if seed.startswith("seed")
            for k, v in entry.items() if k.startswith("s3_")}
    seeds = sorted({s for _, _, s in best})
    own = [best["jax", "jax", s] for s in seeds if ("jax", "jax", s) in best]
    spread = float(np.std(own, ddof=1)) if len(own) > 1 else 0.0
    limit = max(margin, spread)
    # (a): on the same VAE the port trails JAX by more than the limit on every seed measured
    pairs = [best["jax", v, s] - best["port", v, s] for v in SIDES for s in seeds
             if ("jax", v, s) in best and ("port", v, s) in best]
    # (b): both codes lower on the port's VAEs than on JAX's, by more than the limit in the mean
    drop = {t: [best[t, "jax", s] - best[t, "port", s] for s in seeds
                if (t, "jax", s) in best and (t, "port", s) in best] for t in SIDES}
    a = bool(pairs) and all(d > limit for d in pairs)
    b = all(drop[t] and float(np.mean(drop[t])) > limit for t in SIDES)
    mean = {f"{t}_on_{v}": float(np.mean([best[t, v, s] for s in seeds if (t, v, s) in best]))
            for t in SIDES for v in SIDES if any((t, v, s) in best for s in seeds)}
    return {"spread": spread, "limit": limit, "jax_minus_port_same_vae": pairs,
            "jax_vae_minus_port_vae": {t: float(np.mean(d)) if d else None
                                       for t, d in drop.items()},
            "mean_best": mean, "a": a, "b": b, "branch": "a" if a else "b" if b else "c"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["vae", "convert", "stage3", "stats", "table"])
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--side", choices=SIDES)
    p.add_argument("--trainer", choices=SIDES)
    p.add_argument("--vae", choices=SIDES)
    p.add_argument("--vae_epochs", type=int, default=VAE_EPOCHS)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    a = p.parse_args(argv)
    if a.what == "vae":
        res = vae_stage(a.side, a.root, a.seed, a.vae_epochs)
    elif a.what == "convert":
        res = {"written": convert(a.root, a.seed)}
    elif a.what == "stage3":
        res = stage3(a.trainer, a.vae, a.root, a.seed, a.epochs)
    elif a.what == "stats":
        res = stats(a.root, a.seed)
    else:
        res = table(a.root)
    print(json.dumps(res, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
