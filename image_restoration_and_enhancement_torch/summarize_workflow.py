"""Summarize a workflow run (metrics CSVs, training logs, evaluation JSON) as
a markdown table.

The port's counterpart of the JAX package's ``scripts/summarize_workflow.py``:
the same text from the same files. It reads the artifact layout the workflow
runner collects (docs/artifacts/realrun_full by default, or outputs/models
directly) and prints per task: epochs completed, best val PSNR/SSIM (and
epoch), final train loss, the warm epoch's seconds from the training log,
the input-vs-gt baseline the trainer logs, and the test-split metrics of
``evaluate_model``'s JSON when present (entries that are not a task's
results, such as the committed record's "_provenance" note, are skipped:
the JAX script stops on them). The reference columns come from BASELINE.md
(A100 fp16, the same recipe). The trainers of both packages write the log
lines the two patterns below read.

    python -m image_restoration_and_enhancement_torch.summarize_workflow \\
        [--artifacts docs/artifacts/realrun_full] [--models_root outputs/models]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import re
from typing import List, Optional

TASKS = {
    "denoise": ("denoising", "metrics_denoise.csv", "training_denoise.log"),
    "sr_x4": ("super_resolution", "metrics_sr_x4.csv", "training_sr_x4.log"),
    "colorize": ("colorization", "metrics_colorize.csv", "training_colorize.log"),
    "inpaint": ("inpainting", "metrics_inpaint.csv", "training_inpaint.log"),
}

# reference published val numbers + epoch wall-clock (BASELINE.md)
REF = {
    "denoise": (13.76, 0.1786, "14m53s"),
    "sr_x4": (9.73, 0.0955, "20m30s"),
    "colorize": (8.24, 0.0668, "23m07s"),
    "inpaint": (9.75, 0.0802, "28m00s"),
}

EPOCH_RE = re.compile(
    r"epoch (\d+)/(\d+) loss ([\d.]+) val .*?\(([\d.]+)s\)"
)
# the do-nothing baseline run_validation logs once per run: output PSNR is
# only meaningful relative to it
INPUT_PSNR_RE = re.compile(r"val input-vs-gt baseline psnr ([\d.]+)")


def find_file(name, roots):
    for r in roots:
        p = os.path.join(r, name)
        if os.path.exists(p):
            return p
    return None


def summarize(art_root: str, models_root: str, eval_json: str) -> str:
    lines = []
    for vname, vlabel in [("metrics_vae.csv", "VAE pretrain (stage 0)"),
                          ("metrics_vae_run2.csv", "VAE pretrain (run 2)"),
                          ("metrics_vae_run3.csv",
                           "VAE pretrain (run 3, post-reset)")]:
        vae_csv = find_file(vname,
                            [art_root, os.path.join(models_root, "vae_pretrained")])
        if not vae_csv:
            continue
        with open(vae_csv) as f:
            vrows = list(csv.DictReader(f))
        if vrows:
            vbest = max(vrows, key=lambda r: float(r["psnr"]))
            lines.append(
                f"{vlabel}: {len(vrows)} epochs, recon PSNR "
                f"{float(vrows[0]['psnr']):.2f} -> {float(vbest['psnr']):.2f} dB "
                f"(best ep {vbest['epoch']}), scaled-latent std "
                f"{float(vrows[-1]['latent_std']):.3f}"
            )
            lines.append("")
    lines += [
        "| task | epochs | val PSNR ep1 -> best (epoch) | SSIM ep1 -> best | "
        "Y/L-PSNR ep1 -> final | input PSNR | final loss | warm epoch (s) | "
        "ref best PSNR/SSIM | ref epoch |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    # run-2 checkpoint-restore retrains (VM-reset recovery; see
    # docs/WORKFLOW.md "Two runs") get their own rows so they never
    # masquerade as the full run-1 curves.
    task_rows = [(t, spec, "") for t, spec in TASKS.items()]
    for t, (model_dir, csv_name, log_name) in TASKS.items():
        base, ext = os.path.splitext(csv_name)
        lbase, lext = os.path.splitext(log_name)
        for suffix, label in (("_run2", "run-2 retrain"),
                              ("_run3", "run-3 full rerun")):
            if find_file(f"{base}{suffix}{ext}", [art_root]):
                task_rows.append(
                    (f"{t} ({label})",
                     (model_dir, f"{base}{suffix}{ext}",
                      f"{lbase}{suffix}{lext}"),
                     suffix))
    for task, (model_dir, csv_name, log_name), _suffix in task_rows:
        roots = [art_root, os.path.join(models_root, model_dir)]
        cpath = find_file(csv_name, roots)
        if cpath is None:
            lines.append(f"| {task} | — | (no artifacts) | | | | | | | |")
            continue
        with open(cpath) as f:
            rows = list(csv.DictReader(f))
        if not rows:
            continue
        best = max(rows, key=lambda r: float(r["psnr"]))
        n_epochs = rows[-1]["epoch"]
        final_loss = float(rows[-1]["train_loss"])
        # warm epoch time = median of per-epoch durations after the first;
        # input-vs-gt baseline PSNR from the run log
        epoch_secs = []
        input_psnr = ""
        lpath = find_file(log_name, roots)
        if lpath:
            with open(lpath, errors="replace") as f:
                for line in f:
                    m = EPOCH_RE.search(line)
                    if m:
                        epoch_secs.append(float(m.group(4)))
                    m = INPUT_PSNR_RE.search(line)
                    if m:
                        input_psnr = f"{float(m.group(1)):.2f}"
        warm = ""
        if len(epoch_secs) > 1:
            tail = sorted(epoch_secs[1:])
            warm = f"{tail[len(tail) // 2]:.0f}"
        ref_p, ref_s, ref_t = REF[task.split(" ")[0]]
        sbest = max(rows, key=lambda r: float(r["ssim"]))
        ssim_col = (f"{float(rows[0]['ssim']):.4f} -> "
                    f"{float(sbest['ssim']):.4f} (ep {sbest['epoch']})")
        # luma-channel trend (psnr_y for denoise/sr, psnr_l for colorize) —
        # the restoration signal an undertrained eps-predictor's color cast
        # hides from RGB PSNR
        ykey = next((k for k in ("psnr_y", "psnr_l") if rows[0].get(k)), None)
        y_col = (f"{float(rows[0][ykey]):.2f} -> {float(rows[-1][ykey]):.2f}"
                 if ykey else "")
        lines.append(
            f"| {task} | {n_epochs} | {float(rows[0]['psnr']):.2f} -> "
            f"{float(best['psnr']):.2f} (ep {best['epoch']}) | "
            f"{ssim_col} | {y_col} | {input_psnr} | "
            f"{final_loss:.4f} | {warm} | {ref_p:.2f} / {ref_s:.4f} | {ref_t} |"
        )
    ep = find_file(os.path.basename(eval_json),
                   [os.path.dirname(eval_json) or ".", art_root])
    if ep:
        with open(ep) as f:
            ev = json.load(f)
        lines.append("")
        lines.append("Test-split evaluation (evaluate_model.py):")
        lines.append("")
        lines.append("| task | n | PSNR | SSIM | input PSNR | paired ΔPSNR "
                     "(output−input) | 95% CI | win-rate | beats input? |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
        for task, res in ev.items():
            if not isinstance(res, dict):
                continue   # a note beside the tasks, as the record's "_provenance"
            m = res.get("metrics", {})
            ib = res.get("input_baseline", {})
            pd = res.get("paired_delta", {}).get("psnr")
            lines.append(
                f"| {task} | {res.get('num_images', '')} "
                f"| {m.get('psnr', {}).get('mean', float('nan')):.2f} "
                f"| {m.get('ssim', {}).get('mean', float('nan')):.3f} "
                f"| {ib.get('psnr', {}).get('mean', float('nan')):.2f} "
                + (f"| {pd['mean']:+.3f} | [{pd['ci95'][0]:+.3f}, "
                   f"{pd['ci95'][1]:+.3f}] | {pd['win_rate']:.2f} "
                   if pd else "| | | ")
                + f"| {'**yes**' if res.get('beats_input_baseline') else 'no'} |"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifacts", default=os.path.join("docs", "artifacts", "realrun_full"))
    p.add_argument("--models_root", default=os.path.join("outputs", "models"))
    p.add_argument("--eval_json", default=os.path.join("outputs", "evaluation_results.json"))
    args = p.parse_args(argv)
    print(summarize(args.artifacts, args.models_root, args.eval_json))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
