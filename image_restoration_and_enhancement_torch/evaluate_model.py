"""Evaluate predictions against ground truth for all tasks -> JSON + table.

The port's counterpart of the JAX package's ``scripts/evaluate_model.py``,
with the same flags and JSON keys: per task PSNR/SSIM (the Y variants for
denoise and sr_x4, PSNR/SSIM on L and ΔE for colorize; LPIPS when its
weights exist), FID only for colorize and inpaint, the do-nothing input
baseline (input against gt), the paired per-image output-minus-input deltas
and ``beats_input_baseline``; written to ``--out_json``. A requested task
whose prediction or gt directory is missing fails the run (exit 1) unless
``--allow_missing``.

    python -m image_restoration_and_enhancement_torch.evaluate_model \\
        --pred_root outputs/predictions --data_root data/pairs \\
        --out_json outputs/evaluation_results.json [--device cuda]

Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from .metrics.evaluate import evaluate_task, paired_delta_stats, print_results
from .tasks.registry import TASKS


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pred_root", default="outputs/predictions")
    p.add_argument("--data_root", default="data/pairs")
    p.add_argument("--split", default="test")
    p.add_argument("--tasks", nargs="+", default=list(TASKS), choices=list(TASKS))
    p.add_argument("--out_json", default="outputs/evaluation_results.json")
    p.add_argument("--use_lpips", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use_fid", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--input_baseline", action=argparse.BooleanOptionalAction, default=True,
                   help="also evaluate the degraded input dir against gt: the "
                        "do-nothing baseline every output metric is read against")
    p.add_argument("--allow_missing", action="store_true",
                   help="skip a requested task whose directories are missing "
                        "instead of failing the run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    results = {}
    missing = []
    for task in args.tasks:
        spec = TASKS[task]
        pred_dir = os.path.join(args.pred_root, spec.pair_dir)
        gt_dir = os.path.join(args.data_root, spec.pair_dir, args.split, "gt")
        if not (os.path.isdir(pred_dir) and os.path.isdir(gt_dir)):
            missing.append(task)
            print(f"[{task}] MISSING dirs (pred={pred_dir} gt={gt_dir})"
                  + (", skipping" if args.allow_missing else ""))
            continue
        res = evaluate_task(
            pred_dir, gt_dir,
            with_color=spec.with_color_metrics, with_y=spec.with_y_metrics,
            use_lpips=args.use_lpips,
            use_fid=args.use_fid and task in ("colorize", "inpaint"),
            return_per_image=True, device=args.device,
        )
        if args.input_baseline:
            in_dir = os.path.join(args.data_root, spec.pair_dir, args.split, "input")
            if os.path.isdir(in_dir):
                base = evaluate_task(
                    in_dir, gt_dir,
                    with_color=spec.with_color_metrics, with_y=spec.with_y_metrics,
                    use_lpips=False, use_fid=False, return_per_image=True,
                    device=args.device,
                )
                res["input_baseline"] = base["metrics"]
                res["paired_delta"] = {
                    name: d
                    for name in res["per_image"]
                    if name in base["per_image"]
                    and (d := paired_delta_stats(
                        res["per_image"][name], base["per_image"][name]
                    )) is not None
                }
                res["beats_input_baseline"] = bool(
                    res["metrics"]["psnr"]["mean"] > base["metrics"]["psnr"]["mean"])
        # per-image values feed the paired stats; keep the JSON compact
        res.pop("per_image", None)
        results[task] = res
        print_results(task, res)

    out_dir = os.path.dirname(args.out_json)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nwrote {args.out_json}")
    if missing and not args.allow_missing:
        print(f"FAIL: requested tasks with missing dirs: {missing}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
