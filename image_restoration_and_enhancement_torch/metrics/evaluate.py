"""Directory-level evaluation (the port's copy of the JAX package's
``metrics/evaluate.py``).

Prediction and ground-truth files are matched by filename stem across
extensions, per-image PSNR/SSIM (and the Y / colour variants) are computed,
optionally LPIPS and a dataset-level FID, and each metric is reported as
mean/std/min/max/median. Images are loaded on the host, bucketed by
resolution and scored one batch at a time with one call of the metric bundle
on ``device`` (``cuda`` unless ``"cpu"`` is asked for); a prediction whose
size differs from its ground truth is first resized to it with PIL's LANCZOS
(``infer.imaging.resize_lanczos_pil``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import _list_stems
from ..data.png import load_image
from ..device import DeviceLike, resolve_device
from ..infer.imaging import resize_lanczos_pil
from . import functional as F


def _stats(values: List[float]) -> Dict[str, float]:
    arr = np.asarray(values, dtype=np.float64)
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "median": float(np.median(arr)),
    }


def paired_delta_stats(
    out_per_image: Dict[str, float], base_per_image: Dict[str, float]
) -> Optional[Dict[str, float]]:
    """Paired per-image statistics of output-vs-baseline metric deltas: mean
    delta, normal-approximation 95% CI of the mean, and win-rate (the share
    of images where the output strictly beats the baseline), over the stems
    both hold. None when fewer than 2 stems match."""
    stems = sorted(set(out_per_image) & set(base_per_image))
    if len(stems) < 2:
        return None
    d = np.asarray(
        [out_per_image[s] - base_per_image[s] for s in stems], dtype=np.float64
    )
    n = len(d)
    sem = float(d.std(ddof=1)) / np.sqrt(n)
    mean = float(d.mean())
    return {
        "n": n,
        "mean": mean,
        "ci95": [mean - 1.96 * sem, mean + 1.96 * sem],
        "win_rate": float((d > 0).mean()),
    }


def evaluate_task(
    pred_dir: str,
    gt_dir: str,
    with_color: bool = False,
    with_y: bool = False,
    use_lpips: bool = False,
    use_fid: bool = False,
    batch_size: int = 16,
    resize_to_gt: bool = True,
    return_per_image: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Evaluate all matched pred/gt pairs: {metrics: {name: stats}, num_images,
    (lpips / fid when enabled and their weights are available)}.

    With return_per_image=True the result also carries ``per_image: {metric:
    {stem: value}}`` for paired statistics between two evaluations."""
    dev = resolve_device(device)
    preds = _list_stems(pred_dir)
    gts = _list_stems(gt_dir)
    stems = sorted(set(preds) & set(gts))
    if not stems:
        raise FileNotFoundError(f"No matched pairs between {pred_dir} and {gt_dir}")

    # bucket by gt resolution so each bucket evaluates in batches
    buckets: Dict[Tuple[int, int], List[Tuple[str, np.ndarray, np.ndarray]]] = {}
    for s in stems:
        gt = load_image(gts[s], "RGB")
        pr = load_image(preds[s], "RGB")
        if resize_to_gt and pr.shape[:2] != gt.shape[:2]:
            pr = resize_lanczos_pil(pr, gt.shape[:2])
        buckets.setdefault(gt.shape[:2], []).append(
            (s, pr.astype(np.float32) / 255.0, gt.astype(np.float32) / 255.0))

    acc: Dict[str, List[float]] = {}
    per_image: Dict[str, Dict[str, float]] = {}
    with torch.inference_mode():
        for pairs in buckets.values():
            for i in range(0, len(pairs), batch_size):
                chunk = pairs[i: i + batch_size]
                pb = torch.from_numpy(np.stack([p for _, p, _ in chunk])).to(dev)
                gb = torch.from_numpy(np.stack([g for _, _, g in chunk])).to(dev)
                out = F.calculate_all(pb, gb, with_color=with_color, with_y=with_y)
                for name, vals in out.items():
                    vals = vals.cpu().tolist()
                    acc.setdefault(name, []).extend(vals)
                    dst = per_image.setdefault(name, {})
                    for (stem, _, _), v in zip(chunk, vals):
                        dst[stem] = float(v)

    result = {
        "num_images": len(stems),
        "metrics": {name: _stats(vals) for name, vals in acc.items()},
    }
    if return_per_image:
        result["per_image"] = per_image

    if use_lpips or use_fid:
        from . import perceptual

        flat = [(p, g) for pairs in buckets.values() for _, p, g in pairs]
        if use_lpips and perceptual.lpips_available():
            lp = perceptual.lpips_pairs([p for p, _ in flat], [g for _, g in flat], dev)
            result["metrics"]["lpips"] = _stats(lp)
        if use_fid and (perceptual.fid_available() or perceptual.fid_random_init_ok()):
            # with imported weights a real FID; in the IRET_FID_RANDOM_INIT=1
            # mode the number is keyed so that it is never taken for one
            key = "fid" if perceptual.fid_available() else "fid_random_init_weights_pending"
            result[key] = perceptual.fid([p for p, _ in flat], [g for _, g in flat], dev)
    return result


def print_results(task: str, result: Dict) -> None:
    print(f"\n=== {task} ({result['num_images']} images) ===")
    for name, stats in sorted(result["metrics"].items()):
        print(
            f"  {name:8s} mean {stats['mean']:.4f}  std {stats['std']:.4f}  "
            f"min {stats['min']:.4f}  max {stats['max']:.4f}  median {stats['median']:.4f}"
        )
    if "fid" in result:
        print(f"  fid      {result['fid']:.4f}")
    if "fid_random_init_weights_pending" in result:
        print(f"  fid (RANDOM-INIT trunk, weights pending — pipeline "
              f"exercise only) {result['fid_random_init_weights_pending']:.4f}")
    if "input_baseline" in result:
        ib = result["input_baseline"]
        print(f"  input-vs-gt do-nothing baseline: psnr "
              f"{ib['psnr']['mean']:.4f}  ssim {ib['ssim']['mean']:.4f}")
    for name, d in sorted(result.get("paired_delta", {}).items()):
        print(
            f"  paired Δ{name} (output−input, n={d['n']}): "
            f"mean {d['mean']:+.4f}  95% CI [{d['ci95'][0]:+.4f}, "
            f"{d['ci95'][1]:+.4f}]  win-rate {d['win_rate']:.2f}"
        )
