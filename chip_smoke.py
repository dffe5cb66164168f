#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its CUDA kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  build     compile csrc/*.cu with one nvcc call (ops/_build.py) and load it.
  parity    small inputs, CUDA kernels against the plain versions on the CPU:
            the TINY_SD img2img function end to end, and one full-width SD-1.5
            UNet call at 32x32 latents, both in fp32.
  serve     initialise the full SD-1.5 stack (UNet, VAE, CLIP-L) at random from
            a seeded generator, write it in bf16 with the port's own safetensors
            writer to a temporary directory outside the checkout, and answer
            four 512x512 denoise requests through RestorationPipeline: the task
            default (strength 0.5, 20-step PLMS, gs 5.0, so CFG batch 2), one
            with guidance=1.0 (no CFG branch), then both again (steady state).
            Launch counts are zeroed just before and read just after; both
            kernels must have launched. A CUDA pipeline has no OpenCV
            fallback: any failure of a request raises and fails this run.
  kernels   every kernel at every shape the serve launched it with (plus the
            fp32, eps and mean-5000 cases): kernel against plain version on the
            same bf16 inputs, max abs error within the stated tolerance, and
            kernel / plain / library times with CUDA events.

Kernel-vs-plain limits are ops/tolerance.py's: fp32 1e-4 absolute and
relative; bf16 |got - ref| <= share * max|ref| + 2**-7 * |ref| elementwise (one
bf16 step of each value plus a share of the largest: 2**-8 for attention,
2**-10 for GroupNorm).

fp32 references run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are set False at start). The library calls
(F.scaled_dot_product_attention, F.group_norm) are timed as yardsticks only;
the port never calls them.

The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 1234
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
PARITY_TOL = 2e-3     # fp32 end to end, images in [-1, 1]
UNET_REL_TOL = 1e-3   # fp32 full-width UNet eps, relative to max |eps|


def log(msg: str) -> None:
    print(msg, flush=True)


class _Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from image_restoration_and_enhancement_torch.ops import _build

    with _Phase("build"):
        _build.library()
        info = _build.build_info
        log(f"kernels library {info['path']} built={info['built']} "
            f"in {info['seconds']:.2f} s")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", str(info["log"]))]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", str(info["log"]))]
        if regs:
            log(f"ptxas: {len(regs)} kernels, at most {max(regs)} registers a thread, "
                f"{sum(spills)} bytes of spill stores and loads in all")


def phase_parity():
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    with _Phase("parity"):
        # TINY_SD end to end: the same weights and noise on CPU (plain) and CUDA (kernels).
        gen = torch.Generator().manual_seed(SEED)
        cpu = sampling.SDModules.create(C.TINY_SD, torch.float32, "cpu")
        for m in cpu.components().values():
            init_random_(m, gen)
        gpu = sampling.SDModules.create(C.TINY_SD, torch.float32, "cuda")
        for name, m in gpu.components().items():
            m.load_state_dict(cpu.components()[name].state_dict())
        image = torch.rand((1, 64, 64, 3), generator=gen) * 2 - 1
        noise = tuple(torch.randn((1, 8, 8, 4), generator=gen) for _ in range(2))
        ids = torch.randint(0, C.TINY_SD.text_encoder.vocab_size, (2, 77), generator=gen)
        for sampler, gs in (("plms", 5.0), ("ddim", 1.0)):
            outs = []
            for mods in (cpu, gpu):
                ctx = sampling.encode_text(mods, ids)
                fn = sampling.make_img2img_fn(mods, 10, 0.5, gs, sampler)
                outs.append(fn(image, ctx[:1], ctx[1:], noise=noise).cpu())
            err = float((outs[0] - outs[1]).abs().max())
            log(f"TINY_SD img2img {sampler} gs={gs}: cuda vs cpu max abs err {err:.3e} "
                f"(tol {PARITY_TOL})")
            if not err <= PARITY_TOL:
                raise AssertionError(f"TINY_SD {sampler} disagrees: {err}")

        # One full-width SD-1.5 UNet call (N = 1024/256/64/16, d = 40/80/160/160).
        gen_cuda = torch.Generator(device="cuda").manual_seed(SEED)
        unet_gpu = sampling.SDModules.create(C.SD15, torch.float32, "cuda").unet
        init_random_(unet_gpu, gen_cuda)
        with torch.device("meta"):
            from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition

            unet_cpu = UNet2DCondition(C.SD15_UNET)
        unet_cpu = unet_cpu.to_empty(device="cpu").eval()
        unet_cpu.load_state_dict(unet_gpu.state_dict())
        x = torch.randn((1, 32, 32, 4), generator=gen)
        t = torch.tensor([501])
        ctx = torch.randn((1, 77, 768), generator=gen)
        with torch.inference_mode():
            ref = unet_cpu(x, t, ctx)
            got = unet_gpu(x.cuda(), t.cuda(), ctx.cuda()).cpu()
        scale = float(ref.abs().max())
        err = float((ref - got).abs().max())
        log(f"SD15 UNet 32x32 fp32: cuda vs cpu max abs err {err:.3e}, max |eps| "
            f"{scale:.3e} (tol {UNET_REL_TOL} x max |eps|)")
        if not (torch.isfinite(got).all() and err <= UNET_REL_TOL * scale):
            raise AssertionError("SD15 UNet disagrees between CUDA and CPU")
        del unet_gpu, unet_cpu
        torch.cuda.empty_cache()


def phase_serve():
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
    from image_restoration_and_enhancement_torch.models.layers import init_random_
    from image_restoration_and_enhancement_torch.ops import _build

    result = {}
    with _Phase("serve"):
        tmp = tempfile.mkdtemp(prefix="iret_smoke_")
        try:
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            mods = sampling.SDModules.create(C.SD15, torch.bfloat16, "cuda")
            counts = {}
            for name, m in mods.components().items():
                init_random_(m, gen)
                counts[name] = sum(p.numel() for p in m.parameters())
            log(f"random SD-1.5 stack: {counts} in {time.perf_counter() - t0:.2f} s")
            if counts["unet"] != 859_520_964:
                raise AssertionError(f"UNet has {counts['unet']} parameters")
            t0 = time.perf_counter()
            ckpt.save_pipeline(tmp, mods.components(), C.SD15, dtype=torch.bfloat16)
            log(f"wrote + verified bf16 pipeline in {time.perf_counter() - t0:.2f} s")
            del mods
            torch.cuda.empty_cache()

            pipe = RestorationPipeline(
                config={"denoise": {"fine_tuned_dir": tmp, "default_backend": "diffusion"}})
            image = np.random.default_rng(SEED).integers(0, 256, (512, 512, 3), dtype=np.uint8)
            requests = [("default (gs 5.0, CFG batch 2; includes the stack load)", {}),
                        ("guidance=1.0 (no CFG branch; first batch-1 call)",
                         {"guidance": 1.0}),
                        ("default again (steady state)", {}),
                        ("guidance=1.0 again (steady state)", {"guidance": 1.0})]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            seconds = []
            for label, kw in requests:
                t0 = time.perf_counter()
                out = pipe.denoise(image, **kw)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                log(f"request {label}: {seconds[-1]:.3f} s")
                if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
                        and out.shape == (512, 512, 3)):
                    raise AssertionError(f"bad output {type(out)} "
                                         f"{getattr(out, 'shape', None)}")
            launches = dict(_build.launch_counts)
            shapes = dict(_build.launch_shapes)
            peak = torch.cuda.max_memory_allocated()
            log(f"serve launches: {launches}; peak memory {peak / 2**30:.3f} GiB")
            for k in ("attention", "group_norm"):
                if launches.get(k, 0) <= 0:
                    raise AssertionError(f"kernel {k} did not launch on the main path")
            result = {"request_seconds": seconds, "peak_bytes": peak,
                      "launches": launches, "shapes": shapes}
            log("serve_json " + json.dumps(
                {"request_seconds": seconds, "peak_memory_bytes": peak,
                 "launches": launches}))
            _profile_request(pipe, image, seconds[2])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return result


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "attention_mma_kernel" in name or "attention_kernel" in name:
        return "K1 attention"
    if "gn_stats" in name or "gn_finalize" in name or "gn_apply" in name:
        return "K2 group_norm"
    if any(w in low for w in ("fprop", "conv", "implicit", "dgrad")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "elementwise" in low:
        return "elementwise (PyTorch)"
    return "other"


def _profile_request(pipe, image, unprofiled_s: float) -> None:
    """One more default request under torch.profiler: device time by kernel
    group. Its launches are not counted: the counts were read above. The
    profiler's own host cost lengthens this request, so the device busy share
    is also given against ``unprofiled_s``, the same request's steady-state
    time without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.denoise(image)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for e in prof.key_averages():  # device entries only: host ops would count twice
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        group = _kernel_group(e.key)
        total, count = groups.get(group, (0.0, 0))
        groups[group] = (total + us, count + e.count)
    device_us = sum(t for t, _ in groups.values())
    if device_us == 0:
        log("profile: the profiler saw no device time (device split not measured)")
        return
    log("profile_json " + json.dumps({
        "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
        "device_busy_share_profiled": device_us / wall_us,
        "device_busy_share_vs_unprofiled": device_us / 1e6 / unprofiled_s,
        "groups": {k: {"ms": t / 1e3, "launches": c} for k, (t, c) in
                   sorted(groups.items(), key=lambda kv: -kv[1][0])}}))


def _attention_case(key, gen):
    import torch

    b, nq, nk, h, d, dtype = key
    dt = getattr(torch, dtype.split(".")[-1])
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
               for n in (nq, nk, nk))
    flops = 4.0 * b * h * nq * nk * d
    nbytes = (2 * b * nq * h * d + 2 * b * nk * h * d) * q.element_size()
    return (q, k, v), flops, nbytes, dtype


def _gn_case(key, gen):
    import torch

    b, hh, ww, c, groups, eps, act, dtype = key
    dt = getattr(torch, dtype.split(".")[-1])
    x = (torch.randn((b, hh, ww, c), generator=gen, device="cuda") * 2 + 0.5).to(dt)
    scale = torch.randn((c,), generator=gen, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    n = b * hh * ww * c
    flops = (9.0 if act == "silu" else 5.0) * n
    nbytes = 2 * n * x.element_size() + 2 * c * 4
    return (x, scale, bias, groups, eps, act), flops, nbytes, dtype


def phase_kernels(serve):
    import torch
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import attention as A
    from image_restoration_and_enhancement_torch.ops import groupnorm as G
    from image_restoration_and_enhancement_torch.ops import tolerance

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    main = serve["shapes"]
    extra = [  # cases beside the main path's own shapes
        ("attention", (1, 256, 77, 8, 40, "torch.float32")),
        ("group_norm", (2, 32, 32, 640, 32, 1e-6, None, "torch.bfloat16")),
        ("group_norm", (2, 16, 16, 1280, 32, 1e-5, None, "torch.float32")),
    ]
    cases = [(k, key, main.get((k, key), 0)) for (k, key) in sorted(main, key=str)]
    cases += [(k, key, 0) for k, key in extra if (k, key) not in main]
    with _Phase("kernels"):
        for kernel, key, count in cases:
            if kernel == "attention":
                args, flops, nbytes, dtype = _attention_case(key, gen)
                q, k, v = args
                run = lambda: A.attention(q, k, v)  # noqa: E731
                plain = lambda: A.attention_reference(q, k, v)  # noqa: E731
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            else:
                args, flops, nbytes, dtype = _gn_case(key, gen)
                x, scale, bias, groups, eps, act = args
                run = lambda: G.group_norm(x, scale, bias, groups, eps, act)  # noqa: E731
                plain = lambda: G.group_norm_reference(  # noqa: E731
                    x, scale, bias, groups, eps, act)

                def lib():
                    y = F.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype),
                                     bias.to(x.dtype), eps)
                    return F.silu(y) if act == "silu" else y
            with torch.inference_mode():
                got, ref = run(), plain()
                torch.cuda.synchronize()
                tol = tolerance.limits(ref, kernel)
                ok, err = tolerance.within(got, ref, kernel)
                iters = 5 if flops > 2e10 else 20
                ms, plain_ms, lib_ms = (_time_ms(f, iters) for f in (run, plain, lib))
            bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
            bound_by = "operations" if flops / PEAK_FLOPS[dtype] > nbytes / PEAK_BYTES \
                else "bytes"
            row = {"kernel": kernel, "shape": list(key), "main_path_launches": count,
                   "max_abs_err": err, "atol_rtol": list(tol), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by}
            rows.append(row)
            log("kernel_case " + json.dumps(row))
            if not ok:
                raise AssertionError(f"{kernel} {key} disagrees with its plain version: "
                                     f"max abs err {err}")

        # Large-mean GroupNorm: E[x^2]-E[x]^2 cancels in fp32 in both versions
        # (by design), so only finiteness is checked here.
        x = (5000.0 + 0.1 * torch.randn((2, 8, 8, 16), generator=gen, device="cuda"))
        with torch.inference_mode():
            y = G.group_norm(x, torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"), 4)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("group_norm gives non-finite values at mean 5000")
        log("group_norm mean-5000 case: finite")
    return rows


def _kernel_line(rows, launches):
    sources = {
        "attention": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                      "image_restoration_and_enhancement_tpu/ops/attention.py:80"),
        "group_norm": ("image_restoration_and_enhancement_torch/csrc/groupnorm.cu",
                       "image_restoration_and_enhancement_tpu/ops/groupnorm.py:36"),
    }
    out = []
    for name, (source, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name and r["main_path_launches"]]
        total = lambda key: sum(r[key] * r["main_path_launches"] for r in mine)  # noqa: E731
        ops_bound = sum(r["bound_ms"] * r["main_path_launches"] for r in mine
                        if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_bound > total("bound_ms") / 2 else "bytes",
            "library_ms": total("library_ms"),
        })
    return {"kernels": out}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import image_restoration_and_enhancement_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (fp32 references are full fp32)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    phase_build()
    phase_parity()
    serve = phase_serve()
    rows = phase_kernels(serve)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(_kernel_line(rows, serve["launches"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
