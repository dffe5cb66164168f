#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its CUDA kernels against
their plain PyTorch versions.

    python3 chip_smoke.py [--only PHASES]   (a comma list of demo, multidevice, multitrain)

Phases (each prints its seconds, and all of them together go on the
"phase_seconds" line just before the total; any failure exits non-zero):
  build       compile csrc/*.cu (one nvcc process per source, started together,
              then one link; ops/_build.py) and load the library.
  parity      small inputs, CUDA kernels against the plain versions on the CPU,
              in fp32: the TINY_SD img2img function end to end (default
              backend, then attention_backend "flash" (K5) and "pallas_packed"
              (K6b)) and one full-width SD-1.5 UNet call at 32x32 latents,
              exact and then int8_static (K3, K4; tables calibrated on the CPU);
              then TINY_SD_INPAINT's inpaint function (DDIM, gs 5.0) and one
              full-width 9-channel SD-1.5-inpaint UNet call at 32x32 latents,
              at the same limits as their img2img and 4-channel twins; then
              TINY_SDXL's img2img function (DDIM, gs 5.0; both text towers,
              the text_time conditioning) and one full-width SDXL UNet call
              (2,567,463,684 parameters, initialised on the card and copied
              to the CPU) at 32x32 latents with added_cond, at the same
              limits.
  serve       initialise the full SD-1.5 stack (UNet, VAE, CLIP-L) at random from
              a seeded generator, write it in bf16 with the port's own safetensors
              writer to a temporary directory outside the checkout, and answer
              four 512x512 denoise requests through RestorationPipeline: the task
              default (strength 0.5, 20-step PLMS, gs 5.0, so CFG batch 2), one
              with guidance=1.0 (no CFG branch), then both again (steady state).
              Launch counts are zeroed just before and read just after; K1 and K2
              must have launched, every bf16 attention launch at head_dim <= 160
              through the "sm90" code (wgmma + TMA) and the VAE mid-block's
              (d = 512) through "sm90_split" (ops/attention.py's kernel_path),
              and every GroupNorm (K2) through the path groupnorm.plan names,
              "onchip" (one launch) at every UNet-sized shape (H*W <= 4096);
              the same path checks hold in the three serves below.
  serve_int8  the same stack served w8a8: calibrate a static table with
              make_calib_img2img_fn on the request image, write it as JSON, build
              RestorationPipeline(quant="int8_static", quant_calib=...,
              attention_backend="int8") and answer a first CFG request, a steady
              CFG request and a steady gs 1.0 request. Counts are zeroed just
              before and read just after: K3 and K4 must have launched, every
              K3 launch through "sm90" (s8 wgmma + TMA, split-K where
              conv_int8.split_k says), K4 at every UNet site (352 launches per
              CFG request, 1,056 in all) through "sm90" (s8 wgmma + TMA, no
              padded copies; attention.int8_kernel_path), and K1 (VAE
              mid-block, through "sm90_split"); no site may miss the table.
              Prints the PSNR of the int8 output against the bf16 serve's
              output on the same input (random weights: no target, so no
              gate). Then one more CFG request
              captures the input and output of every quantized layer that K3
              does not serve (Linear, 1x1 and stride-2 convs: the s8 products
              of torch._int_mm, and the quantizers), one of each shape, and holds
              each against the same layer on the CPU (layer parity, below).
              A CUDA pipeline has no OpenCV fallback: any failure of a request
              raises and fails this run.
  serve_flash the bf16 stack served by RestorationPipeline(attention_backend=
  serve_packed "flash") and (attention_backend="pallas_packed"): a first and a
              steady CFG request each. Counts are zeroed just before and read
              just after: every UNet attention site must run K5 (K6b), 352
              launches per CFG request (32 sites x 11 UNet calls), all through
              "sm90", and K1 only at the VAE mid-block (2 per request, through
              "sm90_split"). Prints request seconds, peak
              memory, the PSNR against the bf16 serve's output on the same
              image (K5 differs from K1 in its row sum; K6b runs K1's code on
              the same addresses, so inf; random weights, so no gate) and one
              profiled request.
  serve_tasks the other three tasks on the bf16 stack (the default attention
              backend), through RestorationPipeline: sr_x4 (its own stack loaded
              from the serve's directory) 128->512 twice and 512->2048 (SD runs
              at the 1024 bucket, reached through the port's LANCZOS down and
              up: K1 at N = 16384, d = 40 and 512), colorize on a grey 512
              twice, inpaint on a random SD-1.5-inpaint stack (the 9-channel
              UNet, 859,535,364 parameters, written beside the serve's stack)
              with a rectangular hole twice and with mask=None on an image
              whose dark bands the auto mask flags, and process(denoise,
              colorize, inpaint). Each request zeroes the counts just before
              and reads them just after: K1 and K2 launched, the path checks
              as in serve, and K1 exactly 32 x the task's UNet calls (17, 23,
              18 at the defaults) + 2 VAE mid-blocks (3 for inpaint: two
              encodes); process's count follows the tasks it ran SD for. One
              steady request per task and the 2048 one are profiled. Then
              sr_x4 with no SD stack and random RRDBNet weights in the JAX
              layout under IRET_WEIGHTS_DIR: served by RRDBNet on the card
              (equal to upscale_x4 there, not LANCZOS), and RRDBNet on a
              32x32 crop held against the CPU (fp32, 1e-4 of max |out|).
  serve_modes the opt-in serving modes on the bf16 SD-1.5 stack, one pipeline
              each, a first and a steady CFG request each at the denoise
              defaults (11 UNet calls, K1 352 + 2 launches a request):
              tome_ratio=0.5 (the 5 level-0 self-attention sites on 2048
              merged tokens: 55 K1 launches at 2x2048x2048x8x40 and none at
              N = 4096, d = 40), cfg_cache_interval=2 (rows 0, 2, ..., 10
              full: 6 x 32 K1 launches at batch 2 and 5 x 32 at batch 1) and
              IRET_CFG_DEDUP=1 (11 launches at 1x4096x4096x8x40, the other
              341 at batch 2). Counts are zeroed just before and read just
              after each request; the path checks as in serve. Prints
              request seconds, peak memory and the PSNR against the bf16
              serve's output on the same image (random weights, and ToMe
              and the cache are approximations: not gated); profiles the
              steady ToMe request.
  evaluate    the evaluation path (PR 12), after serve_modes: eight clean
              512 px images written as PNG from the seed; each task's test
              split (4 pairs) made on the card by SyntheticPairLoader (sr_x4's
              at 128 px, served 128 -> 512; inpaint with its masks) and written
              as PNG input/gt[/mask]; every task's degradation of a batch of 2
              drawn and applied on the card and again on the CPU from the same
              draws (within 1e-5; inpaint masks equal but at boundary pixels,
              JPEG but in blocks with a coefficient at a rounding midpoint:
              data/degradations.py's near_* functions); generate_predictions
              over the four tasks on the serve's SD-1.5 stacks (and the inpaint
              stack) under models_root/<model_dir>/best, its launch counts
              zeroed just before and read just after (K1 exactly the requests'
              32 x UNet calls + VAE mid-blocks, the path checks as in serve);
              evaluate_model with LPIPS on random weights written in the JAX
              layout under IRET_WEIGHTS_DIR and IRET_FID_RANDOM_INIT=1, under
              torch's default TF32 settings: the JSON has the JAX script's keys
              for every task, every value finite, every SSIM statistic <= 1;
              then the bundle and LPIPS on the CPU from the same files, each
              statistic within PSNR 1e-4 dB, SSIM 1e-5, ΔE 1e-4, LPIPS 1e-5
              relative. Prints seconds per request, the metric bundle's ms per
              512 px image at batch 16, LPIPS ms per pair, Inception ms per
              image at batch 8, the loader's ms per 512 px batch of 8 per
              task and the peak memory ("evaluate_json").
  train       training, after evaluate: one fp32 micro-step of the
              full-width SD-1.5 stack at 64 px (lambda_img 0.05) on the card
              and on the CPU from the same weights and draws, loss, L1 and
              gradient norm within TRAIN_TWIN_REL_TOL, each UNet gradient
              tensor within TRAIN_TWIN_GRAD_TOL of its largest entry (not
              counted); 8 train
              and 2 val 256 px pairs per task degraded on the card and
              written as PNG; then, counts zeroed just before and read just
              after: train_task("denoise") at full SD-1.5 width (random
              weights from the seed, bf16 compute, fp32 masters, the UNet's
              blocks checkpointed)
              with batch 2, k = 2, one epoch and save_steps 2 (4
              micro-steps, 2 optimizer steps; the train state is not
              written), each micro-step synchronised and timed, the fourth
              profiled: every loss and gradient norm finite, K1 exactly
              TRAIN_K1_PER_MICRO_STEP launches a micro-step (the UNet's 32
              sites forward and in the remat recompute, the VAE's 3) and K2
              the same count in each, every UNet tensor moved by optimizer
              step 2 (checkpoint-2 holds the initial weights: step 1's rate
              is 0); one micro-step of a random SD-1.5-inpaint stack (the
              9-channel UNet); pretrain_vae for 2 steps at 256 px; one
              256 px denoise request served by RestorationPipeline from the
              best/ that train_task wrote (K1 32 x 11 + 2). K1 on
              "sm90"/"sm90_split" and K2 on its plan at every launch under
              autograd. Prints seconds per micro-step (steady: the second
              and third), images/s, peak memory, K1/K2 launches per
              micro-step ("train_json").
  tools       the single-device tools chained as a user runs them,
              after train: 4 clean 512 px PNGs (port codec, seeded) under
              data/clean/val; make_synthetic_pairs --splits val at its
              defaults (the four task trees and file names, sr inputs
              128x128, colorize inputs one channel, masks in {0, 255}, the
              denoise noise's sigma estimated from the unclipped pixels
              within [5, 8]); make_demo_data (4 images, 1 mask);
              import_weights.make_rehearsal_dir(config.SD15) at full width
              from a seeded CUDA generator (fp32, ~4 GiB), imported with
              --sd15 to pretrained/sd15; goldens recorded with --device cpu
              (fp32, 256 px probes) and checked on the card, every probe
              within import_weights.THRESHOLDS (check_goldens' exit code)
              and within GOLDEN_CARD_LIMITS (1e-4 each module, 2.5e-4
              img2img: the card against the CPU, its max |delta| printed),
              counts zeroed around the check: K1 on "simt" (fp32) at every
              launch, K2 on its plan; one 512 px denoise request served from
              the import (bf16, K1 32 x 11 + 2); eval_quant_quality on the
              card (--n 4 --size 256 --batch 4 --modes int8,int8_static
              --cfg_cache 2 --tome 0.5, IRET_TOME_MIN=1024 so that ToMe
              merges the 32x32 latent's sites), counts zeroed around each of
              its six runs: K1 in every run, K3 in the five quantized ones
              and on "sm90" at every launch, K1 at the merged token count in
              the ToMe and combo runs only, the path checks as in serve, and
              no site missing from the int8_static table. Prints every
              report line (random weights: no quality gate), seconds per
              step ("tools_json").
  demo        the restoration-learning demo chained as a user runs it, after
              tools: the clean-image source (make_procedural_clean's
              procedural_image, 2 images at 256 px from seed 42, written as
              PNG and read back equal; its own JPEG output must raise an
              error naming PIL with PIL hidden, and, where the machine has
              PIL, write JPEG); then, counts zeroed
              just before and read just after each run,
              demo_restoration_learning at 64 px (the demo's published
              stack: UNet (32, 64, 64, 64) with 4 heads, VAE (16, 32, 32,
              32); 16 train and 8 val pairs at sigma 80, batch 8,
              pretrain_vae 1 epoch, train_task 1 epoch, fp32), the summary's
              input baseline against the same function on the CPU (1e-4
              dB), demo_eval_sweep (the round trip, strength 0.1, a 2-seed
              ensemble), probe_vae_roundtrip on the val pairs (fp32, its
              input_vs_gt equal to the baseline) and summarize_workflow over
              the artifacts (the epoch row and the logged baseline). K1 and
              K2 launch counts per run must equal _demo_launches's (worked
              out from the stack's modules and the runs' call counts); every
              K1 launch on "simt" (fp32), every K2 launch on its plan
              ("demo_json"); the VAE epoch's scaled-latent std and PSNR on a
              line of their own ("demo VAE epoch"). First, the from-scratch
              init on the card: init_random_ on a CUDA generator over the
              demo stack's UNet, VAE and text encoder (fp32), each kind's
              pooled std against flax's law (kernels * sqrt(fan_in) 1, token
              embedding * sqrt(hidden) 1, position embedding 0.01) within
              INIT_STD_SIGMAS standard errors, every kernel within
              lecun_normal's cap 2 / 0.87962566, scales 1 and biases 0
              (tests/test_torch_init.py's checks; "demo init").
  multidevice multi-device serving, after demo: torch.cuda.device_count()
              ranks (at most 4), one card each, over NCCL (parallel/launch.py
              spawns them; each runs parallel/serve.run_cases), serve (a)
              SD-1.5 img2img at full width, bf16, 512 px, batch 4, 20-step
              DDIM with CFG (gs 7.5) through make_sharded_img2img_fn over a
              (data 2, model 2) mesh, (b) the denoise task on one 2048 px
              image through RestorationPipeline(mesh, spatial_axis="sp",
              max_size=2048) over sp 4, and (c) make_sharded_inpaint_fn on
              the SD-1.5-inpaint stack at 512 px, batch 2, over (data 2,
              sp 2), then (d) (a) served int8_static with K4 attention
              (attention_backend "int8") and ToMe 0.5 over (a)'s mesh and (e)
              (c) served int8_static over (c)'s, each table calibrated on
              the request unsharded on card 0 (MD_CALIB_STEPS); two requests
              each. Each output (rank 0's; every rank returns the whole
              image) is held against the same request served unsharded on
              card 0 from the same weights, inputs and generator seed
              (MD_MEAN_TOL, MD_PSNR_MIN; for (d) and (e)
              MD_INT8_NOISE_FACTOR: see their comments); over one card one
              request each, of MD_ONE_CARD_STEPS DDIM steps.
              Launch counts are zeroed in every rank just before its
              requests and read just after, and summed over the ranks: K1
              and K2 launched, every K1 launch "sm90" / "sm90_split", K2 on
              its plan, and K2's sharded entries (group_norm_stats,
              group_norm_apply) launched, and K3 in (d) and (e) and K4 in
              (d). Prints request seconds, peak memory, collectives by kind
              and launches by rank and the errors, each beside the card's
              name and power limit ("multidevice_json"). With one card,
              (a), (c), (d) and (e) run over (1, 1) meshes of one NCCL rank
              (the sharded factories, the interleaved CFG layout, the NCCL
              set-up and, through (c)'s sp axis of one, the height-sharded
              code with zero halos and K2's sharded entries on the card,
              each equal to the unsharded serve) and the log names the
              four-card command. `python3 chip_smoke.py --only
              multidevice` runs this phase alone (build, multidevice,
              kernels); on a machine with four cards
              `--only multidevice,multitrain` is the multi-rank check.
  multitrain  multi-device training, after multidevice: (f)
              train_task("denoise") at full SD-1.5 width, 256 px, bf16,
              global batch 4, 4 micro-steps at gradient_accumulation_steps 2
              (MT_LR), random weights from the config's seed, run on card 0
              alone and then over a data mesh of every card (at most 4; one
              card trains alone by the trainer's rule, which wants more than
              one device), each rank taking its rows of the same batches: the
              loss of every micro-step within MT_LOSS_RTOL of the card's, the
              saved masters within MT_LR_FACTOR learning rates, and bitwise
              equal across the data ranks (parallel/train.fingerprint); (g)
              the DP x TP AdamW step (dryrun_multichip's) in fp32 at full
              width, 256 px, batch 2, over (data 2, model 2), rank 0 first
              taking the same step unsharded on its card: every gathered
              gradient within MT_GRAD_REL of its largest entry, every master
              within MT_LR_FACTOR learning rates; its state saved (gathered,
              the one-device file); (h) that file restored over (data n,
              model 1) and on one card, one more step (batch 4) each, the
              masters held alike. Prints micro-step and step seconds, peak
              memory and collectives by rank and the errors, each beside the
              card's name and power limit ("multitrain_json"); K1 and K2 must
              launch on every rank of (f), (g) and (h). With one card, (g)
              and (h) over (1, 1) meshes. `--only multitrain` runs it alone.
  serve_sdxl  config.SDXL at random from a seeded CUDA generator (each
              component's parameter count asserted against SDXL_PARAMS,
              which tests/test_torch_sdxl.py holds against the JAX package),
              written in bf16 with model_index.json to a temporary directory
              outside the checkout (~6.5 GiB; the free space printed first,
              the directory deleted at the end), and served at 1024x1024 by a
              RestorationPipeline whose denoise fine_tuned_dir is that
              directory (no model_config: the checkpoint describes itself): a
              first and a steady CFG request and a steady gs 1.0 request.
              Each must be served by the SDXL stack with K1 exactly 140 x 11
              + 2 = 1,542 launches (70 transformer blocks x 2 sites x 11
              UNet calls, head_dim 64, all "sm90"; the VAE's two, "sm90_split")
              and K2 on its plan at every launch. Prints request seconds and
              peak memory, and profiles one steady CFG request.
  kernels     every kernel at every shape the serves launched it with (plus edge
              cases; K6a at K6b's shapes through its own entry, and the batch-1
              twins of K5's and K6's CFG shapes): kernel against plain version on
              the same inputs, max abs error within ops/tolerance.py's limit,
              for the bf16 attention kernels (K1, K5, K6a, K6b) the placement
              check (more elements bitwise equal to the plain version than to
              attention_reference, by ops/tolerance.py's margin; for K4 than
              to the same function with xla_attention_int8's roundings), and
              kernel / plain / library times with CUDA events, and for the
              attention kernels, K2, K3 and K4 the device code that served the
              launch ("path") and "bare" times of the C entry alone (no Python
              wrapper): for K1 and K4 the sm90 and mma codes, for K2 its plan
              and the twophase cut, for K3 its path and split, the mma code
              and, where K is split, no split and twice the split, each held
              to its limit.
              K1 also runs once with IRET_ATTN_SCORES_BF16=1 and once with
              IRET_ATTN_NORM_BOUND=1 (both "mma"); the first is held with
              tolerance.scores_bf16_within (a row whose max rounds to the
              other bf16 neighbour on the two sides passes only as such).

Kernel-vs-plain limits are ops/tolerance.py's: fp32 1e-4 absolute and
relative; bf16 |got - ref| <= share * max|ref| + 2**-7 * |ref| elementwise (one
bf16 step of each value plus a share of the largest: 2**-8 for attention and
int8 attention, 2**-10 for GroupNorm); K3 one rounding of the output dtype.

int8 checks, CUDA against CPU:
- Layer parity (the tight check): the same s8 inputs and weights give the
  same int32 sums on both devices (torch._int_mm on the card, float64 on the
  CPU), and both scale them with the same fp32 operations, so each layer's
  output must agree to within one rounding of its dtype (ops/tolerance.py,
  "int8_layer"), under the pipeline's static table and under dynamic scales.
  Control: the card's layer with quantization off must fail that limit at
  every shape, or the run fails.
- End to end (a bound on the quantization noise, not a test of int8): the
  devices' fp32 parts (convs, norms, softmax) differ in the last bits, so
  some activations land on the other side of an s8 rounding boundary, and a
  random-weight int8 network amplifies each such flip. The limits are 25 dB
  PSNR for the TINY_SD image and 15% relative Frobenius error for the SD-1.5
  UNet call. Quantization off on the card lies inside both (w8a8 against fp32
  is about as far as the flips go), so these limits cannot tell int8 from
  full precision; layer parity does. Beside each, the run prints what a 1e-6
  relative perturbation of every quantized layer's input does on the CPU
  (what the cross-device differences look like), the card's fp32 output
  against the CPU's int8 one, and planted faults (a zeroed K3 tap; K4
  dropping 8 keys), and fails if a limit would pass a planted fault.

CUDA graphs: every single-device serve replays a CUDA graph of its sampling
function (core/graphs.py; the factories' default on the card, as the JAX
factories jit), captured at the first request of each input size: the counts
above are the graph's launches, which the function adds to the counters at
every replay. Each serve phase then holds one request of each of its forms
(serve: CFG and gs 1.0; serve_int8; serve_flash; serve_packed; serve_tasks:
sr_x4 at 512, colorize, inpaint; serve_modes: tome, cfg_cache, dedup;
serve_sdxl) served again from the pipeline's own graph (the phase's call
captured it) and by the eager function (graph=False) of the same stack and
settings (_graph_ab). On three requests (the
call's, the image mirrored with other noise, a third noise) the images must be
bitwise equal and the host counters must give the same launches by kernel and
path and the same int8_static misses; the kernel nodes of the replayed graph,
read from the CUDA driver (graphs.graph_nodes), must be by kernel the device
launches that the eager request's host counters give. One profile of a
graphed request is read, not held (profiles on the card missed a few of the
VAE's short twophase K2 events, most in SDXL's 1024 px replay: 12-15 of 150).
It logs ("graph_json") the first graphed call's seconds (warm-up and
capture), the three graphed and eager seconds (interleaved), the launches a
request issues (graphed: the profile's host launch calls; eager: the graph's
nodes), the device busy share (graphed: over the profiled request's own
seconds; eager: an estimate, the graphed profile's device time over the eager
seconds) and the peak memory (allocated, and reserved with the graphs' pool).
serve_int8 also serves a table with one site left out: the miss must be
reported at the graphed function's first call and at every replay. The int8
layer parity's hooks see an eager run.

Plain attention whose fp32 scores of all heads would exceed 2 GiB
(1x16384x16384x8x40) runs one head at a time; each head's output is its own.

fp32 references run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are set False at start). The library calls are
timed as yardsticks only and the port never calls them:
F.scaled_dot_product_attention and F.group_norm compute K1's (K5's, K6's)
and K2's functions up to roundings; no PyTorch call computes K3's or K4's, so
bf16 F.conv2d and bf16 F.scaled_dot_product_attention of the same shapes stand
in, labelled as exact bf16 yardsticks.

The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

SEED = 1234
# H100 SXM, dense; int8 in operations per second
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
PARITY_TOL = 2e-3     # fp32 end to end, images in [-1, 1]
UNET_REL_TOL = 1e-3   # fp32 full-width UNet eps, relative to max |eps|
INT8_PSNR_MIN = 25.0  # TINY_SD int8_static image, CUDA against CPU (docstring)
INT8_UNET_REL_TOL = 0.15  # SD-1.5 int8_static eps, relative Frobenius (docstring)
SD15_INPAINT_UNET_PARAMS = 859_535_364  # SD-1.5's 859,520,964 + conv_in's 5 x 320 x 9
# config.SDXL's parameters by component (tests/test_torch_sdxl.py holds them
# against the JAX package's eval_shape)
SDXL_PARAMS = {"unet": 2_567_463_684, "vae": 83_653_863, "text_encoder": 123_060_480,
               "text_encoder_2": 694_659_840}
PLAIN_SCORES_BYTES = 2 << 30  # above: plain attention runs one head at a time
RRDB_REL_TOL = 1e-4   # RRDBNet fp32 output, CUDA against CPU, relative to max |out|
ATTENTION_KERNELS = ("attention", "flash_attention", "packed_attention",
                     "packed_attention_grid")
# Attention launches per 512x512 denoise request (strength 0.5, 20-step PLMS:
# 10 steps plus PLMS's extra first call = 11 UNet calls): 16 transformer blocks x
# 2 sites in the UNet, and the VAE's mid block once in the encoder and once in
# the decoder.
UNET_ATTENTION_PER_REQUEST = 32 * 11
VAE_ATTENTION_PER_REQUEST = 2


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS = {}  # each phase's seconds, in the order run (the "phase_seconds" line)


class _Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            PHASE_SECONDS[self.name] = round(time.perf_counter() - self.t0, 2)
            log(f"== {self.name}: {PHASE_SECONDS[self.name]:.2f} s")
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
        # registers and spills of K2's, K3's and the sm90 attention code's
        # instances (K1, K5, K6 and K4's S8QK), by (mangled) name
        entries = re.findall(r"Compiling entry function "
                             r"'\w*?((?:gn_|conv3x3_int8_|attention_sm90_)\w+)'"
                             r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                             r".*?Used (\d+) registers", str(info["log"]), re.S)
        if entries:
            log("ptxas_kernels " + json.dumps(
                {name.split("Ev")[0]: {"registers": int(r), "spill_bytes": int(st) + int(ld)}
                 for name, st, ld, r in entries}))


def _psnr(a, b, peak: float) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10.0 * np.log10(peak * peak / mse))


@contextlib.contextmanager
def _planted(fault: str):
    """Run the port's plain path with a planted fault: "k3_tap" zeroes tap
    (2, 2) of every int8 3x3 conv weight, "k4_keys" drops the last 8 keys of
    every int8 attention. Used on the CPU only, to show what a limit rejects."""
    from image_restoration_and_enhancement_torch.models import layers
    from image_restoration_and_enhancement_torch.ops import attention as A

    if fault == "k3_tap":
        mod, name = layers, "conv3x3_same_int8"
        real = layers.conv3x3_same_int8

        def faulty(x, w, scale, out_dtype):
            w = w.clone()
            w[2, 2] = 0
            return real(x, w, scale, out_dtype)
    else:
        mod, name = A, "int8_attention_core"
        real = A.int8_attention_core

        def faulty(q8, k8, v, scale):
            return real(q8, k8[:, :-8], v[:, :-8], scale) if k8.shape[1] > 8 else \
                real(q8, k8, v, scale)
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def _perturbed(roots, rel: float, gen):
    """Multiply the input of every quantized layer under ``roots`` by
    (1 + rel * N(0, 1)) elementwise: the size of the difference between two
    devices' fp32 results, at every place where it can flip an s8 value."""
    import torch

    from image_restoration_and_enhancement_torch.models.layers import QConv2d, QLinear

    def hook(mod, args):
        x = args[0]
        return (x * (1 + rel * torch.randn(x.shape, generator=gen)).to(x.dtype),) + args[1:]

    hooks = [m.register_forward_pre_hook(hook) for root in roots for m in root.modules()
             if isinstance(m, (QConv2d, QLinear))]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def phase_parity():
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import (
        CL,
        init_random_,
        set_quant,
    )
    from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops.quant import QuantState

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
            if sampler == "plms":
                cuda_fp32 = outs[1]
            err = float((outs[0] - outs[1]).abs().max())
            log(f"TINY_SD img2img {sampler} gs={gs}: cuda vs cpu max abs err {err:.3e} "
                f"(tol {PARITY_TOL})")
            if not err <= PARITY_TOL:
                raise AssertionError(f"TINY_SD {sampler} disagrees: {err}")

        # The same function with K5 and K6b at the UNet's sites (the VAE keeps K1).
        for backend, kernel in (("flash", "flash_attention"),
                                ("pallas_packed", "packed_attention_grid")):
            outs = []
            before = _build.launch_counts[kernel]
            for dev in ("cpu", "cuda"):
                mods = sampling.SDModules.create(C.TINY_SD, torch.float32, dev,
                                                 attention_backend=backend)
                for name, m in mods.components().items():
                    m.load_state_dict(cpu.components()[name].state_dict())
                ctx = sampling.encode_text(mods, ids)
                fn = sampling.make_img2img_fn(mods, 10, 0.5, 5.0, "plms")
                outs.append(fn(image, ctx[:1], ctx[1:], noise=noise).cpu())
            err = float((outs[0] - outs[1]).abs().max())
            launched = _build.launch_counts[kernel] - before
            log(f"TINY_SD img2img plms gs=5.0 attention_backend={backend}: cuda vs cpu max abs "
                f"err {err:.3e} (tol {PARITY_TOL}); {kernel} launched {launched} times")
            if not (err <= PARITY_TOL and launched > 0):
                raise AssertionError(f"TINY_SD with attention_backend={backend} disagrees: {err}")

        # TINY_SD int8_static: a table calibrated on the CPU, K3 and K4 on the card.
        mods8 = []
        for dev in ("cpu", "cuda"):
            m8 = sampling.SDModules.create(C.TINY_SD, torch.float32, dev, attention_backend="int8")
            for name, m in m8.components().items():
                m.load_state_dict(cpu.components()[name].state_dict())
            mods8.append(m8)
        ctx = sampling.encode_text(mods8[0], ids)
        _, table = sampling.make_calib_img2img_fn(mods8[0], 10, 0.5, 5.0, "plms")(
            image, ctx[:1], ctx[1:], noise=noise)
        before = collections.Counter(_build.launch_counts)
        outs = []
        for m8 in mods8:
            m8.set_quant(QuantState("int8_static", table))
            ctx = sampling.encode_text(m8, ids)
            fn = sampling.make_img2img_fn(m8, 10, 0.5, 5.0, "plms")
            outs.append(fn(image, ctx[:1], ctx[1:], noise=noise).cpu())
            if m8.quant.misses:
                raise AssertionError(f"TINY_SD int8_static missed sites {m8.quant.misses}")
        launched = {k: _build.launch_counts[k] - before[k]
                    for k in ("conv3x3_int8", "int8_attention")}
        psnr = _psnr(outs[0], outs[1], 2.0)
        err = float((outs[0] - outs[1]).abs().max())
        log(f"TINY_SD int8_static img2img plms gs=5.0 ({len(table)} sites): cuda vs cpu "
            f"PSNR {psnr:.2f} dB (min {INT8_PSNR_MIN}), max abs err {err:.3e}; "
            f"cuda launches {launched}")
        if not (psnr >= INT8_PSNR_MIN and all(v > 0 for v in launched.values())):
            raise AssertionError("TINY_SD int8_static disagrees between CUDA and CPU")
        # What the limit is measured against: on the CPU, the same run with every
        # quantized layer's input perturbed by 1e-6 (relative), and with planted
        # faults; the card's fp32 run of the same function (quantization off).
        ctx = sampling.encode_text(mods8[0], ids)
        fn = sampling.make_img2img_fn(mods8[0], 10, 0.5, 5.0, "plms")
        roots = (mods8[0].unet, mods8[0].vae)
        pert = []
        for _ in range(3):
            with _perturbed(roots, 1e-6, gen):
                pert.append(_psnr(outs[0], fn(image, ctx[:1], ctx[1:], noise=noise), 2.0))
        faults = {}
        for fault in ("k3_tap", "k4_keys"):
            with _planted(fault):
                faults[fault] = _psnr(outs[0], fn(image, ctx[:1], ctx[1:], noise=noise), 2.0)
        log(f"TINY_SD int8_static on the cpu: 1e-6-perturbed layer inputs PSNR "
            f"{', '.join(f'{p:.2f}' for p in pert)} dB; planted faults "
            f"{ {k: round(v, 2) for k, v in faults.items()} } dB; cuda fp32 (quantization "
            f"off) against cpu int8 {_psnr(outs[0], cuda_fp32, 2.0):.2f} dB")
        if not all(v < INT8_PSNR_MIN for v in faults.values()):
            raise AssertionError(f"the TINY_SD int8 limit passes a planted fault: {faults}")

        # One full-width SD-1.5 UNet call (N = 1024/256/64/16, d = 40/80/160/160).
        gen_cuda = torch.Generator(device="cuda").manual_seed(SEED)
        unet_gpu = sampling.SDModules.create(C.SD15, torch.float32, "cuda").unet
        init_random_(unet_gpu, gen_cuda)
        with torch.device("meta"):
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

        # The same call w8a8 with int8 attention, a table calibrated on the CPU.
        u8 = []
        for dev, src in (("cpu", unet_cpu), ("cuda", unet_gpu)):
            with torch.device("meta"):
                u = UNet2DCondition(C.SD15_UNET, "int8")
            u = u.to_empty(device=dev).to(memory_format=CL).eval()
            u.load_state_dict(src.state_dict())
            u8.append(u)
        del unet_gpu, unet_cpu
        dyn = QuantState("int8")
        set_quant(u8[0], dyn)
        with torch.inference_mode():
            with dyn.collect() as sink:
                u8[0](x, t, ctx)
            table = {k: float(v) for k, v in sink.items()}
            states = [QuantState("int8_static", table) for _ in u8]
            for u, st in zip(u8, states):
                set_quant(u, st)
            before = collections.Counter(_build.launch_counts)
            ref8 = u8[0](x, t, ctx)
            got8 = u8[1](x.cuda(), t.cuda(), ctx.cuda()).cpu()
            with _perturbed((u8[0],), 1e-6, gen):
                pert8 = u8[0](x, t, ctx)
            with _planted("k3_tap"):
                fault8 = u8[0](x, t, ctx)
        launched = {k: _build.launch_counts[k] - before[k]
                    for k in ("conv3x3_int8", "int8_attention")}
        rel_fro = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))  # noqa: E731
        rel, fault_rel = rel_fro(got8, ref8), rel_fro(fault8, ref8)
        log(f"SD15 UNet 32x32 int8_static ({len(table)} sites): cuda vs cpu relative "
            f"Frobenius error {rel:.4f} (tol {INT8_UNET_REL_TOL}); on the cpu: w8a8 against "
            f"fp32 {rel_fro(ref8, ref):.4f}, 1e-6-perturbed layer inputs "
            f"{rel_fro(pert8, ref8):.4f}, planted K3 tap fault {fault_rel:.4f}; cuda fp32 "
            f"(quantization off) against cpu int8 {rel_fro(got, ref8):.4f}; cuda launches "
            f"{launched}")
        if not (torch.isfinite(got8).all() and rel <= INT8_UNET_REL_TOL
                and all(v > 0 for v in launched.values())
                and not any(st.misses for st in states)):
            raise AssertionError("SD15 int8 UNet disagrees between CUDA and CPU")
        if not fault_rel > INT8_UNET_REL_TOL:
            raise AssertionError("the SD15 int8 limit passes a planted K3 fault")
        del u8
        torch.cuda.empty_cache()

        # TINY_SD_INPAINT's inpaint function (9-channel UNet input), CPU against CUDA.
        icpu = sampling.SDModules.create(C.TINY_SD_INPAINT, torch.float32, "cpu")
        for m in icpu.components().values():
            init_random_(m, gen)
        igpu = sampling.SDModules.create(C.TINY_SD_INPAINT, torch.float32, "cuda")
        for name, m in igpu.components().items():
            m.load_state_dict(icpu.components()[name].state_dict())
        mask = torch.zeros((1, 64, 64, 1))
        mask[:, 16:44, 8:40] = 1.0
        noise3 = tuple(torch.randn((1, 8, 8, 4), generator=gen) for _ in range(3))
        before = collections.Counter(_build.launch_counts)
        outs = []
        for mods in (icpu, igpu):
            ctx = sampling.encode_text(mods, ids)
            fn = sampling.make_inpaint_fn(mods, 10, 0.6, 5.0, "ddim")
            outs.append(fn(image, mask, ctx[:1], ctx[1:], noise=noise3).cpu())
        launched = {k: _build.launch_counts[k] - before[k] for k in ("attention", "group_norm")}
        err = float((outs[0] - outs[1]).abs().max())
        log(f"TINY_SD_INPAINT inpaint ddim gs=5.0: cuda vs cpu max abs err {err:.3e} "
            f"(tol {PARITY_TOL}); cuda launches {launched}")
        if not (err <= PARITY_TOL and all(v > 0 for v in launched.values())):
            raise AssertionError(f"TINY_SD_INPAINT inpaint disagrees: {err}")

        # One full-width 9-channel (SD-1.5-inpaint) UNet call at 32x32 latents.
        unet9_gpu = sampling.SDModules.create(C.SD15_INPAINT, torch.float32, "cuda").unet
        init_random_(unet9_gpu, gen_cuda)
        with torch.device("meta"):
            unet9_cpu = UNet2DCondition(C.SD15_INPAINT_UNET)
        unet9_cpu = unet9_cpu.to_empty(device="cpu").eval()
        unet9_cpu.load_state_dict(unet9_gpu.state_dict())
        x9 = torch.randn((1, 32, 32, 9), generator=gen)
        ctx9 = torch.randn((1, 77, 768), generator=gen)
        with torch.inference_mode():
            ref = unet9_cpu(x9, t, ctx9)
            got = unet9_gpu(x9.cuda(), t.cuda(), ctx9.cuda()).cpu()
        scale = float(ref.abs().max())
        err = float((ref - got).abs().max())
        log(f"SD15_INPAINT UNet (9 channels) 32x32 fp32: cuda vs cpu max abs err {err:.3e}, "
            f"max |eps| {scale:.3e} (tol {UNET_REL_TOL} x max |eps|)")
        if not (torch.isfinite(got).all() and err <= UNET_REL_TOL * scale):
            raise AssertionError("SD15_INPAINT UNet disagrees between CUDA and CPU")
        del unet9_gpu, unet9_cpu, igpu
        torch.cuda.empty_cache()

        # TINY_SDXL's img2img function (both towers, the text_time conditioning,
        # Linear projections), CPU against CUDA.
        xcpu = sampling.SDModules.create(C.TINY_SDXL, torch.float32, "cpu")
        for m in xcpu.components().values():
            init_random_(m, gen)
        xgpu = sampling.SDModules.create(C.TINY_SDXL, torch.float32, "cuda")
        for name, m in xgpu.components().items():
            m.load_state_dict(xcpu.components()[name].state_dict())
        xids = torch.randint(0, C.TINY_SDXL.text_encoder.vocab_size, (2, 77), generator=gen)
        before = collections.Counter(_build.launch_counts)
        outs = []
        for mods in (xcpu, xgpu):
            c, p = sampling.encode_text_sdxl(mods, xids)
            fn = sampling.make_img2img_fn(mods, 10, 0.5, 5.0, "ddim")
            outs.append(fn(image, (c[:1], p[:1]), (c[1:], p[1:]), noise=noise).cpu())
        launched = {k: _build.launch_counts[k] - before[k] for k in ("attention", "group_norm")}
        err = float((outs[0] - outs[1]).abs().max())
        log(f"TINY_SDXL img2img ddim gs=5.0: cuda vs cpu max abs err {err:.3e} "
            f"(tol {PARITY_TOL}); cuda launches {launched}")
        if not (err <= PARITY_TOL and all(v > 0 for v in launched.values())):
            raise AssertionError(f"TINY_SDXL img2img disagrees: {err}")

        # One full-width SDXL UNet call at 32x32 latents with added_cond
        # (N = 256 and 64, head_dim 64): initialised on the card, copied to the CPU.
        with torch.device("meta"):
            uxl_gpu = UNet2DCondition(C.SDXL_UNET).to(memory_format=CL)
            uxl_cpu = UNet2DCondition(C.SDXL_UNET)
        uxl_gpu = init_random_(uxl_gpu.to_empty(device="cuda").eval(), gen_cuda)
        uxl_cpu = uxl_cpu.to_empty(device="cpu").eval()
        uxl_cpu.load_state_dict(uxl_gpu.state_dict())
        xs = torch.randn((1, 32, 32, 4), generator=gen)
        ctx_xl = torch.randn((1, 77, C.SDXL_UNET.cross_attention_dim), generator=gen)
        added = {"text_embeds": torch.randn((1, C.SDXL.text_encoder_2.hidden_size),
                                            generator=gen),
                 "time_ids": sampling.sdxl_time_ids(1, 256)}
        with torch.inference_mode():
            ref = uxl_cpu(xs, t, ctx_xl, added)
            got = uxl_gpu(xs.cuda(), t.cuda(), ctx_xl.cuda(),
                          {k: v.cuda() for k, v in added.items()}).cpu()
        scale = float(ref.abs().max())
        err = float((ref - got).abs().max())
        log(f"SDXL UNet 32x32 fp32 with added_cond: cuda vs cpu max abs err {err:.3e}, "
            f"max |eps| {scale:.3e} (tol {UNET_REL_TOL} x max |eps|)")
        if not (torch.isfinite(got).all() and err <= UNET_REL_TOL * scale):
            raise AssertionError("SDXL UNet disagrees between CUDA and CPU")
        del uxl_gpu, uxl_cpu, xgpu
        torch.cuda.empty_cache()


def _serve(pipe, image, requests):
    """Answer 512x512 denoise ``requests`` ((label, kwargs) pairs) with launch
    counts zeroed just before and read just after (``_serve_calls``)."""
    return _serve_calls([(label, lambda kw=kw: pipe.denoise(image, **kw), (512, 512, 3))
                         for label, kw in requests])


def _serve_calls(requests, onchip_hw: int = 4096):
    """Answer ``requests`` ((label, call, output shape)) with launch counts
    zeroed just before and read just after: (seconds, outputs, launches,
    shapes, codes, peak bytes); ``codes`` counts the attention launches by
    device code, after checking them (``_check_attention_paths``,
    ``_check_k2_k3_paths`` with ``onchip_hw``)."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    seconds, outs = [], []
    for label, call, shape in requests:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        log(f"request {label}: {seconds[-1]:.3f} s")
        if not (isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == shape):
            raise AssertionError(f"bad output {type(out)} {getattr(out, 'shape', None)}, "
                                 f"not uint8 {shape}")
        outs.append(out)
    launches = dict(_build.launch_counts)
    shapes = dict(_build.launch_shapes)
    codes = dict(_build.launch_paths)
    _check_attention_paths(shapes, codes)
    _check_k2_k3_paths(shapes, codes, onchip_hw)
    return seconds, outs, launches, shapes, codes, torch.cuda.max_memory_allocated()


def _check_attention_paths(shapes, codes) -> None:
    """Every attention launch of a serve went through the sm90 code: "sm90" at
    head_dim <= 160, "sm90_split" above (the VAE mid-block, which every
    request runs), and every int8 attention (K4) launch "sm90" (s8 wgmma +
    TMA, no padded copies). ``shapes``: launches by (kernel, shape key);
    ``codes``: by (kernel, path)."""
    from image_restoration_and_enhancement_torch.ops import attention as A

    kernels = ATTENTION_KERNELS + ("int8_attention",)
    want = collections.Counter()
    for (kernel, key), n in shapes.items():
        if kernel in kernels:
            d, dtype = key[4], key[5]
            if dtype != "torch.bfloat16":
                raise AssertionError(f"a {dtype} attention launch in a bf16 serve: {key}")
            want[(kernel, "sm90" if d <= A.SM90_MAX_HEAD_DIM else "sm90_split")] += n
    got = {k: n for k, n in codes.items() if k[0] in kernels}
    log(f"attention launches by path: { {f'{k}/{p}': n for (k, p), n in sorted(got.items())} }")
    if got != dict(want):
        raise AssertionError(f"attention launches by path {got}, not {dict(want)}")
    if not want[("attention", "sm90_split")]:
        raise AssertionError("the VAE mid-block's attention did not run sm90_split")


def _check_k2_k3_paths(shapes, codes, onchip_hw: int = 4096) -> None:
    """Every GroupNorm (K2) and int8 conv (K3) launch of a serve went through
    the path its plan names (``groupnorm.plan``, ``conv_int8.conv_path``),
    every GroupNorm at SD-1.5's UNet latent sizes (H*W <= ``onchip_hw``)
    through "onchip" (one launch a call; the SDXL serve passes 0: its
    64x64x1920 up-path norm at batch 2 is planned twophase), and every K3
    launch through "sm90" (each served 3x3 conv is one of SD-1.5's UNet or
    VAE)."""
    import torch

    from image_restoration_and_enhancement_torch.ops import conv_int8 as K3
    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = collections.Counter()
    for (kernel, key), n in shapes.items():
        if kernel == "group_norm":
            b, h, w, c = key[:4]
            path = G.plan(b, h * w, c, torch.empty((), dtype=_dtype(key[7])).element_size(),
                          sms).path
            if h * w <= onchip_hw and path != "onchip":
                raise AssertionError(f"a UNet-sized GroupNorm is planned {path}: {key}")
            want[(kernel, path)] += n
        elif kernel == "conv3x3_int8":
            path = K3.conv_path(*key[:5])
            if path != "sm90":
                raise AssertionError(f"an int8 conv of the serve is planned {path}: {key}")
            want[(kernel, path)] += n
    got = {k: n for k, n in codes.items() if k[0] in ("group_norm", "conv3x3_int8")}
    log(f"K2/K3 launches by path: { {f'{k}/{p}': n for (k, p), n in sorted(got.items())} }")
    if got != dict(want):
        raise AssertionError(f"K2/K3 launches by path {got}, not {dict(want)}")


def _pipeline(tmp, **kw):
    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline

    return _recording(RestorationPipeline(
        config={"denoise": {"fine_tuned_dir": tmp, "default_backend": "diffusion"}}, **kw))


SDCall = collections.namedtuple("SDCall", "stack kind settings args fn seconds captured")


def _recording(pipe):
    """``pipe`` with its SD calls kept in ``pipe.sd_calls`` (``SDCall``: the
    stack, the kind, (steps, strength, gs, sampler), the sampling function's
    arguments, the pipeline's function itself, the call's seconds, and whether
    the call captured a graph), so that ``_graph_ab`` can serve the same call
    again from the pipeline's own graph and eagerly."""
    import torch

    pipe.sd_calls = []
    orig = pipe._sampler_fn

    def sampler_fn(stack, kind, *settings):
        fn = orig(stack, kind, *settings)

        def call(*args, **kwargs):
            known = {id(g) for g in getattr(fn, "graphs", {}).values()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            last = getattr(fn, "last", None)
            pipe.sd_calls.append(SDCall(stack, kind, settings, args, fn,
                                        time.perf_counter() - t0,
                                        last is not None and id(last) not in known))
            return out
        return call

    pipe._sampler_fn = sampler_fn
    return pipe


def _launch_profile(request):
    """One request under torch.profiler: (device microseconds, device events
    by kernel group (``_kernel_group``), host launch calls, the request's own
    seconds inside the profile). The host launch calls are the CUDA runtime
    (cuda*) and cu* API calls that issue device work (kernel, graph, copy and
    memset launches) the profiler recorded. The request runs 0.1 s after the
    profile starts and ends 0.2 s before it stops (host sleeps, no device
    work): profiles that began and ended with the request missed up to 15 of
    the VAE's twophase K2 launches, which run first and last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        time.sleep(0.2)
    results = prof.profiler.kineto_results
    groups = collections.Counter()
    device_us = 0.0
    for name, (us, n) in _device_events(results).items():
        groups[_kernel_group(name, "K1 attention")] += n
        device_us += us
    host = sum(1 for e in results.events() if e.name().startswith(_LAUNCH_CALLS))
    return device_us, dict(groups), host, wall_s


def _device_launches(paths) -> dict:
    """The device launches by ``_kernel_group`` label that host-counted
    launches by (kernel, path) make: one a call, two for a twophase
    GroupNorm (statistics, then apply); the UNet sites' tensor-core
    attention codes under "K1 attention"."""
    want = collections.Counter()
    for (kernel, path), n in paths.items():
        if kernel == "group_norm":
            want[f"K2 group_norm ({path})"] += 2 * n if path == "twophase" else n
        elif kernel == "conv3x3_int8":
            want[f"K3 conv3x3_int8 ({path})"] += n
        elif kernel == "int8_attention":
            want[f"K4 int8_attention ({path})"] += n
        elif path == "sm90_split":
            want["K1 attention (VAE d 512, sm90_split)"] += n
        else:
            want["K1 attention" if path in ("sm90", "mma") else "K1 attention (simt)"] += n
    return dict(want)


_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                 "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                 "cuMemcpy", "cuMemset")


def _graph_ab(pipe, mode, pick=lambda call: True):
    """The last SD call of ``pipe`` that ``pick`` accepts, served again from
    the pipeline's own graphed function (a replay of the graph the phase
    captured) and by the eager function (``graph=False``) of the same stack
    and settings, graphed then eager on each of three requests: the call's
    inputs, the image mirrored with other noise, the inputs with a third
    noise. Fails unless each request's graphed image equals the eager one
    bitwise and the host counters give the same launches by kernel and path
    (and, under int8_static, the same table misses); and unless the replayed
    graph's kernel nodes, read from the CUDA driver (``graphs.graph_nodes``),
    are by kernel (K1-K6b) the device launches that the eager request's host
    counters give. One graphed request is profiled and read, not held: its
    device events and time, its busy share over its own seconds inside the
    profile. Logs ("graph_json") the first graphed call's seconds (the phase's
    call that warmed up and captured), the three graphed and eager seconds,
    the launches a request issues (graphed: the profile's host launch calls;
    eager: the graph's nodes, which the eager function launches one by one),
    the busy shares (eager: the graphed profile's device time over the eager
    seconds, an estimate: the same kernels on the same data) and the peak
    memory (allocated; and reserved, which holds the graphs' pool)."""
    import torch

    from image_restoration_and_enhancement_torch.core import graphs, sampling
    from image_restoration_and_enhancement_torch.ops import _build

    call = [c for c in pipe.sd_calls if pick(c)][-1]
    shapes = lambda c: [tuple(a.shape) for a in c.args if torch.is_tensor(a)]  # noqa: E731
    first = [c for c in pipe.sd_calls
             if c.fn is call.fn and c.captured and shapes(c) == shapes(call)]
    if not isinstance(call.fn, graphs.GraphedServe) or not first:
        raise AssertionError(f"{mode}: the pipeline did not serve this call from a graph")
    mods = call.stack["modules"]
    maker = sampling.make_inpaint_fn if call.kind == "inpaint" else sampling.make_img2img_fn
    fns = {"graphed": call.fn,
           "eager": maker(mods, *call.settings, cfg_cache_interval=pipe.cfg_cache_interval,
                          graph=False)}
    mirrored = (torch.flip(call.args[0], dims=[2]),) + tuple(call.args[1:])

    def request(which, inputs, seed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (collections.Counter(_build.launch_counts),
                  collections.Counter(_build.launch_paths))
        if mods.quant is not None:
            mods.quant.misses.clear()
        t0 = time.perf_counter()
        out = fns[which](*inputs, generator=torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = (dict(collections.Counter(_build.launch_counts) - before[0]),
                    dict(collections.Counter(_build.launch_paths) - before[1]))
        misses = set(mods.quant.misses) if mods.quant is not None else set()
        return out, secs, launched, misses, torch.cuda.max_memory_allocated()

    pairs = []
    for i, (inputs, seed) in enumerate(((call.args, SEED), (mirrored, SEED + 7),
                                        (call.args, SEED + 14))):
        got, want = request("graphed", inputs, seed), request("eager", inputs, seed)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{mode}: the graphed image differs from the eager one on "
                                 f"request {i} (max |d| {(got[0] - want[0]).abs().max():.3e})")
        if got[2:4] != want[2:4]:
            raise AssertionError(f"{mode}: graphed launches/misses {got[2:4]} on request {i}, "
                                 f"eager {want[2:4]}")
        pairs.append((got, want))
    if torch.equal(pairs[0][0][0], pairs[1][0][0]):
        raise AssertionError(f"{mode}: two different requests gave the same image")
    expected = _device_launches(pairs[0][1][2][1])  # the eager request's, by the host counters
    nodes = graphs.graph_nodes(call.fn.last.graph)
    kernels = collections.Counter()
    for name, n in nodes.items():
        group = _kernel_group(name, "K1 attention")
        if group.startswith("K"):
            kernels[group] += n
    if dict(kernels) != expected:
        raise AssertionError(f"{mode}: the graph's kernel nodes {dict(kernels)}, not the eager "
                             f"request's launches {expected}")
    steady = {w: [p[i][1] for p in pairs] for i, w in enumerate(("graphed", "eager"))}
    peak = {w: max(p[i][4] for p in pairs) for i, w in enumerate(("graphed", "eager"))}
    reserved = torch.cuda.memory_reserved()
    device_us, seen, host_calls, wall_s = _launch_profile(lambda: call.fn(
        *call.args, generator=torch.Generator(device="cuda").manual_seed(SEED)))
    seen_kernels = {k: n for k, n in seen.items() if k.startswith("K")}
    if seen_kernels != expected:
        log(f"graph {mode}: the graphed profile saw kernel events {seen_kernels}, the graph "
            f"launches {expected} (read, not held)")
    row = {"mode": mode, "first_graphed_s": first[0].seconds,
           "steady_graphed_s": steady["graphed"], "steady_eager_s": steady["eager"],
           "launches_per_request": {"graphed_host_launch_calls": host_calls,
                                    "eager_graph_nodes": sum(nodes.values())},
           "graph_nodes": {"kernel": sum(n for k, n in nodes.items() if not k.startswith("<")),
                           **{k: n for k, n in nodes.items() if k.startswith("<")}},
           "kernel_launches": dict(kernels),
           "graphed_profile": {"device_events": sum(seen.values()), "device_ms": device_us / 1e3,
                               "request_ms": wall_s * 1e3, "kernel_events": seen_kernels},
           "device_busy_share": {"graphed": device_us / 1e6 / wall_s,
                                 "eager_estimate": device_us / 1e6 / min(steady["eager"])},
           "peak_allocated_bytes": peak, "reserved_bytes_after": reserved}
    log(f"graph {mode}: first graphed {first[0].seconds:.3f} s, steady graphed "
        f"{min(steady['graphed']):.3f} s, eager {min(steady['eager']):.3f} s; bitwise equal "
        "on three requests; the same launches by host count; the graph's kernel nodes equal "
        "to the eager request's launches")
    log("graph_json " + json.dumps(row))
    del fns
    return row


def _check_misses_replayed(pipe):
    """int8_static under a table missing one site: a graphed function reports
    the miss at its first call and at every replay, as eagerly."""
    import torch

    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.ops import quant

    stack, kind, settings, args = pipe.sd_calls[-1][:4]
    mods, full = stack["modules"], pipe.quant
    missing = sorted(full.table)[0]
    state = quant.QuantState("int8_static", {s: a for s, a in full.table.items()
                                             if s != missing})
    mods.set_quant(state)
    try:
        fn = sampling.make_img2img_fn(mods, *settings, graph=True)
        for i in range(3):
            state.misses.clear()
            fn(*args, generator=torch.Generator(device="cuda").manual_seed(SEED + i))
            if state.misses != {missing}:
                raise AssertionError(f"int8_static call {i} reported misses {state.misses}, "
                                     f"not {{{missing!r}}}")
        del fn
    finally:
        mods.set_quant(full)
    log(f"int8_static with {missing!r} left out of the table: the miss reported at the "
        "graphed function's first call and at both replays")


def phase_serve(tmp):
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    with _Phase("serve"):
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

        pipe = _pipeline(tmp)
        image = np.random.default_rng(SEED).integers(0, 256, (512, 512, 3), dtype=np.uint8)
        requests = [("default (gs 5.0, CFG batch 2; includes the stack load)", {}),
                    ("guidance=1.0 (no CFG branch; first batch-1 call)", {"guidance": 1.0}),
                    ("default again (steady state)", {}),
                    ("guidance=1.0 again (steady state)", {"guidance": 1.0})]
        seconds, outs, launches, shapes, codes, peak = _serve(pipe, image, requests)
        log(f"serve launches: {launches}; peak memory {peak / 2**30:.3f} GiB")
        for k in ("attention", "group_norm"):
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"kernel {k} did not launch on the main path")
        log("serve_json " + json.dumps(
            {"request_seconds": seconds, "peak_memory_bytes": peak, "launches": launches}))
        _profile_request(lambda: pipe.denoise(image), seconds[2])
        graph = [_graph_ab(pipe, "serve bf16 CFG", lambda c: c[3][-1] is not None),
                 _graph_ab(pipe, "serve bf16 gs 1.0", lambda c: c[3][-1] is None)]
    return {"request_seconds": seconds, "peak_bytes": peak, "launches": launches,
            "shapes": shapes, "codes": codes, "image": image, "out_cfg": outs[2],
            "graph": graph}


def phase_serve_int8(tmp, bf16):
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.tokenizer import load_tokenizer
    from image_restoration_and_enhancement_torch.tasks.registry import get_task

    image = bf16["image"]
    with _Phase("serve_int8"):
        # Calibrate on the request image: the task's prompt, sampler and
        # strength, and the pipeline's seed, on the stack just written.
        t0 = time.perf_counter()
        spec = get_task("denoise")
        mods = sampling.SDModules.create(C.SD15, torch.bfloat16, "cuda", attention_backend="int8")
        params = ckpt.load_pipeline(tmp)
        for comp, m in mods.components().items():
            m.load_state_dict(ckpt.params_from_flax(params.pop(comp)), strict=True)
        tok = load_tokenizer(tmp, vocab_size=C.SD15.text_encoder.vocab_size)
        with torch.inference_mode():
            ctx = sampling.encode_text(mods, torch.as_tensor(tok([spec.prompt])))
            uncond = sampling.encode_text(mods, torch.as_tensor(tok([""])))
        x = torch.from_numpy(image.astype(np.float32) / 127.5 - 1.0)[None]
        sd = spec.sampler
        calib = sampling.make_calib_img2img_fn(mods, sd.num_inference_steps, 0.5,
                                               sd.guidance_scale, sd.sampler)
        _, table = calib(x, ctx, uncond, generator=torch.Generator(device="cuda").manual_seed(42))
        path = os.path.join(tmp, "quant_calib.json")
        with open(path, "w") as f:
            json.dump({"sites": table}, f)
        log(f"calibrated {len(table)} sites on the request image and wrote {path} in "
            f"{time.perf_counter() - t0:.2f} s")
        del calib, mods, params
        torch.cuda.empty_cache()

        pipe = _pipeline(tmp, quant="int8_static", quant_calib=path, attention_backend="int8")
        requests = [("int8 default (gs 5.0, CFG batch 2; includes the stack load)", {}),
                    ("int8 default again (steady state)", {}),
                    ("int8 guidance=1.0 (no CFG branch)", {"guidance": 1.0})]
        seconds, outs, launches, shapes, codes, peak = _serve(pipe, image, requests)
        log(f"serve_int8 launches: {launches}; peak memory {peak / 2**30:.3f} GiB")
        for k in ("conv3x3_int8", "int8_attention", "attention", "group_norm"):
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"kernel {k} did not launch on the int8 path")
        want = UNET_ATTENTION_PER_REQUEST * len(requests)
        if codes.get(("int8_attention", "sm90"), 0) != want:
            raise AssertionError(f"K4 launched {launches['int8_attention']} times, "
                                 f"{codes.get(('int8_attention', 'sm90'), 0)} on sm90, "
                                 f"not {want} on sm90")
        if pipe.quant.misses:
            raise AssertionError(f"sites missing from the table: {sorted(pipe.quant.misses)}")
        psnr = _psnr(outs[1], bf16["out_cfg"], 255.0)
        log(f"int8 CFG output against the bf16 serve's on the same input: PSNR {psnr:.2f} dB "
            "(random weights: printed, not gated)")
        log("serve_int8_json " + json.dumps(
            {"request_seconds": seconds, "peak_memory_bytes": peak, "launches": launches,
             "psnr_vs_bf16_db": psnr, "static_misses": sorted(pipe.quant.misses)}))
        _profile_request(lambda: pipe.denoise(image), seconds[1])
        graph = [_graph_ab(pipe, "serve_int8 int8_static CFG", lambda c: c[3][-1] is not None)]
        _check_misses_replayed(pipe)
        _layer_parity(pipe, image)
    return {"request_seconds": seconds, "peak_bytes": peak, "launches": launches,
            "shapes": shapes, "codes": codes, "graph": graph}


_VARIANT_KERNEL = {"flash": "flash_attention", "pallas_packed": "packed_attention_grid"}
_VARIANT_LABEL = {"flash": "K5 flash_attention", "pallas_packed": "K6b packed_attention_grid"}


def phase_serve_variant(tmp, bf16, backend):
    """The bf16 stack with K5 ("flash") or K6b ("pallas_packed") at every UNet
    attention site: a first and a steady CFG request."""
    import torch

    name = {"flash": "serve_flash", "pallas_packed": "serve_packed"}[backend]
    kernel = _VARIANT_KERNEL[backend]
    image = bf16["image"]
    with _Phase(name):
        torch.cuda.empty_cache()
        pipe = _pipeline(tmp, attention_backend=backend)
        requests = [(f"{backend} default (gs 5.0, CFG batch 2; includes the stack load)", {}),
                    (f"{backend} default again (steady state)", {})]
        seconds, outs, launches, shapes, codes, peak = _serve(pipe, image, requests)
        log(f"{name} launches: {launches}; peak memory {peak / 2**30:.3f} GiB")
        want = {kernel: UNET_ATTENTION_PER_REQUEST * len(requests),
                "attention": VAE_ATTENTION_PER_REQUEST * len(requests)}
        for k, n in want.items():
            if launches.get(k, 0) != n:
                raise AssertionError(f"{name}: {k} launched {launches.get(k, 0)} times, not {n}")
        psnr = _psnr(outs[1], bf16["out_cfg"], 255.0)
        log(f"{backend} CFG output against the bf16 serve's on the same input: PSNR "
            f"{psnr:.2f} dB (inf: bitwise equal; random weights: printed, not gated)")
        log(f"{name}_json " + json.dumps(
            {"request_seconds": seconds, "peak_memory_bytes": peak, "launches": launches,
             "psnr_vs_bf16_db": psnr if math.isfinite(psnr) else None}))
        _profile_request(lambda: pipe.denoise(image), seconds[1], _VARIANT_LABEL[backend])
        graph = [_graph_ab(pipe, f"{name} CFG")]
        del pipe
        torch.cuda.empty_cache()
    return {"request_seconds": seconds, "peak_bytes": peak, "launches": launches,
            "shapes": shapes, "codes": codes, "graph": graph}


def _unet_calls(task: str) -> int:
    """UNet calls of one request of ``task`` at its defaults (the port's step plans)."""
    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import schedulers as sched
    from image_restoration_and_enhancement_torch.tasks.registry import get_task

    sd = get_task(task).sampler
    plan_fn = sched.plms_step_plan if sd.sampler == "plms" else sched.ddim_step_plan
    return plan_fn(C.SD15_SCHEDULER, sd.num_inference_steps, sd.strength).num_calls


def _k1_per_request(task: str) -> int:
    """K1 launches of one request: 32 UNet sites a call, and the VAE mid-block
    once per encode and once for the decode (inpaint encodes twice)."""
    return 32 * _unet_calls(task) + (3 if task == "inpaint" else 2)


def _damaged_grey(size: int, seed: int):
    """A grey (R = G = B) image with two very dark bands, which the auto mask
    flags (grey level <= 30)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = rng.integers(60, 200, (size, size), dtype=np.uint8)
    g[size // 5: size // 5 + size // 12, size // 10: 9 * size // 10] = 5
    g[size // 2: size // 2 + size // 8, size // 3: size // 2] = 12
    return np.stack([g] * 3, axis=-1)


def phase_serve_tasks(tmp, bf16):
    """super_resolve, colorize, inpaint and process on SD-1.5 stacks in bf16
    (the default attention backend), and super_resolve through RRDBNet."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.infer import fallbacks
    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
    from image_restoration_and_enhancement_torch.models import rrdbnet
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    with _Phase("serve_tasks"):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tmp_inpaint = os.path.join(tmp, "inpaint")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        mods = sampling.SDModules.create(C.SD15_INPAINT, torch.bfloat16, "cuda")
        for m in mods.components().values():
            init_random_(m, gen)
        n_unet = sum(p.numel() for p in mods.unet.parameters())
        if n_unet != SD15_INPAINT_UNET_PARAMS:
            raise AssertionError(f"the 9-channel UNet has {n_unet} parameters")
        ckpt.save_pipeline(tmp_inpaint, mods.components(), C.SD15_INPAINT, dtype=torch.bfloat16)
        del mods
        torch.cuda.empty_cache()
        log(f"random SD-1.5-inpaint stack (UNet {n_unet} parameters, 9 input channels) "
            f"written in {time.perf_counter() - t0:.2f} s")

        config = {t: {"fine_tuned_dir": tmp, "default_backend": "diffusion"}
                  for t in ("denoise", "sr_x4", "colorize")}
        config["inpaint"] = {"fine_tuned_dir": tmp_inpaint, "default_backend": "diffusion"}
        pipe = _recording(RestorationPipeline(config=config))
        rng = np.random.default_rng(SEED)
        small = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
        photo = bf16["image"]
        grey = np.repeat(rng.integers(40, 220, (512, 512, 1), dtype=np.uint8), 3, axis=2)
        hole = np.zeros((512, 512), np.uint8)
        hole[128:320, 96:400] = 255
        damaged = _damaged_grey(512, SEED)
        requests = [
            ("sr_x4", "sr_x4 128->512 (includes the stack load)",
             lambda: pipe.super_resolve(small), (512, 512, 3)),
            ("sr_x4", "sr_x4 128->512 again (steady state)",
             lambda: pipe.super_resolve(small), (512, 512, 3)),
            ("sr_x4", "sr_x4 512->2048 (SD at the 1024 bucket)",
             lambda: pipe.super_resolve(photo), (2048, 2048, 3)),
            ("colorize", "colorize grey 512 (includes the stack load)",
             lambda: pipe.colorize(grey), (512, 512, 3)),
            ("colorize", "colorize grey 512 again (steady state)",
             lambda: pipe.colorize(grey), (512, 512, 3)),
            ("inpaint", "inpaint 512 with a rectangular hole (includes the stack load)",
             lambda: pipe.inpaint(photo, mask=hole), (512, 512, 3)),
            ("inpaint", "inpaint 512 with a rectangular hole again (steady state)",
             lambda: pipe.inpaint(photo, mask=hole), (512, 512, 3)),
            ("inpaint", "inpaint 512, mask=None (the auto mask)",
             lambda: pipe.inpaint(damaged), (512, 512, 3)),
        ]
        if fallbacks.auto_mask_from_image(damaged) is None:
            raise AssertionError("the damaged image gives no auto mask")
        rows, shapes, codes, launches = [], collections.Counter(), collections.Counter(), \
            collections.Counter()
        peak = 0

        def run(task, label, call, shape, k1_want):
            """One request, counted alone; ``k1_want`` is K1's launches, or a
            function that works them out from what the request did."""
            nonlocal peak
            secs, outs, n, sh, cd, pk = _serve_calls([(label, call, shape)])
            if callable(k1_want):
                k1_want = k1_want()
            for k in ("attention", "group_norm"):
                if n.get(k, 0) <= 0:
                    raise AssertionError(f"{label}: kernel {k} did not launch")
            if n["attention"] != k1_want:
                raise AssertionError(f"{label}: K1 launched {n['attention']} times, not {k1_want}")
            shapes.update(sh)
            codes.update(cd)
            launches.update(n)
            peak = max(peak, pk)
            rows.append({"task": task, "request": label, "seconds": secs[0],
                         "peak_memory_bytes": pk, "launches": n, "k1_expected": k1_want})
            return outs[0]

        for task, label, call, shape in requests:
            run(task, label, call, shape, _k1_per_request(task))
        # process: denoise, then colorize (skipped when the denoised image has
        # colour), then inpaint (skipped when the auto mask finds nothing)
        results, ran = {}, {}

        def process():
            results.update(pipe.process(damaged, ["denoise", "colorize", "inpaint"]))
            return results["final"]

        def process_k1():
            ran["colorize"] = not fallbacks.is_color_image(results["denoised"])
            ran["inpaint"] = fallbacks.auto_mask_from_image(results["colorized"]) is not None
            return _k1_per_request("denoise") + sum(
                _k1_per_request(t) for t in ("colorize", "inpaint") if ran[t])

        run("process", "process(denoise, colorize, inpaint) on a damaged grey 512",
            process, (512, 512, 3), process_k1)
        if set(results) != {"original", "denoised", "colorized", "inpainted", "final"}:
            raise AssertionError(f"process returned {sorted(results)}")
        log(f"process ran SD for denoise and for {[t for t, r in ran.items() if r]}")
        calls = {t: _unet_calls(t) for t in ("sr_x4", "colorize", "inpaint")}
        log(f"UNet calls per request: {calls}")
        log("serve_tasks_json " + json.dumps({"requests": rows, "peak_memory_bytes": peak}))

        profiles = {}
        steady = {r["request"]: r["seconds"] for r in rows}
        for task, label, call, _ in (requests[1], requests[2], requests[4], requests[6]):
            log(f"profile: {label}")
            profiles[label] = _profile_request(call, steady[label])
        graph = [_graph_ab(pipe, f"serve_tasks {task}", lambda c, task=task: (
            c[0]["spec"].name == task and c[3][0].shape[1] == 512))
            for task in ("sr_x4", "colorize", "inpaint")]
        del pipe
        torch.cuda.empty_cache()

        # RRDBNet: no SD stack for sr_x4, random Real-ESRGAN weights in the JAX layout.
        wdir = os.path.join(tmp, "weights")
        model = rrdbnet.RRDBNet()
        init_random_(model, torch.Generator().manual_seed(SEED))
        rrdbnet.save_weights(model, os.path.join(wdir, rrdbnet.WEIGHTS_FILE))
        env = {k: v for k, v in os.environ.items() if k != "IRET_PRETRAINED_ROOT"}
        with mock.patch.dict(os.environ, {**env, "IRET_WEIGHTS_DIR": wdir}, clear=True):
            pipe = RestorationPipeline(config={"sr_x4": {"fine_tuned_dir": "nonexistent"}})
            if pipe._load_stack("sr_x4") is not None or not rrdbnet.weights_available():
                raise AssertionError("the RRDBNet request would not reach RRDBNet")
            t0 = time.perf_counter()
            out = pipe.super_resolve(small)
            torch.cuda.synchronize()
            rrdb_s = time.perf_counter() - t0
            want = (rrdbnet.upscale_x4(small.astype(np.float32) / 255.0, "cuda") * 255
                    ).astype(np.uint8)
            crop = torch.from_numpy(small[:32, :32].astype(np.float32) / 255.0)[None]
            path = rrdbnet.weights_path()
            with torch.inference_mode():
                got = rrdbnet.load_weights(path, "cuda")(crop.cuda()).cpu()
                ref = rrdbnet.load_weights(path, "cpu")(crop)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"sr_x4 by RRDBNet 128->512 on the card: {rrdb_s:.3f} s; 32x32 crop cuda vs cpu max "
            f"abs err {err:.3e}, max |out| {scale:.3e} (tol {RRDB_REL_TOL} x max |out|)")
        if not (out.dtype == np.uint8 and out.shape == (512, 512, 3)
                and np.array_equal(out, want)
                and not np.array_equal(out, fallbacks.sr_lanczos(small, 4))):
            raise AssertionError("super_resolve did not serve from RRDBNet")
        if not (torch.isfinite(got).all() and err <= RRDB_REL_TOL * scale):
            raise AssertionError("RRDBNet disagrees between CUDA and CPU")
        del pipe, model
        torch.cuda.empty_cache()
    return {"requests": rows, "peak_bytes": peak, "launches": dict(launches),
            "shapes": dict(shapes), "codes": dict(codes), "profiles": profiles,
            "rrdb_seconds": rrdb_s, "graph": graph}


def _attention_split(shapes):
    """K1's UNet launches (head_dim <= 160) of one request by batch, and its
    launches by (B, Nq, Nk, H, d)."""
    from image_restoration_and_enhancement_torch.ops import attention as A

    by_batch, by_shape = collections.Counter(), collections.Counter()
    for (kernel, key), n in shapes.items():
        if kernel == "attention":
            by_shape[key[:5]] += n
            if key[4] <= A.SM90_MAX_HEAD_DIM:
                by_batch[key[0]] += n
    return by_batch, by_shape


def _check_mode(mode, shapes):
    """The K1 launch shapes one CFG request of ``mode`` must give at the
    denoise defaults (11 UNet calls, 32 sites each)."""
    by_batch, by_shape = _attention_split(shapes)
    if mode == "tome":  # the 5 level-0 self-attention sites on 2048 merged tokens
        bad = by_shape[(2, 2048, 2048, 8, 40)] != 5 * 11 or any(
            k[1] == k[2] == 4096 and k[4] == 40 for k in by_shape)
    elif mode == "cfg_cache":  # rows 0, 2, 4, 6, 8, 10 full, the rest cond-only
        bad = dict(by_batch) != {2: 6 * 32, 1: 5 * 32}
    else:  # dedup: the first level-0 self-attention at the half batch
        bad = by_shape[(1, 4096, 4096, 8, 40)] != 11 or dict(by_batch) != {2: 341, 1: 11}
    if bad:
        raise AssertionError(f"{mode}: K1's UNet launches by batch {dict(by_batch)}, by shape "
                             f"{dict(by_shape)}")


def phase_serve_modes(tmp, bf16):
    """The opt-in serving modes on the bf16 SD-1.5 stack, one pipeline each:
    ToMe (tome_ratio=0.5), the CFG cache (cfg_cache_interval=2) and the CFG
    prefix dedup (IRET_CFG_DEDUP=1); a first and a steady CFG request each."""
    import torch

    from image_restoration_and_enhancement_torch.ops import token_merge

    image = bf16["image"]
    modes = (("tome", {"tome_ratio": 0.5}, {}),
             ("cfg_cache", {"cfg_cache_interval": 2}, {}),
             ("dedup", {}, {"IRET_CFG_DEDUP": "1"}))
    rows, shapes, codes, launches = [], collections.Counter(), collections.Counter(), \
        collections.Counter()
    profile, graph = None, []
    with _Phase("serve_modes"):
        env = {k: v for k, v in os.environ.items()
               if k not in ("IRET_TOME", "IRET_TOME_MIN", "IRET_CFG_DEDUP")}
        for mode, kw, extra in modes:
            torch.cuda.empty_cache()
            with mock.patch.dict(os.environ, {**env, **extra}, clear=True):
                pipe = _pipeline(tmp, **kw)
                if mode == "tome" and pipe.tome != token_merge.TomeState(0.5, 4096):
                    raise AssertionError(f"the ToMe pipeline's policy is {pipe.tome}")
                for label in ("first (includes the stack load)", "steady"):
                    secs, outs, n, sh, cd, pk = _serve(pipe, image, [(f"{mode} {label}", {})])
                    if n.get("attention") != UNET_ATTENTION_PER_REQUEST + \
                            VAE_ATTENTION_PER_REQUEST or n.get("group_norm", 0) <= 0:
                        raise AssertionError(f"{mode}: launches {n}")
                    _check_mode(mode, sh)
                    psnr = _psnr(outs[0], bf16["out_cfg"], 255.0)
                    by_batch, by_shape = _attention_split(sh)
                    rows.append({"mode": mode, "request": label, "seconds": secs[0],
                                 "peak_memory_bytes": pk, "psnr_vs_bf16_db": psnr,
                                 "k1_unet_launches_by_batch": dict(by_batch)})
                    log(f"{mode} {label}: {secs[0]:.3f} s, peak {pk / 2**30:.3f} GiB, PSNR "
                        f"against the bf16 serve {psnr:.2f} dB (random weights: printed, "
                        f"not gated); K1 UNet launches by batch {dict(by_batch)}")
                    shapes.update(sh)
                    codes.update(cd)
                    launches.update(n)
                if mode == "tome":
                    profile = _profile_request(lambda: pipe.denoise(image), rows[-1]["seconds"])
                graph.append(_graph_ab(pipe, f"serve_modes {mode}"))
            del pipe
        log("serve_modes_json " + json.dumps({"requests": rows}))
    return {"requests": rows, "launches": dict(launches), "shapes": dict(shapes),
            "codes": dict(codes), "profile": profile, "graph": graph}


EVAL_TASKS = ("denoise", "sr_x4", "colorize", "inpaint")
EVAL_IMAGES = 4       # test pairs per task
EVAL_SIZE = 512       # clean images and splits; sr_x4's split is 128 px (served 128 -> 512)
EVAL_SR_SIZE = 128
# card against CPU on the same files (tests/test_torch_cuda.py's limits)
EVAL_LIMITS = {"psnr": 1e-4, "ssim": 1e-5, "delta_e": 1e-4}
EVAL_LPIPS_REL = 1e-5
DEGRADE_TOL = 1e-5    # degradations, card against CPU on the same draws (absolute)


@contextlib.contextmanager
def _torch_default_tf32():
    """torch's default TF32 settings (cuDNN may take TF32, cuBLAS not) for the
    block, then this script's (both off): the evaluation ops must own their
    precision."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _clean_images(n: int, size: int, seed: int):
    """``n`` clean uint8 photos-like images: smooth random colour fields with
    edges and mild texture."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch.ops.image import resize

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((n, 8, 8, 3), generator=g)
    field = resize(coarse, (size, size), "bicubic")
    edges = (torch.rand((n, 1, 1, 1), generator=g) * size).long()
    cols = torch.arange(size)[None, None, :, None]
    field = field + 0.25 * (cols > edges).float() + 0.03 * torch.randn(field.shape, generator=g)
    return (field.clamp(0, 1) * 255).round().to(torch.uint8).numpy().astype(np.uint8)


def _expected_metrics(task: str):
    from image_restoration_and_enhancement_torch.tasks.registry import get_task

    spec = get_task(task)
    names = {"psnr", "ssim"}
    if spec.with_y_metrics:
        names |= {"psnr_y", "ssim_y"}
    if spec.with_color_metrics:
        names |= {"psnr_l", "ssim_l", "delta_e"}
    return names


def _check_degradations(clean_u8):
    """Each task's synthetic batch (batch 2 at 512 px), drawn on the card and
    degraded there and on the CPU from the same draws; JPEG and motion blur
    alone as well. Returns the largest error of each check."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch.data import degradations as D
    from image_restoration_and_enhancement_torch.data import synthetic as S

    clean = torch.from_numpy(clean_u8[:2].astype(np.float32) / 255.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for task in EVAL_TASKS:
        draws = S.draw_batch(task, gen, 2, EVAL_SIZE, device="cuda")
        card = {k: v.cpu() for k, v in S.degrade_batch(task, clean.cuda(), draws).items()}
        host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                for k, v in draws.items()}
        cpu = S.degrade_batch(task, clean, host)
        keep = torch.ones(clean.shape[:3] + (1,), dtype=torch.bool)
        if task == "inpaint":
            near = D.near_inpaint_boundary((EVAL_SIZE, EVAL_SIZE), host)
            flips = (card["mask"] != cpu["mask"])[..., 0].numpy()
            if (flips & ~near).any() or near.mean() > 0.02:
                raise AssertionError(f"inpaint masks differ off the boundary: "
                                     f"{int((flips & ~near).sum())} pixels")
            errs["inpaint_mask_flips"] = int(flips.sum())
            keep = torch.from_numpy(~near)[..., None]
        errs[task] = float(((card["input"] - cpu["input"]).abs() * keep).max())
    quality = torch.tensor([35, 80])
    got = D.jpeg_quantize(clean.cuda(), quality.cuda()).cpu()
    bad = ((got - D.jpeg_quantize(clean, quality)).abs() > DEGRADE_TOL).any(dim=-1).numpy()
    if (bad & ~D.near_jpeg_midpoint(clean, quality)).any():
        raise AssertionError("JPEG differs outside the rounding-midpoint blocks")
    errs["jpeg_blocks_at_midpoint_differing"] = int(bad.sum())
    length, angle = torch.tensor([4.5, 13.0]), torch.tensor([0.7, 2.9])
    blur = D.motion_blur(clean.cuda(), length.cuda(), angle.cuda()).cpu()
    errs["motion_blur"] = float((blur - D.motion_blur(clean, length, angle)).abs().max())
    bad = {k: v for k, v in errs.items() if isinstance(v, float) and not v <= DEGRADE_TOL}
    if bad:
        raise AssertionError(f"degradations differ between card and CPU: {bad}")
    return errs


def phase_evaluate(tmp, smi: str):
    """The evaluation path on the card: synthetic test splits made by the
    port's SyntheticPairLoader, generate_predictions over the four tasks on
    the serve's SD-1.5 stacks, evaluate_model with LPIPS and FID on random
    weights, the card against the CPU, and the path's times."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import evaluate_model, generate_predictions
    from image_restoration_and_enhancement_torch.data import png
    from image_restoration_and_enhancement_torch.data.synthetic import SyntheticPairLoader
    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
    from image_restoration_and_enhancement_torch.metrics import evaluate as E
    from image_restoration_and_enhancement_torch.metrics import functional as MF
    from image_restoration_and_enhancement_torch.metrics import inception as I
    from image_restoration_and_enhancement_torch.metrics import perceptual as P
    from image_restoration_and_enhancement_torch.models.layers import init_random_
    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.tasks.registry import get_task

    with _Phase("evaluate"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        root = os.path.join(tmp, "eval")
        clean_dir, data, models = (os.path.join(root, d) for d in ("clean", "data", "models"))
        os.makedirs(clean_dir)
        clean_u8 = _clean_images(2 * EVAL_IMAGES, EVAL_SIZE, SEED)
        for i, im in enumerate(clean_u8):
            png.write_png(os.path.join(clean_dir, f"c{i}.png"), im)
        paths = sorted(os.path.join(clean_dir, n) for n in os.listdir(clean_dir))

        # 1. test splits, made on the card; the loader's time per batch of 8
        loader_ms = {}
        for task in EVAL_TASKS:
            spec = get_task(task)
            loader = SyntheticPairLoader(task, paths, image_size=EVAL_SIZE,
                                         batch_size=2 * EVAL_IMAGES, seed=SEED, device="cuda")
            times = []
            for epoch in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(iter(loader.epoch(epoch)))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            loader_ms[task] = sorted(times[1:])[1]   # median of the steady three
            if task == "sr_x4":
                batch = next(iter(SyntheticPairLoader(
                    task, paths, image_size=EVAL_SR_SIZE, batch_size=2 * EVAL_IMAGES,
                    seed=SEED, device="cuda").epoch(0)))
            split = os.path.join(data, spec.pair_dir, "test")
            for key in batch:
                os.makedirs(os.path.join(split, key))
            for i in range(EVAL_IMAGES):
                for key, v in batch.items():
                    arr = v[i].cpu().numpy()
                    arr = arr[..., 0] * 255 if key == "mask" else (arr + 1.0) * 127.5
                    png.write_png(os.path.join(split, key, f"t{i}.png"),
                                  np.clip(np.rint(arr), 0, 255).astype(np.uint8))
        log(f"test splits written: {EVAL_IMAGES} pairs per task; loader ms per batch of "
            f"{2 * EVAL_IMAGES} at {EVAL_SIZE} px: {loader_ms}")

        # 2. the degradations, card against CPU on the same draws
        degrade_errs = _check_degradations(clean_u8)
        log(f"degradations card vs CPU (same draws): {degrade_errs} (limit {DEGRADE_TOL})")

        # 3. generate_predictions over the four tasks on the serve's stacks
        for task, src in (("denoising", tmp), ("super_resolution", tmp),
                          ("colorization", tmp), ("inpainting", os.path.join(tmp, "inpaint"))):
            os.makedirs(os.path.join(models, task))
            os.symlink(src, os.path.join(models, task, "best"))
        request_s = collections.defaultdict(list)
        process = RestorationPipeline.process

        def timed(pipe, image, tasks, **kw):
            t0 = time.perf_counter()
            out = process(pipe, image, tasks, **kw)
            torch.cuda.synchronize()
            request_s[tasks[0]].append(time.perf_counter() - t0)
            return out

        pred_root = os.path.join(root, "pred")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(RestorationPipeline, "process", timed):
            rc = generate_predictions.main(["--data_root", data, "--models_root", models,
                                            "--out_root", pred_root])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches, shapes, codes = (dict(_build.launch_counts), dict(_build.launch_shapes),
                                   dict(_build.launch_paths))
        _check_attention_paths(shapes, codes)
        _check_k2_k3_paths(shapes, codes)
        want_k1 = EVAL_IMAGES * sum(_k1_per_request(t) for t in EVAL_TASKS)
        if rc != 0 or launches.get("attention") != want_k1 or launches.get("group_norm", 0) <= 0:
            raise AssertionError(f"generate_predictions rc {rc}, launches {launches} (K1 "
                                 f"{want_k1} expected)")
        for task in EVAL_TASKS:
            pair_dir = get_task(task).pair_dir
            gt_hw = (EVAL_SR_SIZE if task == "sr_x4" else EVAL_SIZE,) * 2
            out_hw = (EVAL_SIZE, EVAL_SIZE)
            names = sorted(os.listdir(os.path.join(pred_root, pair_dir)))
            if names != [f"t{i}.png" for i in range(EVAL_IMAGES)]:
                raise AssertionError(f"{task}: predictions {names}")
            shapes_out = {png.read_png(os.path.join(pred_root, pair_dir, n)).shape for n in names}
            if shapes_out != {out_hw + (3,)} or len(request_s[task]) != EVAL_IMAGES:
                raise AssertionError(f"{task}: prediction shapes {shapes_out}, gt {gt_hw}")
        per_request = {t: v for t, v in request_s.items()}
        log(f"generate_predictions: {gen_s:.2f} s for {4 * EVAL_IMAGES} requests; seconds per "
            f"request {per_request}; launches {launches}")

        # 4-5. evaluate_model on the card with LPIPS (random weights in the JAX
        # layout) and FID (random-init trunk), under torch's default TF32 settings
        wdir = os.path.join(root, "weights")
        P.save_lpips(init_random_(P.LPIPSAlex(), torch.Generator().manual_seed(SEED)),
                     os.path.join(wdir, P.LPIPS_FILE))
        out_json = os.path.join(root, "evaluation_results.json")
        env = {**os.environ, "IRET_WEIGHTS_DIR": wdir, "IRET_FID_RANDOM_INIT": "1"}
        with mock.patch.dict(os.environ, env, clear=True), _torch_default_tf32():
            t0 = time.perf_counter()
            rc = evaluate_model.main(["--pred_root", pred_root, "--data_root", data,
                                      "--out_json", out_json])
            eval_s = time.perf_counter() - t0
            with open(out_json) as f:
                results = json.load(f)
            if rc != 0 or set(results) != set(EVAL_TASKS):
                raise AssertionError(f"evaluate_model rc {rc}, tasks {sorted(results)}")
            for task, res in results.items():
                keys = {"num_images", "metrics", "input_baseline", "paired_delta",
                        "beats_input_baseline"}
                if task in ("colorize", "inpaint"):
                    keys.add("fid_random_init_weights_pending")
                want = _expected_metrics(task)
                if (set(res) != keys or set(res["metrics"]) != want | {"lpips"}
                        or set(res["input_baseline"]) != want or set(res["paired_delta"]) != want
                        or res["num_images"] != EVAL_IMAGES):
                    raise AssertionError(f"{task}: keys {sorted(res)}, metrics "
                                         f"{sorted(res['metrics'])}")
                values = [v for st in res["metrics"].values() for v in st.values()]
                values += [v for st in res["input_baseline"].values() for v in st.values()]
                values += [v for d in res["paired_delta"].values() for v in
                           (d["mean"], d["win_rate"], *d["ci95"])]
                values += [res.get("fid_random_init_weights_pending", 0.0)]
                if not all(math.isfinite(v) for v in values):
                    raise AssertionError(f"{task}: a value is not finite")
                for name, st in list(res["metrics"].items()) + \
                        list(res["input_baseline"].items()):
                    if name.startswith("ssim") and st["max"] > 1.0:
                        raise AssertionError(f"{task}: {name} max {st['max']} > 1")
        log(f"evaluate_model on the card: {eval_s:.2f} s; " + "; ".join(
            f"{t}: psnr {r['metrics']['psnr']['mean']:.3f} ssim {r['metrics']['ssim']['mean']:.4f}"
            f" lpips {r['metrics']['lpips']['mean']:.4f}"
            + (f" fid(random init) {r['fid_random_init_weights_pending']:.4e}"
               if "fid_random_init_weights_pending" in r else "")
            for t, r in results.items()))

        # 6. the bundle and LPIPS on the CPU from the same files
        worst = collections.defaultdict(float)
        with mock.patch.dict(os.environ, env, clear=True):
            for task in EVAL_TASKS:
                spec = get_task(task)
                cpu = E.evaluate_task(os.path.join(pred_root, spec.pair_dir),
                                      os.path.join(data, spec.pair_dir, "test", "gt"),
                                      with_color=spec.with_color_metrics,
                                      with_y=spec.with_y_metrics, use_lpips=True, device="cpu")
                for name, stats in cpu["metrics"].items():
                    for stat, v in stats.items():
                        got = results[task]["metrics"][name][stat]
                        err = abs(got - v) / (abs(v) if name == "lpips" else 1.0)
                        worst[name] = max(worst[name], err)
        over = {n: e for n, e in worst.items()
                if e > (EVAL_LPIPS_REL if n == "lpips" else
                        EVAL_LIMITS[next(k for k in EVAL_LIMITS if n.startswith(k))])}
        log(f"card vs CPU, largest difference of a statistic: {dict(worst)} (limits "
            f"{EVAL_LIMITS}, lpips {EVAL_LPIPS_REL} relative)")
        if over:
            raise AssertionError(f"the card's metrics differ from the CPU's: {over}")

        # 7. times of the path's parts on the card
        preds = [png.load_image(os.path.join(pred_root, "denoise", f"t{i}.png"))
                 for i in range(EVAL_IMAGES)]
        gts = [png.load_image(os.path.join(data, "denoise", "test", "gt", f"t{i}.png"))
               for i in range(EVAL_IMAGES)]
        p16 = torch.from_numpy(np.stack(preds * 4).astype(np.float32) / 255.0).cuda()
        g16 = torch.from_numpy(np.stack(gts * 4).astype(np.float32) / 255.0).cuda()
        with _torch_default_tf32(), torch.inference_mode():
            bundle_ms = _time_ms(lambda: MF.calculate_all(p16, g16, True, True), 5) / 16
        p01 = [p.astype(np.float32) / 255.0 for p in preds * 4]
        g01 = [g.astype(np.float32) / 255.0 for g in gts * 4]

        def host_ms(fn, n):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        with mock.patch.dict(os.environ, env, clear=True), _torch_default_tf32():
            lpips_ms = host_ms(lambda: P.lpips_pairs(p01, g01, "cuda"), 16)
            inception_ms = host_ms(lambda: I.inception_features(g01[:8], 8, "cuda"), 8)
        peak = torch.cuda.max_memory_allocated()
        row = {"card": smi, "generate_predictions_seconds_per_request": per_request,
               "generate_predictions_seconds": gen_s, "evaluate_model_seconds": eval_s,
               "metric_bundle_ms_per_512px_image_batch16": bundle_ms,
               "lpips_ms_per_pair": lpips_ms, "inception_ms_per_image_batch8": inception_ms,
               "loader_ms_per_512px_batch8": loader_ms, "peak_memory_bytes": peak,
               "card_vs_cpu_largest": dict(worst), "degradations_card_vs_cpu": degrade_errs}
        log("evaluate_json " + json.dumps(row))
    return {"launches": launches, "shapes": shapes, "codes": codes, **row}


TRAIN_SIZE = 256      # train phase: 256 px pairs, batch 2
TRAIN_PAIRS, TRAIN_VAL = 8, 2
# K1 launches per train micro-step: the UNet's 32 sites forward and again in
# the remat recompute of its blocks, the frozen VAE's mid-block in the two
# posterior encodes, and once in the differentiated decode of the L1 term
TRAIN_K1_PER_MICRO_STEP = 2 * 32 + 3
# fp32 full-width micro-step at 64 px, card vs CPU: the loss, L1 and global
# gradient norm relative, and every UNet gradient tensor relative to its
# largest entry on the CPU
TRAIN_TWIN_REL_TOL = 1e-5
TRAIN_TWIN_GRAD_TOL = 2e-4


def _write_train_data(root, gen, n_train=TRAIN_PAIRS, n_val=TRAIN_VAL,
                      tasks=("denoise", "inpaint")):
    """Clean 256 px images; ``tasks``' pairs degraded on the card
    (data/synthetic.py); all written as PNG by the port's codec."""
    import torch

    from image_restoration_and_enhancement_torch.data import png
    from image_restoration_and_enhancement_torch.data.synthetic import degrade_batch, draw_batch
    from image_restoration_and_enhancement_torch.tasks.registry import get_task

    n = n_train + n_val
    clean_u8 = _clean_images(n, TRAIN_SIZE, SEED + 7)
    x = torch.from_numpy(clean_u8).cuda().float() / 255.0

    def write(directory, name, img_u8):
        os.makedirs(directory, exist_ok=True)
        png.write_png(os.path.join(directory, name), img_u8)

    for task in tasks:
        batch = degrade_batch(task, x, draw_batch(task, gen, n, TRAIN_SIZE, device="cuda"))
        for kind, t in batch.items():
            u8 = ((t[..., 0] * 255.0) if kind == "mask" else (t + 1.0) * 127.5)
            u8 = u8.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
            for i in range(n):
                split = "train" if i < n_train else "val"
                write(os.path.join(root, "pairs", get_task(task).pair_dir, split, kind),
                      f"p{i}.png", u8[i])
    for i in range(n):
        write(os.path.join(root, "clean", "train" if i < n_train else "val"), f"c{i}.png",
              clean_u8[i])


def _train_twin(gen):
    """One fp32 micro-step of the full-width SD-1.5 stack at 64 px (batch 1,
    lambda_img 0.05: the differentiated decode too) on the card and on the CPU
    from the same weights and draws: the loss, L1 and global gradient norm
    within TRAIN_TWIN_REL_TOL relative, and each of the UNet's gradient tensors
    within TRAIN_TWIN_GRAD_TOL of its largest entry on the CPU. The card runs
    K1 "simt" and K2 in fp32 here; these launches are not counted (they
    precede the phase's count)."""
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_
    from image_restoration_and_enhancement_torch.tasks.registry import get_task
    from image_restoration_and_enhancement_torch.train import loop, optim

    cfg = loop.TrainConfig(gradient_accumulation_steps=1)
    spec = get_task("denoise")
    card, cpu = (sampling.SDModules.create(C.SD15, torch.float32, dev)
                 for dev in ("cuda", "cpu"))
    for name, m in card.components().items():
        init_random_(m, gen)
        cpu.components()[name].load_state_dict(m.state_dict())
    g = torch.Generator().manual_seed(SEED + 9)
    batch = {"input": torch.rand((1, 64, 64, 3), generator=g) * 2 - 1,
             "gt": torch.rand((1, 64, 64, 3), generator=g) * 2 - 1}
    draws = loop.draw_step(cpu, (1, 64, 64, 3), g)
    ids = torch.randint(0, C.SD15.text_encoder.vocab_size, (1, 77), generator=g)
    out, grads = [], []
    for m in (card, cpu):
        m.freeze_all_but_unet()
        with torch.no_grad():
            ctx = sampling.encode_text(m, ids)
        loss, metrics = loop.make_loss_fn(m, spec, cfg)(batch, ctx, draws)
        loss.backward()
        grads.append({n: p.grad for n, p in m.unet.named_parameters()})
        norm = optim.global_norm(grads[-1])
        out.append((float(loss.detach()), float(metrics["img_l1"].detach()), float(norm)))
    errs = {k: abs(a - b) / abs(b) for k, a, b in zip(("loss", "img_l1", "grad_norm"), *out)}
    per_tensor = sorted(((float((grads[0][n].cpu() - g).abs().max())
                          / max(float(g.abs().max()), 1e-30), n)
                         for n, g in grads[1].items()), reverse=True)
    errs["largest_tensor_grad"] = per_tensor[0][0]
    log(f"train twin (fp32, 64 px, full width): card {out[0]}, cpu {out[1]}, "
        f"relative differences {errs} (limits {TRAIN_TWIN_REL_TOL}, per tensor "
        f"{TRAIN_TWIN_GRAD_TOL}); largest per-tensor gradient differences {per_tensor[:5]}")
    if not all(math.isfinite(v) for v in out[0] + out[1]):
        raise AssertionError(f"train twin: non-finite values {out}")
    if max(errs[k] for k in ("loss", "img_l1", "grad_norm")) > TRAIN_TWIN_REL_TOL:
        raise AssertionError(f"the card's fp32 micro-step differs from the CPU's: {errs}")
    if per_tensor[0][0] > TRAIN_TWIN_GRAD_TOL:
        raise AssertionError(f"the card's fp32 gradients differ from the CPU's: "
                             f"{per_tensor[:5]}")
    return errs


def phase_train(tmp, smi: str):
    """Training on the card at full SD-1.5 width (see the docstring): the fp32
    twin check, train_task("denoise") (4 micro-steps, 2 optimizer steps), one
    step of the 9-channel inpaint UNet, pretrain_vae for 2 steps, then one
    request served from the best/ that train_task wrote."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.data.datasets import BatchLoader, PairDataset
    from image_restoration_and_enhancement_torch.models.layers import init_random_
    from image_restoration_and_enhancement_torch.models.tokenizer import HashTokenizer
    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.tasks.registry import get_task
    from image_restoration_and_enhancement_torch.train import loop, trainer
    from image_restoration_and_enhancement_torch.train.vae_pretrain import (VAEPretrainConfig,
                                                                            pretrain_vae)

    with _Phase("train"):
        torch.cuda.empty_cache()
        root = os.path.join(tmp, "train")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        t0 = time.perf_counter()
        twin = _train_twin(gen)
        log(f"train twin: {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        _write_train_data(root, gen)
        log(f"free disk under {tmp}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB")

        # 1. train_task("denoise"): every micro-step timed (synchronised) with
        # its launches; the fourth profiled
        steps = []
        real_make = trainer.make_train_step

        def timed_make(*args, **kw):
            step = real_make(*args, **kw)

            def timed(state, *a):
                run = lambda: steps[-1].update(metrics=step(state, *a))  # noqa: E731
                torch.cuda.synchronize()
                before = collections.Counter(_build.launch_counts)
                steps.append({})
                t = time.perf_counter()
                if len(steps) == 4:
                    # against micro-step 2, which steps the optimizer as this one does
                    steps[-1]["profile"] = _profile_request(
                        run, steps[1]["seconds"], mma_label="K1 attention (sm90)")
                else:
                    run()
                torch.cuda.synchronize()
                steps[-1]["seconds"] = time.perf_counter() - t
                counts = collections.Counter(_build.launch_counts) - before
                steps[-1].update(k1=counts["attention"], k2=counts["group_norm"])
                return steps[-1]["metrics"]

            return timed

        out_dir = os.path.join(root, "denoise_run")
        cfg = loop.TrainConfig(num_epochs=1, batch_size=2, gradient_accumulation_steps=2,
                               save_steps=2, image_size=TRAIN_SIZE, state_save_epochs=-1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(trainer, "make_train_step", timed_make):
            val = trainer.train_task("denoise", data_root=os.path.join(root, "pairs"),
                                     output_dir=out_dir, cfg=cfg, use_mesh=False, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        rows = [{"seconds": s["seconds"], "loss": float(s["metrics"]["loss"]),
                 "grad_norm": float(s["metrics"]["grad_norm"]), "k1": s["k1"], "k2": s["k2"]}
                for s in steps]
        log(f"train_task denoise: {train_s:.2f} s, val {val}, micro-steps {rows}")
        if len(rows) != 4:
            raise AssertionError(f"{len(rows)} micro-steps, not 4")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
            raise AssertionError(f"a non-finite loss or grad norm: {rows}")
        if any(r["k1"] != TRAIN_K1_PER_MICRO_STEP for r in rows):
            raise AssertionError(f"K1 launches per micro-step {[r['k1'] for r in rows]}, not "
                                 f"{TRAIN_K1_PER_MICRO_STEP} (forward + remat recompute)")
        if len({r["k2"] for r in rows}) != 1:
            raise AssertionError(f"K2 launches differ between micro-steps: {rows}")
        if not all(math.isfinite(v) for v in val.values()):
            raise AssertionError(f"non-finite validation metrics {val}")
        names = set(os.listdir(out_dir))
        want = {"best", "final", "checkpoint-2", "checkpoint-4", "val_samples",
                "metrics_denoise.csv", "training_denoise.log"}
        if not want <= names:
            raise AssertionError(f"train_task wrote {sorted(names)}, not {sorted(want)}")
        # optimizer step 1 has lr 0 (the warmup's first value): checkpoint-2
        # holds the initial weights; step 2 must have moved every tensor
        a, b = (ckpt.load_safetensors(os.path.join(out_dir, c, "unet", "model.safetensors"))
                for c in ("checkpoint-2", "checkpoint-4"))
        still = [k for k in a if torch.equal(a[k], b[k])]
        moved = max(float((a[k] - b[k]).abs().max()) for k in a)
        log(f"optimizer step 2 moved {len(a) - len(still)} of {len(a)} UNet tensors, "
            f"largest change {moved:.3e}")
        if still:
            raise AssertionError(f"optimizer step 2 left {len(still)} tensors unchanged "
                                 f"(first {still[0]})")
        del a, b
        counts = [collections.Counter(_build.launch_counts), collections.Counter(_build.launch_shapes),
                  collections.Counter(_build.launch_paths)]
        torch.cuda.empty_cache()

        # 2. one micro-step of the 9-channel inpaint UNet
        _build.reset_launch_counts()
        mods = sampling.SDModules.create(C.SD15_INPAINT, torch.bfloat16, "cuda")
        for m in mods.components().values():
            init_random_(m, gen)
        mods.freeze_all_but_unet()
        spec = get_task("inpaint")
        icfg = loop.TrainConfig(gradient_accumulation_steps=1, image_size=TRAIN_SIZE)
        state = loop.create_train_state(icfg, mods.unet, 1)
        batch = next(BatchLoader(PairDataset("inpaint", os.path.join(root, "pairs"), "train",
                                             TRAIN_SIZE, 2), 2, shuffle=False).epoch(0))
        with torch.no_grad():
            ctx = sampling.encode_text(mods, torch.as_tensor(
                HashTokenizer(C.SD15.text_encoder.vocab_size)([spec.prompt])))
        draws = loop.draw_step(mods, batch["gt"].shape, loop.step_generator(SEED, 0, "cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        im = loop.make_train_step(mods, spec, icfg)(state, batch, ctx, draws)
        torch.cuda.synchronize()
        inpaint_s = time.perf_counter() - t0
        im = {k: float(v) for k, v in im.items()}
        log(f"inpaint micro-step (9-channel UNet, first call): {inpaint_s:.3f} s, {im}, "
            f"K1 {_build.launch_counts['attention']}")
        if not all(math.isfinite(v) for v in im.values()):
            raise AssertionError(f"inpaint step: non-finite {im}")
        if _build.launch_counts["attention"] != TRAIN_K1_PER_MICRO_STEP:
            raise AssertionError(f"inpaint step: {_build.launch_counts['attention']} K1 launches")
        del mods, state
        torch.cuda.empty_cache()
        for c, now in zip(counts, (_build.launch_counts, _build.launch_shapes,
                                   _build.launch_paths)):
            c.update(now)

        # 3. pretrain_vae: 2 steps (4 images, batch 2), then its validation
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        vae_val = pretrain_vae(os.path.join(root, "clean"), os.path.join(root, "vae_run"),
                               VAEPretrainConfig(num_epochs=1, batch_size=2,
                                                 image_size=TRAIN_SIZE),
                               max_train_samples=4, use_mesh=False, device="cuda")
        torch.cuda.synchronize()
        vae_s = time.perf_counter() - t0
        log(f"pretrain_vae: {vae_s:.2f} s, val {vae_val}, launches "
            f"{dict(_build.launch_counts)}")
        if not all(math.isfinite(v) for v in vae_val.values()):
            raise AssertionError(f"pretrain_vae: non-finite {vae_val}")
        for c, now in zip(counts, (_build.launch_counts, _build.launch_shapes,
                                   _build.launch_paths)):
            c.update(now)

        # 4. serve one denoise request from the best/ that train_task wrote
        pipe = _pipeline(os.path.join(out_dir, "best"))
        image = np.random.default_rng(SEED + 3).integers(0, 256, (TRAIN_SIZE, TRAIN_SIZE, 3),
                                                         dtype=np.uint8)
        sec, _, n, sh, cd, _ = _serve_calls([(
            "denoise served from the trained best/", lambda: pipe.denoise(image),
            (TRAIN_SIZE, TRAIN_SIZE, 3))])
        if n.get("attention", 0) != _k1_per_request("denoise"):
            raise AssertionError(f"the trained stack's request launched K1 {n} times")
        del pipe
        for c, now in zip(counts, (n, sh, cd)):
            c.update(now)
        launches, shapes, codes = (dict(c) for c in counts)
        _check_attention_paths(shapes, codes)
        _check_k2_k3_paths(shapes, codes)
        steady = float(np.mean([r["seconds"] for r in rows[1:3]]))
        row = {"card": smi, "train_task_seconds": train_s, "micro_steps": rows,
               "seconds_per_micro_step_steady": steady,
               "images_per_second": cfg.batch_size / steady,
               "peak_memory_bytes": train_peak,
               "k1_per_micro_step": rows[0]["k1"], "k2_per_micro_step": rows[0]["k2"],
               "inpaint_micro_step_seconds_first": inpaint_s,
               "pretrain_vae_seconds": vae_s, "serve_from_best_seconds": sec[0],
               "twin_relative_differences": twin, "profile": steps[3].get("profile")}
        log("train_json " + json.dumps(row))
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes, "codes": codes, **row}


TOOLS_IMAGES = 4      # tools phase: clean images of the pair factory
TOOLS_SIZE = 512
GATE_SIZE = 256       # eval_quant_quality: --n 4 --size 256 --batch 4
GATE_TOME_MIN = 1024  # IRET_TOME_MIN for the gate: ToMe merges the 32x32 latent's sites
GATE_LABELS = ("bf16", "int8", "int8_static", "turbo(k=2)", "tome(0.5)", "combo(k2+t0.5)")
SIGMA_PER_ABS = math.sqrt(math.pi / 2)  # sigma / E|z| of a normal z
# Card against CPU on the fp32 probes, tighter than import_weights.THRESHOLDS
# (the gate of a cross-framework import). An H100 80GB HBM3 at 700 W read
# 4.1e-6 (text encoder), 1.8e-6 (VAE encode), 1.0e-5 (decode), 1.2e-5 (UNet)
# and 2.8e-5 (img2img, five PLMS steps). The limits keep a margin of 8x or
# more over those and lie below one rounding of an input to TF32's 10-bit
# mantissa (4.9e-4 of its size) or to bf16's 7-bit one (3.9e-3), which a
# probe that left fp32 would take at every product.
GOLDEN_CARD_LIMITS = {"text_encoder": 1e-4, "vae_encode": 1e-4, "vae_decode": 1e-4,
                      "unet": 1e-4, "img2img": 2.5e-4}


def _check_fp32_paths(shapes, codes) -> None:
    """The golden check's fp32 probes: every attention launch K1 in fp32
    through "simt" (CUDA cores; the sm90 code takes bf16 only), every K2
    launch on its plan."""
    kernels = ATTENTION_KERNELS + ("int8_attention",)
    n = 0
    for (kernel, key), count in shapes.items():
        if kernel in kernels:
            if kernel != "attention" or key[5] != "torch.float32":
                raise AssertionError(f"a {kernel} {key} launch among the fp32 probes")
            n += count
    got = {k: c for k, c in codes.items() if k[0] in kernels}
    log(f"fp32 probe attention launches by path: {got}")
    if got != {("attention", "simt"): n} or not n:
        raise AssertionError(f"fp32 probe attention launches {got}, not {n} on simt")
    _check_k2_k3_paths(shapes, codes, onchip_hw=0)


def _tools_pairs(root):
    """Steps 1-3: clean PNGs, make_synthetic_pairs --splits val, make_demo_data;
    checks the layouts. Returns the denoise inputs' sigma estimates."""
    import numpy as np

    from image_restoration_and_enhancement_torch import make_demo_data, make_synthetic_pairs
    from image_restoration_and_enhancement_torch.data.png import load_image, read_png, save_image

    clean_dir = os.path.join(root, "data", "clean", "val")
    os.makedirs(clean_dir)
    names = [f"clean_{i}.png" for i in range(TOOLS_IMAGES)]
    for name, img in zip(names, _clean_images(TOOLS_IMAGES, TOOLS_SIZE, SEED + 11)):
        save_image(os.path.join(clean_dir, name), img)
    pairs = os.path.join(root, "data", "pairs")
    if make_synthetic_pairs.main(["--clean_root", os.path.dirname(clean_dir),
                                  "--out_root", pairs, "--splits", "val"]) != 0:
        raise AssertionError("make_synthetic_pairs failed")
    layout = {"denoise": ("input", "gt"), "sr_x4": ("input", "gt"),
              "colorize": ("input", "gt"), "inpaint": ("input", "gt", "mask")}
    if sorted(os.listdir(pairs)) != sorted(layout):
        raise AssertionError(f"pair tasks {sorted(os.listdir(pairs))}")
    for task, kinds in layout.items():
        split = os.path.join(pairs, task, "val")
        if sorted(os.listdir(split)) != sorted(kinds):
            raise AssertionError(f"{task}: {sorted(os.listdir(split))}, not {kinds}")
        for kind in kinds:
            if sorted(os.listdir(os.path.join(split, kind))) != names:
                raise AssertionError(f"{task}/{kind}: {os.listdir(os.path.join(split, kind))}")
    sigmas = []
    for name in names:
        gt = load_image(os.path.join(pairs, "denoise", "val", "gt", name)).astype(np.int64)
        noisy = load_image(os.path.join(pairs, "denoise", "val", "input", name)).astype(np.int64)
        keep = (gt >= 40) & (gt <= 215)   # 5 sigma from either end: no clipping
        sigmas.append(float(np.abs(noisy - gt)[keep].mean() * SIGMA_PER_ABS))
        lr = read_png(os.path.join(pairs, "sr_x4", "val", "input", name))
        grey = read_png(os.path.join(pairs, "colorize", "val", "input", name))
        mask = read_png(os.path.join(pairs, "inpaint", "val", "mask", name))
        size = TOOLS_SIZE // 4
        if lr.shape != (size, size, 3) or grey.shape != (TOOLS_SIZE,) * 2 \
                or not set(np.unique(mask)) <= {0, 255}:
            raise AssertionError(f"{name}: sr input {lr.shape}, colorize input {grey.shape}, "
                                 f"mask values {np.unique(mask)[:5]}")
    log(f"denoise inputs: sigma estimated from the unclipped pixels {sigmas}")
    if not all(4.95 <= s <= 8.05 for s in sigmas):
        raise AssertionError(f"denoise noise sigma {sigmas} outside [5, 8]")
    demo = os.path.join(root, "demo")
    if make_demo_data.main(["--out_root", demo]) != 0:
        raise AssertionError("make_demo_data failed")
    got = (sorted(os.listdir(os.path.join(demo, "images"))),
           sorted(os.listdir(os.path.join(demo, "mask"))))
    if got != ([f"demo_{i}.png" for i in range(4)], ["demo_3.png"]):
        raise AssertionError(f"make_demo_data wrote {got}")
    return pairs, sigmas


def phase_tools(tmp, smi: str):
    """The single-device tools chained as a user runs them (see the
    docstring): pairs, demo data, a full-width SD-1.5 rehearsal imported to
    pretrained/sd15, goldens recorded on the CPU and checked on the card, a
    request served from the import, and eval_quant_quality's gate."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch import eval_quant_quality as eqq
    from image_restoration_and_enhancement_torch import import_weights as iw
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.ops import _build, token_merge

    with _Phase("tools"):
        torch.cuda.empty_cache()
        root = os.path.join(tmp, "tools")
        seconds = {}
        counts = [collections.Counter() for _ in range(3)]   # launches, shapes, codes

        def add(launches, shapes, codes):
            for c, now in zip(counts, (launches, shapes, codes)):
                c.update(now)

        @contextlib.contextmanager
        def timed(name):
            t0 = time.perf_counter()
            yield
            seconds[name] = time.perf_counter() - t0
            log(f"tools {name}: {seconds[name]:.2f} s")

        # 1-3. pairs and demo data (host numpy, no kernel)
        with timed("pairs_and_demo"):
            pairs, sigmas = _tools_pairs(root)

        # 4. a full-width SD-1.5 rehearsal directory, imported with --sd15
        with timed("rehearsal"):
            reh, pre = os.path.join(root, "rehearsal"), os.path.join(root, "pretrained")
            cfg = iw.make_rehearsal_dir(reh, C.SD15, seed=SEED + 12, device="cuda")
            if cfg != C.SD15:
                raise AssertionError("the SD-1.5 rehearsal changed the config")
            torch.cuda.empty_cache()
            reh_bytes = sum(os.path.getsize(os.path.join(d, f))
                            for d, _, fs in os.walk(reh) for f in fs)
        with timed("import"):
            if iw.main(["--sd15", reh, "--pretrained_root", pre]) != 0:
                raise AssertionError("import_weights --sd15 failed")
            sd15 = os.path.join(pre, "sd15")
            if ckpt.load_pipeline_model_config(sd15) != C.SD15:
                raise AssertionError("the imported pipeline's config is not SD-1.5")
            shutil.rmtree(reh)
        log(f"rehearsal {reh_bytes / 2**30:.2f} GiB; free disk under {tmp}: "
            f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB")

        # 5. goldens: recorded on the CPU (fp32), checked on the card
        goldens = os.path.join(root, "goldens")
        with timed("record_goldens_cpu"):
            if iw.main(["--pretrained_root", pre, "--record_goldens", goldens,
                        "--device", "cpu"]) != 0:
                raise AssertionError("import_weights --record_goldens failed")
        with timed("check_goldens_card"):
            probes = {}
            real_probes = iw.run_our_probes

            def kept_probes(*a, **kw):
                probes.update(real_probes(*a, **kw))
                return probes

            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with mock.patch.object(iw, "run_our_probes", kept_probes):
                rc = iw.main(["--pretrained_root", pre, "--check_goldens", goldens])
            torch.cuda.synchronize()
        golden_launches = (dict(_build.launch_counts), dict(_build.launch_shapes),
                           dict(_build.launch_paths))
        ref = dict(np.load(os.path.join(goldens, "sd15_goldens.npz")))
        deltas = {k: float(np.abs(v - ref[k]).max()) for k, v in probes.items()}
        log(f"goldens, card against CPU, max |delta| by probe: {deltas} "
            f"(limits {GOLDEN_CARD_LIMITS}; check_goldens' thresholds {iw.THRESHOLDS}); "
            f"launches {golden_launches[0]}")
        if rc != 0 or sorted(deltas) != sorted(iw.THRESHOLDS) \
                or any(deltas[k] > GOLDEN_CARD_LIMITS[k] for k in deltas):
            raise AssertionError(f"check_goldens on the card failed: rc {rc}, {deltas}")
        for k in ("attention", "group_norm"):
            if golden_launches[0].get(k, 0) <= 0:
                raise AssertionError(f"the fp32 probes did not launch {k}")
        _check_fp32_paths(*golden_launches[1:])
        add(*golden_launches)
        torch.cuda.empty_cache()

        # 6. one 512 px denoise request from the imported pipeline (bf16)
        with timed("serve_from_import"):
            pipe = _pipeline(sd15)
            image = np.random.default_rng(SEED + 13).integers(0, 256, (TOOLS_SIZE, TOOLS_SIZE, 3),
                                                              dtype=np.uint8)
            sec, _, n, sh, cd, _ = _serve_calls([(
                "denoise served from the imported pretrained/sd15", lambda: pipe.denoise(image),
                (TOOLS_SIZE, TOOLS_SIZE, 3))])
            if n.get("attention", 0) != _k1_per_request("denoise"):
                raise AssertionError(f"the imported stack's request launched K1 {n} times")
            add(n, sh, cd)
            del pipe
            torch.cuda.empty_cache()

        # 7. eval_quant_quality on the card; counts zeroed around each run
        with timed("eval_quant_quality"):
            runs, states = [], []
            real_run, real_set_quant = eqq.run, sampling.SDModules.set_quant

            def counted(*a, **kw):
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                out = real_run(*a, **kw)
                torch.cuda.synchronize()
                runs.append((dict(_build.launch_counts), dict(_build.launch_shapes),
                             dict(_build.launch_paths)))
                return out

            def recorded(self, state):
                if state is not None:
                    states.append(state)
                return real_set_quant(self, state)

            argv = ["--checkpoint", sd15, "--pairs", os.path.join(pairs, "denoise", "val"),
                    "--n", "4", "--size", str(GATE_SIZE), "--batch", "4",
                    "--modes", "int8,int8_static", "--cfg_cache", "2", "--tome", "0.5"]
            with mock.patch.object(eqq, "run", counted), \
                    mock.patch.object(sampling.SDModules, "set_quant", recorded), \
                    mock.patch.dict(os.environ, {"IRET_TOME_MIN": str(GATE_TOME_MIN)}):
                if eqq.main(argv) != 0:
                    raise AssertionError("eval_quant_quality failed")
        if len(runs) != len(GATE_LABELS):
            raise AssertionError(f"{len(runs)} gate runs, not {len(GATE_LABELS)}")
        lat = GATE_SIZE // 8
        merged = lat * lat - token_merge.merge_count(lat, lat, 0.5)
        gate = {}
        for label, (launches, shapes, codes) in zip(GATE_LABELS, runs):
            k3 = launches.get("conv3x3_int8", 0)
            tome_sites = sum(c for (k, key), c in shapes.items()
                             if k == "attention" and key[1] == merged)
            gate[label] = {"k1": launches.get("attention", 0), "k2": launches.get("group_norm", 0),
                           "k3": k3, "k1_at_merged_tokens": tome_sites}
            if launches.get("attention", 0) <= 0:
                raise AssertionError(f"gate run {label}: K1 did not launch")
            if (k3 > 0) != (label != "bf16"):
                raise AssertionError(f"gate run {label}: K3 launched {k3} times")
            if (tome_sites > 0) != label.startswith(("tome", "combo")):
                raise AssertionError(f"gate run {label}: {tome_sites} K1 launches at "
                                     f"{merged} merged tokens")
            _check_attention_paths(shapes, codes)
            _check_k2_k3_paths(shapes, codes, onchip_hw=lat * lat)
            add(launches, shapes, codes)
        static = [s for s in states if s.mode == "int8_static"]
        missed = set().union(*(s.misses for s in static)) if static else {"(no static run)"}
        log(f"gate launches by run: {gate}; int8_static states {len(static)}, "
            f"sites missing from the table {sorted(missed)}")
        if missed:
            raise AssertionError(f"int8_static sites missed the table: {sorted(missed)[:5]}")
        row = {"card": smi, "seconds": seconds, "denoise_sigma_estimates": sigmas,
               "rehearsal_bytes": reh_bytes, "golden_max_abs_delta": deltas,
               "serve_from_import_seconds": sec[0], "gate_launches": gate}
        log("tools_json " + json.dumps(row))
        shutil.rmtree(root, ignore_errors=True)
        launches, shapes, codes = (dict(c) for c in counts)
    return {"launches": launches, "shapes": shapes, "codes": codes, **row}


DEMO_SIZE = 64        # demo phase: the demo's published 64 px family
DEMO_TRAIN, DEMO_VAL = 16, 8
DEMO_BATCH = 8
DEMO_STRENGTH, DEMO_ENSEMBLE, DEMO_STEPS = 0.1, 2, 20   # the sweep: one point, two seeds
INIT_STD_SIGMAS = 5.0  # standard errors of a pooled std against flax's law (the CPU test's)
PROCEDURAL_IMAGES, PROCEDURAL_SIZE = 2, 256  # make_procedural_clean's defaults


def _demo_launches(modules, plms_calls) -> dict:
    """K1 and K2 launches of the demo phase's runs, worked out from the code:
    one launch per CrossAttention / VAEAttentionBlock / FusedGroupNorm forward,
    each module running once per forward of its model; under autograd the
    UNet's down, mid and up blocks run again in the remat recompute. Per run:

    - pretrain_vae: an encode and a decode per step (n_train // batch an
      epoch) and per val batch (batch min(batch, 4));
    - train_task: per micro-step the UNet forward and its blocks' recompute,
      two posterior encodes and the L1 term's decode; per epoch the val
      batches' img2img (batch min(batch, 8): an encode, ``plms_calls(0.6)``
      UNet calls, a decode);
    - the sweep: the round trip, the strength point and the ensemble's
      samples, each one batch of the val images;
    - the probe: a round trip per batch of inputs and of gts.
    """
    from image_restoration_and_enhancement_torch.models import layers

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    unet, vae = modules.unet, modules.vae
    blocks = list(unet.down_blocks) + [unet.mid_block] + list(unet.up_blocks)
    steps = DEMO_TRAIN // DEMO_BATCH      # per epoch, one epoch each
    vae_val = -(-DEMO_VAL // min(DEMO_BATCH, 4))
    task_val = -(-DEMO_VAL // min(DEMO_BATCH, 8))
    per = {}
    for kernel, cls in (("attention", (layers.CrossAttention, layers.VAEAttentionBlock)),
                        ("group_norm", layers.FusedGroupNorm)):
        u, enc, dec = count(unet, cls), count(vae.encoder, cls), count(vae.decoder, cls)
        u_blocks = sum(count(b, cls) for b in blocks)
        serve = lambda s: enc + plms_calls(s) * u + dec  # noqa: E731
        per[kernel] = {
            "pretrain_vae": (steps + vae_val) * (enc + dec),
            "train_task": steps * (u + u_blocks + 2 * enc + dec) + task_val * serve(0.6),
            "sweep": (enc + dec) + (1 + DEMO_ENSEMBLE) * serve(DEMO_STRENGTH),
            "probe": 2 * -(-DEMO_VAL // 8) * (enc + dec),
        }
    return per


def _procedural_source(root) -> str:
    """The workflow's clean-image source on the card: make_procedural_clean's
    images written as PNG and read back, and its own JPEG output, which goes
    through PIL: without PIL (hidden here where the machine has it) the
    script must raise an error naming PIL and write nothing; with PIL it
    writes JPEG."""
    import importlib.util

    import numpy as np

    from image_restoration_and_enhancement_torch import make_procedural_clean as mpc
    from image_restoration_and_enhancement_torch.data.png import read_png, save_image

    clean = os.path.join(root, "procedural", "val")
    os.makedirs(clean)
    rng = np.random.default_rng(42)
    for i in range(PROCEDURAL_IMAGES):
        img = mpc.procedural_image(rng, PROCEDURAL_SIZE)
        path = os.path.join(clean, f"val_{i:06d}.png")
        save_image(path, img)
        if not np.array_equal(read_png(path), img):
            raise AssertionError(f"{path} does not read back as written")
    jpeg_root = os.path.join(root, "procedural_jpeg")
    argv = ["--out_root", jpeg_root, "--num_train", "1", "--num_val", "0", "--num_test",
            "0", "--size", "64"]
    with mock.patch.dict(sys.modules, {"PIL": None}):
        try:
            mpc.main(argv)
        except RuntimeError as e:
            if "PIL" not in str(e):
                raise AssertionError(f"make_procedural_clean's JPEG error names no PIL: {e}")
            refused = str(e)
        else:
            raise AssertionError("make_procedural_clean wrote JPEG without PIL")
    if any(fs for _, _, fs in os.walk(jpeg_root)):
        raise AssertionError("make_procedural_clean wrote files without PIL")
    if importlib.util.find_spec("PIL") is None:
        return f"no PIL on this machine; JPEG refused: {refused}"
    mpc.main(argv)
    with open(os.path.join(jpeg_root, "train", "train_000000.jpg"), "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise AssertionError("make_procedural_clean did not write JPEG")
    return f"PIL present: JPEG written; with PIL hidden, refused: {refused}"


def _init_laws(config) -> dict:
    """init_random_ on a CUDA generator over ``config``'s UNet, VAE and text
    encoder, fp32 on the card, held to flax's laws (see the docstring's demo
    entry); returns each kind's count and pooled std and the largest kernel
    |w| * sqrt(fan_in)."""
    import torch

    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import (TRUNCATED_NORMAL_STD,
                                                                       init_random_)

    stack = sampling.SDModules.create(config, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    moments, cap = {}, 0.0  # kind -> [count, sum, sum of squares] of the scaled entries
    for comp in ("unet", "vae", "text_encoder"):
        for name, p in init_random_(getattr(stack, comp), gen).named_parameters():
            w = p.detach().double()
            if p.dim() == 1:
                if not bool((w == (0.0 if name.endswith("bias") else 1.0)).all()):
                    raise AssertionError(f"init: {comp}.{name} is not its constant")
                continue
            if name.endswith("token_embedding.weight"):
                kind, w = "token_embedding", w * math.sqrt(p.shape[1])
            elif name.endswith("position_embedding.weight"):
                kind, w = "position_embedding", w / 0.01
            else:
                kind, w = "kernel", w * math.sqrt(p[0].numel())
                cap = max(cap, float(w.abs().max()))
            m = moments.setdefault(kind, [0, 0.0, 0.0])
            m[0] += w.numel()
            m[1] += float(w.sum())
            m[2] += float((w * w).sum())
    out = {"kernel_cap": cap}
    for kind, (n, s1, s2) in moments.items():
        std = math.sqrt(s2 / n - (s1 / n) ** 2)
        out[kind] = {"n": n, "std": std}
        if abs(std - 1.0) > INIT_STD_SIGMAS / math.sqrt(2 * n):
            raise AssertionError(f"init: {kind} std {std} (scaled) against flax's 1, n {n}")
    if sorted(moments) != ["kernel", "position_embedding", "token_embedding"] \
            or cap > 2.0 / TRUNCATED_NORMAL_STD + 1e-6:
        raise AssertionError(f"init: {out}")
    del stack
    torch.cuda.empty_cache()
    return out


def phase_demo(tmp, smi: str):
    """The restoration-learning demo chained as a user runs it, after tools
    (see the docstring): the clean-image source, demo_restoration_learning at
    64 px (16 train and 8 val pairs, one VAE and one task epoch), the input
    baseline against the CPU's, demo_eval_sweep (one strength, two seeds),
    probe_vae_roundtrip on the val pairs and summarize_workflow."""
    import io

    import torch

    from image_restoration_and_enhancement_torch import demo_eval_sweep, probe_vae_roundtrip
    from image_restoration_and_enhancement_torch import demo_restoration_learning as demo
    from image_restoration_and_enhancement_torch import summarize_workflow
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.core import schedulers as sched
    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.train import trainer, vae_pretrain

    with _Phase("demo"):
        torch.cuda.empty_cache()
        init = _init_laws(demo.demo_model_config())
        log(f"demo init on the card (flax's laws): {init}")
        root = os.path.join(tmp, "demo")
        source = _procedural_source(root)
        log(f"clean-image source: {PROCEDURAL_IMAGES} procedural {PROCEDURAL_SIZE} px PNGs "
            f"read back equal; {source}")
        out, art = os.path.join(root, "run"), os.path.join(root, "artifacts")
        runs, seconds, counts = {}, {}, [collections.Counter() for _ in range(3)]

        def run(name, fn):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            runs[name] = (dict(_build.launch_counts), dict(_build.launch_shapes),
                          dict(_build.launch_paths))
            for c, now in zip(counts, runs[name]):
                c.update(now)
            log(f"demo {name}: {seconds[name]:.2f} s, launches {runs[name][0]}")
            return result

        # demo_restoration_learning, split at its stages to count each run
        args = ["--out", out, "--size", str(DEMO_SIZE), "--n_train", str(DEMO_TRAIN),
                "--n_val", str(DEMO_VAL), "--vae_epochs", "1", "--epochs", "1",
                "--batch_size", str(DEMO_BATCH), "--device", "cuda", "--artifact_dir", art]
        real_vae, real_train = vae_pretrain.pretrain_vae, trainer.train_task
        with mock.patch.object(vae_pretrain, "pretrain_vae",
                               lambda *a, **kw: run("pretrain_vae", lambda: real_vae(*a, **kw))), \
                mock.patch.object(trainer, "train_task",
                                  lambda *a, **kw: run("train_task", lambda: real_train(*a, **kw))):
            if demo.main(args) != 0:
                raise AssertionError("demo_restoration_learning failed")
        with open(os.path.join(out, "vae_pretrained", "metrics_vae.csv")) as f:
            vae_epoch = list(csv.DictReader(f))[-1]
        log(f"demo VAE epoch: latent_std {vae_epoch['latent_std']} psnr {vae_epoch['psnr']}")
        with open(os.path.join(art, "summary.json")) as f:
            summary = json.load(f)
        cpu_base = round(demo.input_baseline(os.path.join(out, "pairs", "denoise", "val"),
                                             "cpu"), 4)
        log(f"demo summary {summary}; input baseline on the CPU {cpu_base}")
        if abs(summary["input_baseline_psnr"] - cpu_base) > 1e-4:
            raise AssertionError(f"input baseline {summary['input_baseline_psnr']} on the card, "
                                 f"{cpu_base} on the CPU")
        if summary["epochs"] != 1 or not math.isfinite(summary["best_psnr"]):
            raise AssertionError(f"demo summary {summary}")

        sweep_argv = ["--out", out, "--strengths", str(DEMO_STRENGTH), "--ensemble",
                      str(DEMO_ENSEMBLE), "--steps", str(DEMO_STEPS), "--device", "cuda",
                      "--artifact_dir", art]
        if run("sweep", lambda: demo_eval_sweep.main(sweep_argv)) != 0:
            raise AssertionError("demo_eval_sweep failed")
        with open(os.path.join(art, "summary.json")) as f:
            summary = json.load(f)
        served = summary["serving_sweep"]
        if sorted(served) != sorted(["vae_roundtrip", f"strength_{DEMO_STRENGTH:g}",
                                     f"ensemble_{DEMO_ENSEMBLE}_strength_{DEMO_STRENGTH:g}"]) \
                or not all(math.isfinite(v["psnr"]) for v in served.values()):
            raise AssertionError(f"the sweep wrote {served}")

        probe_out = io.StringIO()
        probe_argv = ["--checkpoint", os.path.join(out, "vae_pretrained", "best"),
                      "--pairs", os.path.join(out, "pairs", "denoise", "val"),
                      "--n", str(DEMO_VAL), "--size", str(DEMO_SIZE), "--dtype", "float32",
                      "--device", "cuda"]

        def probe_run():
            with contextlib.redirect_stdout(probe_out):
                return probe_vae_roundtrip.main(probe_argv)

        rc = run("probe", probe_run)
        probe = json.loads(probe_out.getvalue().strip().splitlines()[-1])
        log(f"probe {probe}")
        if rc != 0 or probe["n"] != DEMO_VAL or \
                abs(probe["input_vs_gt"] - summary["input_baseline_psnr"]) > 1e-3:
            raise AssertionError(f"probe_vae_roundtrip: rc {rc}, {probe}")

        table = summarize_workflow.summarize(art, os.path.join(root, "models"),
                                             os.path.join(root, "evaluation_results.json"))
        log("summarize_workflow:\n" + table)
        row = next((line for line in table.splitlines() if line.startswith("| denoise |")), "")
        cells = [c.strip() for c in row.strip("|").split("|")]
        with open(os.path.join(art, "training_denoise.log")) as f:
            lines = f.read().splitlines()
        epoch_lines = [m for m in map(summarize_workflow.EPOCH_RE.search, lines) if m]
        # one epoch: its row and the logged baseline (to 2 decimals; no warm
        # epoch to take)
        if len(cells) < 8 or cells[1] != "1" or not cells[5] \
                or abs(float(cells[5]) - cpu_base) > 0.0051 or len(epoch_lines) != 1:
            raise AssertionError(f"summarize_workflow: row {row!r}, {len(epoch_lines)} epoch "
                                 "lines in the log")

        # the launches the code works out for these runs
        cpu_stack = sampling.SDModules.create(demo.demo_model_config(), torch.float32, "cpu")

        def plms(strength):
            return sched.plms_step_plan(cpu_stack.config.scheduler, DEMO_STEPS,
                                        strength).num_calls

        want = _demo_launches(cpu_stack, plms)
        got = {k: {name: r[0].get(k, 0) for name, r in runs.items()} for k in want}
        log(f"demo launches by run {got}, worked out {want}")
        if got != want:
            raise AssertionError(f"demo launches {got}, not {want}")
        launches, shapes, codes = (dict(c) for c in counts)
        if set(launches) != {"attention", "group_norm"}:
            raise AssertionError(f"the demo launched {launches}")
        _check_fp32_paths(shapes, codes)
        row = {"card": smi, "seconds": seconds, "summary": summary, "probe": probe,
               "launches_by_run": got, "clean_source": source, "init": init,
               "vae_epoch": vae_epoch}
        log("demo_json " + json.dumps(row))
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "shapes": shapes, "codes": codes, **row}


MD_SIZE = 512          # multidevice (a) and (c): 512 px
MD_SP_SIZE = 2048      # multidevice (b): one 2048 px image over sp = 4
MD_BATCH = 4           # (a): 4 images, 20-step DDIM, CFG
MD_INPAINT_BATCH = 2   # (c): 2 images over (data 2, sp 2)
# Sharded against unsharded, bf16 images in [-1, 1] ((a), (c)) or uint8 ((b)):
# the ranks compute each output element from the same products, but the
# tensor-parallel partial products are summed over the ranks (in fp32) and
# rounded once more, GroupNorm's partials are reduced in another order, and
# cuDNN may pick another algorithm for a shard's height; each such difference
# of a bf16 rounding is carried through 20 (11) UNet calls of a random-weight
# network. The limits: mean |delta| within MD_MEAN_TOL of the range and PSNR
# over MD_PSNR_MIN dB (peak 2 for [-1, 1], 255 for uint8). A missing halo row
# or a shard normalised with its own statistics gives whole rows of wrong
# pixels (tests/test_torch_spatial.py holds the same paths in fp32 to 2e-4).
MD_MEAN_TOL = 0.02
MD_PSNR_MIN = 25.0
# (d) and (e), int8_static: on random weights an s8 value at a rounding
# boundary flips for an fp32 difference of one ulp (here: another order of a
# sum over the ranks), and the flip redraws the quantization noise of every
# later layer (tests/test_torch_parallel_modes.py measures it on the CPU). So
# the sharded int8 output is held to the unsharded one by the noise itself:
# mean |delta| at most MD_INT8_NOISE_FACTOR times the mean distance of the
# unsharded int8 output from the unsharded bf16 serve of the same request
# ((a) for (d), (c) for (e)); two draws of the noise lie about sqrt(2) times
# it apart. The tight int8 checks are the scale audit and the unit cases of
# that test file and this script's kernel rows.
MD_INT8_NOISE_FACTOR = 2.0
MD_CALIB_STEPS = 4    # DDIM steps of the unsharded calibration of (d) and (e)
MD_STEPS = 20         # DDIM steps of a request over four cards
MD_ONE_CARD_STEPS = 5  # over one card: the (1, 1) meshes check the function, not the speed


def _md_stacks(tmp):
    """The SD-1.5 and SD-1.5-inpaint bf16 stacks at ``tmp`` and ``tmp/inpaint``
    (the serve phases' own; written here from the seed when absent)."""
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    for path, cfg in ((tmp, C.SD15), (os.path.join(tmp, "inpaint"), C.SD15_INPAINT)):
        if ckpt.pipeline_exists(path):
            continue
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        mods = sampling.SDModules.create(cfg, torch.bfloat16, "cuda")
        for m in mods.components().values():
            init_random_(m, gen)
        ckpt.save_pipeline(path, mods.components(), cfg, dtype=torch.bfloat16)
        log(f"wrote the random bf16 stack {path} in {time.perf_counter() - t0:.2f} s")
        del mods
        torch.cuda.empty_cache()
    return tmp, os.path.join(tmp, "inpaint")


def _kernel_counts(shapes):
    """Launches by kernel from launches by (kernel, shape key)."""
    out = collections.Counter()
    for (k, _), c in shapes.items():
        out[k] += c
    return dict(out)


def _md_compare(name, got, want, peak: float):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"multidevice {name}: output {got.shape}, not {want.shape}, "
                             "or not finite")
    err = np.abs(got - want)
    psnr = _psnr(got, want, peak)
    row = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "psnr_db": psnr, "mean_tol": MD_MEAN_TOL * peak, "psnr_min_db": MD_PSNR_MIN}
    if not (row["mean_abs_err"] <= row["mean_tol"] and psnr >= MD_PSNR_MIN):
        raise AssertionError(f"multidevice {name}: sharded disagrees with unsharded: {row}")
    return row


def _md_calibrate(case):
    """The int8_static table of a serving case: its request served unsharded
    on card 0 under dynamic int8 (the case's attention backend and ToMe) for
    MD_CALIB_STEPS DDIM steps, each site's activation absmax maxed over the
    run (what make_calib_img2img_fn records, for img2img and inpaint)."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.ops import quant
    from image_restoration_and_enhancement_torch.parallel import serve

    dev = torch.device("cuda", 0)
    mods = serve.load_stack(dict(case, quant=None), dev)
    state = quant.QuantState("int8")
    mods.set_quant(state)
    inpaint = case["kind"] == "inpaint"
    maker = sampling.make_inpaint_fn if inpaint else sampling.make_img2img_fn
    fn = maker(mods, **dict(case["sampling"], num_inference_steps=MD_CALIB_STEPS),
               cfg_layout="interleaved")
    inputs = case["inputs"]
    ctx, unc = serve._contexts(mods, inputs, dev)
    args = [torch.from_numpy(np.asarray(inputs["image"])).to(dev)]
    if inpaint:
        args.append(torch.from_numpy(np.asarray(inputs["mask"])).to(dev))
    with state.collect() as stats:
        fn(*args, ctx, unc, generator=torch.Generator(device=dev).manual_seed(int(inputs["seed"])))
    table = {k: float(v) for k, v in stats.items()}
    del mods, fn
    torch.cuda.empty_cache()
    return table


def _md_compare_int8(name, got, want, bf16):
    import numpy as np

    got, want, bf16 = (np.asarray(a, np.float64) for a in (got, want, bf16))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"multidevice {name}: output {got.shape}, not {want.shape}, "
                             "or not finite")
    err = np.abs(got - want)
    noise = float(np.abs(want - bf16).mean())
    row = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "psnr_db": _psnr(got, want, 2.0), "int8_noise_mean": noise,
           "mean_tol": MD_INT8_NOISE_FACTOR * noise,
           "psnr_unsharded_int8_vs_bf16_db": _psnr(want, bf16, 2.0)}
    if not row["mean_abs_err"] <= row["mean_tol"]:
        raise AssertionError(f"multidevice {name}: sharded int8 disagrees with unsharded: {row}")
    return row


def phase_multidevice(tmp, smi: str):
    """Multi-device serving (see the docstring): torch.cuda.device_count()
    ranks (at most 4) over NCCL, one card each, serve (a) SD-1.5 img2img over
    (data 2, model 2), (b) a 2048 px denoise through RestorationPipeline over
    sp 4, (c) SD-1.5-inpaint over (data 2, sp 2), (d) (a) under int8_static,
    K4 attention and ToMe 0.5 and (e) (c) under int8_static, each held
    against the same request unsharded on card 0; with one card, (a), (c),
    (d) and (e) over (1, 1) meshes.
    Returns the ranks' launches (summed over the ranks) as the path's."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.parallel import launch, serve

    with _Phase("multidevice"):
        n = min(torch.cuda.device_count(), 4)
        sd15, inpaint_dir = _md_stacks(tmp)
        rng = np.random.default_rng(SEED)
        vocab = C.SD15.text_encoder.vocab_size  # CLIP's last id is its eos
        ids = rng.integers(1, vocab - 1, (MD_BATCH, 77)).astype(np.int64)
        uncond_ids = np.full((MD_BATCH, 77), vocab - 1, np.int64)
        img = lambda b, s: rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)  # noqa: E731
        # over one card the (1, 1) meshes check the function, not the speed:
        # one request a case, of MD_ONE_CARD_STEPS steps
        base = dict(dtype="bfloat16", requests=2 if n == 4 else 1)
        dd = dict(num_inference_steps=MD_STEPS if n == 4 else MD_ONE_CARD_STEPS, strength=1.0,
                  guidance_scale=7.5, sampler="ddim")
        cases = {"a_img2img": dict(
            base, config="sd15", weights=sd15, kind="img2img", sampling=dd,
            mesh=((2, 2), ("data", "model")) if n == 4 else ((1, 1), ("data", "model")),
            axes={"data_axis": "data", "model_axis": "model"},
            inputs=dict(image=img(MD_BATCH, MD_SIZE), ids=ids, uncond_ids=uncond_ids,
                        seed=SEED))}
        mask = np.zeros((MD_INPAINT_BATCH, MD_SIZE, MD_SIZE, 1), np.float32)
        mask[:, 128:384, 96:416] = 1.0
        if n == 4:
            cases["b_denoise_2048"] = dict(
                base, weights=sd15, kind="denoise", mesh=((4,), ("sp",)),
                axes={"spatial_axis": "sp"}, pipeline={"max_size": MD_SP_SIZE},
                inputs=dict(image=rng.integers(0, 256, (MD_SP_SIZE, MD_SP_SIZE, 3),
                                               dtype=np.uint8)))
        # over one card a (1, 1) mesh: one shard of every sp-gated level, the
        # height-sharded code (zero halos, K2's sharded entries) with no peer
        cases["c_inpaint"] = dict(
            base, config="sd15_inpaint", weights=inpaint_dir, kind="inpaint", sampling=dd,
            mesh=((2, 2) if n == 4 else (1, 1), ("data", "sp")),
            axes={"data_axis": "data", "spatial_axis": "sp"},
            inputs=dict(image=img(MD_INPAINT_BATCH, MD_SIZE), mask=mask,
                        ids=ids[:MD_INPAINT_BATCH], uncond_ids=uncond_ids[:MD_INPAINT_BATCH],
                        seed=SEED + 1))
        from image_restoration_and_enhancement_torch.ops import token_merge

        # (d), (e): (a) and (c) served int8_static, calibrated unsharded on card 0
        int8_of = {"d_img2img_int8": ("a_img2img", dict(
                       backend="int8", tome=(0.5, token_merge.DEFAULT_MIN_TOKENS))),
                   "e_inpaint_int8": ("c_inpaint", {})}
        for name, (src, extra) in int8_of.items():
            t0 = time.perf_counter()
            case = dict(cases[src], **extra)
            cases[name] = dict(case, quant=("int8_static", _md_calibrate(case)))
            log(f"multidevice {name}: calibrated {len(cases[name]['quant'][1])} sites unsharded "
                f"on card 0 in {time.perf_counter() - t0:.2f} s")
        refs = {}
        for name, case in cases.items():
            refs[name] = serve.unsharded(case, "cuda:0")
            log(f"multidevice {name} unsharded on card 0: request seconds "
                f"{refs[name]['seconds']} ({smi})")
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.launch(serve.run_cases, n, "nccl", (list(cases.values()),))
        log(f"multidevice: {n} NCCL ranks served {len(cases)} cases in "
            f"{time.perf_counter() - t0:.2f} s (start-up included)")
        shapes, codes, summary = collections.Counter(), collections.Counter(), {}
        for i, name in enumerate(cases):
            per_rank = [r[i] for r in ranks]
            for r in per_rank:
                shapes.update(r["launch_shapes"])
                codes.update(r["launch_paths"])
            peak = 2.0 if cases[name]["kind"] != "denoise" else 255.0
            if name in int8_of:
                errors = _md_compare_int8(name, per_rank[0]["out"], refs[name]["out"],
                                          refs[int8_of[name][0]]["out"])
            else:
                errors = _md_compare(name, per_rank[0]["out"], refs[name]["out"], peak)
            summary[name] = {
                "mesh": list(cases[name]["mesh"][0]), "axes": list(cases[name]["mesh"][1]),
                "request_seconds_by_rank": [r["seconds"] for r in per_rank],
                "unsharded_request_seconds": refs[name]["seconds"],
                "peak_memory_bytes_by_rank": [r["peak_bytes"] for r in per_rank],
                "collectives_by_rank": [r["collectives"] for r in per_rank],
                "launches_by_rank": [_kernel_counts(r["launch_shapes"]) for r in per_rank],
                **errors}
            log(f"multidevice {name}: " + json.dumps(summary[name]) + f" ({smi})")
        shapes, codes = dict(shapes), dict(codes)
        _check_attention_paths(shapes, codes)
        _check_k2_k3_paths(shapes, codes, 0)  # (a)'s CFG batch 8 plans 64x64x960 twophase
        launches = collections.Counter()
        for (k, _), c in shapes.items():
            launches[k] += c
        for k in ("attention", "group_norm", "group_norm_stats", "group_norm_apply",
                  "conv3x3_int8", "int8_attention"):
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"kernel {k} did not launch on the multidevice path")
        for name in int8_of:
            got = collections.Counter()
            for r in summary[name]["launches_by_rank"]:
                got.update(r)
            want = ("conv3x3_int8", "int8_attention") if name.startswith("d") else (
                "conv3x3_int8",)
            if any(got[k] <= 0 for k in want):
                raise AssertionError(f"multidevice {name}: {want} did not all launch: {got}")
        if n < 4:
            log(f"multidevice: {n} card(s): (a), (c), (d) and (e) over (1, 1) NCCL meshes "
                "only; the multi-rank check is `python3 chip_smoke.py --only "
                "multidevice,multitrain` on a machine with four cards")
        log("multidevice_json " + json.dumps({"ranks": n, "cases": summary,
                                              "launches": dict(launches), "device": smi}))
    return {"launches": dict(launches), "shapes": shapes, "codes": codes, "cases": summary}


MT_SIZE = 256          # multitrain: 256 px
MT_BATCH = 4           # (f): global batch 4, 4 micro-steps, k = 2
MT_STEPS = 4
MT_LR = 1e-4           # (f)'s peak learning rate (its first optimizer step has lr 0)
MT_TP_BATCH = 2        # (g): batch 2 over (data 2, model 2), fp32, two steps
MT_TP_STEPS = 2        # (the first pays cuDNN's and NCCL's first-call costs)
MT_RESTORE_BATCH = 4   # (h): one more step over (data n, model 1) and on one card
MT_TP_LR = 1e-5        # (g), (h): AdamW(1e-5), as dryrun_multichip's optax.adamw
# (f), bf16 compute, data mesh against one card: each rank runs its rows at
# batch 1 where the card runs batch 4, so cuBLAS and cuDNN sum in other
# orders and the bf16 activations round elsewhere; the loss of each
# micro-step within MT_LOSS_RTOL of the card's. The masters: AdamW divides
# each gradient entry by its RMS, so an entry moves by about the learning rate
# a step whatever its size, and one whose gradient is near zero can move the
# other way on a rounding difference (+lr on one side, -lr on the other):
# every master within MT_LR_FACTOR x the learning rate of each step taken of
# the card's. The same holds for (g) and (h) in fp32 with TF32 off in every
# rank, where the gradients must also agree: each sharded gradient tensor
# within MT_GRAD_REL of its largest entry (the ranks' partial sums in another
# order; with cuDNN's TF32 left on in the ranks a four-card run read
# 1.76e-3).
MT_LOSS_RTOL = 2e-2
MT_LR_FACTOR = 2.05   # two learning rates, and fp32 rounding of the sums
MT_GRAD_REL = 1e-3


def _mt_draws(gen_seed, batch, steps, latent):
    """Global batches and draws for run_steps: random [-1, 1] images (numpy)
    and the loss's draws, from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(gen_seed)
    out = []
    for _ in range(steps):
        img = lambda: rng.uniform(-1, 1, (batch, MT_SIZE, MT_SIZE, 3)).astype(np.float32)  # noqa: E731
        lat = lambda: rng.standard_normal((batch, latent, latent, 4)).astype(np.float32)  # noqa: E731
        out.append({"batch": {"input": img(), "gt": img()},
                    "draws": {"t": rng.integers(0, 1000, (batch,)), "noise": lat(),
                              "enc1": lat(), "enc2": lat()}})
    return out


def phase_multitrain(tmp, smi: str):
    """Multi-device training (see the docstring): (f) train_task over a data
    mesh of every card against one card, (g) the DP x TP AdamW step over
    (data 2, model 2) against the unsharded step, (h) its saved state restored
    over (data n, model 1) and on one card, one more step each. With one
    card, (1,) and (1, 1) meshes. Returns the ranks' launches, summed."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.parallel import launch
    from image_restoration_and_enhancement_torch.parallel import train as ptrain
    from image_restoration_and_enhancement_torch.tasks.registry import get_task
    from image_restoration_and_enhancement_torch.train import loop, trainer

    with _Phase("multitrain"):
        n = min(torch.cuda.device_count(), 4)
        root = os.path.join(tmp, "multitrain")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        _write_train_data(root, gen, MT_BATCH * MT_STEPS, 1, tasks=("denoise",))
        spec = get_task("denoise")
        spec = dataclasses.replace(spec, val_sampler=dataclasses.replace(
            spec.val_sampler or spec.sampler, num_inference_steps=2))
        cfg = loop.TrainConfig(num_epochs=1, batch_size=MT_BATCH, gradient_accumulation_steps=2,
                               image_size=MT_SIZE, learning_rate=MT_LR, save_steps=-1,
                               state_save_epochs=-1)
        from image_restoration_and_enhancement_torch import config as C

        kw = dict(task_name="denoise", data_root=os.path.join(root, "pairs"), cfg=cfg,
                  max_val_samples=1, dtype=torch.bfloat16, task_spec=spec,
                  model_config=C.SD15)
        summary = {}
        shapes, codes, launches = collections.Counter(), collections.Counter(), {}

        def add(per_rank):
            for r in per_rank:
                shapes.update(r["launch_shapes"])
                codes.update(r["launch_paths"])

        # (f) the trainer: one card, then a data mesh of n ranks
        seen = ptrain._Observed()
        one_dir = os.path.join(root, "one")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train_task(**kw, output_dir=one_dir, use_mesh=False, device="cuda",
                           on_step=seen)
        one = {"losses": seen.losses, "seconds": seen.seconds,
               "peak_bytes": torch.cuda.max_memory_allocated(), "total": time.perf_counter() - t0}
        one_masters = seen.state.params  # fp32, on card 0; the rest of the state goes
        del seen
        shutil.rmtree(one_dir)  # ~8 GB of pipelines
        torch.cuda.empty_cache()
        mesh_dir = os.path.join(root, "mesh")
        t0 = time.perf_counter()
        ranks = launch.launch(ptrain.run_train_task, n, "nccl",
                              (dict(kw, output_dir=mesh_dir, device="cuda"),))
        total = time.perf_counter() - t0
        add(ranks)
        launches["f"] = [_kernel_counts(r["launch_shapes"]) for r in ranks]
        # the mesh run's masters as its rank 0 wrote them (final/, fp32)
        b = ckpt.load_state_dicts(os.path.join(mesh_dir, "final"))["unet"]
        if set(b) != set(one_masters):
            raise AssertionError("(f): final/ holds other UNet tensors than the run trained")
        master_err = max(float((one_masters[k] - b[k].to(one_masters[k].device)).abs().max())
                         for k in b)
        del b, one_masters
        shutil.rmtree(mesh_dir)
        torch.cuda.empty_cache()
        lr_sum = MT_LR * (MT_STEPS // cfg.gradient_accumulation_steps)
        row = {"ranks": n, "losses_one_card": one["losses"], "losses_mesh": ranks[0]["losses"],
               "micro_step_seconds_one_card": one["seconds"],
               "micro_step_seconds_by_rank": [r["seconds"] for r in ranks],
               "run_seconds_one_card": one["total"], "run_seconds_mesh": total,
               "peak_memory_bytes_one_card": one["peak_bytes"],
               "peak_memory_bytes_by_rank": [r["peak_bytes"] for r in ranks],
               "collectives_by_rank": [r["collectives"] for r in ranks],
               "master_max_abs_err": master_err, "master_tol": MT_LR_FACTOR * lr_sum,
               "fingerprints": [r["fingerprint"] for r in ranks]}
        summary["f_train_task"] = row
        log("multitrain (f) train_task: " + json.dumps(row) + f" ({smi})")
        if len(ranks[0]["losses"]) != MT_STEPS or len(one["losses"]) != MT_STEPS:
            raise AssertionError(f"(f): {len(ranks[0]['losses'])} and {len(one['losses'])} "
                                 f"micro-steps, not {MT_STEPS}")
        for x, y in zip(ranks[0]["losses"], one["losses"]):
            if not (math.isfinite(x) and abs(x - y) <= MT_LOSS_RTOL * abs(y)):
                raise AssertionError(f"(f): mesh losses {ranks[0]['losses']} against one card's "
                                     f"{one['losses']}")
        if not master_err <= row["master_tol"]:
            raise AssertionError(f"(f): masters {master_err:.3e} from one card's")
        if len(set(row["fingerprints"])) != 1:
            raise AssertionError(f"(f): the data ranks' masters differ: {row['fingerprints']}")
        if n > 1 and any(r["collectives"].get("grad_bucket", 0) <= 0 for r in ranks):
            raise AssertionError("(f): no bucketed gradient all-reduce")

        # (g) the DP x TP step, fp32, against the unsharded step on card 0; its
        # state saved; (h) restored over (data n, model 1), one step each
        weights = _md_stacks(tmp)[0]
        latent = MT_SIZE // 8
        state_dir = os.path.join(root, "tp_state")
        with torch.no_grad():  # the context: CLIP on card 0 from the same weights
            from image_restoration_and_enhancement_torch.parallel import serve

            mods = serve.load_stack(dict(config="sd15", dtype="float32", weights=weights), "cuda:0")
            from image_restoration_and_enhancement_torch.core import sampling

            vocab = C.SD15.text_encoder.vocab_size
            ids = np.random.default_rng(SEED + 12).integers(1, vocab - 1, (1, 77))
            ctx = sampling.encode_text(mods, torch.as_tensor(ids)).cpu().numpy()
            del mods
            torch.cuda.empty_cache()
        base = dict(config="sd15", dtype="float32", weights=weights, task="denoise",
                    train=dict(gradient_accumulation_steps=1, lambda_img=0.0),
                    optimizer="adamw", lr=MT_TP_LR, context=ctx, reference=True)
        tp = (2, 2) if n == 4 else (1, 1)
        cases = {"g_dp_tp": dict(base, mesh=(tp, ("data", "model")), save=state_dir,
                                 steps=_mt_draws(SEED + 13, MT_TP_BATCH, MT_TP_STEPS, latent)),
                 "h_restore": dict(base, mesh=((n, 1), ("data", "model")), restore=state_dir,
                                   steps=_mt_draws(SEED + 14, MT_RESTORE_BATCH, 1, latent))}
        t0 = time.perf_counter()
        ranks = launch.launch(ptrain.run_cases, n, "nccl", (list(cases.values()),))
        log(f"multitrain (g), (h): {n} NCCL ranks in {time.perf_counter() - t0:.2f} s "
            "(start-up and the unsharded references on card 0 included)")
        for i, name in enumerate(cases):
            per_rank = [r[i] for r in ranks]
            add(per_rank)
            launches[name[0]] = [_kernel_counts(r["launch_shapes"]) for r in per_rank]
            err = per_rank[0]["errors"]
            row = {"mesh": list(cases[name]["mesh"][0]), "errors": err,
                   "step_seconds_by_rank": [r["seconds"] for r in per_rank],
                   "unsharded_step_seconds": err["reference_seconds"],
                   "peak_memory_bytes_by_rank": [r["peak_bytes"] for r in per_rank],
                   "collectives_by_rank": [r["collectives"] for r in per_rank],
                   "loss": per_rank[0]["metrics"][0]["loss"],
                   "param_tol": MT_LR_FACTOR * MT_TP_LR * len(cases[name]["steps"]),
                   "grad_rel_tol": MT_GRAD_REL}
            summary[name] = row
            log(f"multitrain ({name}): " + json.dumps(row) + f" ({smi})")
            if not (err["params"]["max_abs_err"] <= row["param_tol"]
                    and (name != "g_dp_tp" or err["grads"]["max_rel_err"] <= MT_GRAD_REL)
                    and math.isfinite(row["loss"])):
                raise AssertionError(f"multitrain {name}: sharded against unsharded {err}")
        saved = torch.load(os.path.join(state_dir, trainer.STATE_FILE), map_location="cpu",
                           weights_only=True)
        full = ckpt.load_state_dicts(weights)["unet"]
        if {k: tuple(v.shape) for k, v in saved["params"].items()} != {
                k: tuple(v.shape) for k, v in full.items()}:
            raise AssertionError("(h): the saved train state is not the full UNet's")
        del saved, full
        total = collections.Counter()
        for (k, _), c in shapes.items():
            total[k] += c
        for name, per_rank in launches.items():
            for k in ("attention", "group_norm"):
                if any(r.get(k, 0) <= 0 for r in per_rank):
                    raise AssertionError(f"multitrain ({name}): {k} did not launch on every rank")
        bf16_k1 = {p: c for (k, p), c in codes.items() if k == "attention"}
        log(f"multitrain attention launches by path {bf16_k1}")
        if n < 4:
            log(f"multitrain: {n} card(s): (f) over a (1,) mesh, (g) and (h) over (1, 1); the "
                "multi-rank check is `python3 chip_smoke.py --only multidevice,multitrain` on "
                "a machine with four cards")
        log("multitrain_json " + json.dumps({"ranks": n, "cases": summary,
                                             "launches": dict(total), "device": smi}))
    return {"launches": dict(total), "shapes": dict(shapes), "codes": dict(codes),
            "cases": summary}


def phase_serve_sdxl():
    """config.SDXL at random, written in bf16 and served at 1024x1024 through
    RestorationPipeline from its own directory (no model_config given)."""
    import numpy as np
    import torch

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    rows, shapes, codes, launches = [], collections.Counter(), collections.Counter(), \
        collections.Counter()
    with _Phase("serve_sdxl"):
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="iret_sdxl_")
        try:
            log(f"free space under {tmp}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
            mods = sampling.SDModules.create(C.SDXL, torch.bfloat16, "cuda")
            counts = {}
            for name, m in mods.components().items():
                init_random_(m, gen)
                counts[name] = sum(p.numel() for p in m.parameters())
            log(f"random SDXL stack: {counts} in {time.perf_counter() - t0:.2f} s")
            if counts != SDXL_PARAMS:
                raise AssertionError(f"SDXL parameters {counts}, not {SDXL_PARAMS}")
            t0 = time.perf_counter()
            ckpt.save_pipeline(tmp, mods.components(), C.SDXL, dtype=torch.bfloat16)
            size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp)
                       for f in fs)
            log(f"wrote + verified the bf16 SDXL pipeline ({size / 2**30:.2f} GiB) in "
                f"{time.perf_counter() - t0:.2f} s")
            del mods
            torch.cuda.empty_cache()

            pipe = _pipeline(tmp)
            image = np.random.default_rng(SEED + 2).integers(0, 256, (1024, 1024, 3),
                                                             dtype=np.uint8)
            requests = [("sdxl default (gs 5.0, CFG batch 2; includes the stack load)", {}),
                        ("sdxl default again (steady state)", {}),
                        ("sdxl guidance=1.0 (steady state, batch 1)", {"guidance": 1.0})]
            want = 140 * 11 + VAE_ATTENTION_PER_REQUEST
            for label, kw in requests:
                secs, outs, n, sh, cd, pk = _serve_calls(
                    [(label, lambda kw=kw: pipe.denoise(image, **kw), (1024, 1024, 3))],
                    onchip_hw=0)
                stack = pipe._stacks["denoise"]
                if not stack["modules"].is_sdxl or stack["spec"].model_config != C.SDXL:
                    raise AssertionError("the SDXL directory was not served as SDXL")
                by_batch, by_shape = _attention_split(sh)
                d64 = sum(v for k, v in by_shape.items() if k[4] == 64)
                if n.get("attention") != want or d64 != 140 * 11 or \
                        n.get("group_norm", 0) <= 0:
                    raise AssertionError(f"{label}: K1 launched {n.get('attention')} times "
                                         f"({d64} at head_dim 64), not {want}; {n}")
                log(f"{label}: peak {pk / 2**30:.3f} GiB; K1 {n['attention']} launches "
                    f"({d64} at head_dim 64, by batch {dict(by_batch)})")
                rows.append({"request": label, "seconds": secs[0], "peak_memory_bytes": pk,
                             "launches": n})
                shapes.update(sh)
                codes.update(cd)
                launches.update(n)
            log("serve_sdxl_json " + json.dumps({"requests": rows}))
            profile = _profile_request(lambda: pipe.denoise(image), rows[1]["seconds"])
            graph = [_graph_ab(pipe, "serve_sdxl CFG", lambda c: c[3][-1] is not None)]
            del pipe
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"requests": rows, "launches": dict(launches), "shapes": dict(shapes),
            "codes": dict(codes), "profile": profile, "graph": graph}


def _cpu_twin(mod):
    """A CPU copy of a quantized layer: same class, weights, dtype and site."""
    import torch

    from image_restoration_and_enhancement_torch.models.layers import QConv2d

    with torch.device("cpu"):
        if isinstance(mod, QConv2d):
            twin = type(mod)(mod.in_channels, mod.out_channels, mod.kernel_size, mod.stride,
                             mod.padding, bias=mod.bias is not None)
        else:
            twin = type(mod)(mod.in_features, mod.out_features, bias=mod.bias is not None)
    twin = twin.to(mod.weight.dtype)
    twin.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()})
    twin.site = mod.site
    return twin


def _layer_parity(pipe, image) -> None:
    """Every quantized layer that K3 does not serve (Linear, 1x1 and stride-2
    convs), one of each (class, weight shape, stride, input shape), with the
    input and output it had in a default request on the card. Each output
    must match the same layer on the CPU on the same input to within one
    rounding of its dtype; so must the card's layer under dynamic scales; and
    the card's layer with quantization off must not (the control)."""
    import torch

    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import QConv2d, QLinear
    from image_restoration_and_enhancement_torch.ops import tolerance
    from image_restoration_and_enhancement_torch.ops.quant import QuantState

    t0 = time.perf_counter()
    modules = pipe._stacks["denoise"]["modules"]
    seen = {}

    def hook(mod, args, out):
        x = args[0]
        sig = (type(mod).__name__, tuple(mod.weight.shape), getattr(mod, "stride", None),
               tuple(x.shape))
        if sig not in seen:
            seen[sig] = (mod, x.clone(), out.clone())

    hooks = [m.register_forward_hook(hook) for root in (modules.unet, modules.vae)
             for m in root.modules() if isinstance(m, QLinear) or (isinstance(m, QConv2d) and (
                 m.kernel_size, m.stride, m.padding) != ((3, 3), (1, 1), (1, 1)))]
    # the hooks see the layers only in an eager run: a graph replay calls no module
    stack, kind, settings, args = pipe.sd_calls[-1][:4]
    eager = sampling.make_img2img_fn(modules, *settings, graph=False)
    try:
        eager(*args, generator=torch.Generator(device="cuda").manual_seed(pipe.seed))
    finally:
        for h in hooks:
            h.remove()
    worst = {"static": 0.0, "dynamic": 0.0}
    failed, control_passed = [], []
    twins = {sig: _cpu_twin(mod) for sig, (mod, _, _) in seen.items()}
    with torch.inference_mode():
        for sig, (mod, x, out) in seen.items():
            twin, xc = twins[sig], x.cpu()
            for label, state in (("static", pipe.quant), ("dynamic", QuantState("int8"))):
                twin.set_quant(state)
                ref = twin(xc)
                if label == "static":
                    got, ref_static = out.cpu(), ref
                else:
                    mod.set_quant(state)
                    got = mod(x).cpu()
                ok, err = tolerance.within(got, ref, "int8_layer")
                worst[label] = max(worst[label], err)
                if not ok:
                    failed.append((label, sig, err))
            mod.set_quant(None)
            if tolerance.within(mod(x).cpu(), ref_static, "int8_layer")[0]:
                control_passed.append(sig)
            mod.set_quant(pipe.quant)
    log(f"layer parity: {len(seen)} shapes of {sorted({s[0] for s in seen})} layers, cuda "
        f"against cpu, max abs err static {worst['static']:.3e}, dynamic "
        f"{worst['dynamic']:.3e} (limit one rounding of the output dtype); control "
        f"(quantization off on the card) passes at {len(control_passed)} of {len(seen)} "
        f"shapes; {time.perf_counter() - t0:.2f} s")
    if failed:
        raise AssertionError(f"int8 layers disagree between CUDA and CPU at "
                             f"{len({sig for _, sig, _ in failed})} of {len(seen)} shapes: "
                             f"{failed[:5]}")
    if control_passed or not seen:
        raise AssertionError(f"the int8 layer limit passes full precision: {control_passed[:5]}")


def _kernel_group(name: str, mma_label: str) -> str:
    """``mma_label``: what runs the tensor-core attention code at the UNet's
    sites in this serve (K1, K5 and K6 share its device code; the backend
    decides). The d = 512 instance is K1 at the VAE mid-block in every serve.
    K4's sm90 code is the same kernel template with the s8 score product
    (``S8QK`` in its name), so it is told apart by that and never counted as
    K1. ``name`` is the profiler's demangled name or the driver's mangled one
    (a graph node's: ``graphs.graph_nodes``)."""
    low = name.lower()
    if "conv3x3_int8_sm90_kernel" in name:
        return "K3 conv3x3_int8 (sm90)"
    if "conv3x3_int8_mma_kernel" in name:
        return "K3 conv3x3_int8 (mma)"
    if "attention_sm90_kernel" in name and "S8QK" in name:
        return "K4 int8_attention (sm90)"
    if "int8_attention_kernel" in name:
        return "K4 int8_attention (mma)"
    if "attention_sm90_kernel<512," in name or "attention_sm90_kernelILi512E" in name:
        return "K1 attention (VAE d 512, sm90_split)"
    if "attention_sm90_kernel" in name or "attention_mma_kernel" in name:
        return mma_label
    if "attention_kernel" in name:
        return "K1 attention (simt)"
    if "gn_onchip_kernel" in name:
        return "K2 group_norm (onchip)"
    if "gn_stats_kernel" in name or "gn_apply_kernel" in name:
        return "K2 group_norm (twophase)"
    if any(w in low for w in ("fprop", "conv", "implicit", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "elementwise" in low:
        return "elementwise (PyTorch)"
    return "other"


def _device_events(results) -> dict:
    """{name: (microseconds, count)} of a finished profile's device events:
    the device rows of ``prof.key_averages()`` (each device event's own span,
    summed by name), read straight from the profiler's event list. The
    ``key_averages()`` route first builds the host op tree, 9-29 s a profiled
    request on the card's host; this takes a fraction of a second."""
    from torch.autograd import DeviceType

    out = {}
    for e in results.events():
        hidden = getattr(e, "is_hidden_event", lambda: False)()  # as key_averages() reads it
        if (e.device_type() != DeviceType.CUDA or e.is_async() or hidden
                or e.start_thread_id() != e.end_thread_id()):
            continue
        us, n = out.get(e.name(), (0.0, 0))
        out[e.name()] = (us + (e.end_ns() - e.start_ns()) / 1e3, n + 1)
    return out


def _profile_request(request, unprofiled_s: float, mma_label: str = "K1 attention"):
    """One more request (``request()``) under torch.profiler: device time by
    kernel group, returned and logged. Its launches are not counted: the counts
    were read above. The profiler's own host cost lengthens this request, so
    the device busy share is also given against ``unprofiled_s``, the same
    request's steady-state time without the profiler. ``mma_label`` names the
    kernel that the UNet's bf16 attention sites run (see ``_kernel_group``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for name, (us, n) in _device_events(prof.profiler.kineto_results).items():
        if us <= 0:
            continue
        group = _kernel_group(name, mma_label)
        total, count = groups.get(group, (0.0, 0))
        groups[group] = (total + us, count + n)
    device_us = sum(t for t, _ in groups.values())
    if device_us == 0:
        log("profile: the profiler saw no device time (device split not measured)")
        return None
    profile_row = {
        "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
        "device_busy_share_profiled": device_us / wall_us,
        "device_busy_share_vs_unprofiled": device_us / 1e6 / unprofiled_s,
        "groups": {k: {"ms": t / 1e3, "launches": c} for k, (t, c) in
                   sorted(groups.items(), key=lambda kv: -kv[1][0])}}
    log("profile_json " + json.dumps(profile_row))
    return profile_row


def _dtype(name: str):
    import torch

    return getattr(torch, name.split(".")[-1])


def _bare_call(q, k, v, path):
    """K1's function through one device code ("sm90", or "mma": the design the
    sm90 code replaced at the served sites, which still serves K1's opt-in
    branches) on the same inputs, straight through the C entry without the
    Python wrapper: timed beside the kernel as an in-call comparison of the
    two codes (their host cost is the C entry's alone, tensor-map encodes
    included for sm90) and not counted as a launch."""
    import torch

    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops import attention as A

    b, nq, h, d = q.shape
    out = torch.empty_like(q)
    lib, scale = _build.library(), A._scale(d, q.dtype)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]

    def run():
        err = lib.iret_attention(1, A._PATH_CODES[path], q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[1], d,
                                 *strides, scale, 0, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"attention ({path})")
        return out
    return run


def _plain(fn, per_head, q, k, v):
    """A plain attention function of [B, N, H, D] views, on all heads at once
    or one head at a time (``per_head``: the fp32 scores of all heads would
    take more than PLAIN_SCORES_BYTES; each head's output is its own)."""
    import torch

    if not per_head:
        return fn(q, k, v)
    return torch.cat([fn(*(t[:, :, i:i + 1] for t in (q, k, v))) for i in range(q.shape[2])],
                     dim=2)


def _attention_case(kernel):
    """K1, K5, K6a or K6b on random q, k, v of one shape: (kernel, plain
    version, SDPA, operations seconds, bytes, attention_reference for the
    placement check, and for bf16 K1 at head_dim <= 160 bare calls of the sm90
    and mma.sync codes on the same inputs, ``_bare_call``). K6 takes the
    [B, N, H*D] views of the same tensors."""
    def case(key, gen):
        import torch
        import torch.nn.functional as F

        from image_restoration_and_enhancement_torch.ops import attention as A

        b, nq, nk, h, d, dtype = key
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(_dtype(dtype))
                   for n in (nq, nk, nk))
        ops_s = 4.0 * b * h * nq * nk * d / PEAK_FLOPS[dtype]
        nbytes = (2 * b * nq * h * d + 2 * b * nk * h * d) * q.element_size()
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        per_head = b * h * nq * nk * 4 > PLAIN_SCORES_BYTES
        wrong = lambda: _plain(A.attention_reference, per_head, q, k, v)  # noqa: E731
        if kernel in ("attention", "flash_attention"):
            run, plain = {"attention": (A.pallas_attention, A.pallas_attention_reference),
                          "flash_attention": (A.flash_attention,
                                              A.flash_attention_reference)}[kernel]
            bare = {p: _bare_call(q, k, v, p) for p in ("sm90", "mma")} \
                if kernel == "attention" and dtype == "torch.bfloat16" \
                and d <= A.SM90_MAX_HEAD_DIM else None

            def call():
                return run(q, k, v)
            call.qkv = (q, k, v)  # for tolerance.scores_bf16_within
            return (call, lambda: _plain(plain, per_head, q, k, v), lib, ops_s, nbytes, wrong,
                    bare)
        qp, kp, vp = (t.flatten(2) for t in (q, k, v))
        run = A.pallas_attention_packed if kernel == "packed_attention" \
            else A.pallas_attention_packed_grid
        return (lambda: run(qp, kp, vp, h), lambda: A.packed_attention_reference(qp, kp, vp, h),
                lib, ops_s, nbytes, lambda: wrong().reshape(b, nq, h * d))
    return case


def _bare_gn(x, scale, bias, groups, eps, act, p):
    """K2's function through the C entry alone on plan ``p`` (no Python
    wrapper; not counted as a launch): the wrapper's plan, and beside an
    onchip plan the twophase cut of the same call, timed in the same call."""
    import torch

    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    b, h, w, c = x.shape
    out = torch.empty_like(x)
    fn = _build.entry("iret_group_norm")
    args = (G._PATH_CODES[p.path], G._DTYPE_CODES[x.dtype], G._DTYPE_CODES[scale.dtype],
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h * w, c,
            groups, p.rows_per_block, eps, 1 if act == "silu" else 0)

    def run():
        _build.check(fn(*args, _build.raw_stream(0)), f"group_norm ({p.path})")
        return out
    return run


def _gn_case(key, gen):
    import torch
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    b, hh, ww, c, groups, eps, act, dtype = key
    x = (torch.randn((b, hh, ww, c), generator=gen, device="cuda") * 2 + 0.5).to(_dtype(dtype))
    scale = torch.randn((c,), generator=gen, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    n = b * hh * ww * c
    ops_s = (9.0 if act == "silu" else 5.0) * n / PEAK_FLOPS[dtype]
    nbytes = 2 * n * x.element_size() + 2 * c * 4

    def lib():
        y = F.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype), bias.to(x.dtype), eps)
        return F.silu(y) if act == "silu" else y

    p = G.plan(b, hh * ww, c, x.element_size(), torch.cuda.get_device_properties(0)
               .multi_processor_count)
    plans = [p] if p.path == "twophase" else [p, G.twophase_plan(b, hh * ww)]
    bare = {q.path: _bare_gn(x, scale, bias, groups, eps, act, q) for q in plans}
    return (lambda: G.group_norm(x, scale, bias, groups, eps, act),
            lambda: G.group_norm_reference(x, scale, bias, groups, eps, act), lib, ops_s, nbytes,
            None, bare)


def _gn_sharded_inputs(b, hh, ww, c, groups, dtype, gen, sp: int):
    """A shard (the first of ``sp``) of a random NHWC tensor of ``sp`` times its
    height, its affine, and the partials of all ``sp`` shards from the stats
    kernel, in shard order."""
    import torch

    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    full = (torch.randn((b, hh * sp, ww, c), generator=gen, device="cuda") * 2 + 0.5
            ).to(_dtype(dtype))
    shards = [t.contiguous() for t in full.chunk(sp, dim=1)]
    scale = torch.randn((c,), generator=gen, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    parts = torch.cat([G.group_norm_stats(t, groups) for t in shards], dim=1)
    return shards[0], scale, bias, parts


def _gn_stats_case(key, gen):
    """K2's sharded stats entry on a shard against the plain per-slab sums."""
    import torch

    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    b, hh, ww, c, groups, dtype = key
    x = (torch.randn((b, hh, ww, c), generator=gen, device="cuda") * 2 + 0.5).to(_dtype(dtype))
    rows = G.twophase_plan(b, hh * ww, torch.cuda.get_device_properties(0)
                           .multi_processor_count).rows_per_block
    n = b * hh * ww * c
    ops_s = 3.0 * n / PEAK_FLOPS[dtype]
    nbytes = n * x.element_size() + b * (-(-hh * ww // rows)) * groups * 8
    return (lambda: G.group_norm_stats(x, groups),
            lambda: G.group_norm_stats_reference(x, groups, rows),
            lambda: x.float().sum(dim=(1, 2)), ops_s, nbytes, None)


def _gn_apply_case(key, gen):
    """K2's sharded apply entry on a shard, with every shard's partials,
    against the plain split's apply on the same partials. No PyTorch call
    computes it: F.group_norm of the shard stands in as a yardstick."""
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import groupnorm as G

    b, hh, ww, c, groups, eps, act, dtype, nparts = key
    blocks = -(-hh * ww // G.twophase_plan(b, hh * ww, _sms()).rows_per_block)
    x, scale, bias, parts = _gn_sharded_inputs(b, hh, ww, c, groups, dtype, gen,
                                               nparts // blocks)
    count = float(hh * (nparts // blocks) * ww * (c // groups))
    n = b * hh * ww * c
    ops_s = (9.0 if act == "silu" else 5.0) * n / PEAK_FLOPS[dtype]
    nbytes = 2 * n * x.element_size() + 2 * c * 4 + parts.numel() * 4

    def lib():
        y = F.group_norm(x.permute(0, 3, 1, 2), groups, scale.to(x.dtype), bias.to(x.dtype), eps)
        return F.silu(y) if act == "silu" else y

    return (lambda: G.group_norm_apply(x, scale, bias, parts, count, groups, eps, act),
            lambda: G.group_norm_apply_reference(x, scale, bias, parts, count, groups, eps, act),
            lib, ops_s, nbytes, None)


def _sms() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _bare_conv(x, wq, scale, dt, path, splits):
    """K3 through the C entry alone on ``path`` with ``splits`` (no Python
    wrapper; not counted as a launch): the wrapper's path and split, and
    beside the sm90 path the mma.sync code it replaced at the served shapes
    and, where the rule splits K, the sm90 code without a split and with
    twice the rule's splits, all timed in the same call."""
    import torch

    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops import conv_int8 as K3

    b, hp, wp, c = x.shape
    n = wq.shape[3]
    out = torch.empty((b, hp - 2, wp - 2, n), dtype=dt, device="cuda")
    tiles = K3.tiles(b, hp - 2, wp - 2, n)
    ws = torch.empty(tiles * splits * K3.TILE * K3.tile_n(n), dtype=torch.int32, device="cuda")
    counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")
    w_nhwc = wq.permute(3, 0, 1, 2).contiguous()
    fn = _build.entry("iret_conv3x3_int8")
    args = (K3._PATH_CODES[path], K3._OUT_CODES[dt], x.data_ptr(), w_nhwc.data_ptr(),
            scale.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, hp - 2,
            wp - 2, c, n, splits)

    def run():
        keep = (ws, counters, w_nhwc)  # noqa: F841 (alive while the closure is)
        _build.check(fn(*args, _build.raw_stream(0)), f"conv3x3_int8 ({path}, {splits} splits)")
        return out
    return run


def _conv_int8_case(key, gen):
    """K3 on random s8 input and weight and an fp32 scale of realistic size.
    Yardstick: a bf16 F.conv2d of the same shape (exact bf16, not int8)."""
    import torch
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import conv_int8 as K3

    b, h, w, c, n, dtype = key
    dt = _dtype(dtype)
    x = torch.randint(-127, 128, (b, h + 2, w + 2, c), generator=gen, device="cuda",
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, 3, 3, c), generator=gen, device="cuda",
                       dtype=torch.int8).permute(1, 2, 3, 0)
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-5
    xb = x[:, 1:-1, 1:-1].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wb = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ops_s = 2.0 * b * h * w * n * 9 * c / PEAK_FLOPS["int8"]
    nbytes = x.numel() + wq.numel() + 4 * n + b * h * w * n * torch.empty((), dtype=dt).element_size()
    path = K3.conv_path(b, h, w, c, n)
    splits = K3.split_k(b, h, w, c, n, torch.cuda.get_device_properties(0).multi_processor_count)
    bare = {path: _bare_conv(x, wq, scale, dt, path, splits)}
    if path == "sm90":
        bare["mma"] = _bare_conv(x, wq, scale, dt, "mma", 1)
    if splits > 1:  # the rule's split against none and against twice as many
        for s in (1, 2 * splits):
            bare[f"sm90 splits={s}"] = _bare_conv(x, wq, scale, dt, "sm90", s)
    return (lambda: K3.conv3x3_same_int8(x, wq, scale, dt),
            lambda: K3.conv3x3_same_int8_reference(x, wq, scale, dt),
            lambda: F.conv2d(xb, wb, padding=1), ops_s, nbytes, None, bare)


def _bare_int8(q8, k8, v, scale, path):
    """K4 through the C entry alone on ``path`` (no Python wrapper; not counted
    as a launch): "sm90" on the tensors as they lie, "mma" (the design the
    sm90 code replaced at the served sites) on the zero-padded copies its
    code takes, made here once, outside the timed call."""
    import torch
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops import attention as A

    b, nq, h, d = q8.shape
    if path == "mma":
        dp, dv = A._int8_widths(d)
        q8, k8 = (F.pad(t, (0, dp - d)).contiguous() for t in (q8, k8))
        v = F.pad(v, (0, dv - d)).contiguous()
    out = torch.empty((b, nq, h, d), dtype=v.dtype, device="cuda")
    fn = _build.entry("iret_int8_attention")
    args = (A._PATH_CODES[path], A._DTYPE_CODES[v.dtype], q8.data_ptr(), k8.data_ptr(),
            v.data_ptr(), scale.data_ptr(), out.data_ptr(), b, h, nq, k8.shape[1], d,
            *q8.stride()[:3], *k8.stride()[:3], *v.stride()[:3])

    def run():
        keep = (q8, k8, v)  # noqa: F841 (alive while the closure is)
        _build.check(fn(*args, _build.raw_stream(0)), f"int8_attention ({path})")
        return out
    return run


def _int8_attention_case(key, gen):
    """K4 on the s8 Q, K and the scale that smooth_quantize_qk makes of random
    q, k, and v. Yardstick: bf16 F.scaled_dot_product_attention of the same
    shape (exact bf16, not int8). In bf16: the placement check's wrong version
    is ``attention.xla_int8_core`` (ops/tolerance.py), and bare calls of the
    sm90 and mma codes run on the same inputs (``_bare_int8``)."""
    import torch
    import torch.nn.functional as F

    from image_restoration_and_enhancement_torch.ops import attention as A

    b, nq, nk, h, d, dtype = key
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(_dtype(dtype))
               for n in (nq, nk, nk))
    q8, k8, s = A.smooth_quantize_qk(A._prescale(q), k)
    pv_peak = PEAK_FLOPS[dtype]
    ops_s = 2.0 * b * h * nq * nk * d * (1 / PEAK_FLOPS["int8"] + 1 / pv_peak)
    nbytes = b * h * d * (nq + nk) + (b * nk * h * d + b * nq * h * d) * v.element_size() + 4
    qb, kb, vb = (t.to(torch.bfloat16).transpose(1, 2) for t in (q, k, v))
    bf16 = dtype == "torch.bfloat16"
    wrong = (lambda: A.xla_int8_core(q8, k8, v, s)) if bf16 else None
    bare = {p: _bare_int8(q8, k8, v, s, p) for p in ("sm90", "mma")} if bf16 else None
    return (lambda: A.int8_attention_core(q8, k8, v, s),
            lambda: A.int8_attention_core_reference(q8, k8, v, s),
            lambda: F.scaled_dot_product_attention(qb, kb, vb), ops_s, nbytes, wrong, bare)


_CASES = {"attention": _attention_case("attention"), "group_norm": _gn_case,
          "group_norm_stats": _gn_stats_case, "group_norm_apply": _gn_apply_case,
          "conv3x3_int8": _conv_int8_case, "int8_attention": _int8_attention_case,
          "flash_attention": _attention_case("flash_attention"),
          "packed_attention": _attention_case("packed_attention"),
          "packed_attention_grid": _attention_case("packed_attention_grid")}


def phase_kernels(main):
    """``main``: {(kernel, shape key): launches on the main paths}."""
    import torch

    from image_restoration_and_enhancement_torch.ops import _build
    from image_restoration_and_enhancement_torch.ops import groupnorm as G
    from image_restoration_and_enhancement_torch.ops import tolerance

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    extra = [  # cases beside the main paths' own shapes
        ("attention", (1, 256, 77, 8, 40, "torch.float32")),
        ("group_norm", (2, 32, 32, 640, 32, 1e-6, None, "torch.bfloat16")),
        ("group_norm", (2, 16, 16, 1280, 32, 1e-5, None, "torch.float32")),
        ("conv3x3_int8", (1, 32, 32, 960, 320, "torch.bfloat16")),
        ("conv3x3_int8", (1, 16, 16, 1920, 640, "torch.bfloat16")),
        ("conv3x3_int8", (1, 8, 8, 2560, 1280, "torch.bfloat16")),
        ("conv3x3_int8", (1, 16, 16, 320, 320, "torch.float32")),
        ("conv3x3_int8", (1, 5, 7, 24, 20, "torch.float32")),
        ("conv3x3_int8", (2, 8, 8, 1280, 1280, "torch.bfloat16")),
        ("group_norm", (1, 3, 5, 40, 8, 1e-5, "silu", "torch.bfloat16")),
        # the sharded entries at a UNet shard of 512 px over sp 2 (the path's
        # own shapes are added when it ran over several cards)
        ("group_norm_stats", (2, 32, 64, 320, 32, "torch.bfloat16")),
        ("group_norm_apply", (2, 32, 64, 320, 32, 1e-5, "silu", "torch.bfloat16",
                              2 * -(-32 * 64 // G.twophase_plan(2, 32 * 64, _sms())
                                    .rows_per_block))),
        ("int8_attention", (1, 4096, 77, 8, 40, "torch.bfloat16")),
        ("int8_attention", (1, 256, 77, 8, 40, "torch.float32")),
        ("int8_attention", (1, 1024, 1024, 8, 80, "torch.float32")),
        ("int8_attention", (1, 64, 77, 8, 160, "torch.float32")),
        # K5's and K6's edge cases from the JAX package's tests
        ("flash_attention", (1, 256, 256, 2, 40, "torch.bfloat16")),
        ("flash_attention", (1, 200, 200, 1, 80, "torch.bfloat16")),
        ("flash_attention", (2, 128, 77, 2, 40, "torch.float32")),
        ("flash_attention", (1, 128, 128, 1, 160, "torch.float32")),
        ("packed_attention", (1, 64, 77, 4, 80, "torch.bfloat16")),
        ("packed_attention", (1, 100, 100, 2, 160, "torch.float32")),
        ("packed_attention_grid", (2, 64, 64, 8, 40, "torch.float32")),
        ("packed_attention_grid", (1, 100, 100, 2, 160, "torch.bfloat16")),
    ]
    # K6a at K6b's shapes; K5 and K6 also at the batch-1 twins of their CFG
    # shapes (the UNet's shapes of a gs 1.0 request)
    for k, key in sorted(main, key=str):
        if k not in ("flash_attention", "packed_attention_grid"):
            continue
        shapes = [key, (1,) + key[1:]] if key[0] == 2 else [key]
        for kk in (k, "packed_attention") if k == "packed_attention_grid" else (k,):
            extra += [(kk, shape) for shape in shapes]
    cases = [(k, key, main.get((k, key), 0), {}) for (k, key) in sorted(main, key=str)]
    cases += [(k, key, 0, {}) for k, key in dict.fromkeys(extra) if (k, key) not in main]
    cases += [("attention", (2, 4096, 4096, 8, 40, "torch.bfloat16"), 0, {name: "1"})
              for name in ("IRET_ATTN_SCORES_BF16", "IRET_ATTN_NORM_BOUND")]
    with _Phase("kernels"):
        for kernel, key, count, env in cases:
            case = _CASES[kernel](key, gen)
            run, plain, lib, ops_s, nbytes, wrong = case[:6]
            bare = case[6] if len(case) > 6 and not env else None
            with torch.inference_mode(), mock.patch.dict(os.environ, env):
                before = _build.launch_counts[kernel]
                before_codes = collections.Counter(_build.launch_paths)
                got, ref = run(), plain()
                torch.cuda.synchronize()
                if _build.launch_counts[kernel] != before + 1:
                    raise AssertionError(f"{kernel} {key}: the wrapper did not launch its kernel")
                code = [c for (_, c) in collections.Counter(_build.launch_paths) - before_codes]
                tol = tolerance.limits(ref, kernel)
                if env.get("IRET_ATTN_SCORES_BF16") == "1":
                    # a row whose max rounds to the other bf16 neighbour on the
                    # two sides passes only as such (ops/tolerance.py)
                    ok, err = tolerance.scores_bf16_within(got, ref, *run.qkv)
                else:
                    ok, err = tolerance.within(got, ref, kernel)
                placed = None
                if wrong is not None and got.dtype == torch.bfloat16:
                    placed = dict(zip(("ok", "right_share", "wrong_share"),
                                      tolerance.placement(got, ref, wrong())))
                iters = 5 if ops_s > 2e-5 else 20
                ms, plain_ms, lib_ms = (_time_ms(f, iters) for f in (run, plain, lib))
                if bare is not None:
                    bare_rows = {}
                    for p, f in bare.items():
                        bare_ok, bare_err = tolerance.within(f(), ref, kernel)
                        bare_rows[p] = {"ms": _time_ms(f, iters), "max_abs_err": bare_err,
                                        "within": bare_ok}
                        if kernel in ("group_norm", "conv3x3_int8", "int8_attention") \
                                and not bare_ok:
                            raise AssertionError(f"{kernel} {key} through the C entry on "
                                                 f"path {p} disagrees: {bare_err}")
            bound = max(ops_s, nbytes / PEAK_BYTES) * 1e3
            bound_by = "operations" if ops_s > nbytes / PEAK_BYTES else "bytes"
            row = {"kernel": kernel, "shape": list(key), "main_path_launches": count,
                   "max_abs_err": err, "atol_rtol": list(tol), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by}
            if code:
                row["path"] = code[0]
            if bare is not None:
                row["bare"] = bare_rows
            if placed is not None:
                row["placement"] = placed
            if env:
                row["env"] = env
            rows.append(row)
            log("kernel_case " + json.dumps(row))
            if not ok:
                raise AssertionError(f"{kernel} {key} {env} disagrees with its plain version: "
                                     f"max abs err {err}")
            if placed is not None and not placed["ok"]:
                raise AssertionError(f"{kernel} {key} {env} fails the placement check: {placed}")
            del run, plain, lib, got, ref, wrong, bare, case

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


_SOURCES = {
    "attention": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                  "image_restoration_and_enhancement_tpu/ops/attention.py:80"),
    "flash_attention": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                        "image_restoration_and_enhancement_tpu/ops/attention.py:361"),
    "packed_attention": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                         "image_restoration_and_enhancement_tpu/ops/attention.py:208"),
    "packed_attention_grid": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                              "image_restoration_and_enhancement_tpu/ops/attention.py:319"),
    "group_norm": ("image_restoration_and_enhancement_torch/csrc/groupnorm.cu",
                   "image_restoration_and_enhancement_tpu/ops/groupnorm.py:36"),
    # K2's two-phase kernels as the height-sharded entries (global statistics)
    "group_norm_stats": ("image_restoration_and_enhancement_torch/csrc/groupnorm.cu",
                         "image_restoration_and_enhancement_tpu/ops/groupnorm.py:36"),
    "group_norm_apply": ("image_restoration_and_enhancement_torch/csrc/groupnorm.cu",
                         "image_restoration_and_enhancement_tpu/ops/groupnorm.py:36"),
    "conv3x3_int8": ("image_restoration_and_enhancement_torch/csrc/conv_int8.cu",
                     "image_restoration_and_enhancement_tpu/ops/conv_int8.py:47"),
    "int8_attention": ("image_restoration_and_enhancement_torch/csrc/attention.cu",
                       "image_restoration_and_enhancement_tpu/ops/attention.py:511"),
}


# K6a is on no served path (the JAX package reaches it only through
# _packed_call(variant="packed")): its times are summed over K6b's launches.
_WEIGHTED_BY = {"packed_attention": "packed_attention_grid"}


def _kernel_line(rows, paths, codes):
    """Per kernel: its launches on the main paths, and kernel / plain / bound /
    library times summed over those launches (each shape's time x its
    launches; K6a's over K6b's, see ``_WEIGHTED_BY``), for all paths together
    and under ``by_path`` for each. ``paths``: {path: {(kernel, shape key):
    launches}}; ``codes``: {(kernel, device code): launches} over all paths,
    given as ``codes`` for the attention kernels."""
    def totals(name, counts):
        weight = _WEIGHTED_BY.get(name, name)
        mine = [(r, counts.get((weight, tuple(r["shape"])), 0)) for r in rows
                if r["kernel"] == name and "env" not in r]
        total = lambda key: sum(r[key] * n for r, n in mine)  # noqa: E731
        ops_bound = sum(r["bound_ms"] * n for r, n in mine if r["bound_by"] == "operations")
        launches = sum(n for (k, _), n in counts.items() if k == name)
        out = {"launches": launches, "ms": total("ms"),
               "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": "operations" if ops_bound > total("bound_ms") / 2 else "bytes",
               "library_ms": total("library_ms")}
        if name in ("group_norm", "conv3x3_int8", "int8_attention"):
            # the C entry alone on the wrapper's path: the difference to "ms" is
            # the wrapper's host time
            out["bare_ms"] = sum(r["bare"][r["path"]]["ms"] * n for r, n in mine if n)
        if name == "group_norm":  # device launches: twophase takes two a call
            out["device_launches"] = sum(
                n * (2 if r["path"] == "twophase" else 1) for r, n in mine)
        return out

    everything = collections.Counter()
    for counts in paths.values():
        everything.update(counts)
    out = []
    for name, (source, replaces) in _SOURCES.items():
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            **totals(name, everything),
            "by_path": {path: totals(name, counts) for path, counts in paths.items()},
        })
        if name in ATTENTION_KERNELS + ("int8_attention",):
            out[-1]["codes"] = {c: n for (k, c), n in sorted(codes.items()) if k == name}
        if name in _WEIGHTED_BY:
            out[-1]["times_weighted_by"] = f"{_WEIGHTED_BY[name]} launches"
    return {"kernels": out}


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on the card (see the docstring).")
    parser.add_argument("--only", default=None,
                        help="run these phases alone, a comma list of demo, multidevice "
                             "and multitrain (with the build and the kernels phase)")
    only = parser.parse_args().only
    if only is not None:
        only = only.split(",")
        if not only or not set(only) <= {"demo", "multidevice", "multitrain"}:
            parser.error(f"--only takes demo, multidevice and multitrain, not {only}")
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
    if only is not None:
        phases = {"demo": phase_demo, "multidevice": phase_multidevice,
                  "multitrain": phase_multitrain}
        tmp = tempfile.mkdtemp(prefix="iret_smoke_")
        try:
            results = {name: phases[name](tmp, smi) for name in only}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return _finish(results, smi, t_start)
    phase_parity()
    tmp = tempfile.mkdtemp(prefix="iret_smoke_")
    try:
        results = {"serve": phase_serve(tmp)}
        results["serve_int8"] = phase_serve_int8(tmp, results["serve"])
        results["serve_flash"] = phase_serve_variant(tmp, results["serve"], "flash")
        results["serve_packed"] = phase_serve_variant(tmp, results["serve"], "pallas_packed")
        results["serve_tasks"] = phase_serve_tasks(tmp, results["serve"])
        results["serve_modes"] = phase_serve_modes(tmp, results["serve"])
        results["evaluate"] = phase_evaluate(tmp, smi)
        results["train"] = phase_train(tmp, smi)
        results["tools"] = phase_tools(tmp, smi)
        results["demo"] = phase_demo(tmp, smi)
        results["multidevice"] = phase_multidevice(tmp, smi)
        results["multitrain"] = phase_multitrain(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["serve_sdxl"] = phase_serve_sdxl()
    return _finish(results, smi, t_start)


def _finish(results, smi: str, t_start: float) -> int:
    """The kernels phase on the paths' shapes, the kernels line, the last line."""
    import torch

    paths = {name: r["shapes"] for name, r in results.items()}
    launches = {name: r["launches"] for name, r in results.items()}
    codes = collections.Counter()
    for r in results.values():
        codes.update(r["codes"])
    main_shapes = collections.Counter()
    for counts in paths.values():
        main_shapes.update(counts)
    rows = phase_kernels(dict(main_shapes))
    line = _kernel_line(rows, paths, codes)
    for k in line["kernels"]:
        counted = sum(p[k["name"]] for p in launches.values() if k["name"] in p)
        if k["launches"] != counted:
            raise AssertionError(f"{k['name']}: {k['launches']} launches by shape, {counted} "
                                 "by count")
    log("phase_seconds " + json.dumps(PHASE_SECONDS))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
