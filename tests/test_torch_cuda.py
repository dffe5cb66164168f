"""The port's CUDA kernels against their plain PyTorch versions (needs a GPU).

Every kernel test takes the ``cuda`` fixture, which skips where no CUDA device
exists (so on a CPU-only machine each skips with that reason). On the H100:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances are ``ops/tolerance.py``'s: fp32 1e-4 absolute and relative (the
same sums in another order); bf16 one bf16 step of each value plus a share of
the largest, |got - ref| <= share * max|ref| + 2**-7 * |ref|, with share 2**-8
for the attention kernels (K1, K5, K6a, K6b) and 2**-10 for GroupNorm. In bf16
the attention kernels must also pass ``tolerance.placement``: more of their
output equal bitwise to their own plain version (the Pallas kernel's
roundings) than to ``attention_reference`` (xla_attention's roundings).
``test_placement_check_detects_f1`` shows that this check fails the roundings
K1 had before they were moved (its CPU case runs anywhere).
``test_bf16_limit_rejects_planted_faults`` shows that the bf16 limit catches a
K1 or K5 that drops a KV tile or skips the online-softmax rescale at the
N = 4096 shapes; its CPU case runs anywhere, with fewer query rows. Both run
their CPU cases at the KV tile of each device code (``_kv_tile``: the mma
path's 64 keys, the sm90 paths' 128, 64 or 32).
``test_kernel_path`` holds ``kernel_path`` (which device code serves an
attention call) to its rule on the CPU; on the card every attention test
checks that its launch went through the path ``kernel_path`` names.

K2 (GroupNorm) runs on the path ``groupnorm.plan`` names ("onchip": one
launch, or "twophase"); ``test_group_norm_plan`` holds the plan to its rule at
every SD-1.5 GroupNorm shape and ``test_group_norm_partition_within_limit``
holds a plain emulation of the kernel's partition of the sums to the limit,
both on the CPU. K3 (int8 conv) runs on the path ``conv_int8.conv_path`` names
("sm90" with ``split_k``'s K split, or "mma"; ``test_conv_path_served`` holds
the rule at every UNet 3x3 shape) and must equal its plain version bitwise
(the integer sums are exact), on every path and split;
``test_conv_split_k_emulation_is_exact`` shows on the CPU that the split's sum
is exact and that the limit rejects a dropped split.
K3 is held to one rounding of the output dtype and K4 (int8 attention) to
attention's bf16 limit (share 2**-8);
``test_int8_limits_reject_planted_faults`` shows that they catch a dropped
conv tap, and a dropped KV tile or a missing rescale, with a CPU case as above
(at the mma code's 64-key tiles, and
``test_int8_limit_rejects_planted_faults_at_sm90_tiles`` at the sm90 code's).
K4 runs on the path ``attention.int8_kernel_path`` names ("sm90": s8 wgmma +
TMA on the tensors as they lie; "mma": zero-padded copies;
``test_int8_kernel_path_served`` holds the rule at every UNet site on the
CPU); its card tests assert the path, run both codes through the C entry and
its refusals, count one device launch per served call through the profiler,
and hold bf16 K4 to a placement check against ``attention.xla_int8_core``
(``test_int8_placement_check``, CPU case included).
``test_int8_layers_match_cpu`` holds the int8 layers that K3 does not serve
(``torch._int_mm`` and the quantizers on the card) against the CPU to one
rounding of the output dtype, and shows that the limit fails full precision.

Height-sharded serving (``parallel/spatial.py``) gives K2 two entries and K1
query-sharded shapes: ``test_group_norm_sharded_entries_match_plain_split``
simulates sp by slicing one tensor on one card (each shard's stats launch, the
partials concatenated in shard order, each shard's apply with the global
count) at the UNet's and VAE's 512 px and 2048 px shard shapes, against the
plain split and the unsharded plain version; ``test_attention_at_query_sharded_shapes``
holds K1 on a shard's queries against every shard's keys (Nq = N / sp).

A 1024 px request (super-resolution's SD run) gives K1 and K2 shapes the 512 px
serves do not: ``test_kernels_at_1024px_shapes`` holds them against their plain
versions (plain attention one head at a time: the fp32 scores of all heads at
N = 16384 take 8 GiB), and ``test_kernel_path_served`` and
``test_group_norm_plan_at_1024px`` hold the path and plan rules there on the
CPU. ``test_tasks_match_cpu`` serves TINY super_resolve, colorize and inpaint
(fp32, the same noise on both devices) on the card and on the CPU: the uint8
outputs agree within one level (chip_smoke's 2e-3 image limit is a quarter of
one), and
``test_rrdbnet_matches_cpu`` holds RRDBNet to 1e-4 of its largest output;
both turn cuDNN's TF32 off, so the card's convs are fp32 like the CPU's.
"""
import collections
import contextlib
import math

import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch.ops import _build
from image_restoration_and_enhancement_torch.ops import attention as A
from image_restoration_and_enhancement_torch.ops import conv_int8 as K3
from image_restoration_and_enhancement_torch.ops import groupnorm as G
from image_restoration_and_enhancement_torch.ops import tolerance


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Without a card, torch on one thread for the whole module: under the
    Tier-1 command's parallel workers the CPU emulations' thread-pool
    barriers stall on the shared cores. With a card, the CPU references keep
    torch's default."""
    if torch.cuda.is_available():
        yield
        return
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def assert_within(got, ref, kernel):
    atol, rtol = tolerance.limits(ref, kernel)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def assert_attention_kernel(got, kernel, right_ref, q, k, v):
    """The kernel's output within its limit of its plain version and, in bf16,
    placed: nearer bitwise to it than to ``attention_reference``. Where the two
    plain versions are bitwise equal (Nk = 1: P is 1), no placement can be told
    apart, and the kernel must equal them bitwise instead."""
    assert_within(got, right_ref, kernel)
    if got.dtype == torch.bfloat16:
        wrong = A.attention_reference(q, k, v).reshape(got.shape)
        if torch.equal(right_ref, wrong):
            assert torch.equal(got, right_ref)
            return
        ok, right_share, wrong_share = tolerance.placement(got, right_ref, wrong)
        assert ok, (right_share, wrong_share)


def assert_launched(kernel, before, path):
    """Exactly one launch since ``before`` (a copy of ``launch_paths``), of
    ``kernel`` through ``path``."""
    launched = collections.Counter(_build.launch_paths) - before
    assert launched == {(kernel, path): 1}, launched


ATTN_SHAPES = [
    (2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160),
    (2, 64, 77, 8, 160), (1, 4096, 4096, 1, 512), (1, 100, 37, 3, 24),
    (1, 77, 50, 2, 20),   # head_dim not a multiple of 8: rows TMA cannot address
    # TMA's edges: Nq not a multiple of the 128-row tile, Nk = 77 and Nk = 1,
    # d = 512 with a ragged Nq
    (2, 200, 77, 8, 40), (1, 64, 1, 2, 40), (1, 300, 300, 1, 512),
]


@pytest.mark.parametrize("b,nq,nk,h,d", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain(cuda, b, nq, nk, h, d, dtype):
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(dtype)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v)
    assert_launched("attention", before, A.kernel_path(q, k, v))
    assert_attention_kernel(got, "attention", A.pallas_attention_reference(q, k, v), q, k, v)
    # "xla" is the plain xla_attention function on every device
    assert torch.equal(A.attention(q, k, v, backend="xla"), A.attention_reference(q, k, v))
    assert_launched("attention", before, A.kernel_path(q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_takes_strided_views(cuda, dtype):
    qkv = torch.randn((2, 300, 3, 4, 40), generator=cuda, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    before = collections.Counter(_build.launch_paths)
    assert_within(A.attention(q, k, v), A.pallas_attention_reference(q, k, v), "attention")
    assert_launched("attention", before, "sm90" if dtype == torch.bfloat16 else "simt")


def test_attention_unaligned_rows_take_mma(cuda):
    """A bf16 view whose rows start 2 bytes past a 16-byte boundary: TMA cannot
    address it, so kernel_path names the mma.sync code, and the launch says so."""
    base = torch.randn((2, 300, 4, 48), generator=cuda, device="cuda").to(torch.bfloat16)
    q, k, v = (base[:, :, :, i:i + 40] for i in (1, 2, 3))
    assert A.kernel_path(q, k, v) == "mma"
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v)
    assert_launched("attention", before, "mma")
    assert_attention_kernel(got, "attention", A.pallas_attention_reference(q, k, v), q, k, v)


VARIANT_SHAPES = [  # the UNet's shapes at CFG batch 2, then the JAX tests' edge cases
    (2, 4096, 4096, 8, 40), (2, 4096, 77, 8, 40), (2, 1024, 1024, 8, 80),
    (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160), (2, 64, 77, 8, 160),
    (1, 256, 256, 2, 40), (1, 200, 200, 1, 80), (1, 100, 100, 2, 160), (1, 77, 50, 2, 20),
    (1, 200, 77, 2, 40), (1, 64, 1, 2, 40),  # TMA's edges, D = 40 in both layouts
]


def _variant(kernel, q, k, v):
    """(kernel's output, its plain version's) on [B, N, H, D] inputs."""
    if kernel == "flash_attention":
        return A.attention(q, k, v, backend="flash"), A.flash_attention_reference(q, k, v)
    b, nq, h, d = q.shape
    ref = A.packed_attention_reference(*(t.flatten(2) for t in (q, k, v)), h).view(b, nq, h, d)
    if kernel == "packed_attention_grid":
        return A.attention(q, k, v, backend="pallas_packed"), ref
    return A.packed_call(q, k, v, variant="packed"), ref


@pytest.mark.parametrize("b,nq,nk,h,d", VARIANT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["flash_attention", "packed_attention",
                                    "packed_attention_grid"])
def test_attention_variant_kernels_match_plain(cuda, kernel, b, nq, nk, h, d, dtype):
    """K5, K6a and K6b: one launch each, within the limit of their plain
    versions and, in bf16, placed."""
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(dtype)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_counts)
    before_paths = collections.Counter(_build.launch_paths)
    got, ref = _variant(kernel, q, k, v)
    launched = collections.Counter(_build.launch_counts) - before
    assert launched == {kernel: 1}, launched
    flags = A._ROWSUM_F32 if kernel == "flash_attention" else 0
    assert_launched(kernel, before_paths, A.kernel_path(q, k, v, flags))
    assert got.shape == q.shape and got.dtype == dtype
    assert_attention_kernel(got, kernel, ref, q, k, v)


@pytest.mark.parametrize("env", ["IRET_ATTN_SCORES_BF16", "IRET_ATTN_NORM_BOUND"])
@pytest.mark.parametrize("b,nq,nk,h,d", [(2, 1024, 1024, 8, 80), (2, 1024, 77, 8, 80),
                                         (1, 256, 256, 1, 512), (1, 100, 37, 3, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_branches_match_plain(cuda, monkeypatch, env, b, nq, nk, h, d, dtype):
    """K1's opt-in branches, read at call time by the wrapper and the plain
    version. Both fix the softmax shift for the whole KV walk (the exact row
    max from a first pass, or the norm bound), so the kernel rounds where its
    plain version does."""
    monkeypatch.setenv(env, "1")
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(dtype)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_paths)
    assert_within(A.attention(q, k, v, backend="pallas"), A.pallas_attention_reference(q, k, v),
                  "attention_scores_bf16" if env == "IRET_ATTN_SCORES_BF16" else "attention")
    path = "simt" if dtype == torch.float32 or d > A.SM90_MAX_HEAD_DIM else "mma"
    assert_launched("attention", before, path)
    if env == "IRET_ATTN_NORM_BOUND":  # the underflow cliff: finite, no 0/0
        assert torch.isfinite(A.attention(q * 12, k * 12, v, backend="pallas")).all()


@pytest.mark.parametrize("shape,groups,eps,act", [
    ((2, 64, 64, 320), 32, 1e-5, "silu"), ((2, 8, 8, 2560), 32, 1e-5, "silu"),
    ((2, 32, 32, 640), 32, 1e-6, None), ((1, 256, 256, 256), 32, 1e-6, "silu"),
    ((1, 3, 5, 40), 8, 1e-5, None),
    # 16-byte vectors that straddle groups (gc = 30, 60), the VAE's twophase shapes
    ((2, 32, 32, 960), 32, 1e-5, "silu"), ((2, 16, 16, 1920), 32, 1e-5, None),
    ((1, 512, 512, 128), 32, 1e-6, "silu"), ((1, 256, 256, 512), 32, 1e-6, None),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_matches_plain(cuda, shape, groups, eps, act, dtype):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    scale = torch.randn((c,), generator=cuda, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=cuda, device="cuda") * 0.1
    before = collections.Counter(_build.launch_paths)
    got = G.group_norm(x, scale, bias, groups, eps, act)
    b, h, w, _ = shape
    want = G.plan(b, h * w, c, x.element_size(), torch.cuda.get_device_properties(0)
                  .multi_processor_count).path
    assert_launched("group_norm", before, want)
    assert_within(got, G.group_norm_reference(x, scale, bias, groups, eps, act), "group_norm")


def _gn_entry(x, scale, bias, groups, eps, act, p):
    """K2 through the C entry on plan ``p`` (the wrapper chooses the plan from
    the shape); not counted as a launch."""
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    err = _build.entry("iret_group_norm")(
        G._PATH_CODES[p.path], G._DTYPE_CODES[x.dtype], G._DTYPE_CODES[scale.dtype],
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h * w, c, groups,
        p.rows_per_block, eps, 1 if act == "silu" else 0, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"group_norm ({p.path})")
    return out


@pytest.mark.parametrize("shape,act,dtype", [((2, 64, 64, 960), "silu", torch.bfloat16),
                                             ((2, 8, 8, 2560), None, torch.float32)])
def test_group_norm_paths_agree(cuda, shape, act, dtype):
    """Both of K2's paths at a UNet shape, onchip (the plan's) and twophase
    (cut as the plan cuts it), lie within the limit of the plain version; the
    C entry refuses an onchip slab larger than shared memory (KernelError, no
    other path taken)."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    scale = torch.randn((c,), generator=cuda, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=cuda, device="cuda") * 0.1
    ref = G.group_norm_reference(x, scale, bias, 32, 1e-5, act)
    b, h, w, _ = shape
    onchip = G.plan(b, h * w, c, x.element_size())
    assert onchip.path == "onchip"
    for p in (onchip, G.twophase_plan(b, h * w)):
        assert_within(_gn_entry(x, scale, bias, 32, 1e-5, act, p), ref, "group_norm")
    big = G.Plan("onchip", G.ONCHIP_SLAB_BYTES // (c * x.element_size()) + 1, 1)
    with pytest.raises(_build.KernelError):
        _gn_entry(x, scale, bias, 32, 1e-5, act, big)


def test_group_norm_kernel_large_mean_is_finite(cuda):
    x = 5000.0 + 0.1 * torch.randn((2, 8, 8, 16), generator=cuda, device="cuda")
    y = G.group_norm(x, torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"), 4)
    assert torch.isfinite(y).all()


# GroupNorm shapes of SD-1.5 at 512 px per sample, (H, W, C): the UNet's
# (every resnet norm, transformer norm and conv_norm_out at latents 64 .. 8)
# and the VAE's (encoder and decoder at 512 .. 64).
UNET_GN = [(64, 64, 320), (64, 64, 640), (64, 64, 960), (32, 32, 320), (32, 32, 640),
           (32, 32, 960), (32, 32, 1280), (32, 32, 1920), (16, 16, 640), (16, 16, 1280),
           (16, 16, 1920), (16, 16, 2560), (8, 8, 1280), (8, 8, 2560)]
VAE_GN = [(512, 512, 128), (512, 512, 256), (256, 256, 128), (256, 256, 256),
          (256, 256, 512), (128, 128, 256), (128, 128, 512), (64, 64, 512)]
# The VAE shapes whose slabs exceed shared memory at a batch (H, W, C) -> twophase.
VAE_TWOPHASE = {1: {(512, 512, 128), (512, 512, 256), (256, 256, 256), (256, 256, 512)},
                2: {(512, 512, 128), (512, 512, 256), (256, 256, 128), (256, 256, 256),
                    (256, 256, 512), (128, 128, 512)}}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("model,h,w,c", [("unet",) + s for s in UNET_GN]
                         + [("vae",) + s for s in VAE_GN])
def test_group_norm_plan(model, b, h, w, c):
    """K2's plan at every SD-1.5 GroupNorm shape: one onchip launch at every
    UNet shape (one block per SM at most, every slab within shared memory), two
    launches (twophase) only at the VAE's largest; the slabs cover every row
    once and the partials fit the kernel's buffer."""
    p = G.plan(b, h * w, c, 2)
    want = "twophase" if model == "vae" and (h, w, c) in VAE_TWOPHASE[b] else "onchip"
    assert p.path == want
    assert p.rows_per_block * (p.blocks_per_sample - 1) < h * w <= \
        p.rows_per_block * p.blocks_per_sample
    assert b * p.blocks_per_sample * 32 <= 1 << 16
    if p.path == "onchip":
        assert b * p.blocks_per_sample <= G.H100_SMS
        assert p.rows_per_block * c * 2 <= G.ONCHIP_SLAB_BYTES
    else:
        assert b * p.blocks_per_sample <= G.TWOPHASE_BLOCKS_PER_SM * G.H100_SMS


# K2's shapes of a 1024 px request: the UNet's at latents 128 .. 16 and the
# VAE's at 1024 .. 128; twophase where one block per SM would need a slab
# larger than shared memory.
GN_1024 = [("unet", 2 * h, 2 * w, c) for h, w, c in UNET_GN] + \
    [("vae", 2 * h, 2 * w, c) for h, w, c in VAE_GN]
TWOPHASE_1024 = {("unet", 128, 128, 960), ("vae", 1024, 1024, 128), ("vae", 1024, 1024, 256),
                 ("vae", 512, 512, 128), ("vae", 512, 512, 256), ("vae", 512, 512, 512),
                 ("vae", 256, 256, 256), ("vae", 256, 256, 512)}


@pytest.mark.parametrize("model,h,w,c", GN_1024)
def test_group_norm_plan_at_1024px(model, h, w, c):
    """K2's plan at every GroupNorm shape of a 1024 px request (batch 1): onchip
    (one block per SM at most, every slab within shared memory) except at the
    shapes whose slabs would not fit; the slabs cover every row once and the
    partials fit the kernel's buffer."""
    p = G.plan(1, h * w, c, 2)
    assert p.path == ("twophase" if (model, h, w, c) in TWOPHASE_1024 else "onchip")
    assert p.rows_per_block * (p.blocks_per_sample - 1) < h * w <= \
        p.rows_per_block * p.blocks_per_sample
    assert p.blocks_per_sample * 32 <= 1 << 16
    if p.path == "onchip":
        assert p.blocks_per_sample <= G.H100_SMS
        assert p.rows_per_block * c * 2 <= G.ONCHIP_SLAB_BYTES
    else:
        assert -(-h * w // G.H100_SMS) * c * 2 > G.ONCHIP_SLAB_BYTES


def _butterfly(vals):
    """Lane 0's value after a shuffle-xor butterfly over ``len(vals)`` lanes."""
    off = len(vals) // 2
    while off:
        vals = [vals[i] + vals[i ^ off] for i in range(len(vals))]
        off //= 2
    return vals[0]


def _gn_partitioned(x, scale, bias, groups, eps, act, p, threads=512):
    """K2's arithmetic in plain PyTorch over ``p``'s partition: per slab,
    per-channel fp32 sums over each row slice of the slab (rows rs, rs + rsplit,
    ... for a thread's 16-byte vector of channels), added over the slices in
    order; per group, lane l of a warp adds the group's channels l, l + 32, ...
    and a butterfly combines the 32 lanes; the slabs' pairs reduced as the
    kernel's lanes do (lane l sums slabs l, l + L, ..., then a butterfly);
    mean, variance, 1 / sqrt and the folded affine, rounded as the kernel
    rounds them."""
    b, h, w, c = x.shape
    gc = c // groups
    nvec = c // (16 // x.element_size())
    rsplit = max(1, threads // nvec)
    xf = x.float().reshape(b, h * w, c)
    pairs = []
    for k in range(p.blocks_per_sample):
        slab = xf[:, k * p.rows_per_block:(k + 1) * p.rows_per_block]
        s = ss = 0
        for rs in range(rsplit):
            rows = slab[:, rs::rsplit]
            s, ss = s + rows.sum(1), ss + rows.square().sum(1)
        lanes = [sum(t[:, j::gc][:, :groups] for j in range(l, gc, 32)) + 0 * s[:, :groups]
                 for t in (s, ss) for l in range(32)]
        pairs.append(torch.stack([_butterfly(lanes[:32]), _butterfly(lanes[32:])], -1))
    lanes = 1
    while lanes < 32 and 2 * lanes * groups <= threads:
        lanes *= 2
    acc = _butterfly([sum(pairs[i] for i in range(l, len(pairs), lanes)) + 0 * pairs[0]
                      for l in range(lanes)])
    count = float(h * w * gc)
    mean = acc[..., 0] / count
    var = torch.clamp(acc[..., 1] / count - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    wc = rstd.repeat_interleave(gc, -1) * scale.float()
    bc = bias.float() - mean.repeat_interleave(gc, -1) * wc
    y = x.float() * wc[:, None, None] + bc[:, None, None]
    if act == "silu":
        y = y / (1 + torch.exp(-y))
    return y.to(x.dtype)


@pytest.mark.parametrize("shape,act", [((2, 64, 64, 320), "silu"), ((2, 32, 32, 960), None),
                                       ((2, 16, 16, 1920), "silu")])
def test_group_norm_partition_within_limit(shape, act):
    """On the CPU: the kernel's partition of the sums (gc = 10, 30, 60, whose
    16-byte vectors straddle groups) lies within the "group_norm" limit of
    ``group_norm_reference`` on bf16 inputs, on the onchip plan and on the
    twophase cut of the same shape."""
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(torch.bfloat16)
    c = shape[-1]
    scale = torch.randn((c,), generator=gen) * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen) * 0.1
    ref = G.group_norm_reference(x, scale, bias, 32, 1e-5, act)
    b, h, w, _ = shape
    onchip = G.plan(b, h * w, c, 2)
    assert onchip.path == "onchip"
    for p in (onchip, G.twophase_plan(b, h * w)):
        assert_within(_gn_partitioned(x, scale, bias, 32, 1e-5, act, p), ref, "group_norm")


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 1, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        A.attention(q, q, q)
    x = torch.zeros((1, 4, 4, 8), device="cuda").permute(0, 2, 1, 3)
    with pytest.raises(ValueError):
        G.group_norm(x, torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"), 2)


def _online_attention(q, k, v, tile=64, drop_tile=None, rescale=True, rowsum_f32=False,
                      placement="pallas"):
    """K1's algorithm in plain PyTorch: KV tiles of ``tile`` keys, fp32 running
    max, sum and accumulator, P rounded to v's dtype for P.V, one divide at the
    end. ``placement="pallas"``: Q times 1/sqrt(D) rounded to q's dtype before
    the dot and the row sum over the rounded P (K1), or over the fp32 P with
    ``rowsum_f32`` (K5); ``placement="f1"``: the roundings K1 had before they
    were moved (fp32 scores scaled after the dot, the row sum over the fp32 P).
    ``drop_tile`` (skip that tile) and ``rescale=False`` (never scale the
    accumulator by exp(m_old - m_new)) plant the two faults."""
    if placement == "pallas":
        qf = A._prescale(q).float().transpose(1, 2)
    else:
        qf = q.float().transpose(1, 2) / math.sqrt(q.shape[-1])
        rowsum_f32 = True
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    m = torch.full(qf.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for i, k0 in enumerate(range(0, k.shape[1], tile)):
        if i == drop_tile:
            continue
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        pr = p.to(v.dtype).float()
        l = l * alpha + (p if rowsum_f32 else pr).sum(-1, keepdim=True)
        acc = (acc * alpha if rescale else acc) + pr @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l).to(q.dtype).transpose(1, 2)


def _kv_tile(design, d):
    """Keys per KV tile of a bf16 device code of csrc/attention.cu at head_dim
    ``d``: the mma.sync path's 64, or the sm90 paths' (Sm90's BK: 128 up to
    d 80, 64 at 160, 32 above)."""
    if design == "mma":
        return 64
    return 128 if d <= 80 else 64 if d <= A.SM90_MAX_HEAD_DIM else 32


def _max_near_midpoint():
    """One query row (head_dim 16, so Q's prescale by 1/4 is exact) whose row
    max has the exact score 5.921875 - 2**-20, 2**-15 of a bf16 step below the
    rounding midpoint between 5.90625 and 5.9375 (fp32 sums keep it there and
    round down), and 15 keys 2 below it that together weigh about as much."""
    q = torch.zeros((1, 1, 1, 16))
    q[0, 0, 0, :3] = torch.tensor([16.0, 0.5, 2.0**-8])  # x 1/4: 4, 1/8, 2**-10
    k = torch.zeros((1, 16, 1, 16))
    k[0, 0, 0, :3] = torch.tensor([1.4765625, 0.125, -2.0**-10])
    k[0, 1:, 0, 0] = 0.96875 + 0.0078125 * torch.arange(15) / 15  # scores ~3.9
    v = torch.randn((1, 16, 1, 16), generator=torch.Generator().manual_seed(21)) * 2
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def test_scores_bf16_row_max_flip_explained(monkeypatch):
    """``tolerance.scores_bf16_within`` passes a row that differs from the
    plain version beyond the limit only by its row max rounded to the other
    bf16 neighbour, and fails a dropped key or a flip with no midpoint nearby
    (CPU; what K1's IRET_ATTN_SCORES_BF16 case on the card needs)."""
    monkeypatch.setenv("IRET_ATTN_SCORES_BF16", "1")
    q, k, v = _max_near_midpoint()
    ref = A.pallas_attention_reference(q, k, v)
    sb = (k[0, :, 0].float() @ A._prescale(q)[0, 0, 0].float()).to(torch.bfloat16)
    assert float(sb[0]) == 5.90625 and float(sb.max()) == 5.90625
    torch.testing.assert_close(tolerance._scores_bf16_row(sb, v[0, :, 0], q.dtype),
                               ref[0, 0, 0], rtol=0, atol=0)
    flipped = sb.clone()
    flipped[0] = 5.9375
    got = tolerance._scores_bf16_row(flipped, v[0, :, 0], q.dtype).view(ref.shape)
    assert not tolerance.within(got, ref, "attention_scores_bf16")[0]
    assert tolerance.scores_bf16_within(got, ref, q, k, v)[0]
    dropped = A.pallas_attention_reference(q, k[:, :-1], v[:, :-1])  # one key missing
    assert not tolerance.scores_bf16_within(dropped, ref, q, k, v)[0]
    k_far = k.clone()
    k_far[0, 0, 0, 1:3] = 0  # the row max 5.90625 exactly: half a step from either midpoint
    ref_far = A.pallas_attention_reference(q, k_far, v)
    sb_far = (k_far[0, :, 0].float() @ A._prescale(q)[0, 0, 0].float()).to(torch.bfloat16)
    sb_far[0] = 5.9375
    got_far = tolerance._scores_bf16_row(sb_far, v[0, :, 0], q.dtype).view(ref.shape)
    assert not tolerance.within(got_far, ref_far, "attention_scores_bf16")[0]
    assert not tolerance.scores_bf16_within(got_far, ref_far, q, k_far, v)[0]


@pytest.mark.parametrize("b,nk,h,d", [(2, 4096, 8, 40), (1, 4096, 1, 512)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("design", ["mma", "sm90"])
def test_bf16_limit_rejects_planted_faults(design, device, b, nk, h, d):
    """At the main path's two N = 4096 sites, the bf16 limit passes K1 and K5
    and faithful emulations of them at the device code's KV tile, and fails a
    dropped KV tile and a missing rescale in either. The CPU case keeps
    Nk = 4096 and takes 256 query rows: each row sees the same statistics."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    nq = nk if device == "cuda" else 256
    tile = _kv_tile(design, d)
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=device).to(torch.bfloat16)
               for n in (nq, nk, nk))
    for kernel, plain, backend, rowsum_f32 in (
            ("attention", A.pallas_attention_reference, "pallas", False),
            ("flash_attention", A.flash_attention_reference, "flash", True)):
        ref = plain(q, k, v)
        honest = [_online_attention(q, k, v, tile=tile, rowsum_f32=rowsum_f32)]
        if device == "cuda":
            honest.append(A.attention(q, k, v, backend=backend))
        for got in honest:
            assert_within(got, ref, kernel)
        for fault in ({"drop_tile": 17}, {"rescale": False}):
            ok, err = tolerance.within(_online_attention(q, k, v, tile=tile,
                                                         rowsum_f32=rowsum_f32, **fault),
                                       ref, kernel)
            assert not ok, f"the {kernel} limit passed a planted fault {fault} (max err {err})"


@pytest.mark.parametrize("b,nk,h,d", [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 77, 8, 160)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("design", ["mma", "sm90"])
def test_placement_check_detects_f1(design, device, b, nk, h, d):
    """``tolerance.placement`` passes K1's tiled algorithm with the Pallas
    kernel's roundings at the device code's KV tile (and, on the card, K1
    itself) and fails the same algorithm with the roundings K1 had before they
    were moved: the bf16 limit alone passes both. The CPU case takes 128 query
    rows."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    nq = nk if device == "cuda" else 128
    tile = _kv_tile(design, d)
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=device).to(torch.bfloat16)
               for n in (nq, nk, nk))
    right, wrong = A.pallas_attention_reference(q, k, v), A.attention_reference(q, k, v)
    honest = [_online_attention(q, k, v, tile=tile)]
    if device == "cuda":
        honest.append(A.attention(q, k, v))
    for got in honest:
        assert_within(got, right, "attention")
        ok, r, w = tolerance.placement(got, right, wrong)
        assert ok, (r, w)
    moved = _online_attention(q, k, v, tile=tile, placement="f1")
    assert_within(moved, right, "attention")
    ok, r, w = tolerance.placement(moved, right, wrong)
    assert not ok, f"the placement check passed the old roundings ({r} vs {w})"


_SERVED = [(2, 4096, 4096, 8, 40), (2, 4096, 77, 8, 40), (2, 1024, 1024, 8, 80),
           (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160), (2, 256, 77, 8, 160),
           (2, 64, 64, 8, 160), (2, 64, 77, 8, 160)]


def _qkv(b, nq, nk, h, d, dtype=torch.bfloat16):
    return tuple(torch.empty((b, n, h, d), dtype=dtype) for n in (nq, nk, nk))


# the UNet's and the VAE mid-block's shapes of a 1024 px request (batch 1, no CFG)
_SERVED_1024 = [(1, 16384, 16384, 8, 40), (1, 16384, 77, 8, 40), (1, 4096, 4096, 8, 80),
                (1, 4096, 77, 8, 80), (1, 1024, 1024, 8, 160), (1, 1024, 77, 8, 160),
                (1, 256, 256, 8, 160), (1, 256, 77, 8, 160), (1, 16384, 16384, 1, 512)]


# SDXL's UNet sites at 1024 px (head_dim 64; the CFG pair and the batch-1
# calls of gs 1.0 and the CFG cache), ToMe's merged level-0 self-attention at
# 512 px (N = 4096 -> 2048) and the dedup's half-batch one
_SDXL = [(b, nq, nk, h, 64) for b in (2, 1) for nq, h in ((4096, 10), (1024, 20))
         for nk in (nq, 77)]
_SERVED_MODES = _SDXL + [(2, 2048, 2048, 8, 40), (1, 2048, 2048, 8, 40),
                         (1, 4096, 4096, 8, 40), (1, 4096, 77, 8, 40)]


@pytest.mark.parametrize("b,nq,nk,h,d",
                         _SERVED + [(1, 4096, 4096, 1, 512)] + _SERVED_1024 + _SERVED_MODES)
@pytest.mark.parametrize("layout", ["bnhd", "packed", "projection_views"])
def test_kernel_path_served(layout, b, nq, nk, h, d):
    """Every served shape takes an sm90 path, in K1's and K5's [B, N, H, D]
    layout, as K6's [B, N, H*D] views split into heads (head stride D, row
    stride H*D), and as views of one fused [B, N, 3, H, D] projection."""
    if layout == "bnhd":
        q, k, v = _qkv(b, nq, nk, h, d)
    elif layout == "packed":
        q, k, v = (t.flatten(2).unflatten(-1, (h, d)) for t in _qkv(b, nq, nk, h, d))
        assert q.stride() == (nq * h * d, h * d, d, 1)
    else:
        q = torch.empty((b, nq, 3, h, d), dtype=torch.bfloat16)[:, :, 0]
        k, v = torch.empty((b, nk, 3, h, d), dtype=torch.bfloat16).unbind(2)[1:]
    want = "sm90" if d <= A.SM90_MAX_HEAD_DIM else "sm90_split"
    assert A.kernel_path(q, k, v) == want
    assert A.kernel_path(q, k, v, A._ROWSUM_F32) == want  # K5's flag


@pytest.mark.parametrize("d", [40, 80, 160, 512])
@pytest.mark.parametrize("case", ["fp32", "scores_bf16", "norm_bound", "both_branches",
                                  "unaligned_base", "head_dim_20", "zero_stride"])
def test_kernel_path_other_cases(case, d):
    """What leaves the sm90 paths: fp32 (simt), K1's opt-in branches, a base
    that is not 16-byte aligned, strides that are not a 16-byte multiple or are
    zero: mma at head_dim <= 160, simt above."""
    off = "mma" if d <= A.SM90_MAX_HEAD_DIM else "simt"
    flags = 0
    q, k, v = _qkv(1, 100, 77, 2, d)
    if case == "fp32":
        q, k, v = _qkv(1, 100, 77, 2, d, torch.float32)
        off = "simt"
    elif case == "scores_bf16":
        flags = A._SCORES_BF16 | A._ROWSUM_F32
    elif case == "norm_bound":
        flags = A._NORM_BOUND
    elif case == "both_branches":
        flags = A._SCORES_BF16 | A._NORM_BOUND
    elif case == "unaligned_base":
        q = torch.empty((1, 100, 2, d + 8), dtype=torch.bfloat16)[..., 1:d + 1]
        assert q.data_ptr() % 16 == 2
    elif case == "head_dim_20":  # rows of 40 bytes: strides not a 16-byte multiple
        q, k, v = _qkv(1, 77, 50, 2, 20)
        off = "mma"
    else:
        k = torch.empty((1, 1, 2, d), dtype=torch.bfloat16).expand(1, 77, 2, d)
    assert A.kernel_path(q, k, v, flags) == off


def test_kernel_path_rejects_other_dtypes():
    with pytest.raises(TypeError):
        A.kernel_path(*_qkv(1, 8, 8, 1, 16, torch.float16))


# ---------------------------------------------------------------------------
# K3 (int8 3x3 conv) and K4 (int8 Q.K^T attention)
# ---------------------------------------------------------------------------


def _conv_inputs(b, h, w, c, n, device, gen):
    x = torch.randint(-127, 128, (b, h + 2, w + 2, c), generator=gen, device=device,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, 3, 3, c), generator=gen, device=device,
                       dtype=torch.int8).permute(1, 2, 3, 0)
    scale = torch.rand((n,), generator=gen, device=device) * 1e-5
    return x, wq, scale


@pytest.mark.parametrize("b,h,w,c,n", [
    (2, 64, 64, 320, 320), (2, 8, 8, 2560, 1280), (2, 16, 16, 1920, 640),
    (2, 32, 32, 960, 320), (1, 256, 256, 256, 256), (1, 5, 7, 24, 20), (1, 1, 1, 16, 8),
    # split-K at the 8x8 level (F4), its batch-1 twin, and the 4x4 level of a
    # 256-px image (eight images a tile, seven of them past the batch)
    (2, 8, 8, 1280, 1280), (1, 8, 8, 1280, 1280), (1, 4, 4, 640, 640),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_int8_kernel_matches_plain(cuda, b, h, w, c, n, dtype):
    x, wq, scale = _conv_inputs(b, h, w, c, n, "cuda", cuda)
    before = collections.Counter(_build.launch_paths)
    got = K3.conv3x3_same_int8(x, wq, scale, dtype)
    assert_launched("conv3x3_int8", before, K3.conv_path(b, h, w, c, n))
    assert torch.equal(got, K3.conv3x3_same_int8_reference(x, wq, scale, dtype))


def _conv_entry(x, wq, scale, dtype, path, splits):
    """K3 through the C entry on a chosen path and K split (the wrapper
    chooses both from the shape); not counted as a launch."""
    b, hp, wp, c = x.shape
    n = wq.shape[3]
    out = torch.empty((b, hp - 2, wp - 2, n), dtype=dtype, device=x.device)
    tiles = K3.tiles(b, hp - 2, wp - 2, n)
    ws = torch.empty(tiles * splits * K3.TILE * K3.tile_n(n), dtype=torch.int32, device=x.device)
    counters = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    w_nhwc = wq.permute(3, 0, 1, 2).contiguous()
    err = _build.entry("iret_conv3x3_int8")(
        K3._PATH_CODES[path], K3._OUT_CODES[dtype], x.data_ptr(), w_nhwc.data_ptr(),
        scale.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, hp - 2,
        wp - 2, c, n, splits, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"conv3x3_int8 ({path}, {splits} splits)")
    assert not counters.any(), "the split-K counters were not left at zero"
    return out


@pytest.mark.parametrize("b,h,w,c,n", [(2, 8, 8, 1280, 1280), (2, 16, 16, 1920, 640),
                                       (2, 32, 32, 960, 640)])
def test_conv3x3_int8_paths_and_splits_agree(cuda, b, h, w, c, n):
    """Every path and K split of K3 gives the plain version's output bitwise:
    mma, sm90 without split, the rule's split, and the most splits the K
    blocks allow (one K block each at C = 960)."""
    x, wq, scale = _conv_inputs(b, h, w, c, n, "cuda", cuda)
    ref = K3.conv3x3_same_int8_reference(x, wq, scale, torch.bfloat16)
    kblocks = 9 * c // (128 if c % 128 == 0 else 64)
    for path, splits in (("mma", 1), ("sm90", 1), ("sm90", K3.split_k(b, h, w, c, n)),
                         ("sm90", kblocks)):
        got = _conv_entry(x, wq, scale, torch.bfloat16, path, splits)
        assert torch.equal(got, ref), (path, splits)


# The UNet's 3x3 stride-1 convs at 512 px (latents 64 .. 8), (H, W, C, N): the
# resnets' conv1 / conv2 and the upsamplers' convs.
UNET_CONV3 = [(64, 64, 320, 320), (32, 32, 320, 640), (32, 32, 640, 640), (16, 16, 640, 1280),
              (16, 16, 1280, 1280), (8, 8, 1280, 1280), (8, 8, 2560, 1280),
              (16, 16, 2560, 1280), (16, 16, 1920, 1280), (32, 32, 1280, 1280),
              (32, 32, 1920, 640), (32, 32, 1280, 640), (32, 32, 960, 640),
              (64, 64, 640, 640), (64, 64, 960, 320), (64, 64, 640, 320)]


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h,w,c,n", UNET_CONV3)
def test_conv_path_served(b, h, w, c, n):
    """Every UNet 3x3 conv of a 512-px request (CFG batch 2 and the gs 1.0
    batch 1) takes the sm90 path; split-K keeps the blocks within one wave of
    the card's SMs, gives every split at least MIN_SPLIT_KBLOCKS K blocks and
    takes at most MAX_SPLITS, and splits the 8x8 and 16x16 levels (F4), where
    the tiles alone fill at most a quarter of the SMs, to at least 4x the
    blocks or MAX_SPLITS."""
    assert K3.conv_path(b, h, w, c, n) == "sm90"
    box = K3.sm90_box(h, w)
    assert box[0] * box[1] * box[2] == K3.TILE
    splits = K3.split_k(b, h, w, c, n)
    tiles = K3.tiles(b, h, w, n)
    kblocks = 9 * c // (128 if c % 128 == 0 else 64)
    assert 1 <= splits <= K3.MAX_SPLITS and tiles * splits <= max(tiles, K3.H100_SMS)
    assert splits == 1 or kblocks // splits >= K3.MIN_SPLIT_KBLOCKS
    if h <= 16:
        assert tiles * 4 <= K3.H100_SMS
        assert splits >= min(4, K3.MAX_SPLITS)
    assert (K3.split_k(2, 8, 8, 1280, 1280), K3.split_k(2, 16, 16, 1920, 640)) == (8, 8)


def test_conv_path_other_cases():
    """What leaves the sm90 path: C not a multiple of 64 (TINY_SD's 8 and 16
    channels, the card tests' 24), N not a multiple of 8, or no 128-pixel box
    that is one rectangle of the image (W = 7, W = 48)."""
    for shape in ((1, 5, 7, 24, 20), (1, 1, 1, 16, 8), (2, 8, 8, 16, 16), (1, 8, 8, 64, 20),
                  (1, 8, 7, 64, 64), (1, 48, 48, 128, 128)):
        assert K3.conv_path(*shape) == "mma", shape
        assert K3.split_k(*shape) == 1
    assert K3.sm90_box(512, 512) == (128, 1, 1) and K3.sm90_box(4, 4) == (4, 4, 8)


def _conv_split_emulation(x, wq, scale, out_dtype, splits, drop=None):
    """K3's sm90 split-K in plain PyTorch: the K blocks (tap, slice of 128 or
    64 channels) cut into ``splits`` ranges as the kernel cuts them, each
    range's int64 partial sum, the partials added (``drop``: leave one out)."""
    b, hp, wp, c = x.shape
    h, w = hp - 2, wp - 2
    kb = 128 if c % 128 == 0 else 64
    cpt = c // kb
    nkb = 9 * cpt
    total = 0
    for sp in range(splits):
        if sp == drop:
            continue
        part = torch.zeros((b * h * w, wq.shape[-1]), dtype=torch.int64)
        for k in range(sp * nkb // splits, (sp + 1) * nkb // splits):
            tap, c0 = divmod(k, cpt)
            dy, dx = divmod(tap, 3)
            cols = x[:, dy:dy + h, dx:dx + w, c0 * kb:(c0 + 1) * kb].reshape(-1, kb).double()
            part += (cols @ wq[dy, dx, c0 * kb:(c0 + 1) * kb].double()).to(torch.int64)
        total = total + part
    return (total.float() * scale.float()).to(out_dtype).view(b, h, w, -1)


@pytest.mark.parametrize("b,h,w,c,n", [(2, 8, 8, 1280, 320), (1, 16, 16, 960, 128)])
def test_conv_split_k_emulation_is_exact(b, h, w, c, n):
    """On the CPU: K3's split of the K blocks at the rule's factor is bitwise
    equal to ``conv3x3_same_int8_reference``, and the "conv3x3_int8" limit
    rejects the same sum with one split dropped."""
    gen = torch.Generator().manual_seed(5)
    x, wq, scale = _conv_inputs(b, h, w, c, n, "cpu", gen)
    splits = K3.split_k(b, h, w, c, n)
    assert splits > 1
    for dtype in (torch.bfloat16, torch.float32):
        ref = K3.conv3x3_same_int8_reference(x, wq, scale, dtype)
        assert torch.equal(_conv_split_emulation(x, wq, scale, dtype, splits), ref)
    ok, err = tolerance.within(_conv_split_emulation(x, wq, scale, torch.bfloat16, splits,
                                                     drop=splits // 2), ref.bfloat16(),
                               "conv3x3_int8")
    assert not ok, f"the K3 limit passed a dropped K split (max err {err})"


def _int8_inputs(b, nq, nk, h, d, dtype, device, gen):
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=device).to(dtype)
               for n in (nq, nk, nk))
    q8, k8, s = A.smooth_quantize_qk(A._prescale(q), k)
    return q8, k8, v, s


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 4096, 77, 8, 40), (2, 1024, 1024, 8, 80),
    (2, 256, 256, 8, 160), (2, 64, 77, 8, 160), (1, 64, 64, 2, 4), (1, 100, 37, 3, 8),
    # the sm90 code's edges: Nq not a multiple of its 128-row tile with Nk = 77,
    # s8 rows of 32 bytes (d 16) and 96 bytes with a box past the row (d 24),
    # Nk = 1
    (2, 200, 77, 8, 40), (1, 100, 37, 2, 16), (1, 77, 100, 4, 24), (1, 64, 1, 2, 40),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_attention_kernel_matches_plain(cuda, b, nq, nk, h, d, dtype):
    q8, k8, v, s = _int8_inputs(b, nq, nk, h, d, dtype, "cuda", cuda)
    path = A.int8_kernel_path(q8, k8, v)
    if dtype == torch.float32 or h * d % 16:
        assert path == "mma"
    before = collections.Counter(_build.launch_paths)
    got = A.int8_attention_core(q8, k8, v, s)
    assert_launched("int8_attention", before, path)
    ref = A.int8_attention_core_reference(q8, k8, v, s)
    assert_within(got, ref, "int8_attention")
    if dtype == torch.bfloat16 and nk > 1:
        ok, right, wrong = tolerance.placement(got, ref, A.xla_int8_core(q8, k8, v, s))
        assert ok, (right, wrong)
    # the entry point the model calls, quantization prologue included
    q, k = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(dtype) for n in (nq, nk))
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v, backend="int8")
    assert_launched("int8_attention", before, path)
    assert_within(got, A.int8_attention_reference(q, k, v), "int8_attention")


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    x, wq, scale = _conv_inputs(1, 4, 4, 12, 8, "cuda", cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        K3.conv3x3_same_int8(x, wq, scale)
    q8, k8, v, s = _int8_inputs(1, 8, 8, 1, 200, torch.bfloat16, "cuda", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        A.int8_attention_core(q8, k8, v, s)
    q8, k8, v, s = _int8_inputs(1, 8, 8, 1, 40, torch.float16, "cuda", cuda)
    with pytest.raises(TypeError):
        A.int8_attention_core(q8, k8, v, s)


def _online_int8_attention(q8, k8, v, scale, tile=64, drop_tile=None, rescale=True):
    """K4's algorithm in plain PyTorch: exact s8 scores in KV tiles of ``tile``
    keys, exp2 against the running max, P rounded to v's dtype for P.V and the
    row sum, one divide at the end. ``drop_tile`` and ``rescale=False`` plant
    the two faults."""
    s_all = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float()) * (scale * A.LOG2E)
    vf = v.float().transpose(1, 2)
    m = torch.full(s_all.shape[:-1] + (1,), -math.inf, device=v.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s_all.shape[:-1] + (v.shape[-1],), device=v.device)
    for i, k0 in enumerate(range(0, k8.shape[1], tile)):
        if i == drop_tile:
            continue
        s = s_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(v.dtype).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = (acc * alpha if rescale else acc) + p @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l).to(v.dtype).transpose(1, 2)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_int8_limits_reject_planted_faults(device):
    """At the main path's largest shapes, the K3 limit passes the kernel and
    fails a dropped conv tap; the K4 limit passes the kernel and an emulation
    of it, and fails a dropped KV tile and a missing rescale (N = 4096). The
    CPU case takes fewer rows: each row sees the same statistics."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    h = 64 if device == "cuda" else 8
    x, wq, scale = _conv_inputs(2, h, h, 320, 320, device, gen)
    ref = K3.conv3x3_same_int8_reference(x, wq, scale, torch.bfloat16)
    if device == "cuda":
        assert_within(K3.conv3x3_same_int8(x, wq, scale, torch.bfloat16), ref, "conv3x3_int8")
    dropped = wq.clone()
    dropped[2, 2] = 0
    ok, err = tolerance.within(K3.conv3x3_same_int8_reference(x, dropped, scale, torch.bfloat16),
                               ref, "conv3x3_int8")
    assert not ok, f"the K3 limit passed a dropped tap (max err {err})"

    nq = 4096 if device == "cuda" else 256
    for b, nk, hh, d in ((2, 4096, 8, 40), (2, 1024, 8, 80)):
        q8, k8, v, s = _int8_inputs(b, nq, nk, hh, d, torch.bfloat16, device, gen)
        ref = A.int8_attention_core_reference(q8, k8, v, s)
        honest = [_online_int8_attention(q8, k8, v, s)]
        if device == "cuda":
            honest.append(A.int8_attention_core(q8, k8, v, s))
        for got in honest:
            assert_within(got, ref, "int8_attention")
        for fault in ({"drop_tile": 5}, {"rescale": False}):
            ok, err = tolerance.within(_online_int8_attention(q8, k8, v, s, **fault), ref,
                                       "int8_attention")
            assert not ok, f"the K4 limit passed a planted fault {fault} (max err {err})"


def _int8_tile(design, d):
    """Keys per KV tile of a K4 device code at head_dim ``d``: the mma code's
    64, or the sm90 code's (K1's tiles: 128 up to d 96, 64 at 160)."""
    if design == "mma":
        return 64
    return 128 if d <= 96 else 64


def _online_int8_xla(q8, k8, v, scale, tile):
    """K4's tiles with xla_attention_int8's roundings: a first walk over the
    KV tiles takes the row max and the fp32 row sum, a second rounds the
    normalised P to v's dtype for P.V (no divide after it)."""
    s_all = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float()) * (scale * A.LOG2E)
    m = torch.full(s_all.shape[:-1] + (1,), -math.inf, device=v.device)
    l = torch.zeros_like(m)
    for k0 in range(0, k8.shape[1], tile):
        s = s_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp2(m - m_new) + torch.exp2(s - m_new).sum(-1, keepdim=True)
        m = m_new
    vf = v.float().transpose(1, 2)
    acc = sum((torch.exp2(s_all[..., k0:k0 + tile] - m) / l).to(v.dtype).float()
              @ vf[:, :, k0:k0 + tile] for k0 in range(0, k8.shape[1], tile))
    return acc.to(v.dtype).transpose(1, 2)


@pytest.mark.parametrize("b,nk,h,d", [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_int8_limit_rejects_planted_faults_at_sm90_tiles(device, b, nk, h, d):
    """K4's limit at the sm90 code's KV tiles (128 keys, 64 at d 160): it
    passes an emulation of the tiled walk (and, on the card, the kernel on
    "sm90") and fails a dropped KV tile and a missing rescale. The CPU case
    takes 256 query rows."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    nq = nk if device == "cuda" else min(nk, 256)
    tile = _int8_tile("sm90", d)
    gen = torch.Generator(device=device).manual_seed(3)
    q8, k8, v, s = _int8_inputs(b, nq, nk, h, d, torch.bfloat16, device, gen)
    ref = A.int8_attention_core_reference(q8, k8, v, s)
    honest = [_online_int8_attention(q8, k8, v, s, tile=tile)]
    if device == "cuda":
        assert A.int8_kernel_path(q8, k8, v) == "sm90"
        honest.append(A.int8_attention_core(q8, k8, v, s))
    for got in honest:
        assert_within(got, ref, "int8_attention")
    for fault in ({"drop_tile": nk // tile // 2}, {"rescale": False}):
        ok, err = tolerance.within(_online_int8_attention(q8, k8, v, s, tile=tile, **fault), ref,
                                   "int8_attention")
        assert not ok, f"the K4 limit passed a planted fault {fault} (max err {err})"


@pytest.mark.parametrize("b,nk,h,d", [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 77, 8, 160)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("design", ["mma", "sm90"])
def test_int8_placement_check(design, device, b, nk, h, d):
    """K4's placement check (``tolerance.placement`` against
    ``attention.xla_int8_core``) passes the tiled walk with K4's roundings at
    the device code's KV tile (and, on the card, K4 on that code) and fails
    the same walk with xla_attention_int8's roundings (P normalised before it
    is rounded); the K4 limit alone passes both. The CPU case takes 128
    query rows."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    nq = nk if device == "cuda" else 128
    tile = _int8_tile(design, d)
    gen = torch.Generator(device=device).manual_seed(4)
    q8, k8, v, s = _int8_inputs(b, nq, nk, h, d, torch.bfloat16, device, gen)
    right, wrong = A.int8_attention_core_reference(q8, k8, v, s), A.xla_int8_core(q8, k8, v, s)
    honest = [_online_int8_attention(q8, k8, v, s, tile=tile)]
    if device == "cuda":
        honest.append(_int8_entry(q8, k8, v, s, design))  # the device code itself
    for got in honest:
        assert_within(got, right, "int8_attention")
        ok, r, w = tolerance.placement(got, right, wrong)
        assert ok, (r, w)
    moved = _online_int8_xla(q8, k8, v, s, tile)
    assert_within(moved, right, "int8_attention")
    ok, r, w = tolerance.placement(moved, right, wrong)
    assert not ok, f"the K4 placement check passed xla_attention_int8's roundings ({r} vs {w})"


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("nq,nk,d", [(n, k, d) for _, n, k, _, d in _SERVED])
def test_int8_kernel_path_served(b, nq, nk, d):
    """At every UNet attention site of an int8 serve, at CFG batch 2 and at
    batch 1, the quantizer's s8 outputs and the projection's bf16 v take K4's
    "sm90" code (no padded copies), and fp32 v the "mma" code."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, n, 8, d), generator=gen).to(torch.bfloat16) for n in (nq, nk, nk))
    q8, k8, _ = A.smooth_quantize_qk(A._prescale(q), k)
    assert A.int8_kernel_path(q8, k8, v) == "sm90"
    assert A.int8_kernel_path(q8, k8, v.float()) == "mma"


@pytest.mark.parametrize("case", ["head_dim_8", "unaligned_base", "heads_not_packed",
                                  "row_stride", "v_unaligned", "v_dim_stride"])
def test_int8_kernel_path_other_cases(case):
    """What leaves K4's sm90 code for the mma code: s8 rows that are not a
    16-byte multiple (3 heads of 8 dims), a base off a 16-byte boundary, heads
    not packed in the rows, a row stride off a 16-byte multiple, and v rows
    TMA cannot address. Other dtypes and head_dim > 160 raise."""
    q8, k8 = (torch.zeros((1, n, 4, 40), dtype=torch.int8) for n in (100, 77))
    v = torch.zeros((1, 77, 4, 40), dtype=torch.bfloat16)
    assert A.int8_kernel_path(q8, k8, v) == "sm90"
    if case == "head_dim_8":
        q8, k8 = (torch.zeros((1, n, 3, 8), dtype=torch.int8) for n in (100, 77))
        v = torch.zeros((1, 77, 3, 8), dtype=torch.bfloat16)
    elif case == "unaligned_base":
        q8 = torch.zeros(1 + 100 * 160, dtype=torch.int8)[1:].view(1, 100, 4, 40)
        assert q8.data_ptr() % 16 == 1
    elif case == "heads_not_packed":
        q8 = torch.zeros((1, 100, 4, 48), dtype=torch.int8)[..., :40]
    elif case == "row_stride":
        k8 = torch.zeros((1, 77, 164), dtype=torch.int8)[..., :160].view(1, 77, 4, 40)
    elif case == "v_unaligned":
        v = torch.zeros((1, 77, 4, 41), dtype=torch.bfloat16)[..., 1:]
    else:
        v = torch.zeros((1, 77, 4, 80), dtype=torch.bfloat16)[..., ::2]
    assert A.int8_kernel_path(q8, k8, v) == "mma"
    with pytest.raises(TypeError):
        A.int8_kernel_path(q8, k8, v.half())
    with pytest.raises(ValueError, match="head_dim"):
        A.int8_kernel_path(*(torch.zeros((1, 8, 1, 200), dtype=torch.int8) for _ in range(2)),
                           torch.zeros((1, 8, 1, 200), dtype=torch.bfloat16))


def _int8_padded(q8, k8, v):
    """Contiguous copies of q8, k8 and v zero-padded to the mma code's widths."""
    dp, dv = A._int8_widths(q8.shape[-1])
    pad = torch.nn.functional.pad
    return (pad(q8, (0, dp - q8.shape[-1])).contiguous(),
            pad(k8, (0, dp - q8.shape[-1])).contiguous(),
            pad(v, (0, dv - v.shape[-1])).contiguous())


def _int8_entry(q8, k8, v, scale, path, d=None):
    """K4 through its C entry on ``path`` with these tensors as they are
    (head_dim ``d``, default q8's last axis; on "mma" the default passes
    ``_int8_padded`` copies)."""
    if d is None:
        d = q8.shape[-1]
        if path == "mma":
            q8, k8, v = _int8_padded(q8, k8, v)
    b, nq, h = q8.shape[:3]
    out = torch.empty((b, nq, h, d), dtype=v.dtype, device=v.device)
    err = _build.entry("iret_int8_attention")(
        A._PATH_CODES[path], A._DTYPE_CODES[v.dtype], q8.data_ptr(), k8.data_ptr(),
        v.data_ptr(), scale.data_ptr(), out.data_ptr(), b, h, nq, k8.shape[1], d,
        *q8.stride()[:3], *k8.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"int8_attention ({path})")
    return out


@pytest.mark.parametrize("b,nq,nk,h,d", [(2, 1024, 77, 8, 80), (1, 300, 300, 2, 160),
                                         (2, 4096, 4096, 8, 40)])
def test_int8_attention_paths_agree(cuda, b, nq, nk, h, d):
    """K4's two device codes through the C entry on the same inputs, each
    within the limit of the plain version; and the entry refuses what a path
    cannot take: fp32 v or heads not packed in the s8 rows on "sm90", rows
    not padded to its widths on "mma" (at d 40 and 80; at 160 the unpadded
    rows are its layout), and a path K4 does not have."""
    q8, k8, v, s = _int8_inputs(b, nq, nk, h, d, torch.bfloat16, "cuda", cuda)
    ref = A.int8_attention_core_reference(q8, k8, v, s)
    for path in ("sm90", "mma"):
        assert_within(_int8_entry(q8, k8, v, s, path), ref, "int8_attention")
    spread = torch.nn.functional.pad(q8, (0, 16))[..., :d]
    refused = [("sm90", (q8, k8, v.float())), ("sm90", (spread, k8, v)),
               ("simt", (q8, k8, v))]
    if A._int8_widths(d)[0] != d:
        refused.append(("mma", (q8, k8, v)))
    for path, (qq, kk, vv) in refused:
        with pytest.raises(_build.KernelError):
            _int8_entry(qq, kk, vv, s, path, d)


def test_int8_attention_launches_one_kernel(cuda):
    """On the served path a K4 call is one device launch, the kernel itself: the
    wrapper copies and pads nothing (the profiler sees every kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q8, k8, v, s = _int8_inputs(2, 4096, 77, 8, 40, torch.bfloat16, "cuda", cuda)
    A.int8_attention_core(q8, k8, v, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        A.int8_attention_core(q8, k8, v, s)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "S8QK" in kernels[0], kernels


@pytest.mark.parametrize("layer,in_shape", [
    (("linear", 320, 320), (2, 4096, 320)),        # to_q at 64x64 latents, CFG batch
    (("linear", 768, 320), (2, 77, 768)),          # to_k on the text context
    (("linear", 640, 5120), (2, 1024, 640)),       # GEGLU proj at 32x32
    (("linear", 1280, 1280), (2, 64, 1280)),       # mid block
    (("conv", 640, 1280, 1, 1, 0), (2, 640, 16, 16)),   # resnet conv_shortcut
    (("conv", 320, 320, 3, 2, 1), (2, 320, 64, 64)),    # Downsample2D, stride 2
])
def test_int8_layers_match_cpu(cuda, layer, in_shape):
    """The int8 layers that K3 does not serve (torch._int_mm on the card,
    float64 sums on the CPU) give the CPU's output to within one rounding of
    the output dtype, under a static and a dynamic scale; the same layer with
    quantization off does not."""
    from image_restoration_and_enhancement_torch.models.layers import CL, QConv2d, QLinear
    from image_restoration_and_enhancement_torch.ops.quant import QuantState

    torch.manual_seed(3)
    if layer[0] == "linear":
        cpu = QLinear(*layer[1:])
        x = torch.randn(in_shape)
    else:
        cpu = QConv2d(*layer[1:3], kernel_size=layer[3], stride=layer[4], padding=layer[5])
        x = torch.randn(in_shape).contiguous(memory_format=CL)
    cpu, x = cpu.to(torch.bfloat16), x.to(torch.bfloat16)
    gpu = type(cpu)(*layer[1:3], **({} if layer[0] == "linear" else dict(
        kernel_size=layer[3], stride=layer[4], padding=layer[5]))).to("cuda", torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    cpu.site = gpu.site = "site"
    for state in (QuantState("int8_static", {"site": float(x.abs().amax()) * 0.9}),
                  QuantState("int8")):
        cpu.set_quant(state)
        gpu.set_quant(state)
        with torch.inference_mode():
            ref, got = cpu(x), gpu(x.cuda()).cpu()
        assert_within(got, ref, "int8_layer")
    gpu.set_quant(None)
    with torch.inference_mode():
        ok, err = tolerance.within(gpu(x.cuda()).cpu(), ref, "int8_layer")
    assert not ok, f"the int8 layer limit passed full precision (max err {err})"


def _per_head(fn, q, k, v):
    return torch.cat([fn(*(t[:, :, i:i + 1] for t in (q, k, v))) for i in range(q.shape[2])],
                     dim=2)


@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 16384, 16384, 8, 40), (1, 16384, 16384, 1, 512)])
def test_kernels_at_1024px_shapes(cuda, b, nq, nk, h, d):
    """K1 at a 1024 px request's self-attention (UNet level 0, VAE mid-block)
    and K2 at its 128x128 latent and 1024 px VAE shapes, bf16, against their
    plain versions (attention one head at a time), through the planned paths."""
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(torch.bfloat16)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v)
    assert_launched("attention", before, "sm90" if d <= A.SM90_MAX_HEAD_DIM else "sm90_split")
    right = _per_head(A.pallas_attention_reference, q, k, v)
    assert_within(got, right, "attention")
    ok, right_share, wrong_share = tolerance.placement(
        got, right, _per_head(A.attention_reference, q, k, v))
    assert ok, (right_share, wrong_share)
    del q, k, v, got, right
    shapes = [(1, 128, 128, 320, "silu"), (1, 128, 128, 960, None), (1, 1024, 1024, 128, "silu"),
              (1, 1024, 1024, 256, None)] if d == 40 else []
    for b2, hh, ww, c, act in shapes:
        x = (torch.randn((b2, hh, ww, c), generator=cuda, device="cuda") * 2 + 0.5
             ).to(torch.bfloat16)
        scale = torch.randn((c,), generator=cuda, device="cuda") * 0.5 + 1.0
        bias = torch.randn((c,), generator=cuda, device="cuda") * 0.1
        before = collections.Counter(_build.launch_paths)
        out = G.group_norm(x, scale, bias, 32, 1e-6, act)
        assert_launched("group_norm", before, G.plan(b2, hh * ww, c, 2).path)
        assert_within(out, G.group_norm_reference(x, scale, bias, 32, 1e-6, act), "group_norm")


@pytest.mark.parametrize("b,nq,nk,h,d", [s for s in _SDXL if s[0] == 2])
def test_attention_at_sdxl_shapes(cuda, b, nq, nk, h, d):
    """K1 at the SDXL UNet's CFG shapes (1024 px, head_dim 64), bf16, against
    its plain version and placed, through "sm90"."""
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(torch.bfloat16)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v)
    assert_launched("attention", before, "sm90")
    assert_attention_kernel(got, "attention", A.pallas_attention_reference(q, k, v), q, k, v)


def _tiny_dirs(root):
    """TINY_SD and TINY_SD_INPAINT stacks at random (fp32), written in the
    pipeline layout; the per-task pipeline config that serves them."""
    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    gen = torch.Generator().manual_seed(7)
    config = {}
    for name, cfg in (("sd", C.TINY_SD), ("inpaint", C.TINY_SD_INPAINT)):
        mods = sampling.SDModules.create(cfg, torch.float32, "cpu")
        for m in mods.components().values():
            init_random_(m, gen)
        ckpt.save_pipeline(str(root / name), mods.components(), cfg)
    for task in ("sr_x4", "colorize", "inpaint"):
        config[task] = {"fine_tuned_dir": str(root / ("inpaint" if task == "inpaint" else "sd")),
                        "default_backend": "diffusion"}
    return config


def _same_noise(pipe):
    """Serve ``pipe``'s sampling functions with noise drawn on the CPU from a
    fixed seed: a CUDA and a CPU ``torch.Generator`` draw different streams."""
    from image_restoration_and_enhancement_torch.core import sampling

    orig = pipe._sampler_fn

    def sampler_fn(stack, kind, *args):
        fn = orig(stack, kind, *args)

        def run(x, *tensors, generator=None):
            gen = torch.Generator().manual_seed(11)
            shape = sampling.latent_shape(stack["modules"], x.shape)
            noise = tuple(torch.randn(shape, generator=gen)
                          for _ in range(3 if kind == "inpaint" else 2))
            return fn(x, *tensors, noise=noise)
        return run

    pipe._sampler_fn = sampler_fn
    return pipe


def test_tasks_match_cpu(cuda, tmp_path, monkeypatch):
    import numpy as np

    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # fp32 convs, as on the CPU
    config = _tiny_dirs(tmp_path)
    pipes = [_same_noise(RestorationPipeline(config=config, dtype=torch.float32, device=dev))
             for dev in ("cpu", "cuda")]
    rng = np.random.default_rng(8)
    small = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    grey = np.repeat(rng.integers(0, 256, (64, 64, 1), dtype=np.uint8), 3, axis=2)
    photo = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:44, 8:40] = 255
    calls = [("super_resolve", (small,), {}), ("colorize", (grey,), {}),
             ("inpaint", (photo,), {"mask": mask})]
    before = collections.Counter(_build.launch_counts)
    for method, args, kwargs in calls:
        ref, got = (getattr(p, method)(*args, **kwargs) for p in pipes)
        assert got.dtype == np.uint8 and got.shape == ref.shape, method
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, method
    launched = collections.Counter(_build.launch_counts) - before
    assert launched["attention"] > 0 and launched["group_norm"] > 0


def test_sdxl_and_serve_modes_match_cpu(cuda, tmp_path, monkeypatch):
    """A TINY_SDXL denoise (its directory describes itself) and TINY_SD
    denoise under ToMe (ratio 0.5, the site threshold lowered to TINY's 64
    level-0 tokens) and the CFG cache (interval 2), on the card against the
    CPU, fp32, the same noise: within one uint8 level."""
    import numpy as np

    from image_restoration_and_enhancement_torch import config as C
    from image_restoration_and_enhancement_torch.core import checkpoint as ckpt
    from image_restoration_and_enhancement_torch.core import sampling
    from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # fp32 convs, as on the CPU
    monkeypatch.setenv("IRET_TOME_MIN", "64")
    gen = torch.Generator().manual_seed(12)
    for name, cfg in (("sdxl", C.TINY_SDXL), ("sd", C.TINY_SD)):
        mods = sampling.SDModules.create(cfg, torch.float32, "cpu")
        for m in mods.components().values():
            init_random_(m, gen)
        ckpt.save_pipeline(str(tmp_path / name), mods.components(), cfg)
    image = np.random.default_rng(13).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    before = collections.Counter(_build.launch_shapes)
    for name, kw in (("sdxl", {}), ("sd", {"tome_ratio": 0.5, "cfg_cache_interval": 2})):
        config = {"denoise": {"fine_tuned_dir": str(tmp_path / name),
                              "default_backend": "diffusion"}}
        pipes = [_same_noise(RestorationPipeline(config=config, dtype=torch.float32,
                                                 device=dev, **kw)) for dev in ("cpu", "cuda")]
        ref, got = (p.denoise(image) for p in pipes)
        assert pipes[1]._stacks["denoise"]["modules"].is_sdxl == (name == "sdxl")
        assert got.dtype == np.uint8 and got.shape == ref.shape == (64, 64, 3), name
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name
    launched = collections.Counter(_build.launch_shapes) - before
    attn = {key: n for (k, key), n in launched.items() if k == "attention"}
    assert any(key[1] == key[2] == 32 for key in attn)  # ToMe's merged level 0
    assert any(key[0] == 1 and key[3] == 2 and key[1] == 64 for key in attn)  # the cache's


def test_rrdbnet_matches_cpu(cuda, monkeypatch):
    from image_restoration_and_enhancement_torch.models.layers import init_random_
    from image_restoration_and_enhancement_torch.models.rrdbnet import RRDBNet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # fp32 convs, as on the CPU
    cpu = init_random_(RRDBNet().eval(), torch.Generator().manual_seed(9))
    gpu = RRDBNet().eval().to("cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand((1, 16, 20, 3), generator=torch.Generator().manual_seed(10))
    with torch.inference_mode():
        ref, got = cpu(x), gpu(x.cuda()).cpu()
    assert got.shape == (1, 64, 80, 3)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


# --- the evaluation path: metrics, perceptual networks, degradations ----------------


@contextlib.contextmanager
def torch_default_tf32():
    """torch's default TF32 settings (cuDNN may take TF32, cuBLAS not), restored
    after: the metric ops must own their precision under them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _evaluation_images(b, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    smooth = torch.cumsum(torch.rand((b, h, w, 3), generator=g) - 0.5, dim=2) * 0.02 + 0.5
    gt = smooth.clamp(0, 1)
    pred = (gt + 0.03 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    return gt, pred


def test_metric_ops_on_card_match_cpu_under_default_tf32(cuda):
    """uniform_filter, resize and the metric bundle (SSIM above all) on the
    card under torch's default TF32 settings against the CPU: within 1e-5
    (of the largest value for the filter and the resize; absolute for the
    metrics, 1e-4 dB for PSNR) and SSIM never above 1. (An fp32 depthwise
    convolution takes no TF32 on the card even where cuDNN may, PR 12: the
    control is the networks', below.)"""
    from image_restoration_and_enhancement_torch.metrics import functional as MF
    from image_restoration_and_enhancement_torch.ops import image as IM

    gt, pred = _evaluation_images(4, 96, 120, 20)
    with torch_default_tf32():
        filt = IM.uniform_filter(gt.cuda(), 7).cpu()
        small = IM.resize(gt.cuda(), (61, 47), "bicubic").cpu()
        big = IM.resize(gt.cuda(), (299, 299), "bilinear").cpu()
        card = {k: v.cpu() for k, v in MF.calculate_all(pred.cuda(), gt.cuda(), True, True)
                .items()}
        same = MF.ssim(gt.cuda(), gt.cuda()).cpu()
    ref = IM.uniform_filter(gt, 7)
    torch.testing.assert_close(filt, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    for got, want in ((small, IM.resize(gt, (61, 47), "bicubic")),
                      (big, IM.resize(gt, (299, 299), "bilinear"))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    cpu = MF.calculate_all(pred, gt, True, True)
    for name, v in card.items():
        torch.testing.assert_close(v, cpu[name], rtol=0,
                                   atol=1e-4 if name.startswith("psnr") else 1e-5, msg=name)
        if name.startswith("ssim"):
            assert (v <= 1.0).all(), name
    assert (same <= 1.0).all() and (same > 1 - 1e-6).all()


@pytest.mark.parametrize("task", ["denoise", "sr_x4", "colorize", "inpaint"])
def test_degradations_on_card_match_cpu(cuda, task):
    """A synthetic batch drawn and degraded on the card against the CPU on the
    same draws: within 1e-5 of the largest value (noise, blur, resize, LAB),
    masks equal but at boundary pixels. JPEG and the artifact mode's motion
    blur on their own: within 1e-5 outside blocks with a DCT coefficient at a
    rounding midpoint."""
    from image_restoration_and_enhancement_torch.data import degradations as D
    from image_restoration_and_enhancement_torch.data import synthetic as S

    gt, _ = _evaluation_images(4, 64, 64, 21)
    gen = torch.Generator(device="cuda").manual_seed(22)
    draws = S.draw_batch(task, gen, 4, 64, device="cuda")
    with torch_default_tf32():
        card = {k: v.cpu() for k, v in S.degrade_batch(task, gt.cuda(), draws).items()}
    cpu_draws = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                 for k, v in draws.items()}
    cpu = S.degrade_batch(task, gt, cpu_draws)
    assert set(card) == set(cpu)
    if task == "inpaint":
        near = D.near_inpaint_boundary((64, 64), cpu_draws)
        diff = (card["mask"] != cpu["mask"])[..., 0].numpy()
        assert not (diff & ~near).any() and near.mean() < 0.02
        keep = torch.from_numpy(~near)[..., None]
        torch.testing.assert_close(card["input"] * keep, cpu["input"] * keep, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(card["input"], cpu["input"], rtol=0, atol=1e-5)
    if task == "denoise":
        quality = torch.tensor([31, 55, 72, 90])
        with torch_default_tf32():
            got = D.jpeg_quantize(gt.cuda(), quality.cuda()).cpu()
            length, angle = torch.tensor([3.5, 5.0, 7.2, 8.0]), torch.tensor([0.3, 1.2, 2.5, 4.0])
            blur = D.motion_blur(gt.cuda(), length.cuda(), angle.cuda(), (3, 8)).cpu()
        bad = ((got - D.jpeg_quantize(gt, quality)).abs() > 1e-5).any(dim=-1).numpy()
        assert not (bad & ~D.near_jpeg_midpoint(gt, quality)).any()
        torch.testing.assert_close(blur, D.motion_blur(gt, length, angle, (3, 8)), rtol=0,
                                   atol=1e-5)


def test_lpips_and_inception_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """``lpips_pairs`` (random LPIPS-Alex weights in the JAX layout under
    IRET_WEIGHTS_DIR) within 1e-5 relative, and ``inception_features`` (the
    seeded random-init trunk, IRET_FID_RANDOM_INIT=1) within 1e-4 of their
    largest, card against CPU under torch's default TF32 settings (the
    networks run in full fp32). Control: the same Inception trunk called
    without ``full_fp32`` under those settings (cuDNN in TF32) misses the
    limit."""
    from image_restoration_and_enhancement_torch.metrics import inception as I
    from image_restoration_and_enhancement_torch.metrics import perceptual as P
    from image_restoration_and_enhancement_torch.models.layers import init_random_

    monkeypatch.setenv("IRET_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("IRET_FID_RANDOM_INIT", "1")
    P.save_lpips(init_random_(P.LPIPSAlex(), torch.Generator().manual_seed(24)),
                 str(tmp_path / P.LPIPS_FILE))
    gt, pred = _evaluation_images(3, 128, 160, 23)
    gts, preds = list(gt.numpy()), list(pred.numpy())
    with torch_default_tf32():
        got = P.lpips_pairs(preds, gts, device="cuda")
        card_feats = I.inception_features(gts, device="cuda")
    ref = P.lpips_pairs(preds, gts, device="cpu")
    feats = I.inception_features(gts, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert min(ref) > 0
    assert card_feats.shape == feats.shape == (3, 2048)
    assert np.abs(card_feats - feats).max() <= 1e-4 * np.abs(feats).max()
    net = I._inception_model(P.inception_weights_path(), "cuda")
    x = I.resize(torch.from_numpy(np.stack(gts)).cuda(), (299, 299), "bilinear")
    with torch_default_tf32(), torch.inference_mode():
        tf32 = net(x.permute(0, 3, 1, 2)).cpu().numpy()
    assert np.abs(tf32 - feats).max() > 1e-4 * np.abs(feats).max()


# Height-sharded GroupNorm (parallel/spatial.py): (global NHWC shape, groups,
# eps, act, sp) of the UNet and the VAE at 512 px and at 2048 px (one image,
# latent 256).
SHARDED_GN = [
    ((2, 64, 64, 320), 32, 1e-5, "silu", 2), ((2, 32, 32, 640), 32, 1e-5, None, 4),
    ((1, 512, 512, 128), 32, 1e-6, "silu", 2), ((1, 256, 256, 512), 32, 1e-6, None, 4),
    ((2, 256, 256, 320), 32, 1e-5, "silu", 4), ((1, 2048, 2048, 128), 32, 1e-6, "silu", 4),
    ((1, 1024, 1024, 256), 32, 1e-6, None, 4),
]


@pytest.mark.parametrize("shape,groups,eps,act,sp", SHARDED_GN)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_sharded_entries_match_plain_split(cuda, shape, groups, eps, act, sp, dtype):
    """K2's two sharded entries with sp simulated by slicing one tensor on one
    card: each shard's stats launch (its partials, summed, within fp32 1e-5 of
    the largest of the plain split's), the partials concatenated in shard
    order, and each shard's apply launch with the global count: within the
    GroupNorm limit of the plain split and of the unsharded plain version."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    scale = torch.randn((c,), generator=cuda, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=cuda, device="cuda") * 0.1
    shards = [s.contiguous() for s in x.chunk(sp, dim=1)]
    before = collections.Counter(_build.launch_paths)
    parts = torch.cat([G.group_norm_stats(s, groups) for s in shards], dim=1)
    plain = torch.cat([G.group_norm_stats_reference(s, groups) for s in shards], dim=1)
    got_tot, want_tot = parts.sum(1), plain.sum(1)
    assert (got_tot - want_tot).abs().max() <= 1e-5 * want_tot.abs().max()
    count = float(shape[1] * shape[2] * (c // groups))
    got = torch.cat([G.group_norm_apply(s, scale, bias, parts, count, groups, eps, act)
                     for s in shards], dim=1)
    launched = collections.Counter(_build.launch_paths) - before
    assert launched == {("group_norm_stats", "twophase"): sp,
                        ("group_norm_apply", "twophase"): sp}, launched
    assert_within(got, G.group_norm_apply_reference(x, scale, bias, plain, count, groups, eps,
                                                    act), "group_norm")
    assert_within(got, G.group_norm_reference(x, scale, bias, groups, eps, act), "group_norm")


# K1 at height-sharded self-attention: the shard's queries (Nq = N / sp)
# against every shard's keys (Nk = N): UNet level 0 and the VAE mid-block at
# 512 px (sp 2, 4) and at 2048 px (sp 4).
SHARDED_ATTN = [(2, 2048, 4096, 8, 40), (2, 1024, 4096, 8, 40), (1, 2048, 4096, 1, 512),
                (2, 16384, 65536, 8, 40), (1, 16384, 65536, 1, 512)]


@pytest.mark.parametrize("b,nq,nk,h,d", SHARDED_ATTN)
def test_attention_at_query_sharded_shapes(cuda, b, nq, nk, h, d):
    """K1 on a shard's queries against the gathered K and V, bf16, within the
    limit of its plain version (one head at a time) and placed, through
    "sm90" (head_dim <= 160) or "sm90_split" (the VAE's 512)."""
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(torch.bfloat16)
               for n in (nq, nk, nk))
    before = collections.Counter(_build.launch_paths)
    got = A.attention(q, k, v)
    assert_launched("attention", before, "sm90" if d <= A.SM90_MAX_HEAD_DIM else "sm90_split")
    per_row = max(1, (1 << 30) // (nk * 4 * b))  # plain fp32 scores of at most 1 GiB at once
    for i in range(0, nq, per_row):
        sl = slice(i, i + per_row)
        right = _per_head(A.pallas_attention_reference, q[:, sl], k, v)
        assert_within(got[:, sl], right, "attention")
        if i == 0:
            ok, right_share, wrong_share = tolerance.placement(
                got[:, sl], right, _per_head(A.attention_reference, q[:, sl], k, v))
            assert ok, (right_share, wrong_share)


# --- the shapes a rank of a mesh hands the kernels (int8 serving, training) ---------------


@pytest.mark.parametrize("b,h,w,c,n", [(2, 64, 64, 320, 320), (2, 32, 32, 640, 640)])
def test_conv3x3_int8_on_a_height_shard(cuda, b, h, w, c, n):
    """K3 on each half of SD-1.5's 64x64x320 and 32x32x640 levels cut in two
    over sp = 2: the shard's s8 rows with one halo row above and one below as
    its padded input. Bitwise its plain version, and bitwise the rows of the
    whole level's conv."""
    x, wq, scale = _conv_inputs(b, h, w, c, n, "cuda", cuda)
    full = K3.conv3x3_same_int8(x, wq, scale, torch.bfloat16)
    half = h // 2
    for r in range(2):
        shard = x[:, r * half:r * half + half + 2].contiguous()
        before = collections.Counter(_build.launch_paths)
        got = K3.conv3x3_same_int8(shard, wq, scale, torch.bfloat16)
        assert_launched("conv3x3_int8", before, K3.conv_path(b, half, w, c, n))
        assert torch.equal(got, K3.conv3x3_same_int8_reference(shard, wq, scale,
                                                               torch.bfloat16))
        assert torch.equal(got, full[:, r * half:(r + 1) * half])


@pytest.mark.parametrize("b,nq,nk,h,d", [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80),
                                         (2, 256, 77, 8, 160)])
def test_int8_attention_at_local_heads_and_queries(cuda, b, nq, nk, h, d):
    """K4 as a rank of a mesh calls it: SD-1.5's 8 heads over model 2 (4 local
    heads) and its queries over sp 2 (half the rows, every key), with the
    global scale sq*sk given from outside (the all-reduced one). Within its
    limit of ``int8_attention_core_reference`` on the same local inputs, and of
    the unsharded call's rows and heads."""
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(torch.bfloat16)
               for n in (nq, nk, nk))
    q8, k8, s = A.smooth_quantize_qk(A._prescale(q), k)
    whole = A.int8_attention_core_reference(q8, k8, v, s)
    for heads, rows in ((slice(0, h // 2), slice(None)), (slice(None), slice(nq // 2, nq)),
                        (slice(h // 2, h), slice(0, nq // 2))):
        ql, kl, vl = (t[:, r, heads].contiguous() for t, r in ((q8, rows), (k8, slice(None)),
                                                               (v, slice(None))))
        path = A.int8_kernel_path(ql, kl, vl)
        assert path == "sm90"
        before = collections.Counter(_build.launch_paths)
        got = A.int8_attention_core(ql, kl, vl, s)
        assert_launched("int8_attention", before, path)
        ref = A.int8_attention_core_reference(ql, kl, vl, s)
        assert_within(got, ref, "int8_attention")
        assert_within(got, whole[:, rows, heads], "int8_attention")


@pytest.mark.parametrize("b,n,nk,h,d", [(2, 4096, 4096, 4, 40), (2, 1024, 77, 4, 80),
                                        (2, 256, 256, 2, 160)])
def test_attention_gradients_at_local_heads(cuda, b, n, nk, h, d):
    """Training under tensor parallelism: K1's forward and ``_AttentionFn``'s
    backward at SD-1.5's local head counts (8 heads over model 2 and 4). The
    gradients recompute through ``attention_reference``, as the JAX package's
    custom_vjp recomputes through ``xla_attention``: bitwise its gradients."""
    q, k, v = (torch.randn((b, m, h, d), generator=cuda, device="cuda").to(torch.bfloat16)
               .requires_grad_() for m in (n, nk, nk))
    before = collections.Counter(_build.launch_paths)
    out = A.attention(q, k, v)
    assert_launched("attention", before, A.kernel_path(q, k, v))
    assert_within(out.detach(), A.pallas_attention_reference(q.detach(), k.detach(),
                                                             v.detach()), "attention")
    g = torch.randn(out.shape, generator=cuda, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(A.attention_reference(q, k, v), (q, k, v), g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("shape,groups,eps,act", [((2, 32, 32, 320), 32, 1e-5, "silu"),
                                                  ((2, 16, 16, 640), 32, 1e-6, None)])
def test_group_norm_gradients_under_autograd(cuda, shape, groups, eps, act):
    """Training: K2's forward and ``_GroupNormFn``'s backward (through the
    plain version) at UNet norm shapes: the output within K2's limit, the
    gradients bitwise the plain version's."""
    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16).requires_grad_()
    scale = (1 + 0.1 * torch.randn(shape[-1], generator=cuda, device="cuda")).requires_grad_()
    bias = (0.1 * torch.randn(shape[-1], generator=cuda, device="cuda")).requires_grad_()
    before = collections.Counter(_build.launch_paths)
    out = G.group_norm(x, scale, bias, groups, eps, act)
    launched = collections.Counter(_build.launch_paths) - before
    assert sum(launched.values()) >= 1 and all(k[0].startswith("group_norm") for k in launched)
    ref = G.group_norm_reference(x, scale, bias, groups, eps, act)
    assert_within(out.detach(), ref.detach(), "group_norm")
    g = torch.randn(out.shape, generator=cuda, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, (x, scale, bias), g)
    want = torch.autograd.grad(ref, (x, scale, bias), g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
