"""The port's CUDA kernels against their plain PyTorch versions (needs a GPU).

Every kernel test takes the ``cuda`` fixture, which skips where no CUDA device
exists (so on a CPU-only machine each skips with that reason). On the H100:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances are ``ops/tolerance.py``'s: fp32 1e-4 absolute and relative (the
same sums in another order); bf16 one bf16 step of each value plus a share of
the largest, |got - ref| <= share * max|ref| + 2**-7 * |ref|, with share 2**-8
for attention and 2**-10 for GroupNorm.
``test_bf16_limit_rejects_planted_faults`` shows that this limit catches a
kernel that drops a KV tile or skips the online-softmax rescale at the N = 4096
shapes; its CPU case runs anywhere, with fewer query rows.
"""
import math

import pytest
import torch

from image_restoration_and_enhancement_torch.ops import _build
from image_restoration_and_enhancement_torch.ops import attention as A
from image_restoration_and_enhancement_torch.ops import groupnorm as G
from image_restoration_and_enhancement_torch.ops import tolerance


def assert_within(got, ref, kernel):
    atol, rtol = tolerance.limits(ref, kernel)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160),
    (2, 64, 77, 8, 160), (1, 4096, 4096, 1, 512), (1, 100, 37, 3, 24),
    (1, 77, 50, 2, 20),   # head_dim not a multiple of 8: the unvectorised tile loads
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain(cuda, b, nq, nk, h, d, dtype):
    q, k, v = (torch.randn((b, n, h, d), generator=cuda, device="cuda").to(dtype)
               for n in (nq, nk, nk))
    before = _build.launch_counts["attention"]
    got = A.attention(q, k, v)
    assert _build.launch_counts["attention"] == before + 1
    assert_within(got, A.attention_reference(q, k, v), "attention")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_takes_strided_views(cuda, dtype):
    qkv = torch.randn((2, 300, 3, 4, 40), generator=cuda, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    assert_within(A.attention(q, k, v), A.attention_reference(q, k, v), "attention")


@pytest.mark.parametrize("shape,groups,eps,act", [
    ((2, 64, 64, 320), 32, 1e-5, "silu"), ((2, 8, 8, 2560), 32, 1e-5, "silu"),
    ((2, 32, 32, 640), 32, 1e-6, None), ((1, 256, 256, 256), 32, 1e-6, "silu"),
    ((1, 3, 5, 40), 8, 1e-5, None),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_matches_plain(cuda, shape, groups, eps, act, dtype):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    scale = torch.randn((c,), generator=cuda, device="cuda") * 0.5 + 1.0
    bias = torch.randn((c,), generator=cuda, device="cuda") * 0.1
    before = _build.launch_counts["group_norm"]
    got = G.group_norm(x, scale, bias, groups, eps, act)
    assert _build.launch_counts["group_norm"] == before + 1
    assert_within(got, G.group_norm_reference(x, scale, bias, groups, eps, act), "group_norm")


def test_group_norm_kernel_large_mean_is_finite(cuda):
    x = 5000.0 + 0.1 * torch.randn((2, 8, 8, 16), generator=cuda, device="cuda")
    y = G.group_norm(x, torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"), 4)
    assert torch.isfinite(y).all()


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 1, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        A.attention(q, q, q)
    x = torch.zeros((1, 4, 4, 8), device="cuda").permute(0, 2, 1, 3)
    with pytest.raises(ValueError):
        G.group_norm(x, torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"), 2)


def _online_attention(q, k, v, tile=64, drop_tile=None, rescale=True):
    """K1's algorithm in plain PyTorch: KV tiles of ``tile`` keys, fp32 running
    max, sum and accumulator, bf16 probabilities into P.V, one divide at the
    end. ``drop_tile`` (skip that tile) and ``rescale=False`` (never scale the
    accumulator by exp(m_old - m_new)) plant the two faults."""
    d = q.shape[-1]
    qf = q.float().transpose(1, 2) / math.sqrt(d)
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
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float() @ vf[:, :, k0:k0 + tile]
        acc = (acc * alpha if rescale else acc) + pv
        m = m_new
    return (acc / l).to(q.dtype).transpose(1, 2)


@pytest.mark.parametrize("b,nk,h,d", [(2, 4096, 8, 40), (1, 4096, 1, 512)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bf16_limit_rejects_planted_faults(device, b, nk, h, d):
    """At the main path's two N = 4096 sites, the bf16 limit passes the kernel
    and a faithful emulation of it, and fails a dropped KV tile and a missing
    rescale. The CPU case keeps Nk = 4096 and takes 256 query rows: each row
    sees the same statistics."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    nq = nk if device == "cuda" else 256
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=device).to(torch.bfloat16)
               for n in (nq, nk, nk))
    ref = A.attention_reference(q, k, v)
    honest = [_online_attention(q, k, v)]
    if device == "cuda":
        honest.append(A.attention(q, k, v))
    for got in honest:
        assert_within(got, ref, "attention")
    for fault in ({"drop_tile": 17}, {"rescale": False}):
        ok, err = tolerance.within(_online_attention(q, k, v, **fault), ref, "attention")
        assert not ok, f"the bf16 limit passed a planted fault {fault} (max err {err})"
