"""The port's from-scratch init (``models/layers.init_random_``) against the
JAX package's (flax's default initializers and the ones its modules name in
``self.param``), on the CPU.

For TINY_SD and the learning demo's stack (``demo_model_config``): the JAX
side is ``core/sampling.init_params`` exported through
``export_torch_state_dict``, the port's side ``init_random_`` on a CPU
generator seeded 0, both over the UNet, the VAE and the text encoder. The
frameworks draw other numbers; the distributions must agree:

- the same keys and shapes;
- the constants (norm scales 1, biases 0) bitwise;
- per kind, pooled over the stack: a conv/dense kernel scaled by
  sqrt(fan_in) (fan_in = in * kh * kw), the token embedding by
  sqrt(hidden) (flax ``nn.Embed``: N(0, 1/features)), the position
  embedding by 1/0.01 (``clip_text.py``'s ``normal(0.01)``); the pooled stds
  of the two sides within ``STD_SIGMAS`` standard errors of each other (and
  JAX's of 1), and a two-sample Kolmogorov-Smirnov statistic under its
  critical value at alpha = 1e-3 (``KS_C``);
- every kernel within flax's lecun_normal cap, max |w| * sqrt(fan_in) <=
  2 / 0.87962566 (a normal truncated at two of its standard deviations).

Both limits follow from the kind's sample sizes (1,232 position and 2,048
token values; ~2e5 and ~2.4e6 kernel entries). An untruncated N(0, 1/fan_in)
kernel draw (KS distance ~0.017 to the truncated law, caps 3.4-4.1 on these
stacks) and N(0, 0.02) embeddings fail them.

LPIPS's lin weights are flax ``ones`` in the JAX module
(``metrics/perceptual.py``'s ``self.param``); the port's AlexNet head keeps
them through its ``flax_init``.

Marked slow (minutes; not in Tier-1): the learning demo's VAE stage at its
v1 protocol (40 epochs, 128 images at 64 px, batch 8, lr 1e-3, fp32) from
each package's own init, on the same ``gen_data`` files, for seeds 0-3: the
port's mean final scaled-latent std within 10% of JAX's mean. The denoise
stage adds N(0, 1) noise to these latents, so their scale sets the signal the
UNet learns from.
"""
import importlib.util
import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from image_restoration_and_enhancement_torch import demo_restoration_learning as tdemo
from image_restoration_and_enhancement_torch.config import TINY_SD as T_TINY_SD
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.metrics import perceptual as TP
from image_restoration_and_enhancement_torch.models.layers import init_random_
from image_restoration_and_enhancement_tpu.config import TINY_SD as J_TINY_SD
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.metrics import perceptual as JP
from test_torch_serving import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRUNCATED_NORMAL_STD = 0.87962566103423978  # std of N(0, 1) cut to [-2, 2] (flax's constant)
CAP = 2.0 / TRUNCATED_NORMAL_STD + 1e-6      # flax lecun_normal's largest |w| * sqrt(fan_in)
POSITION_STD = 0.01                          # clip_text.py's normal(0.01)
STD_SIGMAS = 5.0                             # standard errors of the pooled std ratio
KS_C = 1.95                                  # two-sample KS critical constant, alpha 1e-3
COMPONENTS = ("unet", "vae", "text_encoder")


VAE_SEEDS = (0, 1, 2, 3)
VAE_STD_RTOL = 0.10                          # the port's mean latent std against JAX's


def _jax_demo_config():
    spec = importlib.util.spec_from_file_location(
        "jax_script_demo_init", REPO / "scripts" / "demo_restoration_learning.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.demo_model_config()


STACKS = {"tiny_sd": (lambda: J_TINY_SD, lambda: T_TINY_SD),
          "demo": (_jax_demo_config, tdemo.demo_model_config)}


@pytest.fixture(scope="module", params=sorted(STACKS))
def inits(request):
    """({component: {name: array}} of JAX's init, the same of the port's)."""
    jcfg, tcfg = (make() for make in STACKS[request.param])
    jm = js.SDModules.create(jcfg, dtype=jnp.float32)
    # jitted: one compile; eager flax init compiles each op of the forward
    params = jax.jit(lambda k: js.init_params(jm, k, image_size=64))(jax.random.PRNGKey(0))
    jax_sd = {c: jck.export_torch_state_dict(params[c]) for c in COMPONENTS}
    tm = ts.SDModules.create(tcfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    port_sd = {}
    for c in COMPONENTS:
        module = init_random_(getattr(tm, c), gen)
        port_sd[c] = {k: v.numpy() for k, v in module.state_dict().items()}
    return jax_sd, port_sd


def _kind(name: str) -> str:
    if name.endswith("token_embedding.weight"):
        return "token embedding"
    if name.endswith("position_embedding.weight"):
        return "position embedding"
    return "kernel"


def _pooled(sd):
    """{kind: the stack's entries of that kind, each scaled to unit std under
    flax's law for it}."""
    pools = {}
    scales = {"kernel": lambda a: math.sqrt(a[0].size),
              "token embedding": lambda a: math.sqrt(a.shape[1]),
              "position embedding": lambda a: 1.0 / POSITION_STD}
    for comp in COMPONENTS:
        for name, a in sd[comp].items():
            if a.ndim >= 2:
                kind = _kind(name)
                pools.setdefault(kind, []).append((a.astype(np.float64) * scales[kind](a)).ravel())
    return {k: np.concatenate(v) for k, v in pools.items()}


def test_same_keys_and_shapes(inits):
    jax_sd, port_sd = inits
    for c in COMPONENTS:
        assert set(jax_sd[c]) == set(port_sd[c]), c
        for k, a in jax_sd[c].items():
            assert port_sd[c][k].shape == a.shape, (c, k)


def test_constants_equal(inits):
    jax_sd, port_sd = inits
    n = 0
    for c in COMPONENTS:
        for k, a in jax_sd[c].items():
            if a.ndim == 1:
                assert set(np.unique(a)) <= {0.0, 1.0}, (c, k)
                np.testing.assert_array_equal(port_sd[c][k], a, err_msg=f"{c} {k}")
                n += 1
    assert n > 0


@pytest.mark.parametrize("kind", ["kernel", "token embedding", "position embedding"])
def test_pooled_std(inits, kind):
    jax_sd, port_sd = inits
    want, got = _pooled(jax_sd)[kind], _pooled(port_sd)[kind]
    limit = STD_SIGMAS * math.sqrt(1 / (2 * want.size) + 1 / (2 * got.size))
    ratio = got.std() / want.std()
    assert abs(ratio - 1.0) <= limit, (kind, got.std(), want.std(), limit)
    assert abs(want.std() - 1.0) <= STD_SIGMAS / math.sqrt(2 * want.size)  # the law itself


def test_kernels_within_flax_cap(inits):
    jax_sd, port_sd = inits
    for side, sd in (("jax", jax_sd), ("port", port_sd)):
        for c in COMPONENTS:
            for k, a in sd[c].items():
                if a.ndim >= 2 and _kind(k) == "kernel":
                    top = float(np.abs(a.astype(np.float64)).max()) * math.sqrt(a[0].size)
                    assert top <= CAP, (side, c, k, top)


@pytest.mark.parametrize("kind", ["kernel", "token embedding", "position embedding"])
def test_ks_statistic(inits, kind):
    jax_sd, port_sd = inits
    want, got = _pooled(jax_sd)[kind], _pooled(port_sd)[kind]
    limit = KS_C * math.sqrt((want.size + got.size) / (want.size * got.size))
    d = stats.ks_2samp(got, want).statistic
    assert d <= limit, (kind, d, limit)


def test_lpips_named_initializers():
    """LPIPS: the lin weights flax's ones, the AlexNet kernels capped, biases
    0; the same keys as JAX's init through the port's bridge."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    flat = jck.flatten_params(jax.jit(JP.LPIPSAlex().init)(jax.random.PRNGKey(0), x, x)["params"])
    want = TP.params_from_flax(flat)
    model = init_random_(TP.LPIPSAlex(), torch.Generator().manual_seed(0))
    got = {k: p.detach() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k.startswith("lin") or k.endswith("bias"):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=k)
        else:
            fan = math.sqrt(w[0].numel())
            assert float(w.abs().max()) * fan <= CAP and float(g.abs().max()) * fan <= CAP, k


@pytest.mark.slow
def test_vae_stage_latent_scale_over_seeds(tmp_path):
    from image_restoration_and_enhancement_torch.train import vae_pretrain as TV
    from image_restoration_and_enhancement_tpu.train import vae_pretrain as JV

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)   # minutes of work, run alone
    try:
        finals = {"jax": [], "port": []}
        for seed in VAE_SEEDS:
            out = tmp_path / f"seed{seed}"
            tdemo.gen_data(str(out), 64, 80.0, 128, 8, seed)
            kw = dict(num_epochs=40, batch_size=8, learning_rate=1e-3, image_size=64,
                      seed=seed)
            finals["jax"].append(JV.pretrain_vae(
                str(out / "clean"), str(out / "vae_pretrained_jax"), JV.VAEPretrainConfig(**kw),
                model_config=_jax_demo_config(), use_mesh=False, dtype=jnp.float32))
            # the demo's own directory name: its stage 3 can go on from here
            finals["port"].append(TV.pretrain_vae(
                str(out / "clean"), str(out / "vae_pretrained"), TV.VAEPretrainConfig(**kw),
                model_config=tdemo.demo_model_config(), use_mesh=False, dtype=torch.float32,
                device="cpu"))
            print(f"seed {seed}: " + "; ".join(
                f"{side} latent_std {finals[side][-1]['latent_std']:.4f} "
                f"psnr {finals[side][-1]['psnr']:.4f}" for side in ("jax", "port")))
    finally:
        torch.set_num_threads(threads)
    jax_mean, port_mean = (float(np.mean([m["latent_std"] for m in finals[side]]))
                           for side in ("jax", "port"))
    print(f"mean latent_std: jax {jax_mean:.4f} port {port_mean:.4f}")
    assert abs(port_mean - jax_mean) <= VAE_STD_RTOL * jax_mean, (port_mean, jax_mean)
