"""Multi-device serving in the port: data and tensor parallelism against the JAX
package, on gloo ranks on the CPU (TINY_SD, fp32).

The JAX reference is the UNSHARDED ``make_img2img_fn`` in the "interleaved"
CFG layout with XLA attention (one compile per function); every port mesh is
held against it. The port's ranks are spawned once for the module (8 gloo
ranks, ``parallel/launch.py``) and serve every case through
``parallel/serve.run_cases``, a function of the port (a rank imports only the
port). Cases, after ``tests/test_tensor_parallel.py``:

- the partition rules against JAX's ``tree_partition_specs`` for every UNet and
  CLIP parameter, through ``export_torch_state_dict``'s names and the [in, out]
  -> [out, in] transposition;
- the UNet forward under tensor parallelism (model 2);
- img2img under data parallelism (data 4), data x tensor (4 x 2), tensor 4
  on TINY_SD's 2 heads (every attention site stays replicated: the heads do
  not divide) and data x tensor x height (2 x 2 x 2) against JAX, the last
  also against JAX's own ``make_sharded_img2img_fn`` on the conftest's 8
  virtual devices; data parallelism, and the CFG cache under it, bitwise
  against the port's unsharded function;
- pure data parallelism makes no collective inside the denoise loop (the
  counter of ``parallel/collectives.py``), only the output's gather;
- the interleaved layout against halves on one device (bitwise);
- GEGLU's half split, and which sites stay replicated.

Tolerance: 2e-4 absolute on images in [-1, 1] and on eps, as
``test_torch_serving.py`` states it for the unsharded port (the same fp32 sums
in another order; tensor parallelism adds one more order, the ranks' partial
products summed). Data parallelism alone must equal the unsharded port bitwise
(under the CFG cache within 2e-4: its cond-only UNet call runs at another
batch than the unsharded one, which reorders the CPU's sums).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.infer.pipeline import RestorationPipeline
from image_restoration_and_enhancement_torch.models import layers as tlayers
from image_restoration_and_enhancement_torch.models.unet import UNet2DCondition
from image_restoration_and_enhancement_torch.parallel import launch, serve
from image_restoration_and_enhancement_torch.parallel import mesh as tmesh
from image_restoration_and_enhancement_torch.parallel import sharding_rules as tsr
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.parallel import mesh as jax_mesh
from image_restoration_and_enhancement_tpu.parallel import sharding_rules as jsr
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (fixture)

ATOL = 2e-4
B, SIZE = 4, 128
SAMPLING = dict(num_inference_steps=3, strength=0.8, guidance_scale=5.0, sampler="ddim")
CACHE = dict(num_inference_steps=4, strength=1.0, guidance_scale=5.0, sampler="ddim",
             cfg_cache_interval=2)
WORLD = 8
# name -> (mesh shape, axis names, factory axes, sampling)
MESHES = {
    "dp": ((4, 2), ("data", "model"), {"data_axis": "data"}, SAMPLING),
    "dp_tp": ((4, 2), ("data", "model"), {"data_axis": "data", "model_axis": "model"}, SAMPLING),
    "tp4_heads_replicated": ((2, 4), ("data", "model"),
                             {"data_axis": "data", "model_axis": "model"}, SAMPLING),
    "dp_cfg_cache": ((4, 2), ("data", "model"), {"data_axis": "data"}, CACHE),
    "dp_tp_sp": ((2, 2, 2), ("data", "model", "sp"),
                 {"data_axis": "data", "model_axis": "model", "spatial_axis": "sp"}, SAMPLING),
}


def _jax_img2img(jm, params, image, ctx, unc, key, **kw):
    kw = dict(kw)
    steps, strength, gs, sampler = (kw.pop(k) for k in ("num_inference_steps", "strength",
                                                        "guidance_scale", "sampler"))
    fn = js.make_img2img_fn(jm, steps, strength, gs, sampler, cfg_layout="interleaved", **kw)
    return np.asarray(fn(params, image, ctx, unc, key))


def _noise(key, shape, n=2):
    return tuple(np.array(jax.random.normal(k, shape, jnp.float32))
                 for k in jax.random.split(key, n))


@pytest.fixture(scope="module")
def served():
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32, attention_backend="xla")
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=31)
    sd = {comp: tck.params_from_flax(jck.flatten_params(params[comp])) for comp in params}
    rng = np.random.default_rng(32)
    image = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    encode = jax.jit(lambda p, i: js.encode_text(jm, p, i))
    ctx = np.asarray(encode(params, jnp.asarray(rng.integers(3, 128, (B, 77)), jnp.int32)))
    unc = np.asarray(encode(params, jnp.asarray(rng.integers(3, 128, (B, 77)), jnp.int32)))
    key = jax.random.PRNGKey(33)
    lat = (B, SIZE // 8, SIZE // 8, 4)
    refs = {"dp": _jax_img2img(jm, params, image, ctx, unc, key, **SAMPLING)}
    # JAX's own sharded function on the conftest's 8 virtual CPU devices
    jmesh = jax_mesh.make_mesh((2, 2, 2), ("data", "model", "sp"))
    with jmesh:
        fn, shard = js.make_sharded_img2img_fn(
            jm, jmesh, SAMPLING["num_inference_steps"], SAMPLING["strength"],
            SAMPLING["guidance_scale"], SAMPLING["sampler"], model_axis="model",
            spatial_axis="sp")
        refs["jax_sharded"] = np.asarray(fn(shard(params), image, ctx, unc, key))
    # the UNet alone: batch 2 at an 8x8 latent, two timesteps
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    refs["unet"] = np.asarray(jax.jit(lambda p: jm.unet.apply({"params": p}, x, t, ctx[:2]))(
        params["unet"]))
    inputs = dict(image=image, ctx=ctx, uncond=unc, noise=_noise(key, lat))
    weights = {comp: {k: v.numpy() for k, v in d.items()} for comp, d in sd.items()}
    base = dict(config="tiny_sd", dtype="float32", weights=weights, backend="xla",
                inputs=inputs)
    cases = [dict(base, kind="img2img", mesh=(shape, names), axes=axes, sampling=samp)
             for shape, names, axes, samp in MESHES.values()]
    cases.append(dict(base, kind="unet", mesh=((4, 2), ("data", "model")),
                      axes={"model_axis": "model"}, inputs=dict(x=x, t=t, ctx=ctx[:2])))
    results = launch.launch(serve.run_cases, WORLD, "gloo", (cases,))
    return {"jm": jm, "params": params, "sd": sd, "refs": refs, "inputs": inputs,
            "ranks": results, "names": list(MESHES) + ["unet"]}


def _result(served, name, rank=0):
    return served["ranks"][rank][served["names"].index(name)]


@pytest.mark.parametrize("name", [n for n in MESHES if n != "dp_cfg_cache"])
def test_sharded_img2img_matches_jax(served, name):
    out = _result(served, name)["out"]
    assert out.shape == (B, SIZE, SIZE, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, served["refs"]["dp"], atol=ATOL, rtol=0)


def test_dp_tp_sp_matches_jax_sharded(served):
    """The port's (data 2, model 2, sp 2) serve against JAX's own
    make_sharded_img2img_fn on the same mesh shape of virtual devices."""
    np.testing.assert_allclose(_result(served, "dp_tp_sp")["out"], served["refs"]["jax_sharded"],
                               atol=ATOL, rtol=0)


def test_tp_forward_matches_jax(served):
    res = _result(served, "unet")
    np.testing.assert_allclose(res["out"], served["refs"]["unet"], atol=ATOL, rtol=0)
    assert res["collectives"].get("all_reduce", 0) > 0  # the row-parallel sums ran


def test_dp_makes_no_collective_in_the_loop(served):
    """Pure data parallelism: each image's CFG pair is on its rank, so the
    denoise loop calls no collective; the request gathers the output once."""
    for rank in range(WORLD):
        res = _result(served, "dp", rank)
        assert res["loop_collectives"] == 0
        assert res["collectives"] == {"all_gather": 1}
    assert _result(served, "dp_tp")["loop_collectives"] > 0  # the counter counts


@pytest.mark.parametrize("name", ["dp", "dp_cfg_cache"])
def test_dp_equals_unsharded_port(served, name):
    """Data parallelism alone serves each image on one rank as one device would:
    bitwise the port's unsharded function (the CFG cache included, whose
    unsharded loop ``test_torch_cfg_modes.py`` holds against JAX's)."""
    modules = ts.SDModules.create(TC.TINY_SD, torch.float32, "cpu", attention_backend="xla")
    for comp, m in modules.components().items():
        m.load_state_dict(served["sd"][comp])
    inp = {k: np.array(v) if k != "noise" else v for k, v in served["inputs"].items()}
    fn = ts.make_img2img_fn(modules, **MESHES[name][3], cfg_layout="interleaved")
    want = fn(torch.from_numpy(inp["image"]), torch.from_numpy(inp["ctx"]),
              torch.from_numpy(inp["uncond"]),
              noise=tuple(torch.from_numpy(np.array(n)) for n in inp["noise"])).numpy()
    if name == "dp":
        np.testing.assert_array_equal(_result(served, name)["out"], want)
    else:  # the cache's cond-only call runs at batch 1 against 4: CPU sums reorder
        np.testing.assert_allclose(_result(served, name)["out"], want, atol=ATOL, rtol=0)


def test_interleaved_matches_halves():
    """The two CFG layouts compute the same function: bitwise on one device."""
    modules = ts.SDModules.create(TC.TINY_SD, torch.float32, "cpu", attention_backend="xla")
    gen = torch.Generator().manual_seed(34)
    for m in modules.components().values():
        tlayers.init_random_(m, gen)
    image = torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
    ctx, unc = (torch.randn((2, 77, 16), generator=gen) for _ in range(2))
    noise = tuple(torch.randn((2, 8, 8, 4), generator=gen) for _ in range(2))
    for kw in (dict(sampler="ddim"), dict(sampler="plms", cfg_cache_interval=2)):
        halves = ts.make_img2img_fn(modules, 4, 0.8, 7.5, **kw)
        inter = ts.make_img2img_fn(modules, 4, 0.8, 7.5, cfg_layout="interleaved", **kw)
        assert torch.equal(halves(image, ctx, unc, noise=noise),
                           inter(image, ctx, unc, noise=noise))
    with pytest.raises(ValueError, match="cfg_layout"):
        ts.make_img2img_fn(modules, 4, 0.8, 7.5, cfg_layout="rows")(image, ctx, unc, noise=noise)


def _jax_name_to_port(path: str):
    """A flax param path -> (the port's state-dict name, is it transposed)."""
    name = next(iter(tck.params_from_flax({path: np.zeros((1, 1), np.float32)})))
    return name, path.endswith("/kernel")


def test_partition_rules_match_jax(served):
    """Every UNet and CLIP parameter shards on the port's names as JAX's
    PartitionSpecs say, kernels transposed: P(None, model) -> torch dim 0,
    P(model, None) -> dim 1, a sharded bias -> dim 0, P() -> replicated."""
    params = served["params"]
    n_sharded = 0
    for comp in ("unet", "text_encoder"):
        specs = jax.tree_util.tree_leaves_with_path(
            jsr.tree_partition_specs(params[comp]), is_leaf=lambda s: isinstance(s, P))
        flat = jck.flatten_params(params[comp])
        assert len(specs) == len(flat)
        for keypath, spec in specs:
            path = "/".join(k.key for k in keypath)
            name, _ = _jax_name_to_port(path)
            ndim = np.ndim(flat[path])
            want = {(): None, (None, "model"): 0, ("model", None): 1, ("model",): 0}[tuple(spec)]
            assert tsr.partition_dim(name, ndim) == want, (path, name, spec)
            n_sharded += want is not None
    assert n_sharded > 40


def test_geglu_half_split():
    """Rank r holds [hidden_r; gate_r] of GEGLU's [2 * inner, dim] projection:
    the ranks' row-parallel products sum to the full feed-forward. A
    contiguous split of the projection would not."""
    torch.manual_seed(35)
    ff = tlayers.GEGLUFeedForward(16)
    x = torch.randn(2, 5, 16)
    full = ff(x)
    sd = {f"ff.{k}": v for k, v in ff.state_dict().items()}

    def ranks(split):
        total = 0
        for r in range(2):
            w1, b1 = (split(f"ff.net.0.proj.{p}", sd[f"ff.net.0.proj.{p}"], r)
                      for p in ("weight", "bias"))
            w2 = tsr.shard_tensor("ff.net.2.weight", sd["ff.net.2.weight"], 2, r)
            h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            total = total + F.linear(h * F.gelu(gate, approximate="tanh"), w2)
        return total + sd["ff.net.2.bias"]

    with torch.no_grad():
        torch.testing.assert_close(ranks(lambda n, t, r: tsr.shard_tensor(n, t, 2, r)), full,
                                   atol=1e-6, rtol=1e-5)
        contiguous = ranks(lambda n, t, r: t.chunk(2, dim=0)[r])
    assert (contiguous - full).abs().max() > 1e-2


def test_replicated_sites():
    """Attention whose heads do not divide by the model axis stays whole:
    TINY_SD's 2 heads at tp 4; SDXL's 10 heads of level 1 at tp 4 (its 20
    heads of level 2 divide); none of SD-1.5's 8 at tp 2 or 4."""
    def unet(cfg):
        with torch.device("meta"):
            return UNet2DCondition(cfg.unet)

    tiny = unet(TC.TINY_SD)
    attn = {n for n, m in tiny.named_modules() if isinstance(m, tlayers.CrossAttention)}
    assert tsr.replicated_sites(tiny, 4) == attn and tsr.replicated_sites(tiny, 2) == set()
    sdxl = tsr.replicated_sites(unet(TC.SDXL), 4)
    assert sdxl and all(n.startswith(("down_blocks.1", "up_blocks.1")) for n in sdxl)
    assert tsr.replicated_sites(unet(TC.SD15), 4) == set()


def test_mesh_modes_not_ported_raise():
    """int8 and ToMe under a model mesh construct (ToMe is turned off under a
    spatial one); NCCL ranks need cards; launch takes an explicit backend; a
    batch must divide by the data axis."""
    fake = types.SimpleNamespace(device=torch.device("cpu"))
    pipe = RestorationPipeline(mesh=fake, model_axis="model", quant="int8")
    assert pipe.quant.mode == "int8"
    assert RestorationPipeline(mesh=fake, model_axis="model", tome_ratio=0.5).tome.active
    assert not RestorationPipeline(mesh=fake, spatial_axis="sp", tome_ratio=0.5).tome.active
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cards"):
            launch.launch(serve.run_cases, 2, "nccl", ([],))
    with pytest.raises(ValueError, match="backend"):
        launch.launch(serve.run_cases, 2, "mpi", ([],))
    data4 = types.SimpleNamespace(size=lambda axis: 4)
    assert tmesh.local_batch_size(8, data4) == 2
    with pytest.raises(ValueError, match="not divisible by data=4"):
        tmesh.local_batch_size(6, data4)
