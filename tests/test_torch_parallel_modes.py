"""int8 and ToMe serving under a mesh in the port, on gloo ranks on the CPU
(TINY_SD, fp32, ``attention_backend="xla"`` on both sides, as in
``tests/test_torch_parallel.py``).

The ranks (8, spawned once for the file) serve every case through
``parallel/serve.run_cases``. Cases:

- ``int8`` and ``int8_static`` img2img over data (4), data x tensor (4 x 2),
  data x height (4 x 2) and data x tensor x height (2 x 2 x 2):
  - every dynamic activation scale a rank makes equals, bit for bit, the scale
    of that activation's absmax over every axis of the mesh (the scale audit
    of ``parallel/serve.py``): the scales are the unsharded function's. The
    batch's first image spans [-1, 1] and the others a fifth of it, so the
    global absmax lies on data rank 0 and the other ranks' own absmaxes fall
    below it: a rank-local scale would be another function (the audit counts
    those calls);
  - data parallelism alone: bitwise the port's unsharded int8 function (each
    rank computes its images' rows of it);
  - every mesh: within the int8 noise of JAX's UNSHARDED int8 function
    (``quant_mode("int8")``, the "interleaved" CFG layout, the same weights
    and noise; int8_static: the port's unsharded function on the same
    table, which ``tests/test_torch_quant_serving.py`` holds against JAX's):
    the mean |difference| at most ``NOISE_FACTOR`` times the mean distance of
    JAX's int8 output from the full-precision one. Why no tighter bound: on
    this random TINY stack an fp32 difference of one ulp at a rounding
    boundary flips one s8 value, and the flip redraws the quantization noise
    of every later layer. Two correct implementations at batch 4 then differ
    by the noise itself (measured: the port's and JAX's unsharded int8
    functions 0.77 apart at 128 px, while every quantized layer of the port,
    fed JAX's input, agrees with JAX's op). The scale audit and the unit
    checks below are the tight int8 checks; the serve shows the mesh keeps the
    function's quality.
- a row-parallel ``QLinear`` over (data 4, model 2): bitwise the unsharded
  ``QLinear`` (s32 partial products summed, then dequantized once).
- the plain int8 attention (``int8_attention_reference``, K4's function) with
  local rows, local heads and local queries over (data 2, model 2, sp 2)
  against the unsharded call, within 1e-6 (the same s8 values and exact
  scores; P.V's fp32 sums over the same keys in blocks of another size).
- ``QConv2d`` (int8) under height sharding at shards of 8, 6 and 4 rows, the
  3x3 stride-1 conv (K3's plain version on s8 halo rows) and the stride-2
  downsample: bitwise the unsharded int8 conv.
- ToMe 0.5 (``IRET_TOME_MIN=64``, as ``tests/test_token_merge.py`` sets it)
  over an 8-rank data mesh against JAX's ``make_sharded_img2img_fn`` under
  ``tome_mode(0.5)`` on the conftest's 8 virtual devices, and over (data 4,
  model 2) against the port's unsharded ToMe serve.

Tolerance of the full-precision (ToMe) serves: 2e-4 absolute on images in
[-1, 1], the bound of ``test_torch_serving.py`` (the same fp32 sums in
another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.ops import quant as tq
from image_restoration_and_enhancement_torch.ops import token_merge as ttm
from image_restoration_and_enhancement_torch.parallel import launch, serve
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.ops import quant as jq
from image_restoration_and_enhancement_tpu.ops import token_merge as jtm
from image_restoration_and_enhancement_tpu.parallel import mesh as jax_mesh
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-4
ATTN_ATOL = 1e-6
NOISE_FACTOR = 2.0
B, SIZE = 4, 64
TOME_B, TOME_SIZE, TOME_MIN = 8, 64, 64
SAMPLING = dict(num_inference_steps=3, strength=0.8, guidance_scale=5.0, sampler="ddim")
WORLD = 8
MESHES = {
    "dp": ((4, 2), ("data", "model"), {"data_axis": "data"}),
    "dp_tp": ((4, 2), ("data", "model"), {"data_axis": "data", "model_axis": "model"}),
    "dp_sp": ((4, 2), ("data", "sp"), {"data_axis": "data", "spatial_axis": "sp"}),
    "dp_tp_sp": ((2, 2, 2), ("data", "model", "sp"),
                 {"data_axis": "data", "model_axis": "model", "spatial_axis": "sp"}),
}
MODES = ("int8", "int8_static")
CONV_ROWS = (8, 6, 4)


def _noise(key, shape, n=2):
    return tuple(np.array(jax.random.normal(k, shape, jnp.float32))
                 for k in jax.random.split(key, n))


def _port_stack(sd, quant=None, tome=None):
    tm = ts.SDModules.create(TC.TINY_SD, torch.float32, "cpu", attention_backend="xla")
    for comp, m in tm.components().items():
        m.load_state_dict(sd[comp])
    if quant:
        tm.set_quant(tq.QuantState(*quant))
    if tome:
        tm.set_tome(ttm.TomeState(*tome))
    return tm


def _port_img2img(tm, inputs, rows=slice(None)):
    fn = ts.make_img2img_fn(tm, **SAMPLING, cfg_layout="interleaved")
    t = lambda a: torch.from_numpy(np.array(a[rows]))  # noqa: E731
    return fn(t(inputs["image"]), t(inputs["ctx"]), t(inputs["uncond"]),
              noise=tuple(t(n) for n in inputs["noise"])).numpy()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32, attention_backend="xla")
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=64),
                            jax.random.PRNGKey(0))
    params = fill_params(shapes, seed=61)
    sd = {comp: tck.params_from_flax(jck.flatten_params(params[comp])) for comp in params}
    weights = {comp: {k: v.numpy() for k, v in d.items()} for comp, d in sd.items()}
    rng = np.random.default_rng(62)
    tm = _port_stack(sd)
    with torch.no_grad():
        ctx, unc = (ts.encode_text(tm, torch.from_numpy(rng.integers(3, 128, (B, 77)))).numpy()
                    for _ in range(2))
    image = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    image[1:] *= 0.2  # the global absmax lies in image 0, on data rank 0
    key = jax.random.PRNGKey(63)
    inputs = dict(image=image, ctx=ctx, uncond=unc, noise=_noise(key, (B, SIZE // 8, SIZE // 8, 4)))
    refs = {"fp32": _port_img2img(tm, inputs)}
    with jq.quant_mode("int8"):
        fn = js.make_img2img_fn(jm, SAMPLING["num_inference_steps"], SAMPLING["strength"],
                                SAMPLING["guidance_scale"], SAMPLING["sampler"],
                                cfg_layout="interleaved")
        refs["int8"] = np.asarray(fn(params, image, ctx, unc, key))
    # the static table: the port's calibration on the request (unsharded)
    calib = ts.make_calib_img2img_fn(tm, **SAMPLING)
    _, table = calib(*(torch.from_numpy(a) for a in (image, ctx, unc)),
                     noise=tuple(torch.from_numpy(n) for n in inputs["noise"]))
    refs["int8_static"] = _port_img2img(_port_stack(sd, ("int8_static", table)), inputs)
    refs["port_int8"] = _port_img2img(_port_stack(sd, ("int8", {})), inputs)

    # ToMe: JAX's sharded serve over 8 virtual devices (test_token_merge.py's)
    old = os.environ.get("IRET_TOME_MIN")
    os.environ["IRET_TOME_MIN"] = str(TOME_MIN)
    try:
        t_image = rng.uniform(-1, 1, (TOME_B, TOME_SIZE, TOME_SIZE, 3)).astype(np.float32)
        t_ctx = np.repeat(ctx[:1], TOME_B, axis=0)
        t_key = jax.random.PRNGKey(64)
        with jtm.tome_mode(0.5), jax_mesh.make_mesh((8,), ("data",)) as jmesh:
            fn, shard = js.make_sharded_img2img_fn(jm, jmesh, **SAMPLING)
            refs["tome_jax_sharded"] = np.asarray(fn(shard(params), t_image, t_ctx, t_ctx,
                                                     t_key))
    finally:
        if old is None:
            os.environ.pop("IRET_TOME_MIN")
        else:
            os.environ["IRET_TOME_MIN"] = old
    t_inputs = dict(image=t_image, ctx=t_ctx, uncond=t_ctx,
                    noise=_noise(t_key, (TOME_B, TOME_SIZE // 8, TOME_SIZE // 8, 4)))
    refs["tome"] = _port_img2img(_port_stack(sd, tome=(0.5, TOME_MIN)), t_inputs)

    base = dict(config="tiny_sd", dtype="float32", weights=weights, backend="xla",
                kind="img2img", sampling=SAMPLING, inputs=inputs)
    cases, names = [], []
    for mode in MODES:
        for mesh_name, (shape, axes_names, axes) in MESHES.items():
            cases.append(dict(base, mesh=(shape, axes_names), axes=axes, audit=True,
                              quant=(mode, table if mode == "int8_static" else {})))
            names.append(f"{mode}_{mesh_name}")
    cases.append(dict(base, mesh=((8,), ("data",)), axes={"data_axis": "data"},
                      tome=(0.5, TOME_MIN), inputs=t_inputs))
    names.append("tome_dp8")
    cases.append(dict(base, mesh=((4, 2), ("data", "model")),
                      axes={"data_axis": "data", "model_axis": "model"},
                      tome=(0.5, TOME_MIN), inputs=t_inputs))
    names.append("tome_dp_tp")
    cases.append(dict(kind="qlinear", mesh=((4, 2), ("data", "model")),
                      axes={"data_axis": "data", "model_axis": "model"},
                      inputs=dict(x=rng.standard_normal((4, 7, 64)).astype(np.float32),
                                  seed=65, out_features=48, quant="int8")))
    names.append("qlinear")
    qkv = {n: rng.standard_normal((4, 32, 4, 8)).astype(np.float32) for n in "qkv"}
    qkv["q"][0, 3, 1] *= 8.0  # the absmax of q on one rank's rows, heads and queries
    cases.append(dict(kind="int8_attention", mesh=((2, 2, 2), ("data", "model", "sp")),
                      axes={"data_axis": "data", "model_axis": "model", "spatial_axis": "sp"},
                      inputs=qkv))
    names.append("int8_attention")
    for rows in CONV_ROWS:
        x = rng.standard_normal((2, 2 * rows, 12, 16)).astype(np.float32)
        for geometry in ("stride1", "down"):
            cases.append(dict(kind="halo", mesh=((4, 2), ("data", "sp")),
                              axes={"spatial_axis": "sp"},
                              inputs=dict(x=x, seed=66 + rows, geometry=geometry,
                                          quant="int8")))
            names.append(f"conv_{geometry}_{rows}")
    results = launch.launch(serve.run_cases, WORLD, "gloo", (cases,))
    return {"sd": sd, "refs": refs, "ranks": results, "names": names, "table": table,
            "tome_inputs": t_inputs}


def _result(served, name, rank=0):
    return served["ranks"][rank][served["names"].index(name)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_img2img_over_a_mesh(served, mode, mesh):
    out = _result(served, f"{mode}_{mesh}")["out"]
    refs = served["refs"]
    assert out.shape == (B, SIZE, SIZE, 3) and np.isfinite(out).all()
    if mesh == "dp":
        want = refs["port_int8" if mode == "int8" else "int8_static"]
        np.testing.assert_array_equal(out, want)
    noise = float(np.abs(refs["int8"] - refs["fp32"]).mean())
    assert float(np.abs(out - refs[mode]).mean()) <= NOISE_FACTOR * noise


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_scales_are_global(served, mesh):
    """Every dynamic scale is the whole mesh's; on the ranks without image 0
    the rank-local absmax fell below it (int8: every site is dynamic;
    int8_static with a full table: none is)."""
    below = 0
    for rank in range(WORLD):
        audit = _result(served, f"int8_{mesh}", rank)["scale_audit"]
        assert audit["checked"] > 100 and audit["mismatched"] == 0
        below += audit["local_below"]
        assert _result(served, f"int8_static_{mesh}", rank)["scale_audit"]["checked"] == 0
    assert below > 0
    coll = _result(served, f"int8_{mesh}")["collectives"]
    assert coll.get("all_reduce_max", 0) > 0
    if "tp" in mesh:
        assert coll.get("all_reduce_s32", 0) > 0  # the row-parallel s8 products' sums


def test_row_parallel_qlinear_bitwise(served):
    out = _result(served, "qlinear")["out"]
    np.testing.assert_array_equal(out["sharded"], out["unsharded"])


def test_int8_attention_local_heads_and_queries(served):
    out = _result(served, "int8_attention")["out"]
    np.testing.assert_allclose(out["sharded"], out["unsharded"], atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("rows", CONV_ROWS)
@pytest.mark.parametrize("geometry", ["stride1", "down"])
def test_int8_conv_under_height_sharding(served, geometry, rows):
    assert _result(served, f"conv_{geometry}_{rows}")["out"] == 0.0


def test_tome_over_data_matches_jax_sharded(served):
    out = _result(served, "tome_dp8")["out"]
    assert out.shape == (TOME_B, TOME_SIZE, TOME_SIZE, 3)
    np.testing.assert_allclose(out, served["refs"]["tome_jax_sharded"], atol=ATOL, rtol=0)
    assert _result(served, "tome_dp8")["loop_collectives"] == 0  # merges are per image


def test_tome_over_model_matches_unsharded(served):
    np.testing.assert_allclose(_result(served, "tome_dp_tp")["out"], served["refs"]["tome"],
                               atol=ATOL, rtol=0)
