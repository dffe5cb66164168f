"""Multi-device training in the port (data and tensor parallelism, the sharded
train state) against the JAX package and the port's one-device step, on gloo
ranks on the CPU (TINY_SD, fp32, 64 px).

The ranks run ``parallel/train.run_cases`` (a function of the port: a rank
imports only the port), spawned once for the file on 8 gloo ranks, once on 4
for the restore into the smaller mesh, and twice on 2 for the trainers.
Cases, after ``tests/test_tensor_parallel.py``,
``tests/test_sampling_and_train.py`` and ``tests/test_mesh_reshape_restore.py``:

- the DP x TP gradients at (data 2, model 4) and (data 4, model 2) on
  ``test_tp_dp_train_step``'s inputs (batch 4, ``lambda_img`` 0, JAX's draws
  from ``PRNGKey(0)``) against JAX's unsharded ``jax.grad`` of
  ``make_loss_fn``, at that test's ``rtol=5e-3, atol=5e-5``. At model 4
  TINY_SD's 2 heads keep attention replicated; at model 2 it is sharded.
- the DP step over 8 ranks (the trainer's optimizer chain, 3 steps) against
  the port's one-device step, as ``test_train_step_data_parallel_mesh`` holds
  JAX's: the loss to ``rtol`` 1e-4 and the parameters within 1e-5; the masters
  bitwise equal across the 8 data ranks; one bucketed gradient all-reduce a
  micro-step (the collective counter), not one per tensor.
- a NaN planted in one data rank's rows over (data 4, model 2):
  ``apply_if_finite`` skips the step on every rank, and the next steps' clip
  decides alike (its global norm the same on all 8 ranks); after the third
  step (the first whose learning rate is not 0) the parameters equal the
  one-device run's within 1e-5.
- accumulation (k = 2) over 8 data ranks against one device, within 1e-5.
- the restore across a reshape: AdamW state saved from (data 4, model 2)
  after one step, restored into (data 2, model 2) on 4 ranks and on one
  device, one more step on each agreeing at ``rtol=2e-3, atol=1e-4`` (the
  JAX test's); the saved file is the one-device state.
- ``train_task`` and ``pretrain_vae`` on two gloo ranks against one device:
  the CSV's losses to 1e-4 relative, the saved UNet (VAE) within 1e-5, and
  rank 0 alone writing (one CSV row an epoch, one start line in the log).
- Adafactor under a model axis raises, naming the reason.

Tolerances beyond the JAX tests': 1e-5 absolute on parameters moved by
AdamW at learning rate 1e-3 from gradients that agree to fp32 rounding
(sums over the ranks in another order), as the JAX DP test states it. The
VAE's parameters within half its learning rate (1e-4): AdamW divides each
entry's gradient by its own RMS, so an entry whose gradient is near zero
moves by up to the learning rate on rounding noise alone (measured: 4 of the
1,152 entries of ``encoder.conv_out.weight`` 2.1e-5 apart; the JAX VAE step
test allows three learning rates for such an entry).
"""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_and_enhancement_torch import config as TC
from image_restoration_and_enhancement_torch.core import checkpoint as tck
from image_restoration_and_enhancement_torch.core import sampling as ts
from image_restoration_and_enhancement_torch.parallel import launch
from image_restoration_and_enhancement_torch.parallel import sharding_rules as tsr
from image_restoration_and_enhancement_torch.parallel import train as ptrain
from image_restoration_and_enhancement_torch.tasks.registry import get_task as t_get_task
from image_restoration_and_enhancement_torch.train import loop as tloop
from image_restoration_and_enhancement_torch.train import optim as toptim
from image_restoration_and_enhancement_torch.train import trainer as T
from image_restoration_and_enhancement_torch.train.vae_pretrain import (VAEPretrainConfig,
                                                                        pretrain_vae)
from image_restoration_and_enhancement_tpu import config as JC
from image_restoration_and_enhancement_tpu.core import checkpoint as jck
from image_restoration_and_enhancement_tpu.core import sampling as js
from image_restoration_and_enhancement_tpu.tasks.registry import get_task as j_get_task
from image_restoration_and_enhancement_tpu.train import loop as jloop
from test_torch_serving import fill_params, one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import jax_draws
from test_torch_trainer import data  # noqa: F401  (fixture)

SIZE = 64
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-5          # test_tp_dp_train_step's
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5         # test_train_step_data_parallel_mesh's
RESTORE_RTOL, RESTORE_ATOL = 2e-3, 1e-4    # test_mesh_reshape_restore's
CSV_RTOL = 1e-4
VAE_LR_FRACTION = 0.5  # of the VAE's learning rate, on its parameters (see below)
LR = 1e-3
WORLD = 8
TRAIN = dict(gradient_accumulation_steps=1, lambda_img=0.0)


def _batch(rng, b):
    return {"input": (rng.random((b, SIZE, SIZE, 3), np.float32) * 2 - 1),
            "gt": (rng.random((b, SIZE, SIZE, 3), np.float32) * 2 - 1)}


def _np_draws(draws):
    return {k: v.numpy() for k, v in draws.items()}


def _port_stack(sd):
    tm = ts.SDModules.create(TC.TINY_SD, dtype=torch.float32, device="cpu",
                             attention_backend="xla")
    for comp, mod in tm.components().items():
        mod.load_state_dict(sd[comp], strict=True)
    tm.freeze_all_but_unet()
    return tm


def _one_device(sd, case, restore=None):
    """The case's steps on one device in this process: (metrics, masters)."""
    tm = _port_stack(sd)
    cfg = tloop.TrainConfig(**case["train"])
    tx = ptrain._optimizer(case, cfg)
    state = tloop.TrainState.create(tm.unet, tx)
    if restore:
        assert T.restore_train_state(restore, state)
    step = tloop.make_train_step(tm, t_get_task("denoise"), cfg)
    ctx = torch.from_numpy(case["context"])
    metrics = []
    for s in case["steps"]:
        draws = {k: torch.as_tensor(v) for k, v in s["draws"].items()}
        metrics.append({k: float(v) for k, v in step(state, s["batch"], ctx, draws).items()})
    return metrics, {n: p.detach().numpy().copy() for n, p in state.params.items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jm = js.SDModules.create(JC.TINY_SD, dtype=jnp.float32, attention_backend="xla")
    shapes = jax.eval_shape(lambda k: js.init_params(jm, k, image_size=SIZE),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, fill_params(shapes, seed=51))
    sd = {comp: tck.params_from_flax(jck.flatten_params(params[comp])) for comp in params}
    weights = {comp: {k: v.numpy() for k, v in d.items()} for comp, d in sd.items()}
    with torch.no_grad():  # the port's encoder (held against JAX's elsewhere)
        ctx = ts.encode_text(_port_stack(sd), torch.zeros((1, 77), dtype=torch.long)).numpy()

    # test_tp_dp_train_step's batch and key; JAX's unsharded gradients
    rng = np.random.default_rng(0)
    batch4 = _batch(rng, 4)
    key = jax.random.PRNGKey(0)
    jspec = dataclasses.replace(j_get_task("denoise"), model_config=JC.TINY_SD)
    jloss = jloop.make_loss_fn(jm, jspec, jloop.TrainConfig(**TRAIN))
    ref_grads = jax.jit(jax.grad(lambda p, f, b, c, k: jloss(p, f, b, c, k)[0]))(
        params["unet"], {"vae": params["vae"]}, jax.tree_util.tree_map(jnp.asarray, batch4),
        jnp.asarray(ctx), key)
    ref_grads = tck.params_from_flax({k: np.asarray(v) for k, v in
                                      jck.flatten_params(ref_grads).items()})

    def steps(n, b, seed, plant=None):
        r = np.random.default_rng(seed)
        out = []
        for i in range(n):
            bt = _batch(r, b)
            if plant is not None and i == 0:
                bt["input"][plant] = np.nan
            out.append({"batch": bt, "draws": _np_draws(jax_draws(jm, jax.random.PRNGKey(seed + i),
                                                                  b))})
        return out

    base = dict(config="tiny_sd", dtype="float32", weights=weights, backend="xla",
                task="denoise", context=ctx, lr=LR, full=True)
    jax_step = [{"batch": batch4, "draws": _np_draws(jax_draws(jm, key, 4))}]
    state_dir = str(tmp_path_factory.mktemp("state"))
    lin = {"input": np.linspace(-1, 1, 4 * SIZE * SIZE * 3, dtype=np.float32).reshape(
               4, SIZE, SIZE, 3),
           "gt": np.linspace(1, -1, 4 * SIZE * SIZE * 3, dtype=np.float32).reshape(
               4, SIZE, SIZE, 3)}
    restore_steps = [{"batch": lin, "draws": _np_draws(jax_draws(jm, jax.random.PRNGKey(7), 4))}]
    config_opt = dict(optimizer="config", num_steps=10)
    cases = {
        "tp24": dict(base, mesh=((2, 4), ("data", "model")), train=TRAIN, optimizer="adamw",
                     steps=jax_step),
        "tp42": dict(base, mesh=((4, 2), ("data", "model")), train=TRAIN, optimizer="adamw",
                     steps=jax_step),
        "dp8": dict(base, **config_opt, mesh=((8,), ("data",)), train=TRAIN,
                    steps=steps(3, 8, 100)),
        # rows 2-3 lie on data rank 1 of (data 4, model 2)
        "nan": dict(base, **config_opt, mesh=((4, 2), ("data", "model")), train=TRAIN,
                    steps=steps(3, 8, 200, plant=slice(2, 4))),
        "accum": dict(base, **config_opt, mesh=((8,), ("data",)),
                      train=dict(TRAIN, gradient_accumulation_steps=2), steps=steps(4, 8, 300)),
        "save42": dict(base, mesh=((4, 2), ("data", "model")), train=TRAIN, optimizer="adamw",
                       steps=restore_steps, save=state_dir),
    }
    ranks = launch.launch(ptrain.run_cases, WORLD, "gloo", (list(cases.values()),))
    results = {name: [r[i] for r in ranks] for i, name in enumerate(cases)}
    # the restore: one more step from the saved state on (data 2, model 2)
    more = dict(base, mesh=((2, 2), ("data", "model")), train=TRAIN, optimizer="adamw",
                steps=[{"batch": lin, "draws": restore_steps[0]["draws"]}], restore=state_dir)
    results["restore22"] = [r[0] for r in launch.launch(ptrain.run_cases, 4, "gloo",
                                                        ([more],))]
    cases["restore22"] = more
    return {"jm": jm, "sd": sd, "cases": cases, "ranks": results, "ref_grads": ref_grads,
            "state_dir": state_dir}


@pytest.mark.parametrize("name", ["tp24", "tp42"])
def test_dp_tp_grads_match_jax(trained, name):
    got = trained["ranks"][name][0]["grads"]
    ref = trained["ref_grads"]
    assert set(got) == set(ref)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    # the row-parallel sums and the column inputs' gradient sums ran
    coll = trained["ranks"][name][0]["collectives"]
    assert coll.get("all_reduce", 0) > 0 and coll.get("grad_bucket", 0) == 1


def _held_against_one_device(trained, name):
    ranks = trained["ranks"][name]
    metrics, params = _one_device(trained["sd"], trained["cases"][name])
    for got, want in zip(ranks[0]["metrics"], metrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for n, want in params.items():
        np.testing.assert_allclose(ranks[0]["params"][n], want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=n)
    return ranks, metrics


def test_dp_step_matches_one_device(trained):
    _held_against_one_device(trained, "dp8")


def test_dp_masters_bitwise_equal_across_ranks(trained):
    """After 3 steps every data rank holds the same masters, bit for bit."""
    prints = {r["fingerprint"] for r in trained["ranks"]["dp8"]}
    assert len(prints) == 1
    # and the fingerprint sees a difference of one bit
    p = {"w": torch.ones(4)}
    q = {"w": torch.ones(4)}
    q["w"].view(torch.int32)[2] += 1
    assert ptrain.fingerprint(p) != ptrain.fingerprint(q)


def test_dp_gradients_all_reduce_in_buckets(trained):
    """One bucketed gradient all-reduce a micro-step, not one per tensor."""
    n_tensors = len(trained["sd"]["unet"])
    for r in trained["ranks"]["dp8"]:
        assert r["collectives"]["grad_bucket"] == 3 < n_tensors


def test_nan_in_one_rank_skips_everywhere(trained):
    ranks, metrics = _held_against_one_device(trained, "nan")
    assert not np.isfinite(metrics[0]["loss"])
    for r in ranks:
        assert not np.isfinite(r["metrics"][0]["loss"])
        # the next steps' clip sees the same global norm on every rank
        for i in (1, 2):
            assert r["metrics"][i]["grad_norm"] == ranks[0]["metrics"][i]["grad_norm"]
    assert ranks[0]["metrics"][1]["grad_norm"] > 1.0  # so the clip acted
    start = trained["sd"]["unet"]["conv_in.weight"].numpy()
    assert not np.array_equal(ranks[0]["params"]["conv_in.weight"], start)


def test_accumulation_over_dp(trained):
    _held_against_one_device(trained, "accum")


def test_restore_across_mesh_reshape(trained):
    """Saved from (data 4, model 2), restored into (data 2, model 2) and
    into one device: one more AdamW step agrees."""
    saved = torch.load(os.path.join(trained["state_dir"], T.STATE_FILE), weights_only=True)
    assert saved["step"] == 1
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(t.shape) for n, t in trained["sd"]["unet"].items()}
    case = trained["cases"]["restore22"]
    metrics, params = _one_device(trained["sd"], case, restore=trained["state_dir"])
    got = trained["ranks"]["restore22"][0]
    assert got["metrics"][0]["loss"] == pytest.approx(metrics[0]["loss"], abs=RESTORE_ATOL)
    for n, want in params.items():
        np.testing.assert_allclose(got["params"][n], want, rtol=RESTORE_RTOL,
                                   atol=RESTORE_ATOL, err_msg=n)
    # the saved state is the first step's: its masters moved from the start
    start = trained["sd"]["unet"]["conv_in.weight"].numpy()
    assert not np.array_equal(saved["params"]["conv_in.weight"].numpy(), start)


def test_adafactor_refuses_a_model_axis():
    tx = toptim.Optimizer("adafactor", lambda c: 1e-3)
    with pytest.raises(NotImplementedError, match="Adafactor.*model axis"):
        tx.shard(tsr.TrainSharding(None, 2, 0, {}))
    tx.shard(tsr.TrainSharding(None, 1, 0, {}))  # a model axis of one is no axis
    toptim.Optimizer("adamw", lambda c: 1e-3).shard(tsr.TrainSharding(None, 2, 0, {}))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_task_on_two_ranks(data, tmp_path):  # noqa: F811
    cfg = tloop.TrainConfig(
        batch_size=2, gradient_accumulation_steps=1, lambda_img=0.05, image_size=SIZE,
        save_steps=-1, learning_rate=LR, num_epochs=2, state_save_epochs=0)
    runs = {}
    for name, kw in (("one", dict(use_mesh=False)), ("two", dict(num_devices=2))):
        out = tmp_path / name
        runs[name] = T.train_task("denoise", data_root=data["pairs"], output_dir=str(out),
                                  cfg=cfg, dtype=torch.float32,
                                  model_config=TC.TINY_SD, device="cpu", **kw)
    one, two = (_rows(tmp_path / n / "metrics_denoise.csv") for n in ("one", "two"))
    assert [r["epoch"] for r in two] == ["1", "2"]  # rank 0 alone writes
    for a, b in zip(one, two):
        assert float(b["train_loss"]) == pytest.approx(float(a["train_loss"]), rel=CSV_RTOL)
    log = open(tmp_path / "two" / "training_denoise.log").read()
    assert log.count("=== training denoise") == 1
    assert "data-parallel mesh over 2 devices" in log
    u1, u2 = (tck.load_state_dicts(str(tmp_path / n / "final"))["unet"] for n in ("one", "two"))
    for k in u1:
        np.testing.assert_allclose(u2[k].float().numpy(), u1[k].float().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    assert np.isfinite(runs["two"]["psnr"])
    assert T.latest_step(str(tmp_path / "two" / "train_state")) == 4


def test_pretrain_vae_on_two_ranks(data, tmp_path):  # noqa: F811
    cfg = VAEPretrainConfig(num_epochs=1, batch_size=2, image_size=SIZE)
    for name, kw in (("one", dict(use_mesh=False)), ("two", dict(num_devices=2))):
        pretrain_vae(data["clean"], str(tmp_path / name), cfg, model_config=TC.TINY_SD,
                     dtype=torch.float32, device="cpu", **kw)
    one, two = (_rows(tmp_path / n / "metrics_vae.csv") for n in ("one", "two"))
    assert len(two) == 1
    assert float(two[0]["train_loss"]) == pytest.approx(float(one[0]["train_loss"]),
                                                        rel=CSV_RTOL)
    v1, v2 = (tck.load_state_dicts(str(tmp_path / n / "final"))["vae"] for n in ("one", "two"))
    for k in v1:
        np.testing.assert_allclose(v2[k].float().numpy(), v1[k].float().numpy(),
                                   atol=VAE_LR_FRACTION * cfg.learning_rate, rtol=0, err_msg=k)
