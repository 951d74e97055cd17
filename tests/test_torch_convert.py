"""The checkpoint converter (``tools/convert_checkpoint.py``) between the
JAX trainer's orbax ``step_N`` and the port trainer's ``step_N/*.npz``,
on the CPU.

- Leaf for leaf: a JAX trainer state (after three optimizer updates, so
  every moment and counter is live) saved by the JAX package converts to
  the port's files holding exactly its values, and back to an orbax tree
  bit-identical to the original, for one device with clip and cosine,
  ``--accum-steps 2`` (mid-accumulation), ``--moe-experts 4`` and the
  dp×pp×tp pipeline's split tree.
- One step on each side: from the two sides of a conversion, one step of
  the port's ``make_train_step`` and one of the JAX step (f32) give
  losses within 2e-4 and params within test_torch_train's bound for
  params after steps (rtol 1e-3, atol 1e-5).
- Through the CLIs (bf16, as the trainers run): the JAX trainer's
  checkpoint is resumed by the port's trainer and read by the port's
  ``generate``, and a port checkpoint is resumed by the JAX trainer.
  Both resumed runs train on the same crops of ``data/corpus.bin`` as the
  uninterrupted run on the other side (the loader streams are equal),
  and their step-20 losses agree within ``CLI_LOSS_TOL``.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import checkpoint as jax_checkpoint  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import pipeline as jax_pipeline  # noqa: E402
from tpu_autoscaler_torch.workloads import checkpoint, model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "convert_checkpoint", os.path.join(REPO, "tools",
                                       "convert_checkpoint.py"))
convert = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert)

ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16)
LOSS_TOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
# bf16 products on both sides, ten steps from the same state on the same
# batches: the step-20 losses of the two trainers differ by bf16
# rounding in XLA's and PyTorch's CPU kernels (measured below 2e-3).
CLI_LOSS_TOL = 2e-3

CASES = {
    "one-device-clip-cosine": (
        {}, {"grad_clip": 1.0, "warmup_steps": 2, "decay_steps": 10},
        False),
    "accum2": ({}, {"accum_steps": 2}, False),
    "moe4": ({"moe_experts": 4}, {}, False),
    "pp2-split": ({}, {"warmup_steps": 2}, True),
}


def _jax_state(arch_kw, train_kw, split):
    """A JAX trainer state for these flags after three optax updates with
    seeded random gradients (bf16 compute, f32 leaves as saved)."""
    cfg = jax_model.ModelConfig(**ARCH, **arch_kw)
    tcfg = jax_model.TrainConfig(**train_kw)
    params = jax_model.init_params(jax.random.PRNGKey(0), cfg)
    if split:
        params = jax_pipeline.split_qkv_weights(params, cfg)
    tx = jax_model.make_optimizer(tcfg)
    opt = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), params)
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return cfg, tcfg, {"params": params, "opt": opt}


@pytest.fixture(params=list(CASES), scope="module")
def converted(request, tmp_path_factory):
    """(case, cfg, TrainConfig, split, the JAX state, its orbax dir, the
    port dir converted from it)."""
    arch_kw, train_kw, split = CASES[request.param]
    cfg, tcfg, state = _jax_state(arch_kw, train_kw, split)
    root = tmp_path_factory.mktemp(request.param)
    jax_checkpoint.save_checkpoint(str(root / "jax"), 3, state)
    convert.jax_to_torch(str(root / "jax"), str(root / "torch"), 3, cfg,
                         tcfg, split)
    return request.param, cfg, tcfg, split, state, root


def _port_key(path) -> str:
    return "/".join(str(k.key) for k in path)


def test_jax_to_torch_is_leaf_for_leaf(converted):
    """params.npz and opt.npz hold the orbax tree's values exactly, in
    the port's layout (the split qkv merged), and the port's trainer
    restores them."""
    case, cfg, tcfg, split, state, root = converted
    want = {"params": state["params"]}
    fields = convert.opt_fields(jax.tree.map(np.asarray, state["opt"]))
    want.update({k: v for k, v in fields.items() if isinstance(v, dict)})
    if split:
        want = {k: jax_pipeline.merge_qkv_weights(v, cfg)
                for k, v in want.items()}
    files = {}
    for name in ("params", "opt"):
        with np.load(root / "torch" / "step_3" / f"{name}.npz") as npz:
            files[name] = {k: npz[k] for k in npz.files}
    expected = {"params": {}, "opt": {}}
    for tree, value in want.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(value)[0]:
            key = _port_key(path)
            if tree == "params":
                expected["params"][key] = np.asarray(leaf)
            else:
                expected["opt"][f"{tree}/{key}"] = np.asarray(leaf)
    counters = {k: v for k, v in fields.items() if not isinstance(v, dict)}
    assert counters["count"] == (1 if case == "accum2" else 3)
    if case == "accum2":
        assert (counters["mini_step"], counters["gradient_step"]) == (1, 1)
    else:
        assert set(counters) == {"count"}
    for name, value in counters.items():
        expected["opt"][name] = np.asarray(value, np.int64)
    for name in ("params", "opt"):
        assert sorted(files[name]) == sorted(expected[name]), name
        for key, leaf in expected[name].items():
            assert files[name][key].dtype == leaf.dtype, key
            np.testing.assert_array_equal(files[name][key], leaf,
                                          err_msg=key)
    restored = checkpoint.restore_checkpoint(str(root / "torch"), 3, "cpu")
    tcfg_port = model.TrainConfig(**{f: getattr(tcfg, f) for f in (
        "warmup_steps", "decay_steps", "grad_clip", "accum_steps")})
    opt = model.make_optimizer(tcfg_port).init(restored["params"])
    assert set(restored["opt"]) == set(opt)
    shapes = model.param_shapes(model.ModelConfig(
        **ARCH, moe_experts=cfg.moe_experts))
    assert model._map_tree(lambda t: tuple(t.shape), restored["params"]) \
        == shapes


def test_round_trip_is_bit_identical(converted, tmp_path):
    """jax -> torch -> jax restores, against the JAX trainer's own target
    for the flags, the saved tree: the same structure (optax state types
    included), dtypes and bits."""
    _, cfg, tcfg, split, state, root = converted
    convert.torch_to_jax(str(root / "torch"), str(tmp_path), 3, cfg, tcfg,
                         split)
    back = jax_checkpoint.restore_checkpoint(
        str(tmp_path), 3, convert.jax_target(cfg, tcfg, split))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(state)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


def _jax_step(cfg, tcfg, split, state):
    """The JAX trainer's step for these flags (f32), with ``state`` put on
    its shardings: the one-device mesh, or the (data 1, pp 2, model 1)
    mesh of two virtual devices for the split tree."""
    if split:
        mesh = jax_pipeline.make_pipeline_mesh(jax.devices()[:2], pp=2,
                                               tp=1)
        init, step = jax_pipeline.make_pipeline_train_step(
            mesh, cfg, num_microbatches=2, train=tcfg)
    else:
        mesh = jax_model.make_mesh(jax.devices()[:1])
        init, step = jax_model.make_sharded_train_step(mesh, cfg,
                                                       train=tcfg)
    like = {"params": None, "opt": None}
    like["params"], like["opt"] = init(jax.random.PRNGKey(0))
    state = jax.tree.map(lambda x, ref: jax.device_put(x, ref.sharding),
                         state, like)
    return step, state


def test_one_step_on_each_side_agrees(converted):
    """One step of the port's make_train_step from the converted files
    against one JAX step from the orbax tree, same batch, f32."""
    case, cfg, tcfg, split, _, root = converted
    jcfg = jax_model.ModelConfig(**{**ARCH, "moe_experts": cfg.moe_experts,
                                    "dtype": jnp.float32,
                                    "attention": "einsum"})
    target = convert.jax_target(cfg, tcfg, split)
    jstate = jax_checkpoint.restore_checkpoint(str(root / "jax"), 3, target)
    step, jstate = _jax_step(jcfg, tcfg, split, jstate)
    tokens = np.random.default_rng(8).integers(
        0, ARCH["vocab"], (4, ARCH["seq_len"] + 1)).astype(np.int32)
    jparams, _, jloss = step(jstate["params"], jstate["opt"],
                             jnp.asarray(tokens))
    if split:
        jparams = jax_pipeline.merge_qkv_weights(jparams, jcfg)
    tcfg_port = model.TrainConfig(**{f: getattr(tcfg, f) for f in (
        "warmup_steps", "decay_steps", "grad_clip", "accum_steps")})
    state = checkpoint.restore_checkpoint(str(root / "torch"), 3, "cpu")
    _, tstep = model.make_train_step(
        model.ModelConfig(**ARCH, moe_experts=cfg.moe_experts,
                          dtype=torch.float32),
        train=tcfg_port, device="cpu")
    tparams, topt, tloss = tstep(state["params"], state["opt"], tokens)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=case)
    want = dict(model._flatten(jax.tree.map(np.asarray, jparams)))
    for path, t in model._flatten(tparams):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{case} {path}")
    assert topt["count"] == (2 if case == "accum2" else 4)


def test_converter_refusals(tmp_path):
    runner = CliRunner()
    res = runner.invoke(convert.main, ["--from", str(tmp_path), "--to",
                                       str(tmp_path), "--direction",
                                       "jax-to-torch"])
    assert res.exit_code == 2 and "--to must differ" in res.output
    res = runner.invoke(convert.main, ["--from", str(tmp_path / "none"),
                                       "--to", str(tmp_path / "out"),
                                       "--direction", "torch-to-jax"])
    assert res.exit_code == 2 and "no step_N checkpoint" in res.output
    (tmp_path / "src" / "step_4").mkdir(parents=True)
    res = runner.invoke(convert.main, ["--from", str(tmp_path / "src"),
                                       "--to", str(tmp_path / "out"),
                                       "--direction", "torch-to-jax",
                                       "--step", "5"])
    assert res.exit_code == 2 and "no step_5" in res.output
    assert not (tmp_path / "out").exists()


def test_a_tree_the_flags_do_not_give_is_refused(tmp_path):
    """A port checkpoint of another width, converted under these flags,
    is refused before anything is written."""
    cfg = model.ModelConfig(**{**ARCH, "d_model": 48})
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    checkpoint.save_checkpoint(str(tmp_path / "torch"), 1,
                               {"params": params, "opt": opt})
    with pytest.raises(ValueError, match="where the flags give"):
        convert.torch_to_jax(str(tmp_path / "torch"), str(tmp_path / "jax"),
                             1, jax_model.ModelConfig(**ARCH),
                             jax_model.TrainConfig(), False)
    assert not (tmp_path / "jax").exists()


# -- through the CLIs --------------------------------------------------

CLI_ARCH = ["--vocab", "8192", "--d-model", "64", "--n-layers", "2",
            "--seq-len", "64"]
CLI_TRAIN = ["--batch", "8", "--data-file",
             os.path.join(REPO, "data", "corpus.bin"), "--grad-clip", "1.0",
             "--lr-schedule", "cosine", "--warmup-steps", "2", "--steps",
             "20", "--checkpoint-every", "10"]
CONVERT_FLAGS = CLI_ARCH + ["--grad-clip", "1.0", "--lr-schedule", "cosine",
                            "--warmup-steps", "2", "--steps", "20"]


def _env():
    # One JAX device: the JAX trainer's mesh is then dp 1 x tp 1, as the
    # port's on one device.
    return {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}


def _trainer(package, ckpt):
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.workloads.train", "--platform",
         "cpu", *CLI_ARCH, *CLI_TRAIN, "--checkpoint-dir", str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_env())


def _finish(proc, what):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"{what}:\n{err[-3000:]}"
    return err


def _loss(log: str, step: int) -> float:
    return float(re.search(rf"step {step} loss ([0-9.]+)", log).group(1))


def test_cli_checkpoints_cross_between_the_trainers(tmp_path):
    """The JAX trainer and the port's each train 20 steps on
    data/corpus.bin (checkpoints at 10 and 20); each one's step 10 is
    converted by the converter's CLI and resumed by the other trainer to
    step 20, whose loss must equal the uninterrupted run's within
    CLI_LOSS_TOL; the port's generate CLI reads the converted JAX
    checkpoint."""
    jax_run = _trainer("tpu_autoscaler", tmp_path / "jax")
    port_run = _trainer("tpu_autoscaler_torch", tmp_path / "port")
    jax_log = _finish(jax_run, "JAX trainer")
    port_log = _finish(port_run, "port trainer")
    assert "(NativeTokenLoader loader)" in port_log
    runner = CliRunner()
    for src, dst, direction in (("jax", "to_port", "jax-to-torch"),
                                ("port", "to_jax", "torch-to-jax")):
        res = runner.invoke(convert.main, [
            "--from", str(tmp_path / src), "--to", str(tmp_path / dst),
            "--direction", direction, "--step", "10", *CONVERT_FLAGS])
        assert res.exit_code == 0, res.output
        assert f"converted step 10 ({direction})" in res.output
    assert sorted(os.listdir(tmp_path / "jax")) == ["step_10", "step_20"]
    gen = subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.generate",
         "--platform", "cpu", *CLI_ARCH, "--checkpoint-dir",
         str(tmp_path / "to_port"), "--prompt", "1,2,3", "--batch", "2",
         "--steps", "4"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env=_env())
    assert gen.returncode == 0, gen.stderr
    assert "loaded step 10" in gen.stderr
    assert len(gen.stdout.strip().splitlines()) == 2
    port_resumed = _trainer("tpu_autoscaler_torch", tmp_path / "to_port")
    jax_resumed = _trainer("tpu_autoscaler", tmp_path / "to_jax")
    for log, resumed, what in (
            (jax_log, _finish(port_resumed, "port trainer resumed"),
             "port from JAX"),
            (port_log, _finish(jax_resumed, "JAX trainer resumed"),
             "JAX from port")):
        assert "resumed from checkpoint step 10" in resumed, what
        assert "training complete at step 20" in resumed, what
        assert "step 10 loss" not in resumed, what
        assert abs(_loss(resumed, 20) - _loss(log, 20)) <= CLI_LOSS_TOL, (
            what, _loss(resumed, 20), _loss(log, 20))
