"""The port's multi-host bootstrap (``workloads/distributed.py``) and the
trainer's multi-process data parallelism against the JAX package's, on
the CPU.

``parse_gke_tpu_env`` must equal JAX's field for field on every env;
``make_multislice_mesh`` must have JAX's shape, batch spec and error;
five ``make_sharded_train_step`` steps on the (dcn 2, data 2, model 2)
mesh of ``["cpu"] * 8`` in each shard mode are held to JAX's on its 8
virtual CPU devices (``test_torch_mesh.py``'s tolerances: losses 1e-3
relative, params rtol 1e-3 / atol 1e-5).  Two processes joined by gloo
on the CPU, each on its half of the batch, must train the model of the
one-process dp 2 mesh on the whole batch: losses within 2e-5 and params
within 2e-4 after three steps (f32; the two runs sum the same
gradients in another order).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import (  # noqa: E402
    distributed as jax_distributed,
    model as jax_model,
    train as jax_train,
)
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    distributed,
    model,
)
from tpu_autoscaler_torch.workloads import train as train_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16)
STEP_LOSS_RTOL = 1e-3
PROC_LOSS_TOL = 2e-5
PROC_PARAM_TOL = 2e-4
TIMEOUT_S = 120

ENVS = {
    "none": {},
    "single-slice": {"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3",
                     "TPU_WORKER_ID": "2"},
    "slice-0": {"TPU_WORKER_HOSTNAMES": "a0,a1", "TPU_WORKER_ID": "1",
                "MEGASCALE_SLICE_ID": "0", "MEGASCALE_NUM_SLICES": "2"},
    "slice-1": {"TPU_WORKER_HOSTNAMES": "b0,b1", "TPU_WORKER_ID": "1",
                "MEGASCALE_SLICE_ID": "1", "MEGASCALE_NUM_SLICES": "2"},
    "jobset-index": {"TPU_WORKER_HOSTNAMES": "w0", "TPU_WORKER_ID": "0",
                     "JOB_COMPLETION_INDEX": "1",
                     "MEGASCALE_NUM_SLICES": "2"},
    "blank-megascale": {"TPU_WORKER_HOSTNAMES": "h0,h1,,",
                        "TPU_WORKER_ID": "1", "MEGASCALE_SLICE_ID": "",
                        "MEGASCALE_NUM_SLICES": "",
                        "JOB_COMPLETION_INDEX": "3"},
    "no-worker-id": {"TPU_WORKER_HOSTNAMES": "h0,h1",
                     "MEGASCALE_NUM_SLICES": "3"},
}


def _np(t):
    return t.detach().cpu().numpy()


def _free_port() -> int:
    """A port nothing listens on (bound to 0 and released), so runs in
    parallel never share one."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---- the env contract ----------------------------------------------------


@pytest.mark.parametrize("name", list(ENVS))
def test_parse_gke_tpu_env_equals_jax(name):
    want = jax_distributed.parse_gke_tpu_env(ENVS[name])
    got = distributed.parse_gke_tpu_env(ENVS[name])
    if want is None:
        assert got is None
        return
    assert {f: getattr(got, f) for f in want.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}
    assert got.single_process == want.single_process


def test_parse_reads_os_environ(monkeypatch):
    for key, value in ENVS["slice-1"].items():
        monkeypatch.setenv(key, value)
    assert distributed.parse_gke_tpu_env() == distributed.HostTopology(
        coordinator="b0:8476", num_processes=4, process_id=3, slice_id=1,
        num_slices=2)


@pytest.mark.parametrize("env", [{}, {"TPU_WORKER_HOSTNAMES": "only"}],
                         ids=["no-contract", "one-host"])
def test_initialize_from_env_does_nothing_for_one_process(env):
    topo = distributed.initialize_from_env(env)
    want = jax_distributed.initialize_from_env(env)
    assert topo.single_process and want.single_process
    assert (topo.num_processes, topo.process_id) == (
        want.num_processes, want.process_id)
    assert not torch.distributed.is_initialized()


# ---- the multi-slice mesh -----------------------------------------------


def test_multislice_mesh_matches_jax():
    jmesh = jax_distributed.make_multislice_mesh(num_slices=2, model=2)
    tmesh = distributed.make_multislice_mesh(2, model=2,
                                             devices=["cpu"] * 8)
    assert dict(tmesh.shape) == dict(jmesh.shape) == {
        "dcn": 2, "data": 2, "model": 2}
    assert tmesh.axis_names == jmesh.axis_names
    assert tuple(model.batch_spec(tmesh)) == tuple(
        jax_model.batch_spec(jmesh)) == (("dcn", "data"), None)
    assert model.data_axes(tmesh) == jax_model.data_axes(jmesh)
    assert tmesh.coords(5) == {"dcn": 1, "data": 0, "model": 1}
    assert model.mesh_rows(tmesh) == [[torch.device("cpu")] * 2] * 4


def test_multislice_mesh_refusal_matches_jax():
    with pytest.raises(ValueError) as want:
        jax_distributed.make_multislice_mesh(num_slices=3, model=2)
    with pytest.raises(ValueError) as got:
        distributed.make_multislice_mesh(3, model=2, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)


def test_multislice_mesh_needs_cuda_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        distributed.make_multislice_mesh(2)


@pytest.mark.parametrize("shard", ["none", "zero1", "fsdp"])
def test_multislice_train_steps_match_jax(shard):
    """Five make_sharded_train_step steps on (dcn 2, data 2, model 2)
    against JAX's on make_multislice_mesh(2, model=2), from the same
    params and batches; zero1 and fsdp cut over both data axes."""
    jcfg = jax_model.ModelConfig(**ARCH, dtype=jnp.float32)
    tcfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    jmesh = jax_distributed.make_multislice_mesh(num_slices=2, model=2)
    tmesh = distributed.make_multislice_mesh(2, model=2,
                                             devices=["cpu"] * 8)
    jinit, jstep = jax_model.make_sharded_train_step(jmesh, jcfg,
                                                     shard=shard)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    _, tstep = model.make_sharded_train_step(tmesh, tcfg, shard=shard)
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    tparams = model.shard_params(tmesh, tcfg, tparams, shard)
    topt = model.shard_opt_state(tmesh, tcfg, topt, shard)
    if shard != "none":
        assert tuple(topt["mu"]["blocks"]["qkv"].spec) == (
            None, ("dcn", "data"), "model")
    for step in range(5):
        tokens = np.random.default_rng(30 + step).integers(
            0, ARCH["vocab"], (8, ARCH["seq_len"] + 1)).astype(np.int32)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for path, t in model._flatten(model.gather_params(tmesh, tparams)):
        np.testing.assert_allclose(_np(t), want[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)


# ---- two processes --------------------------------------------------------


def test_synthetic_rows_are_the_jax_trainers_stream():
    """The trainer's rows of process p at step s: the JAX trainer's
    ``default_rng((step << 16) | process_id)`` draw (its train.py
    batch_for), local rows only."""
    for step, pid in ((0, 0), (3, 1), (7, 5)):
        rng = np.random.default_rng((step << 16) | pid)
        want = rng.integers(0, 64, (4, 17), dtype=np.int32)
        np.testing.assert_array_equal(
            train_cli.synthetic_rows(step, pid, 4, 64, 16), want)


WORKER = r"""
import sys
import numpy as np
import torch
from tpu_autoscaler_torch.workloads import distributed, model, train

port, pid, steps, out = (int(sys.argv[1]), int(sys.argv[2]),
                         int(sys.argv[3]), sys.argv[4])
distributed._COORDINATOR_PORT = port
topo = distributed.initialize_from_env(
    {"TPU_WORKER_HOSTNAMES": "localhost,localhost",
     "TPU_WORKER_ID": str(pid)}, backend="gloo")
cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                        d_ff=64, seq_len=16, dtype=torch.float32)
mesh = distributed.make_process_mesh(["cpu"], tp=1)
init_fn, step = model.make_sharded_train_step(mesh, cfg)
params, opt = init_fn(torch.Generator().manual_seed(0))
losses = []
for s in range(steps):
    rows = train.synthetic_rows(s, topo.process_id, 4, cfg.vocab,
                                cfg.seq_len)
    params, opt, loss = step(params, opt, rows)
    losses.append(float(loss))
np.savez(out, losses=np.asarray(losses),
         **{k: v.numpy() for k, v in model._flatten(
             model.gather_params(mesh, params))})
torch.distributed.destroy_process_group()
"""


def _run_pair(argv_of, env_of=None):
    """Start two processes (``argv_of(pid)``, env ``env_of(pid)``) and
    wait for both, at most TIMEOUT_S; a timeout kills both and fails."""
    procs = [subprocess.Popen(
        argv_of(pid), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO,
             **(env_of(pid) if env_of else {})}) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"two-process run exceeded {TIMEOUT_S} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def _one_process_dp2(steps, rows_of):
    """The one-process dp 2 mesh on the global batch (process 0's rows,
    then process 1's), from the trainer's initial params."""
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    mesh = model.make_mesh(["cpu"] * 2, tp=1)
    init_fn, step = model.make_sharded_train_step(mesh, cfg)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    losses = []
    for s in range(steps):
        tokens = np.concatenate([rows_of(s, pid) for pid in range(2)])
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    return losses, dict(model._flatten(model.gather_params(mesh, params)))


def test_two_processes_train_the_one_process_dp2_model(tmp_path):
    """Two processes joined by gloo on the CPU (initialize_from_env with
    TPU_WORKER_HOSTNAMES=localhost,localhost and a free port) on one
    mesh (``distributed.make_process_mesh``, shard none), each stepping
    on its own 4 rows with the gradients and the loss averaged over the
    processes: three steps give the losses and params of the
    one-process dp 2 mesh on the 8 rows."""
    port = _free_port()
    outs = [str(tmp_path / f"p{pid}.npz") for pid in range(2)]
    _run_pair(lambda pid: [sys.executable, "-c", WORKER, str(port),
                           str(pid), "3", outs[pid]])
    want_losses, want = _one_process_dp2(
        3, lambda s, pid: train_cli.synthetic_rows(s, pid, 4, 64, 16))
    got = [np.load(path) for path in outs]
    for g in got:
        np.testing.assert_allclose(g["losses"], want_losses,
                                   rtol=PROC_LOSS_TOL, atol=PROC_LOSS_TOL)
        for path, t in want.items():
            np.testing.assert_allclose(g[path], _np(t), rtol=PROC_PARAM_TOL,
                                       atol=PROC_PARAM_TOL, err_msg=path)
    for path in want:   # both processes hold one model
        np.testing.assert_array_equal(got[0][path], got[1][path])


CLI = r"""
import sys
from tpu_autoscaler_torch.workloads import distributed, train

distributed._COORDINATOR_PORT = int(sys.argv[1])
train.main(sys.argv[2:])
"""


def _two_process_steps(cfg, steps, rows_of):
    """What the two processes compute, in one: each step the gradient
    of each process's rows at the same params, their mean, then the
    optimizer (the trainer's defaults)."""
    optimizer = model.make_optimizer(model.TrainConfig())
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = optimizer.init(params)
    for s in range(steps):
        paths, leaves = zip(*model._flatten(params))
        total = None
        for pid in range(2):
            live = [p.detach().requires_grad_() for p in leaves]
            loss = model.loss_fn(model._unflatten(dict(zip(paths, live))),
                                 torch.from_numpy(rows_of(s, pid)), cfg)
            grads = torch.autograd.grad(loss, live)
            total = grads if total is None else [
                a + b for a, b in zip(total, grads)]
        updates, opt = optimizer.update(
            model._unflatten({p: g / 2 for p, g in zip(paths, total)}), opt,
            params)
        params = model.apply_updates(params, updates)
    return dict(model._flatten(params))


def test_train_cli_across_two_processes(tmp_path):
    """The train CLI in two processes under the GKE env contract (gloo
    with --platform cpu): each logs its topology, process 0 alone writes
    step_2 (the others wait at the barrier), and the checkpoint holds
    the CLI's bf16 model after two steps on the global --batch 8, each
    process's 4 rows averaged (computed here in one process)."""
    port = _free_port()
    ckpt = str(tmp_path / "ckpt")
    args = ["--platform", "cpu", "--vocab", "64", "--d-model", "32",
            "--n-layers", "2", "--seq-len", "16", "--batch", "8", "--steps",
            "2", "--checkpoint-dir", ckpt, "--annotations-file",
            str(tmp_path / "none")]
    outs = _run_pair(
        lambda pid: [sys.executable, "-c", CLI, str(port), *args],
        lambda pid: {"TPU_WORKER_HOSTNAMES": "localhost,localhost",
                     "TPU_WORKER_ID": str(pid)})
    for pid, (_, err) in enumerate(outs):
        assert f"topology: process {pid}/2 (slice 0/1); devices: 1" in err
        assert "training complete at step 2" in err
    assert os.listdir(ckpt) == ["step_2"]
    want = _two_process_steps(
        model.ModelConfig(vocab=64, d_model=32, n_layers=2, seq_len=16), 2,
        lambda s, pid: train_cli.synthetic_rows(s, pid, 4, 64, 16))
    got = model.load_params(ckpt, 2, "cpu")
    for path, t in model._flatten(got):
        np.testing.assert_allclose(_np(t), _np(want[path]),
                                   rtol=PROC_PARAM_TOL, atol=PROC_PARAM_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("flags", [
    ["--sp", "2"], ["--ep", "2", "--moe-experts", "8"],
    ["--pp-stages", "2"]], ids=["sp", "ep", "pp"])
def test_train_cli_single_process_only_matches_jax(tmp_path, monkeypatch,
                                                   flags):
    """--sp, --ep and --pp-stages in a multi-process job: the JAX
    trainer's "single-process only for now" usage errors, word for
    word (both trainers given a two-process topology)."""
    two = dict(coordinator="localhost:1", num_processes=2, process_id=0)
    monkeypatch.setattr(
        distributed, "initialize_from_env",
        lambda env=None, backend="nccl": distributed.HostTopology(**two))
    monkeypatch.setattr(
        jax_distributed, "initialize_from_env",
        lambda env=None: jax_distributed.HostTopology(**two))
    base = ["--steps", "1", "--vocab", "64", "--d-model", "32",
            "--n-layers", "1", "--seq-len", "16", "--checkpoint-dir",
            str(tmp_path)]
    mine = CliRunner().invoke(train_cli.main,
                              base + ["--platform", "cpu"] + flags)
    theirs = CliRunner().invoke(jax_train.main, base + flags)
    assert mine.exit_code == theirs.exit_code == 2, (mine.output,
                                                     theirs.output)
    error = [line for line in theirs.output.splitlines()
             if line.startswith("Error:")]
    assert error and "single-process only" in error[0]
    assert error[0] in mine.output.splitlines(), (mine.output, error)
    assert not os.listdir(tmp_path)
