"""ZeRO-1 and FSDP over the global data axes across processes, on the CPU.

Two processes joined by gloo (``initialize_from_env`` with
TPU_WORKER_HOSTNAMES=localhost,localhost and a free port) share one
mesh (``distributed.make_process_mesh``: one CPU rank each, data 2 ×
model 1), as the JAX trainer's one mesh over every process's devices.
Under ``--shard zero1`` and ``fsdp`` each process must hold what the
one-process dp 2 mesh places on its rank (``rank_state_bytes``), and
three steps on each process's own 4 rows of the trainer's stream, the
global-norm clip on (its norm summed over both processes), must give that mesh's losses within 2e-5 and its
params within 2e-4 (``tests/test_torch_distributed.py``'s bounds: f32,
the two runs sum the same gradients in another order).  Process 0's
``step_3``, gathered over both, must load through ``load_params`` in the
one-device layout; and the train CLI in two processes must write a
zero1 checkpoint and resume from it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_autoscaler_torch.workloads import model
from tpu_autoscaler_torch.workloads import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16)
# A clip this small leaves every element of the clipped gradient below
# Adam's epsilon (1e-8), so the update is proportional to the gradient
# and a wrong global norm shows in the params; at an ordinary clip
# Adam's invariance to the gradient's scale hides it.
TRAIN = dict(grad_clip=1e-6)
STEPS = 3
PROC_LOSS_TOL = 2e-5
PROC_PARAM_TOL = 2e-4
TIMEOUT_S = 120

WORKER = r"""
import json, sys
import numpy as np
import torch
from tpu_autoscaler_torch.workloads import checkpoint, distributed, model, train

port, pid, shard, steps, out, ckpt = sys.argv[1:7]
distributed._COORDINATOR_PORT = int(port)
topo = distributed.initialize_from_env(
    {"TPU_WORKER_HOSTNAMES": "localhost,localhost", "TPU_WORKER_ID": pid},
    backend="gloo")
cfg = model.ModelConfig(**json.loads(sys.argv[7]), dtype=torch.float32)
mesh = distributed.make_process_mesh(["cpu"], tp=1)
init_fn, step = model.make_sharded_train_step(
    mesh, cfg, train=model.TrainConfig(**json.loads(sys.argv[8])),
    shard=shard)
params, opt = init_fn(torch.Generator().manual_seed(0))
held = model.rank_state_bytes(mesh, params, opt)
losses = []
for s in range(int(steps)):
    rows = train.synthetic_rows(s, topo.process_id, 4, cfg.vocab,
                                cfg.seq_len)
    params, opt, loss = step(params, opt, rows)
    losses.append(float(loss))
state = model.gather_params(mesh, {"params": params, "opt": opt})
if topo.process_id == 0:
    checkpoint.save_checkpoint(ckpt, int(steps), state)
torch.distributed.barrier()
np.savez(out, losses=np.asarray(losses), held=np.asarray(held),
         **{k: v.numpy() for k, v in model._flatten(state["params"])})
torch.distributed.destroy_process_group()
"""

CLI = r"""
import sys
from tpu_autoscaler_torch.workloads import distributed, train

distributed._COORDINATOR_PORT = int(sys.argv[1])
train.main(sys.argv[2:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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


def _one_process_dp2(shard, arch):
    """The one-process dp 2 mesh on both processes' rows: each rank's
    bytes at init, the losses and the gathered params."""
    cfg = model.ModelConfig(**arch, dtype=torch.float32)
    mesh = model.make_mesh(["cpu"] * 2, tp=1)
    init_fn, step = model.make_sharded_train_step(
        mesh, cfg, train=model.TrainConfig(**TRAIN), shard=shard)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    held = model.rank_state_bytes(mesh, params, opt)
    losses = []
    for s in range(STEPS):
        tokens = np.concatenate([train_cli.synthetic_rows(
            s, pid, 4, cfg.vocab, cfg.seq_len) for pid in range(2)])
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    return held, losses, dict(model._flatten(model.gather_params(mesh,
                                                                 params)))


@pytest.mark.parametrize("shard,remat", [("zero1", False), ("fsdp", False),
                                         ("fsdp", True)],
                         ids=["zero1", "fsdp", "fsdp-remat"])
def test_two_processes_cut_the_state_as_the_one_process_mesh(tmp_path,
                                                             shard, remat):
    """With remat, FSDP's fetch of a layer runs inside the layer's
    checkpoint and again when the backward recomputes the layer."""
    arch = dict(ARCH, remat=remat)
    port = _free_port()
    outs = [str(tmp_path / f"p{pid}.npz") for pid in range(2)]
    ckpt = str(tmp_path / "ckpt")
    _run_pair(lambda pid: [sys.executable, "-c", WORKER, str(port), str(pid),
                           shard, str(STEPS), outs[pid], ckpt,
                           json.dumps(arch), json.dumps(TRAIN)])
    held, want_losses, want = _one_process_dp2(shard, arch)
    got = [np.load(path) for path in outs]
    whole = 3 * 4 * sum(t.numel() for t in want.values())
    for pid, g in enumerate(got):
        assert g["held"].tolist() == [held[pid]]
        np.testing.assert_allclose(g["losses"], want_losses,
                                   rtol=PROC_LOSS_TOL, atol=PROC_LOSS_TOL)
        for path, t in want.items():
            np.testing.assert_allclose(g[path], t.numpy(),
                                       rtol=PROC_PARAM_TOL,
                                       atol=PROC_PARAM_TOL, err_msg=path)
    assert held[0] < whole      # each process holds part of the state
    for path in want:           # both processes gathered one model
        np.testing.assert_array_equal(got[0][path], got[1][path])
    assert os.listdir(ckpt) == [f"step_{STEPS}"]
    for path, t in model._flatten(model.load_params(ckpt, STEPS, "cpu")):
        assert t.shape == want[path].shape, path
        np.testing.assert_allclose(t.numpy(), want[path].numpy(),
                                   rtol=PROC_PARAM_TOL, atol=PROC_PARAM_TOL,
                                   err_msg=path)


def test_train_cli_zero1_across_two_processes_resumes(tmp_path):
    """The train CLI in two processes under the GKE env contract with
    --shard zero1: two steps write step_2 (process 0, gathered over
    both), and a second run resumes from it to step 3; step_3 holds the
    one-device layout."""
    port = _free_port()
    ckpt = str(tmp_path / "ckpt")
    base = ["--platform", "cpu", "--vocab", "64", "--d-model", "32",
            "--n-layers", "2", "--seq-len", "16", "--batch", "8",
            "--shard", "zero1", "--checkpoint-dir", ckpt,
            "--annotations-file", str(tmp_path / "none")]

    def env(pid):
        return {"TPU_WORKER_HOSTNAMES": "localhost,localhost",
                "TPU_WORKER_ID": str(pid)}

    outs = _run_pair(lambda pid: [sys.executable, "-c", CLI, str(port),
                                  *base, "--steps", "2"], env)
    for _, err in outs:
        assert "'data': 2, 'model': 1}, shard zero1" in err
        assert "training complete at step 2" in err
    assert os.listdir(ckpt) == ["step_2"]
    port = _free_port()
    outs = _run_pair(lambda pid: [sys.executable, "-c", CLI, str(port),
                                  *base, "--steps", "3"], env)
    for _, err in outs:
        assert "resumed from checkpoint step 2" in err
        assert "training complete at step 3" in err
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    shapes = model.param_shapes(model.ModelConfig(vocab=64, d_model=32,
                                                  n_layers=2, seq_len=16))
    for path, t in model._flatten(model.load_params(ckpt, 3, "cpu")):
        assert tuple(t.shape) == tuple(dict(model._flatten(shapes))[path])
        assert torch.isfinite(t).all(), path
