"""The port's serving and generate under a (data, model) mesh against
the JAX package's, on the CPU: ``make_sharded_generate``, the cache's
shard shapes, an uneven batch, the linear (and ring) engine under dp 2 ×
tp 2, the paged engine under a ('model',) mesh and under dp 2 × tp 2,
the speculative paged engine and a MoE model under a mesh, the kernel
route's launches per shard, and the ``serve``/``generate`` CLIs' ``--tp``
(``generate --tp`` also on what ``train --tp`` wrote).

JAX runs on the conftest's 8 virtual CPU devices (its Pallas kernels in
interpret mode), the port on ``["cpu"] * n`` (rank r the r-th device of
the grid).  The same weights (JAX's, carried across with
``params_from_jax``) and the same numpy-made prompts go through both in
f32.  Greedy tokens must be equal; the prefill logits within 2e-4 (f32,
summation order only: the row-parallel products are summed over the
model ranks in another order than one device's product)."""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from tpu_autoscaler.workloads import checkpoint as jax_checkpoint  # noqa: E402
from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import paged as jax_paged  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    decode,
    model,
    paged,
    serve,
    serving,
    spec_serving,
)
from tpu_autoscaler_torch.workloads import train as train_cli  # noqa: E402

jax_serve = importlib.import_module("tpu_autoscaler.workloads.serve")
jax_generate = importlib.import_module("tpu_autoscaler.workloads.generate")
# The CLI module: both packages re-export decode's ``generate`` function
# under the same name.
generate = importlib.import_module("tpu_autoscaler_torch.workloads.generate")

ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, seq_len=64)
LOGIT_TOL = 2e-4


def _cfgs(attention_impl=None, **kw):
    """The same config in both packages, f32; JAX's attention "auto"
    (the einsum on the CPU, as the port's) unless given."""
    arch = {**ARCH, **kw}
    jkw = {} if attention_impl is None else {"attention": attention_impl}
    return (jax_model.ModelConfig(**arch, dtype=jnp.float32, **jkw),
            model.ModelConfig(**arch, dtype=torch.float32))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jp, "cpu")


def _prompt(b, s=7, seed=0):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, s)).astype(np.int32)


def _grid(n, tp=2):
    """A dp × tp mesh of n devices on both sides."""
    return (jax_model.make_mesh(jax.devices()[:n], tp=tp),
            model.make_mesh(["cpu"] * n, tp=tp))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ARCH["vocab"], (n,)).astype(np.int32)
            for n in lens]


def _serve(eng, prompts, new):
    reqs = [serving.Request(prompt=p, max_new_tokens=new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.generated)) for r in reqs]


def _jax_serve(eng, prompts, new):
    reqs = [jax_serving.Request(prompt=p, max_new_tokens=new)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.generated)) for r in reqs]


@pytest.fixture
def launches(monkeypatch):
    """The port's kernel route on the CPU: attention resolves to the
    kernel, whose wrappers run their plain versions on CPU tensors; each
    wrapper's calls are counted where the serving modules call it, with
    each call's q shape."""
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    calls = {"flash_attention": [], "flash_decode": [],
             "paged_flash_decode": []}

    def spy(name, real):
        def wrapper(q, *args, **kwargs):
            calls[name].append(tuple(q.shape))
            return real(q, *args, **kwargs)
        return wrapper

    for mod, name in ((decode, "flash_attention"), (decode, "flash_decode"),
                      (serving, "flash_decode"),
                      (paged, "paged_flash_decode")):
        monkeypatch.setattr(mod, name, spy(name, getattr(attention, name)))
    return calls


# ---- the fixed-batch path -------------------------------------------------

def test_sharded_generate_matches_jax():
    """make_sharded_generate at dp 2 × tp 2: greedy tokens equal to
    JAX's, and the prefill logits under the mesh within 2e-4."""
    jcfg, tcfg = _cfgs()
    jp, tp_ = _params(jcfg)
    jmesh, tmesh = _grid(4)
    prompt = _prompt(4)
    want = jax_decode.make_sharded_generate(jmesh, jcfg, steps=6)(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(1))
    got = decode.make_sharded_generate(tmesh, tcfg, steps=6)(
        tp_, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlogits = jax.jit(lambda p, t: jax_decode.prefill(
        p, t, jcfg, max_len=16, mesh=jmesh)[0])(jp, jnp.asarray(prompt))
    tlogits, _ = decode.prefill(tp_, torch.from_numpy(prompt), tcfg, 16,
                                mesh=tmesh)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=0)


def test_sharded_generate_samples_as_one_device():
    """A sampled run under the mesh draws from the caller's generator on
    the first device in the one-device order: the same tokens."""
    _, tcfg = _cfgs()
    params = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    prompt = torch.from_numpy(_prompt(4))
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    want = decode.generate(params, prompt, tcfg, 8, device="cpu",
                           generator=torch.Generator().manual_seed(5), **kw)
    got = decode.make_sharded_generate(_grid(4)[1], tcfg, 8, **kw)(
        params, prompt, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,kv,b", [("gqa", 2, 4), ("mqa", 1, 4),
                                       ("gqa-dp4", 2, 8)])
def test_cache_shard_shapes_match_jax(name, kv, b):
    """Each realized cache shard has JAX's shard_shape: the batch over
    the data rows, KV heads over 'model' when they divide (MQA at tp 2
    keeps its one head whole on each row's first rank, where JAX
    replicates it)."""
    jcfg, tcfg = _cfgs(n_kv_heads=kv)
    jp, tp_ = _params(jcfg)
    n = 8 if name == "gqa-dp4" else 4
    jmesh, tmesh = _grid(n)
    prompt = _prompt(b)
    jcache = jax.jit(lambda p, t: jax_decode.prefill(
        p, t, jcfg, max_len=16, mesh=jmesh)[1])(jp, jnp.asarray(prompt))
    want = jcache.k.sharding.shard_shape(jcache.k.shape)
    _, cache = decode.prefill(tp_, torch.from_numpy(prompt), tcfg, 16,
                              mesh=tmesh)
    shapes = {tuple(t.shape) for row in cache.k + cache.v for t in row}
    assert shapes == {tuple(want)}
    per_row = 2 if kv % 2 == 0 else 1
    assert [len(row) for row in cache.k] == [per_row] * (n // 2)
    # Each shard its own tensor: a write lands in one shard only.
    ptrs = [t.data_ptr() for row in cache.k + cache.v for t in row]
    assert len(set(ptrs)) == len(ptrs)
    np.testing.assert_allclose(cache.gather().k.numpy(), np.asarray(jcache.k),
                               atol=LOGIT_TOL, rtol=0)
    spec = decode.cache_specs(tmesh)
    assert spec.k == model.P(None, "data", "model", None, None)


def test_uneven_batch_keeps_the_kernel(launches):
    """A batch of 3 over dp 2: JAX falls back to the einsum with a
    warning; the port cuts the batch 2 + 1 and keeps the kernel route
    (K1 per shard in the prefill, K3 per shard in every decode step, on
    each row's share), with JAX's tokens."""
    jcfg, tcfg = _cfgs("pallas")
    jp, tp_ = _params(jcfg)
    jmesh, tmesh = _grid(4)
    prompt = _prompt(3)
    steps = 4
    with pytest.warns(UserWarning, match="does not divide"):
        want = jax_decode.generate(jp, jnp.asarray(prompt), jcfg, steps,
                                   mesh=jmesh)
    got = decode.make_sharded_generate(tmesh, tcfg, steps)(
        tp_, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    L, tp = ARCH["n_layers"], 2
    per_layer = [(2, 2, 7, 8), (2, 2, 7, 8), (1, 2, 7, 8), (1, 2, 7, 8)]
    assert launches["flash_attention"] == per_layer * L
    assert launches["flash_decode"] == [
        (s[0], 2, 1, 8) for s in per_layer] * L * (steps - 1)
    assert len(launches["flash_decode"]) == (steps - 1) * L * 2 * tp


# ---- the linear engine ----------------------------------------------------

@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_continuous_batcher_under_mesh_matches_jax(ring):
    """The linear engine (and its ring cache) under dp 2 × tp 2 against
    JAX's under Mesh(devices[:4].reshape(2, 2)): greedy tokens equal."""
    window = 8 if ring else None
    jcfg, tcfg = _cfgs(attention_window=window)
    jp, tp_ = _params(jcfg)
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
    tmesh = model.make_mesh(["cpu"] * 4, tp=2)
    prompts = _prompts(5, (6, 13, 3, 9))
    kw = dict(slots=2, max_len=64, chunk=8, ring=ring)
    want = _jax_serve(jax_serving.ContinuousBatcher(jp, jcfg, mesh=jmesh,
                                                    **kw), prompts, 4)
    eng = serving.ContinuousBatcher(tp_, tcfg, mesh=tmesh, **kw)
    assert _serve(eng, prompts, 4) == want
    assert [[tuple(t.shape) for t in row] for row in eng.cache.k] == [
        [(2, 1, 1, 16 if ring else 64, 8)] * 2] * 2


def test_slots_not_dividing_over_dp_refused_as_jax():
    """3 slots over dp 2: JAX's engine builds, then its jit refuses the
    cache at the first step with a ValueError; the port refuses it when
    the engine is built, in the same words."""
    jcfg, tcfg = _cfgs()
    jp, tp_ = _params(jcfg)
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
    words = "should be divisible by 2, but it is equal to 3"
    eng = jax_serving.ContinuousBatcher(jp, jcfg, slots=3, max_len=64,
                                        chunk=8, mesh=jmesh)
    with pytest.raises(ValueError, match=words):
        _jax_serve(eng, _prompts(1, (5,)), 2)
    with pytest.raises(ValueError, match=words):
        serving.ContinuousBatcher(tp_, tcfg, slots=3, max_len=64, chunk=8,
                                  mesh=model.make_mesh(["cpu"] * 4, tp=2))


def test_moe_engine_under_mesh_equals_one_device():
    """A MoE model (4 experts, top 2) through the mesh linear engine:
    the tokens of one device."""
    _, tcfg = _cfgs(moe_experts=4, moe_top_k=2)
    params = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    prompts = _prompts(3, (6, 13, 3, 9, 20))
    kw = dict(slots=2, max_len=64, chunk=8)
    want = _serve(serving.ContinuousBatcher(params, tcfg, device="cpu", **kw),
                  prompts, 5)
    got = _serve(serving.ContinuousBatcher(
        params, tcfg, mesh=model.make_mesh(["cpu"] * 4, tp=2), **kw),
        prompts, 5)
    assert got == want


# ---- the paged engines ----------------------------------------------------

def _paged(cls, params, cfg, mesh, prompts, new, **kw):
    eng = cls(params, cfg, slots=2, max_len=64, block_size=8, chunk=8,
              mesh=mesh, **kw)
    tokens = (_jax_serve if cls is jax_paged.PagedBatcher else _serve)(
        eng, prompts, new)
    return tokens, eng.ticks, eng.preemptions


@pytest.mark.parametrize("grid", ["tp2", "dp2xtp2"])
def test_paged_batcher_under_mesh_matches_jax(grid):
    """The paged engine under a ('model',) mesh of 2 (the pool cut over
    KV heads), and under dp 2 × tp 2 (the rows gathered from the pool):
    tokens, ticks and preemptions equal to JAX's, on a pool small
    enough to preempt."""
    jcfg, tcfg = _cfgs()
    jp, tp_ = _params(jcfg, seed=1)
    if grid == "tp2":
        jmesh = JaxMesh(np.array(jax.devices()[:2]), ("model",))
        tmesh = model.Mesh(np.array(["cpu", "cpu"], dtype=object),
                           ("model",))
    else:
        jmesh, tmesh = _grid(4)
    prompts = _prompts(8, (20, 14, 9))
    want = _paged(jax_paged.PagedBatcher, jp, jcfg, jmesh, prompts, 6,
                  num_blocks=4)
    got = _paged(paged.PagedBatcher, tp_, tcfg, tmesh, prompts, 6,
                 num_blocks=4)
    assert got == want
    assert got[2] > 0


def test_spec_engine_under_mesh_equals_one_device():
    """The speculative paged engine at tp 2 (its draft placed and its
    pool cut like the target's): the one-device engine's tokens and
    accept rate."""
    _, tcfg = _cfgs()
    params = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    draft = {**params, "blocks": {k: v[:1] for k, v in
                                  params["blocks"].items()}}
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    prompts = _prompts(4, (12, 5, 20, 9))

    def run(**where):
        eng = spec_serving.SpeculativePagedBatcher(
            params, tcfg, draft, dcfg, k=2, slots=2, max_len=64,
            block_size=8, chunk=8, **where)
        return _serve(eng, prompts, 6), eng.accept_rate, eng.verify_passes

    want = run(device="cpu")
    got = run(mesh=model.make_mesh(["cpu"] * 2, tp=2))
    assert got == want


# ---- the kernel route -----------------------------------------------------

def test_kernel_route_generate_matches_jax_pallas(launches):
    """make_sharded_generate down the kernel route at dp 2 × tp 2
    against JAX's Pallas route through its shard_map: K1 once per shard
    a layer in the prefill, K3 once per shard a layer a decode step."""
    jcfg, tcfg = _cfgs("pallas")
    jp, tp_ = _params(jcfg)
    jmesh, tmesh = _grid(4)
    prompt = _prompt(4)
    steps = 4
    want = jax_decode.make_sharded_generate(jmesh, jcfg, steps=steps)(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(1))
    got = decode.make_sharded_generate(tmesh, tcfg, steps)(
        tp_, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    L, ranks = ARCH["n_layers"], 4
    assert launches["flash_attention"] == [(2, 2, 7, 8)] * L * ranks
    assert launches["flash_decode"] == [(2, 2, 1, 8)] * (
        L * ranks * (steps - 1))


def test_kernel_route_engines_launch_per_shard(launches):
    """The linear engine down the kernel route at dp 2 × tp 2: K3 once
    per (row, rank) shard a layer every decode tick, with JAX's tokens;
    the paged engine at tp 2 against JAX's Pallas paged kernel: K4 once
    per model rank a layer."""
    jcfg, tcfg = _cfgs("pallas")
    jp, tp_ = _params(jcfg, seed=1)
    prompts = _prompts(12, (11, 6))
    jmesh, tmesh = _grid(4)
    eng = serving.ContinuousBatcher(tp_, tcfg, slots=2, max_len=64,
                                    chunk=8, mesh=tmesh)
    got = _serve(eng, prompts, 3)
    want = _jax_serve(jax_serving.ContinuousBatcher(
        jp, dataclasses.replace(jcfg, attention="auto"), slots=2,
        max_len=64, chunk=8, mesh=jmesh), prompts, 3)
    assert got == want
    L = ARCH["n_layers"]
    assert launches["flash_decode"] == [(1, 2, 1, 8)] * (
        eng.decode_steps * L * 4)
    jmesh = JaxMesh(np.array(jax.devices()[:2]), ("model",))
    tmesh = model.make_mesh(["cpu"] * 2, tp=2)
    want = _paged(jax_paged.PagedBatcher, jp, jcfg, jmesh, prompts, 3)
    peng = paged.PagedBatcher(tp_, tcfg, slots=2, max_len=64, block_size=8,
                              chunk=8, mesh=tmesh)
    assert (_serve(peng, prompts, 3), peng.ticks, peng.preemptions) == want
    assert launches["paged_flash_decode"] == [(2, 2, 1, 8)] * (
        peng.decode_steps * L * 2)


# ---- the CLIs -------------------------------------------------------------

def _checkpoints(tmp_path):
    """The same model as a JAX (orbax) checkpoint and a port one."""
    jcfg = jax_model.ModelConfig(vocab=64, d_model=32, n_layers=2,
                                 seq_len=16)
    jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), 1,
                                   {"params": jp, "opt": {}})
    model.save_params(str(tmp_path / "port"), 1,
                      model.params_from_jax(jp, "cpu"))
    return ["--vocab", "64", "--d-model", "32", "--n-layers", "2",
            "--seq-len", "16"]


SERVE = ["--random", "4", "--max-len", "32", "--chunk", "8",
         "--max-new-tokens", "6"]
GENERATE = ["--steps", "5", "--batch", "4", "--prompt", "3,1,4,1,5"]


def _tokens(cli, out):
    lines = out.strip().splitlines()
    if cli == "generate":
        return lines
    assert json.loads(lines[-1])["event"] == "final_stats"
    return [json.loads(line)["tokens"] for line in lines[:-1]]


def _invoke(mod, args):
    res = CliRunner().invoke(mod.main, args)
    assert res.exit_code == 0, res.output
    return res


@pytest.mark.parametrize("cli,devices,extra", [
    ("serve", 8, []), ("serve", 2, ["--paged"]),
    ("serve", 2, ["--paged", "--spec-k", "2"]), ("generate", 8, [])],
    ids=["serve", "serve-paged", "serve-paged-spec", "generate"])
def test_cli_tp_serves_the_jax_tokens(tmp_path, monkeypatch, caplog, cli,
                                      devices, extra):
    """``--tp 2`` serves under the mesh (dp 4 × tp 2 on 8 devices; the
    paged engines on 2, a TP-only mesh) and prints the tokens the JAX
    CLI prints at ``--tp 2`` on its 8 devices from the same model."""
    mod, jmod = {"serve": (serve, jax_serve),
                 "generate": (generate, jax_generate)}[cli]
    flags = _checkpoints(tmp_path) + (SERVE if cli == "serve" else GENERATE)
    if cli == "serve":
        flags += ["--annotations-file", str(tmp_path / "none")]
    theirs = _invoke(jmod, ["--checkpoint-dir", str(tmp_path / "jax"),
                            *flags, "--tp", "2"])
    monkeypatch.setattr(mod, "device_count", lambda platform: devices)
    caplog.set_level(logging.INFO)
    mine = _invoke(mod, ["--checkpoint-dir", str(tmp_path / "port"),
                         "--platform", "cpu", *flags, *extra, "--tp", "2"])
    assert _tokens(cli, mine.stdout) == _tokens(cli, theirs.stdout)
    assert f"serving under mesh {{'data': {devices // 2}, 'model': 2}}" \
        in caplog.text


@pytest.mark.parametrize("cli,flags", [
    ("serve", ["--slots", "3"]), ("serve", ["--paged"]),
    ("generate", ["--batch", "3"])], ids=["slots", "paged-dp", "batch"])
def test_cli_tp_usage_errors_match_jax(tmp_path, monkeypatch, cli, flags):
    """JAX's usage errors of ``--tp 2`` on 8 devices, in JAX's words:
    slots or a batch that do not divide over the 4 data rows, and
    ``--paged`` on a mesh with data rows."""
    mod, jmod = {"serve": (serve, jax_serve),
                 "generate": (generate, jax_generate)}[cli]
    args = _checkpoints(tmp_path) + (SERVE if cli == "serve" else GENERATE)
    if cli == "serve":
        args += ["--annotations-file", str(tmp_path / "none")]
    theirs = CliRunner().invoke(jmod.main, [
        "--checkpoint-dir", str(tmp_path / "jax"), *args, *flags,
        "--tp", "2"])
    error = [line for line in theirs.output.splitlines()
             if line.startswith("Error:")]
    assert theirs.exit_code == 2 and len(error) == 1, theirs.output
    monkeypatch.setattr(mod, "device_count", lambda platform: 8)
    mine = CliRunner().invoke(mod.main, [
        "--checkpoint-dir", str(tmp_path / "port"), "--platform", "cpu",
        *args, *flags, "--tp", "2"])
    assert mine.exit_code == 2
    assert " ".join(error[0].split()) in " ".join(mine.output.split())


@pytest.mark.parametrize("shard", ["none", "zero1", "fsdp"])
def test_generate_tp_reads_what_train_tp_wrote(tmp_path, shard):
    """``train --tp 2 --shard S`` writes the one-device layout, and
    ``generate --tp 2`` reads it whatever S was: its rows are what
    generate under the same dp 1 × tp 2 mesh gives in-process from the
    trainer's last checkpoint."""
    arch = ["--platform", "cpu", "--vocab", "64", "--d-model", "32",
            "--n-layers", "2", "--seq-len", "16"]
    ckpt = str(tmp_path / "ckpt")
    res = CliRunner().invoke(train_cli.main, [
        *arch, "--batch", "4", "--steps", "2", "--checkpoint-every", "2",
        "--checkpoint-dir", ckpt, "--tp", "2", "--shard", shard,
        "--annotations-file", str(tmp_path / "none")])
    assert res.exit_code == 0, res.output
    res = CliRunner().invoke(generate.main, [
        *arch, "--checkpoint-dir", ckpt, "--prompt", "1,2,3", "--batch",
        "2", "--steps", "4", "--tp", "2"])
    assert res.exit_code == 0, res.output
    cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=2, seq_len=16)
    want = decode.generate(model.load_params(ckpt, 2, "cpu"),
                           torch.tensor([[1, 2, 3]] * 2), cfg, 4,
                           mesh=model.make_mesh(["cpu"] * 2, tp=2))
    assert res.stdout.strip().splitlines() == [
        f"1,2,3 | {','.join(map(str, row[3:]))}" for row in want.tolist()]
