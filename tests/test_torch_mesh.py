"""The port's training mesh against the JAX package's, on the CPU:
``make_mesh``, the partition specs (params, FSDP, the optimizer state),
each rank's shard, ``make_sharded_flash_attention``,
``make_sharded_train_step`` in every shard mode, the checkpoint layout
(``gather_params`` / ``shard_params``), the trainer's ``--tp`` and
``--shard``, and the ``--tp`` of ``serve`` and ``generate``.

JAX runs on the conftest's 8 virtual CPU devices (its Pallas kernels in
interpret mode), the port on ``["cpu"] * 8``: a dp 4 × tp 2 mesh on
both sides, rank r the r-th device of the (data, model) grid.  The
same weights (JAX's, carried across with ``params_from_jax``) and the
same numpy-made batches go through both in f32.  Tolerances: 2e-5 for
the attention forward and 1e-4 for its gradients (f32, summation order
only); losses within 1e-3 relative over five steps and the params after
them within rtol 1e-3, atol 1e-5 (Adam moves every parameter by about
the LR whatever its gradient, so small gradient differences grow;
JAX's own sp-parity bounds); shapes, specs and round trips exactly.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import checkpoint as jax_checkpoint  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    model,
    serve,
)
from tpu_autoscaler_torch.workloads import train as train_cli  # noqa: E402

jax_serve = importlib.import_module("tpu_autoscaler.workloads.serve")
jax_generate = importlib.import_module("tpu_autoscaler.workloads.generate")
# The CLI module: both packages re-export decode's ``generate`` function
# under the same name.
generate = importlib.import_module("tpu_autoscaler_torch.workloads.generate")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16)
MODES = ("none", "zero1", "fsdp")
CONFIGS = {"mha": {}, "gqa": {"n_kv_heads": 2},
           "unshardable": {"n_kv_heads": 1},
           "moe": {"moe_experts": 4, "moe_top_k": 2}}
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
STEP_LOSS_RTOL = 1e-3
BATCH = 8


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(**kw):
    """The same config in both packages, f32; JAX's attention "auto"
    (the einsum on the CPU, as the port's)."""
    return (jax_model.ModelConfig(**ARCH, dtype=jnp.float32, **kw),
            model.ModelConfig(**ARCH, dtype=torch.float32, **kw))


def _meshes():
    return (jax_model.make_mesh(jax.devices()[:8]),
            model.make_mesh(["cpu"] * 8))


def _tokens(seed, b=BATCH):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, ARCH["seq_len"] + 1)).astype(np.int32)


def _paths(tree):
    """'/'-joined dict path -> leaf of a JAX tree."""
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_MOMENTS = {"mu": "mu", "nu": "nu", "acc_grads": "acc"}


def _jax_moments(opt_tree):
    """(port state key, '/'-joined param path) -> leaf for every moment
    leaf of an optax state tree, and the leaves that are no moment."""
    moments, others = {}, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_tree)[0]:
        names = [k.name for k in path
                 if isinstance(k, jax.tree_util.GetAttrKey)
                 and k.name in _MOMENTS]
        keys = [k.key for k in path if isinstance(k, jax.tree_util.DictKey)]
        if names:
            moments[_MOMENTS[names[-1]], "/".join(keys)] = leaf
        else:
            others.append(leaf)
    return moments, others


# ---- the mesh and the specs -------------------------------------------


def test_make_mesh_shapes_match_jax():
    """8 devices: dp 4 × tp 2 (tp defaults to 2 on an even count); 5
    with tp 1: 5 × 1; 5 by default: tp 1 (odd); a device may repeat."""
    for n, tp in ((8, None), (5, 1), (5, None), (8, 4)):
        jm = jax_model.make_mesh(jax.devices()[:n], tp=tp)
        tm = model.make_mesh(["cpu"] * n, tp=tp)
        assert dict(tm.shape) == dict(jm.shape), (n, tp)
        assert tm.axis_names == jm.axis_names == ("data", "model")
        assert tm.size == jm.size
    tm = model.make_mesh(["cpu"] * 8)
    assert tm.ranks == [torch.device("cpu")] * 8
    assert tm.coords(5) == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="tp must be in"):
        model.make_mesh(["cpu"], tp=2)


@pytest.mark.parametrize("name", ["mha", "moe"])
def test_param_and_fsdp_specs_match_jax(name):
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    jmesh, tmesh = _meshes()
    for jspecs, tspecs in (
            (jax_model.param_specs(jcfg), model.param_specs(tcfg)),
            (jax_model.fsdp_param_specs(jcfg, jmesh),
             model.fsdp_param_specs(tcfg, tmesh))):
        want = {p: tuple(s) for p, s in _paths(jax.tree.map(
            lambda s: s, jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))).items()}
        got = {p: tuple(s) for p, s in model._flatten(tspecs)}
        assert got == want
    assert tuple(model.batch_spec(tmesh)) == tuple(
        jax_model.batch_spec(jmesh))
    assert model.data_axes(tmesh) == jax_model.data_axes(jmesh)


@pytest.mark.parametrize("zero1", [False, True], ids=["moments", "zero1"])
@pytest.mark.parametrize("train_kw", [{}, {"accum_steps": 2,
                                           "grad_clip": 1.0}],
                         ids=["adamw", "accum-clip"])
def test_opt_state_specs_match_jax(zero1, train_kw):
    """Every moment (mu, nu and the accumulator) gets its param's spec,
    with the ZeRO-1 data cut when asked; the counts replicate."""
    jcfg, tcfg = _cfgs(**CONFIGS["moe"])
    jmesh, tmesh = _meshes()
    jspecs = jax_model.param_specs(jcfg)
    tspecs = model.param_specs(tcfg)
    want = jax_model.opt_state_shardings(
        jcfg, jax_model.make_optimizer(jax_model.TrainConfig(**train_kw)),
        jspecs, jmesh, zero1)
    got = model.opt_state_shardings(
        tcfg, model.make_optimizer(model.TrainConfig(**train_kw)), tspecs,
        tmesh, zero1)
    moments, others = _jax_moments(want)
    assert all(tuple(s.spec) == () for s in others)
    flat = {(key, path): tuple(spec) for key, tree in got.items()
            if isinstance(tree, dict) for path, spec in model._flatten(tree)}
    assert flat == {k: tuple(s.spec) for k, s in moments.items()}
    assert all(tuple(v) == () for v in got.values() if not isinstance(v, dict))


def test_resolved_for_mesh_takes_the_kernel_on_cuda(monkeypatch):
    """'auto' takes the kernel on a CUDA mesh whether or not the heads
    divide over 'model' (JAX's shard_map needs them to, so its 'auto'
    falls back to the einsum and its explicit 'pallas' is refused; the
    port attends over whole heads instead), and the einsum on the CPU;
    mesh_shardable, which picks head shards or whole heads, is JAX's."""
    grid = np.empty((4, 2), dtype=object)
    grid[...] = torch.device("cuda", 0)
    tmesh = model.Mesh(grid, ("data", "model"))
    jmesh = jax_model.make_mesh(jax.devices()[:8])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cpu = model.make_mesh(["cpu"] * 8)
    for kw, jax_route in (({}, "pallas"), ({"n_kv_heads": 2}, "pallas"),
                          ({"n_kv_heads": 1}, "einsum")):
        jcfg, tcfg = _cfgs(**kw)
        assert jcfg.resolved_for_mesh(jmesh).attention == jax_route
        assert tcfg.resolved_for_mesh(tmesh).attention == "kernel"
        assert tcfg.mesh_shardable(tmesh) == jcfg.mesh_shardable(jmesh)
        assert tcfg.resolved_for_mesh(cpu).attention == "einsum"
    jcfg, tcfg = _cfgs(n_kv_heads=1)
    with pytest.raises(ValueError, match="cannot shard over mesh"):
        dataclasses.replace(jcfg, attention="pallas").resolved_for_mesh(jmesh)
    kernel = dataclasses.replace(tcfg, attention="kernel")
    assert kernel.resolved_for_mesh(tmesh).attention == "kernel"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.resolved_for_mesh(cpu)


# ---- each rank's shard -------------------------------------------------


def _jax_shards(x, jmesh):
    """Each rank's (shape, index) of the JAX array ``x``, in rank order."""
    by_device = {s.device: s for s in x.addressable_shards}
    return [by_device[d] for d in jmesh.devices.flat]


@pytest.mark.parametrize("shard", MODES)
@pytest.mark.parametrize("name", ["gqa", "moe"])
def test_rank_shards_match_jax(name, shard):
    """Every param and moment: each rank's block has the shape of JAX's
    shard on the same rank's device, and (but for qkv, whose columns
    are head-aligned) covers the same slice of the global tensor."""
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    jmesh, tmesh = _meshes()
    train = jax_model.TrainConfig(accum_steps=2)
    jinit, _ = jax_model.make_sharded_train_step(jmesh, jcfg, train=train,
                                                 shard=shard)
    jp, jo = jinit(jax.random.PRNGKey(0))
    tp = model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    topt = model.make_optimizer(model.TrainConfig(accum_steps=2)).init(tp)
    sp = model.shard_params(tmesh, tcfg, tp, shard)
    so = model.shard_opt_state(tmesh, tcfg, topt, shard)
    moments, _ = _jax_moments(jo)
    pairs = [(p, leaf, _paths(jp)[p]) for p, leaf in model._flatten(sp)]
    pairs += [(f"{key}/{p}", leaf, moments[key, p])
              for key, tree in so.items() if isinstance(tree, dict)
              for p, leaf in model._flatten(tree)]
    assert len(pairs) == len(_paths(jp)) * 4      # params, mu, nu, acc
    for path, leaf, jx in pairs:
        for r, js in enumerate(_jax_shards(jx, jmesh)):
            block = leaf.blocks[r]
            assert tuple(block.shape) == tuple(js.data.shape), (path, r)
            if not path.endswith("qkv"):
                assert leaf.region(leaf.index_of(r)) == tuple(
                    slice(*sl.indices(n)[:2]) for sl, n in
                    zip(js.index, leaf.shape)), (path, r)


@pytest.mark.parametrize("shard", MODES)
@pytest.mark.parametrize("name", ["gqa", "unshardable", "moe"])
def test_gather_of_shard_is_exact(name, shard):
    """gather_params(shard_params(x)) == x and the same for the optimizer
    state, bit for bit (qkv's head-aligned order undone)."""
    _, tcfg = _cfgs(**CONFIGS[name])
    mesh = model.make_mesh(["cpu"] * 8)
    params = model.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig(accum_steps=2)).init(params)
    opt = {k: (model._map_tree(lambda t: torch.randn_like(t), v)
               if isinstance(v, dict) else v + 3) for k, v in opt.items()}
    back = model.gather_params(mesh, model.shard_params(mesh, tcfg, params,
                                                        shard))
    for (path, x), (_, y) in zip(model._flatten(params),
                                 model._flatten(back)):
        assert torch.equal(x, y), path
    back = model.gather_params(mesh, model.shard_opt_state(mesh, tcfg, opt,
                                                           shard))
    assert {k: v for k, v in back.items() if not isinstance(v, dict)} == {
        k: v for k, v in opt.items() if not isinstance(v, dict)}
    for key in ("mu", "nu", "acc"):
        for (path, x), (_, y) in zip(model._flatten(opt[key]),
                                     model._flatten(back[key])):
            assert torch.equal(x, y), (key, path)


def _jax_device_bytes(jmesh, jparams, jopt) -> list:
    """The bytes of JAX's params and moments (mu, nu; no counts) in each
    device's addressable shards, in rank order."""
    moments, _ = _jax_moments(jopt)
    out = [0] * jmesh.size
    for x in [*_paths(jparams).values(), *moments.values()]:
        for r, js in enumerate(_jax_shards(x, jmesh)):
            out[r] += js.data.nbytes
    return out


def test_rank_state_bytes_rank_the_modes():
    """Params + moments stored per rank at dp 4 × tp 2, as placed: each
    rank holds its own blocks, so every rank's bytes are JAX's
    addressable shards' on the same rank's device in each mode (a
    replicated block counts on each rank of its group: under none every
    rank holds the same, at least a tp-th of the state), and the blocks'
    storages, one per block, hold exactly the counted bytes, so no two
    ranks share one and no block keeps a whole tensor alive; the busiest
    rank ranks the modes fsdp < zero1 < none."""
    jcfg, tcfg = _cfgs()
    jmesh, mesh = _meshes()
    one_copy = 3 * 4 * sum(
        int(np.prod(shape)) for _, shape in model._flatten(
            model.param_shapes(tcfg)))
    held = {}
    for shard in MODES:
        params, opt = model.make_sharded_train_step(
            mesh, tcfg, shard=shard)[0](torch.Generator().manual_seed(0))
        held[shard] = model.rank_state_bytes(mesh, params, opt)
        jp, jo = jax_model.make_sharded_train_step(
            jmesh, jcfg, shard=shard)[0](jax.random.PRNGKey(0))
        assert held[shard] == _jax_device_bytes(jmesh, jp, jo), shard
        blocks = [t for tree in (params, opt["mu"], opt["nu"])
                  for _, leaf in model._flatten(tree)
                  for t in leaf.blocks.values()]
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in blocks}
        assert len(storages) == len(blocks), shard
        assert sum(storages.values()) == sum(held[shard]), shard
    assert held["none"] == [held["none"][0]] * 8
    assert 2 * held["none"][0] >= one_copy
    assert max(held["fsdp"]) < max(held["zero1"]) < max(held["none"])


# ---- K1/K2 per shard -----------------------------------------------------


def _rank_shards(leaf):
    """Each rank's block of ``leaf`` on its rank's device, in rank
    order."""
    return [leaf.blocks[r] for r in range(leaf.mesh.size)]


def _from_rank_shards(mesh, spec, shards):
    """The leaf whose ranks hold ``shards`` (one per rank, in rank
    order)."""
    leaf = model.Sharded(mesh, spec, tuple(shards[0].shape), {})
    leaf.shape = tuple(n * c for n, c in zip(leaf.shape, leaf.counts))
    leaf.blocks.update(enumerate(shards))
    return leaf


@pytest.mark.parametrize("h,hkv,window", [(4, 4, None), (4, 2, None),
                                          (4, 2, 8)],
                         ids=["mha", "gqa", "gqa-window"])
def test_sharded_flash_attention_matches_jax(h, hkv, window):
    """Forward and q/k/v gradients of make_sharded_flash_attention on a
    dp 4 × tp 2 mesh, each rank's [b/4, h/2, s, d] shard through
    flash_attention (its plain versions on the CPU), against JAX's
    shard_map of its Pallas kernel in interpret mode."""
    b, s, d = 4, 32, 16
    rng = np.random.default_rng(5)
    q, k, v, do = [rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, h, s, d))]
    jmesh, tmesh = _meshes()
    jattn = jax_attention.make_sharded_flash_attention(
        jmesh, causal=True, window=window, block_q=16, block_k=16)
    want, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    spec = model.P("data", "model", None, None)
    shards = [[t.requires_grad_() for t in _rank_shards(model.shard_tensor(
        tmesh, torch.from_numpy(x), spec))]
        for x in (q, k, v)]
    outs = attention.make_sharded_flash_attention(
        tmesh, causal=True, window=window)(*shards)
    got = model.gather_tensor(_from_rank_shards(tmesh, spec, outs))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    cot = _rank_shards(model.shard_tensor(tmesh, torch.from_numpy(do), spec))
    grads = torch.autograd.grad(outs, [t for ts in shards for t in ts], cot)
    for i, name in enumerate("qkv"):
        g = model.gather_tensor(_from_rank_shards(
            tmesh, spec, grads[i * 8:(i + 1) * 8]))
        np.testing.assert_allclose(_np(g), np.asarray(want_grads[i]),
                                   rtol=0, atol=GRAD_TOL, err_msg=name)


def test_sharded_flash_attention_replicated_heads():
    """Shards cut by batch only (heads whole on every rank of a batch
    block): each output equals flash_attention's on its block; a shard
    list that does not cover the mesh is refused."""
    mesh = model.make_mesh(["cpu"] * 8)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((4, 4, 16, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 2, 16, 8)).astype(
        np.float32))
    spec = model.P("data", None, None, None)
    qs, ks = (_rank_shards(model.shard_tensor(mesh, t, spec))
              for t in (q, k))
    outs = attention.make_sharded_flash_attention(mesh)(qs, ks, ks)
    want = attention.flash_attention(q, k, k)
    for r, out in enumerate(outs):
        assert torch.equal(out, want[r // 2:r // 2 + 1]), r
    with pytest.raises(ValueError, match="one q, k and v shard per rank"):
        attention.make_sharded_flash_attention(mesh)(qs[:4], ks[:4], ks[:4])
    with pytest.raises(ValueError, match="must have one shape"):
        attention.make_sharded_flash_attention(mesh)(
            qs[:7] + [qs[7][:, :2]], ks, ks)


# ---- the sharded train step ---------------------------------------------


STEP_CASES = {f"{name}-{shard}": (CONFIGS[name], shard, {})
              for name in CONFIGS for shard in MODES}
STEP_CASES["mha-zero1-clip"] = ({}, "zero1", {"grad_clip": 0.5})
STEP_CASES["gqa-fsdp-accum"] = (CONFIGS["gqa"], "fsdp",
                                {"accum_steps": 2, "warmup_steps": 1,
                                 "decay_steps": 6})


def _run_both(arch_kw, shard, train_kw, steps=5, jattention=None):
    jcfg, tcfg = _cfgs(**arch_kw)
    if jattention is not None:
        jcfg = dataclasses.replace(jcfg, attention=jattention)
    jmesh, tmesh = _meshes()
    jinit, jstep = jax_model.make_sharded_train_step(
        jmesh, jcfg, train=jax_model.TrainConfig(**train_kw), shard=shard)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    _, tstep = model.make_sharded_train_step(
        tmesh, tcfg, train=model.TrainConfig(**train_kw), shard=shard)
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig(**train_kw)).init(tparams)
    tparams = model.shard_params(tmesh, tcfg, tparams, shard)
    topt = model.shard_opt_state(tmesh, tcfg, topt, shard)
    for step in range(steps):
        tokens = _tokens(30 + step)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = _paths(jax.tree.map(np.asarray, jparams))
    for path, t in model._flatten(model.gather_params(tmesh, tparams)):
        np.testing.assert_allclose(_np(t), want[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)
    return tparams, topt


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_train_steps_match_jax(case):
    """Five make_sharded_train_step steps against JAX's on a dp 4 × tp 2
    mesh, from the same params and batches: losses within 1e-3 relative
    at every step, the gathered params within rtol 1e-3, atol 1e-5."""
    arch_kw, shard, train_kw = STEP_CASES[case]
    _, topt = _run_both(arch_kw, shard, train_kw)
    assert topt["count"] == 5 // train_kw.get("accum_steps", 1)


@pytest.fixture
def kernel_route(monkeypatch):
    """Send the port down its kernel route on the CPU (the plain versions
    of K1 and K2 through flash_attention's autograd.Function), counting
    the backward's calls."""
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    calls = {"backward": 0}
    real = attention.flash_attention_backward

    def spy(*args, **kwargs):
        calls["backward"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_backward", spy)
    return calls


def test_kernel_route_per_shard_matches_jax_pallas(kernel_route):
    """The kernel route (flash_attention on each rank's shard) against
    JAX's Pallas route through its shard_map, GQA under FSDP: every rank
    runs K2 once a layer a step."""
    _run_both(CONFIGS["gqa"], "fsdp", {}, steps=3, jattention="pallas")
    assert kernel_route["backward"] == 3 * 8 * ARCH["n_layers"]


def test_kernel_route_on_whole_heads_when_heads_do_not_divide(
        kernel_route):
    """MQA (one KV head) at tp 2: the kernel route gathers qkv on each
    data row's first rank and runs K1/K2 over the row's whole heads,
    once a row a layer; against JAX, whose shard_map needs heads that
    divide and so takes the einsum."""
    _run_both(CONFIGS["unshardable"], "zero1", {}, steps=3)
    assert kernel_route["backward"] == 3 * 4 * ARCH["n_layers"]


def test_mesh_step_equals_single_device_step():
    """The dp 4 × tp 2 step and the one-device step, in each shard mode
    (and make_train_step's own shard="zero1"/"fsdp", the same one-device
    step), from the same params and batches: the same losses and params
    after three steps (f32, summation order only)."""
    _, cfg = _cfgs(n_kv_heads=2, ce_chunk=4)
    init_fn, step_fn = model.make_train_step(cfg, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(3))
    mesh = model.make_mesh(["cpu"] * 8)
    runs = {"one": (step_fn, params, opt)}
    for shard in MODES:
        _, step = model.make_sharded_train_step(mesh, cfg, shard=shard)
        runs[shard] = (step, model.shard_params(mesh, cfg, params, shard),
                       model.shard_opt_state(mesh, cfg, opt, shard))
    for shard in ("zero1", "fsdp"):
        runs[f"one-{shard}"] = (model.make_train_step(
            cfg, device="cpu", shard=shard)[1], params, opt)
    for seed in range(3):
        tokens = _tokens(seed)
        losses = {}
        for name, (step, p, o) in runs.items():
            p, o, loss = step(p, o, tokens)
            runs[name] = (step, p, o)
            losses[name] = float(loss)
        for name, loss in losses.items():
            np.testing.assert_allclose(loss, losses["one"], rtol=1e-5,
                                       err_msg=name)
    want = dict(model._flatten(runs["one"][1]))
    for name, (_, p, _) in runs.items():
        got = p if name.startswith("one") else model.gather_params(mesh, p)
        for path, t in model._flatten(got):
            np.testing.assert_allclose(_np(t), _np(want[path]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {path}")


def test_sharded_step_refusals_match_jax():
    jcfg, tcfg = _cfgs()
    jmesh, tmesh = _meshes()
    for fn, mesh, cfg in ((jax_model.make_sharded_train_step, jmesh, jcfg),
                          (model.make_sharded_train_step, tmesh, tcfg)):
        with pytest.raises(ValueError, match="unknown shard mode 'zero3'"):
            fn(mesh, cfg, shard="zero3")
    _, step = model.make_sharded_train_step(tmesh, tcfg)
    init, _ = model.make_sharded_train_step(tmesh, tcfg)
    with pytest.raises(ValueError, match="not divisible by the 4-way"):
        step(*init(torch.Generator().manual_seed(0)), _tokens(0, b=6))
    with pytest.raises(ValueError, match="does not divide over the 2 ranks"):
        model.shard_params(tmesh, dataclasses.replace(tcfg, vocab=63),
                           model.init_params(torch.Generator().manual_seed(0),
                                             dataclasses.replace(
                                                 tcfg, vocab=63), "cpu"))


# ---- the CLIs ------------------------------------------------------------


def _train(tmp_path, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.train",
         "--platform", "cpu", "--vocab", "64", "--d-model", "32",
         "--n-layers", "1", "--seq-len", "16", "--batch", "4",
         "--checkpoint-dir", str(tmp_path / "ckpt"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_mesh_trains_resumes_drains_and_generate_reads_it(tmp_path):
    """``--tp 2 --shard fsdp`` on the CPU (dp 1 × tp 2): 4 steps with a
    checkpoint every 2, resume to 6 under ``--tp 2 --zero1``, drain; the
    checkpoints hold the one-device layout (step 2's params are exactly
    the gathered params of the same mesh step run here on the JAX
    trainer's batches), and generate reads them."""
    first = _train(tmp_path, "--tp", "2", "--shard", "fsdp", "--steps", "4",
                   "--checkpoint-every", "2")
    assert first.returncode == 0, first.stderr
    assert "mesh {'data': 1, 'model': 2}, shard fsdp on cpu, cpu" \
        in first.stderr
    assert "training complete at step 4" in first.stderr
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2", "step_4"]
    cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=1, seq_len=16)
    mesh = model.make_mesh(["cpu"] * 2, tp=2)
    init_fn, step_fn = model.make_sharded_train_step(mesh, cfg, shard="fsdp")
    state = init_fn(torch.Generator().manual_seed(0))
    for step in range(2):
        tokens = np.random.default_rng((step << 16) | 0).integers(
            0, 64, (4, 17), dtype=np.int32)
        *state, _ = step_fn(*state, tokens)
    got = dict(model._flatten(model.load_params(str(tmp_path / "ckpt"), 2,
                                                "cpu")))
    for path, t in model._flatten(model.gather_params(mesh, state[0])):
        assert torch.equal(got[path], t), path
    second = _train(tmp_path, "--tp", "2", "--zero1", "--steps", "6",
                    "--checkpoint-every", "2")
    assert second.returncode == 0, second.stderr
    assert "resumed from checkpoint step 4" in second.stderr
    assert "training complete at step 6" in second.stderr
    annotations = tmp_path / "annotations"
    annotations.write_text('autoscaler.tpu.dev/checkpoint-requested="1"\n')
    drain = _train(tmp_path, "--tp", "2", "--shard", "fsdp", "--steps",
                   "5000", "--annotations-file", str(annotations))
    assert drain.returncode == 0, drain.stderr
    assert "drain requested: checkpointed at step 6" in drain.stderr
    with np.load(tmp_path / "ckpt" / "step_6" / "opt.npz") as npz:
        assert int(npz["count"]) == 6
        assert npz["mu/blocks/qkv"].shape == (1, 32, 96)
    gen = subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.generate",
         "--platform", "cpu", "--vocab", "64", "--d-model", "32",
         "--n-layers", "1", "--seq-len", "16", "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--prompt", "1,2,3", "--batch", "2",
         "--steps", "4"], capture_output=True, text=True, timeout=240,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert gen.returncode == 0, gen.stderr
    assert "loaded step 6" in gen.stderr


def test_cli_mesh_usage_errors(tmp_path):
    for flags, match in ((["--tp", "0"], "tp must be in"),
                         (["--tp", "3"], "does not divide over the 3 ranks"),
                         (["--tp", "2", "--vocab", "63"],
                          "does not divide over the 2 ranks")):
        res = CliRunner().invoke(train_cli.main, [
            "--platform", "cpu", "--steps", "1", "--checkpoint-dir",
            str(tmp_path), "--d-model", "32", *flags])
        assert res.exit_code == 2, res.output
        assert match in " ".join(res.output.split()), (flags, res.output)
        assert not os.listdir(tmp_path)


def _checkpoints(tmp_path):
    """The same model as a port checkpoint and a JAX (orbax) one."""
    arch = dict(vocab=64, d_model=32, n_layers=2, seq_len=16)
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(**arch), "cpu")
    model.save_params(str(tmp_path / "port"), 1, params)
    jp = jax_model.init_params(jax.random.PRNGKey(0),
                               jax_model.ModelConfig(**arch))
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), 1,
                                   {"params": jp, "opt": {}})
    return ["--vocab", "64", "--d-model", "32", "--n-layers", "2",
            "--seq-len", "16"]


CLI_ARGS = {"serve": ["--random", "2", "--max-len", "32", "--chunk", "8"],
            "generate": ["--steps", "3", "--batch", "8"]}


@pytest.mark.parametrize("tp", [None, "1", "2"], ids=["none", "1", "2"])
@pytest.mark.parametrize("cli", ["serve", "generate"])
def test_serve_and_generate_tp_one_device_or_the_mesh(tmp_path, cli, tp,
                                                      monkeypatch):
    """--tp None and 1 serve on one device; 2 (dividing the 8 devices the
    JAX tests see) serves under the dp 4 × tp 2 mesh: the same output,
    a final_stats line or 8 generate rows."""
    mod = {"serve": serve, "generate": generate}[cli]
    monkeypatch.setattr(mod, "device_count", lambda platform: 8)
    flags = _checkpoints(tmp_path)
    extra = [] if tp is None else ["--tp", tp]
    res = CliRunner().invoke(mod.main, [
        "--checkpoint-dir", str(tmp_path / "port"), "--platform", "cpu",
        *flags, *CLI_ARGS[cli], *extra]
        + (["--annotations-file", str(tmp_path / "none")]
           if cli == "serve" else []))
    assert res.exit_code == 0, res.output
    lines = res.stdout.strip().splitlines()
    assert lines and ("final_stats" in lines[-1] if cli == "serve"
                      else len(lines) == 8)


@pytest.mark.parametrize("cli", ["serve", "generate"])
def test_serve_and_generate_tp_usage_errors_match_jax(tmp_path, cli,
                                                      monkeypatch):
    """A --tp that does not divide the devices: the JAX CLI's exit code
    and message, on the same 8 devices.  On the port's one CPU a --tp
    above the device count repeats it round-robin, as the trainer's
    --tp does, and serves."""
    mod = {"serve": serve, "generate": generate}[cli]
    jmod = {"serve": jax_serve, "generate": jax_generate}[cli]
    flags = _checkpoints(tmp_path) + CLI_ARGS[cli]
    extra = ["--annotations-file", str(tmp_path / "none")] \
        if cli == "serve" else []
    theirs = CliRunner().invoke(jmod.main, [
        "--checkpoint-dir", str(tmp_path / "jax"), *flags, *extra,
        "--tp", "3"])
    error = [line for line in theirs.output.splitlines()
             if line.startswith("Error:")]
    assert theirs.exit_code == 2 and error == [
        "Error: --tp 3 must divide the 8 available devices"]
    monkeypatch.setattr(mod, "device_count", lambda platform: 8)
    mine = CliRunner().invoke(mod.main, [
        "--checkpoint-dir", str(tmp_path / "port"), "--platform", "cpu",
        *flags, *extra, "--tp", "3"])
    assert mine.exit_code == 2 and error[0] in mine.output.splitlines()
    monkeypatch.undo()
    mine = CliRunner().invoke(mod.main, [
        "--checkpoint-dir", str(tmp_path / "port"), "--platform", "cpu",
        *flags, *extra, "--tp", "2"])
    assert mine.exit_code == 0, mine.output
    lines = mine.stdout.strip().splitlines()
    assert "final_stats" in lines[-1] if cli == "serve" else len(lines) == 8
