"""The port's EP and SP compositions against the JAX package's, on the
CPU: ep×tp (``moe.make_ep_mesh(tp=2)``, the model-cut expert FFN and
the tensor-parallel attention of ``_ep_tp_block``), the ep step's
sharded expert state, a data axis beside sp, sp×tp (ring and Ulysses),
sp×ep×tp, and ZeRO-1 under sp.

JAX runs on the conftest's 8 virtual CPU devices, the port on ``cpu``
repeated, on meshes of the same shape; the same weights (JAX's, carried
across with ``params_from_jax``) and numpy-made batches go through
both in f32 for three steps.  Tolerances: losses within 2e-5 relative
and the params after three steps within 2e-4 (rtol and atol), the
``test_torch_moe.py`` bounds; the one-row-pool ep×tp loss against the
one-device loss within 2e-5 relative and its balance loss within 1e-4,
JAX's own bounds (``tests/test_moe.py``); shapes, specs, state bytes and
round trips exactly.  The port's "pallas" ring runs the plain versions
of K5/K6 on CPU ranks, and its ep×tp attention the einsum (K1/K2 on CUDA
ranks); JAX's pallas ring runs in interpret mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import moe as jax_moe  # noqa: E402
from tpu_autoscaler.workloads import sp as jax_sp  # noqa: E402
from tpu_autoscaler_torch.workloads import model, moe, sp  # noqa: E402

ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=32)
MOE = dict(moe_experts=4, moe_top_k=2)
LOSS_RTOL = 2e-5
PARAM_TOL = 2e-4


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(**kw):
    arch = {**ARCH, **kw}
    return (jax_model.ModelConfig(**arch, dtype=jnp.float32),
            model.ModelConfig(**arch, dtype=torch.float32))


def _tokens(b, seq_len, seed):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, seq_len + 1)).astype(np.int32)


def _jax_paths(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _meshes(kind, data, n, tp):
    """JAX's and the port's (data, sp|ep[, model]) mesh of n ranks."""
    if kind == "sp":
        return (jax_sp.make_sp_mesh(jax.devices()[:data * n * tp], sp=n,
                                    tp=tp),
                sp.make_sp_mesh(["cpu"] * (data * n * tp), sp=n, tp=tp))
    return (jax_moe.make_ep_mesh(jax.devices()[:data * n * tp], ep=n, tp=tp),
            moe.make_ep_mesh(["cpu"] * (data * n * tp), ep=n, tp=tp))


def _three_steps(kind, jmesh, tmesh, jcfg, tcfg, *, batch, impl=None,
                 shard="none"):
    """Three steps of both packages' sp or ep step from JAX's initial
    params on the same batches, the losses (and, for a MoE step, the
    router metrics) held at every step and the params after them.
    Returns the port's (params, opt state)."""
    if kind == "sp":
        jinit, jstep = jax_sp.make_sp_train_step(jmesh, jcfg, impl=impl,
                                                 shard=shard)
        _, tstep = sp.make_sp_train_step(tmesh, tcfg, impl=impl, shard=shard)
    else:
        jinit, jstep = jax_moe.make_ep_train_step(jmesh, jcfg)
        _, tstep = moe.make_ep_train_step(tmesh, tcfg)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    if kind == "sp":
        topt = sp.shard_sp_opt_state(tmesh, tcfg, topt, shard)
    else:
        tparams = moe.shard_ep_params(tmesh, tcfg, tparams)
        topt = moe.shard_ep_opt_state(tmesh, tcfg, topt)
    for step in range(3):
        tokens = _tokens(batch, tcfg.seq_len, 40 + step)
        jout = jstep(jparams, jopt, jnp.asarray(tokens))
        tout = tstep(tparams, topt, tokens)
        (jparams, jopt, jl), (tparams, topt, tl) = jout[:3], tout[:3]
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        if tcfg.moe_experts is not None:
            for name in ("ce", "balance_loss", "z_loss"):
                np.testing.assert_allclose(
                    float(tout[3][name]), float(jout[3][name]),
                    rtol=LOSS_RTOL, err_msg=f"{name} step {step}")
    want = _jax_paths(jparams)
    got = model.gather_params(tmesh, tparams) if kind == "ep" else tparams
    for path, t in model._flatten(got):
        np.testing.assert_allclose(_np(t), want[path], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)
    return tparams, topt


# ---- sequence parallelism -----------------------------------------------


SP_CASES = {
    "data2-sp2-einsum": (2, 2, 1, "einsum", {}, "none"),
    "data2-sp2-ulysses": (2, 2, 1, "ulysses", {}, "none"),
    "sp2-tp2-einsum": (2, 2, 2, "einsum", {}, "none"),
    "sp2-tp2-kernel-ring": (2, 2, 2, "pallas", {}, "none"),
    "sp2-tp2-ulysses": (2, 2, 2, "ulysses", {}, "none"),
    "sp2-tp2-gqa-window-remat": (2, 2, 2, "einsum",
                                 dict(n_kv_heads=2, attention_window=12,
                                      remat=True), "none"),
    "data2-sp2-zero1": (2, 2, 1, "einsum", {}, "zero1"),
    "sp2-tp2-zero1": (2, 2, 2, "einsum", {}, "zero1"),
    "data2-sp2-ep": (2, 2, 1, "einsum", MOE, "none"),
    "sp2-ep-tp2": (2, 2, 2, "einsum", MOE, "none"),
}


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sp_compositions_match_jax(case):
    """make_sp_train_step on a (data, sp[, model]) mesh against JAX's:
    the batch over data, the sequence over sp, heads and d_ff over
    model, experts over sp; three steps."""
    data, n, tp, impl, kw, shard = SP_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    jmesh, tmesh = _meshes("sp", data, n, tp)
    assert dict(tmesh.shape) == dict(jmesh.shape)
    _three_steps("sp", jmesh, tmesh, jcfg, tcfg, batch=4, impl=impl,
                 shard=shard)


@pytest.mark.parametrize("tp", [1, 2], ids=["sp", "sp-tp"])
def test_zero1_under_sp_cuts_the_moments_over_data_and_sp(tp):
    """ZeRO-1 under sp (JAX tests/test_sp.py's zero1 test): every moment
    is cut over (data, sp), as JAX's opt_state_shardings cut it, each
    rank's slice 1/4 of the whole and every rank holding its own (the
    model ranks of a (data, sp) coordinate each a copy, as JAX's devices
    each hold their shard); the params stay one copy."""
    jcfg, tcfg = _cfgs()
    jmesh, tmesh = _meshes("sp", 2, 2, tp)
    jinit, _ = jax_sp.make_sp_train_step(jmesh, jcfg, shard="zero1")
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tparams, topt = sp.make_sp_train_step(tmesh, tcfg, shard="zero1")[0](
        torch.Generator().manual_seed(0))
    jmu = {"/".join(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(jopt[0].mu)[0]}
    for path, leaf in model._flatten(topt["mu"]):
        assert tuple(leaf.spec) == tuple(jmu[path].sharding.spec), path
        assert {tuple(t.shape) for t in leaf.blocks.values()} == {
            tuple(jmu[path].sharding.shard_shape(jmu[path].shape))}, path
    qkv = topt["mu"]["blocks"]["qkv"]
    assert sorted(qkv.blocks) == list(range(tmesh.size))
    assert len({qkv.indices[r] for r in qkv.blocks}) == 4
    assert all(4 * t.numel() == int(np.prod(qkv.shape))
               for t in qkv.blocks.values())
    assert all(isinstance(t, torch.Tensor) for _, t in
               model._flatten(tparams))


def test_zero1_under_sp_gathers_and_cuts_exactly():
    """shard_sp_opt_state then gather_params gives the one-device state
    back bit for bit (the checkpoint layout)."""
    _, tcfg = _cfgs()
    mesh = sp.make_sp_mesh(["cpu"] * 8, sp=2, tp=2)
    params = model.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    opt = {k: (model._map_tree(torch.randn_like, v) if isinstance(v, dict)
               else v + 2) for k, v in opt.items()}
    back = model.gather_params(mesh, sp.shard_sp_opt_state(mesh, tcfg, opt))
    assert back["count"] == opt["count"]
    for key in ("mu", "nu"):
        for (path, a), (_, b) in zip(model._flatten(opt[key]),
                                     model._flatten(back[key])):
            assert torch.equal(a, b), (key, path)


def test_sp_tp_kernel_ring_runs_one_ring_per_row_and_rank(monkeypatch):
    """Under data 2 × sp 2 × tp 2 the kernel ring runs once per (data
    row, model rank): 4 rings a layer, each over its 2 sp ranks on the
    rank's h/tp heads."""
    from tpu_autoscaler_torch.workloads import ring_attention

    calls = []
    real = ring_attention._ring_attn_local_kernel

    def spy(qs, ks, vs, devices, **kw):
        calls.append((len(devices), qs[0].shape[1], ks[0].shape[1]))
        return real(qs, ks, vs, devices, **kw)

    monkeypatch.setattr(ring_attention, "_ring_attn_local_kernel", spy)
    _, tcfg = _cfgs(n_kv_heads=2)
    mesh = sp.make_sp_mesh(["cpu"] * 8, sp=2, tp=2)
    init_fn, step = sp.make_sp_train_step(mesh, tcfg, impl="pallas")
    step(*init_fn(torch.Generator().manual_seed(0)), _tokens(4, 32, 0))
    assert calls == [(2, 2, 1)] * (4 * ARCH["n_layers"])


# ---- expert parallelism ---------------------------------------------------


def _ep_cfgs(**kw):
    return _cfgs(**{**MOE, "seq_len": 16, "moe_capacity_factor": 64.0,
                    **kw})


@pytest.mark.parametrize("batch,kw", [
    (4, {}), (8, dict(moe_balance_weight=0.0, moe_z_weight=0.0))],
    ids=["one-row-pools", "multi-row-aux-off"])
def test_ep_tp_no_drop_loss_equals_one_device(batch, kw):
    """JAX's ep×tp parity cases (tests/test_moe.py): at ample capacity
    on data 2 × ep 2 × model 2, with one row per routing pool the loss
    equals the one-device loss_and_metrics (and the balance loss the
    per-row one), and with the router losses off the multi-row pools'
    loss does too; both equal JAX's step."""
    jcfg, tcfg = _ep_cfgs(**kw)
    jmesh, tmesh = _meshes("ep", 2, 2, 2)
    assert dict(tmesh.shape) == dict(jmesh.shape) == {
        "data": 2, "ep": 2, "model": 2}
    tokens = _tokens(batch, 16, 3)
    jinit, jstep = jax_moe.make_ep_train_step(jmesh, jcfg)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    _, _, jloss, _ = jstep(jparams, jopt, jnp.asarray(tokens))
    ref, ref_m = model.loss_and_metrics(params, torch.from_numpy(tokens),
                                        tcfg)
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    _, _, loss, metrics = moe.make_ep_train_step(tmesh, tcfg)[1](
        params, opt, tokens)
    np.testing.assert_allclose(float(loss), float(ref), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    if batch == 4:
        np.testing.assert_allclose(float(metrics["balance_loss"]),
                                   float(ref_m["balance_loss"]), atol=1e-4)


EP_CASES = {
    "data2-ep2-tp2-drops": (2, 2, 2, dict(moe_capacity_factor=1.0)),
    "data2-ep2-tp2-gqa": (2, 2, 2, dict(n_kv_heads=2)),
    "data1-ep4-tp2-window-remat": (1, 4, 2, dict(attention_window=8,
                                                 remat=True)),
    "data2-ep4": (2, 4, 1, {}),
}


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_compositions_match_jax(case):
    """make_ep_train_step on sharded state over (data, ep[, model])
    against JAX's: three steps; the port's step keeps the state cut."""
    data, n, tp, kw = EP_CASES[case]
    jcfg, tcfg = _cfgs(**{**MOE, "seq_len": 16, **kw})
    jmesh, tmesh = _meshes("ep", data, n, tp)
    tparams, topt = _three_steps("ep", jmesh, tmesh, jcfg, tcfg, batch=8)
    assert isinstance(tparams["blocks"]["w1"], model.Sharded)
    assert topt["count"] == 3


@pytest.mark.parametrize("n,tp", [(2, 1), (2, 2), (4, 2)],
                         ids=["ep2", "ep2-tp2", "ep4-tp2"])
def test_ep_state_bytes_fall_by_ep_and_tp(n, tp):
    """Each rank stores 1/(ep·tp) of the expert weights and of their
    Adam moments (JAX's shard shapes), and its own copy of the dense
    state: every rank's params and moments weigh what JAX's addressable
    shards weigh on its device; every block on its rank's device; the
    one-device layout round-trips bit for bit through shard and
    gather."""
    jcfg, tcfg = _ep_cfgs()
    jmesh, tmesh = _meshes("ep", 2, n, tp)
    jparams, jopt = jax_moe.make_ep_train_step(jmesh, jcfg)[0](
        jax.random.PRNGKey(0))
    params, opt = moe.make_ep_train_step(tmesh, tcfg)[0](
        torch.Generator().manual_seed(0))
    for name in ("w1", "w2"):
        leaf, jleaf = params["blocks"][name], jparams["blocks"][name]
        shapes = {tuple(t.shape) for t in leaf.blocks.values()}
        assert shapes == {tuple(jleaf.sharding.shard_shape(jleaf.shape))}
        assert sorted(leaf.blocks) == list(range(tmesh.size))
        assert len({leaf.indices[r] for r in leaf.blocks}) == n * tp
    jmoments = [leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(jopt)[0]
                if any(getattr(k, "name", None) in ("mu", "nu")
                       for k in path)]
    jbytes = [0] * jmesh.size
    for x in jax.tree_util.tree_leaves(jparams) + jmoments:
        by_device = {sh.device: sh for sh in x.addressable_shards}
        for r, dev in enumerate(jmesh.devices.flat):
            jbytes[r] += by_device[dev].data.nbytes
    # JAX has 8 devices: at ep 4 × tp 2 its mesh has one data row, whose
    # bytes each of the port's data rows repeats.
    assert model.rank_state_bytes(tmesh, params, opt) \
        == jbytes * (tmesh.size // jmesh.size)
    experts = {"blocks": {k: params["blocks"][k] for k in ("w1", "w2")}}
    moments = {key: {"blocks": {k: opt[key]["blocks"][k]
                                for k in ("w1", "w2")}}
               for key in ("mu", "nu")}
    held = model.rank_state_bytes(tmesh, experts, moments)
    whole = 3 * 4 * sum(int(np.prod(leaf.shape))
                        for leaf in experts["blocks"].values())
    assert held == [whole // (n * tp)] * tmesh.size
    one = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    back = model.gather_params(tmesh, moe.shard_ep_params(tmesh, tcfg, one))
    for (path, a), (_, b) in zip(model._flatten(one), model._flatten(back)):
        assert torch.equal(a, b), path
    state = model.make_optimizer(model.TrainConfig()).init(one)
    state = {k: (model._map_tree(torch.randn_like, v)
                 if isinstance(v, dict) else v) for k, v in state.items()}
    back = model.gather_params(
        tmesh, moe.shard_ep_opt_state(tmesh, tcfg, state))
    for key in ("mu", "nu"):
        for (path, a), (_, b) in zip(model._flatten(state[key]),
                                     model._flatten(back[key])):
            assert torch.equal(a, b), (key, path)


def test_ep_step_keeps_the_layout_it_is_given():
    """A step given the one-device layout returns it (the earlier
    callers' contract), and computes what the step on the cut state
    computes."""
    _, tcfg = _ep_cfgs(moe_capacity_factor=1.25)
    mesh = moe.make_ep_mesh(["cpu"] * 8, ep=2, tp=2)
    init_fn, step = moe.make_ep_train_step(mesh, tcfg)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    one = (model.gather_params(mesh, params), model.gather_params(mesh, opt))
    tokens = _tokens(8, 16, 5)
    params, opt, loss, _ = step(params, opt, tokens)
    p1, o1, l1, _ = step(*one, tokens)
    assert isinstance(p1["blocks"]["w1"], torch.Tensor)
    assert float(l1) == float(loss)
    for (path, a), (_, b) in zip(model._flatten(p1), model._flatten(
            model.gather_params(mesh, params))):
        assert torch.equal(a, b), path


# ---- the refusals -----------------------------------------------------------


def _same_error(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,ep,tp", [(6, 4, 1), (8, 3, 2), (4, None, 8),
                                     (8, 2, 0)],
                         ids=["ep", "ep-tp", "tp-over-n", "tp-zero"])
def test_ep_mesh_refusals_match_jax(n, ep, tp):
    _same_error(lambda: jax_moe.make_ep_mesh(jax.devices()[:n], ep=ep,
                                             tp=tp),
                lambda: moe.make_ep_mesh(["cpu"] * n, ep=ep, tp=tp))


@pytest.mark.parametrize("n,sp_n,tp", [(6, 4, 1), (8, 3, 2), (8, 4, 3)],
                         ids=["sp", "sp-tp", "tp"])
def test_sp_mesh_refusals_match_jax(n, sp_n, tp):
    _same_error(lambda: jax_sp.make_sp_mesh(jax.devices()[:n], sp=sp_n,
                                            tp=tp),
                lambda: sp.make_sp_mesh(["cpu"] * n, sp=sp_n, tp=tp))


@pytest.mark.parametrize("kind,kw,impl", [
    ("ep", dict(n_heads=3, d_model=48), None),
    ("ep", dict(d_ff=65), None),
    ("ep", dict(moe_experts=5), None),
    ("sp", dict(n_heads=3, d_model=48), "einsum"),
    ("sp", dict(d_ff=65), "einsum"),
    ("sp", dict(n_heads=8, d_model=64, n_kv_heads=2), "ulysses"),
    ("sp", dict(moe_experts=3, moe_top_k=1), "einsum"),
], ids=["ep-tp-heads", "ep-tp-dff", "ep-experts", "sp-tp-heads",
        "sp-tp-dff", "sp-tp-ulysses-local-heads", "sp-ep-experts"])
def test_step_refusals_match_jax(kind, kw, impl):
    """make_ep_train_step / make_sp_train_step on a (data 2, ·2, model 2)
    mesh refuse what JAX refuses, with JAX's words."""
    jcfg, tcfg = _cfgs(**{**MOE, **kw} if kind == "ep" else kw)
    jmesh, tmesh = _meshes(kind, 2, 2, 2)
    if kind == "ep":
        _same_error(lambda: jax_moe.make_ep_train_step(jmesh, jcfg),
                    lambda: moe.make_ep_train_step(tmesh, tcfg))
    else:
        _same_error(
            lambda: jax_sp.make_sp_train_step(jmesh, jcfg, impl=impl),
            lambda: sp.make_sp_train_step(tmesh, tcfg, impl=impl))


def test_ep_and_sp_steps_take_the_earlier_device_lists():
    """The grid of rows and the plain device list earlier callers pass
    are the (data, ep) and one-row (data, sp) meshes."""
    _, tcfg = _ep_cfgs()
    grid = [["cpu"] * 2] * 2
    params = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    tokens = _tokens(4, 16, 1)
    a = moe.make_ep_train_step(grid, tcfg)[1](params, opt, tokens)
    b = moe.make_ep_train_step(moe.make_ep_mesh(["cpu"] * 4, ep=2), tcfg)[1](
        params, opt, tokens)
    assert float(a[2]) == float(b[2])
    cfg = dataclasses.replace(tcfg, moe_experts=None)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    a = sp.make_sp_train_step(["cpu"] * 2, cfg)[1](params, opt, tokens)
    b = sp.make_sp_train_step(sp.make_sp_mesh(["cpu"] * 2, sp=2), cfg)[1](
        params, opt, tokens)
    assert float(a[2]) == float(b[2])
