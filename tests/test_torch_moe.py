"""The port's mixture-of-experts paths against the JAX package's, on the
CPU: the routing rule, the reference and the model's per-row MoE FFN,
the loss with the router losses, the single-device train step, the
linear, ring and paged engines and ``generate`` on a MoE model, the
expert-parallel layer and train step, sp×ep, checkpoints and the CLIs.

The same numpy-made inputs and the same weights (JAX's, carried across
with ``params_from_jax``) go through both packages in f32; JAX runs on
the conftest's 8 virtual CPU devices, the port's ranks are ``cpu``
repeated.  Tolerances: routing integers (expert, rank, keep) exactly
equal; gates and router losses 1e-6; the reference and ``moe_ffn``
2e-5; the loss 2e-5 relative; greedy tokens exactly equal.  Routing is
computed from logits that agree to ~1e-6, so where a test routes from
logits each package computed itself, it reports the smallest gap
between the k-th and (k+1)-th router probability beside any flip.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import moe as jax_moe  # noqa: E402
from tpu_autoscaler.workloads import paged as jax_paged  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler.workloads import sp as jax_sp  # noqa: E402
from tpu_autoscaler.workloads import train as jax_train  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    decode,
    model,
    moe,
    paged,
    serving,
    sp,
)
from tpu_autoscaler_torch.workloads import train as train_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16, moe_experts=8, moe_top_k=2)
GATE_TOL = 1e-6
FFN_TOL = 2e-5
LOSS_RTOL = 2e-5


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(**kw):
    """The same MoE config in both packages, f32 (JAX on its einsum
    attention)."""
    arch = {**ARCH, **kw}
    return (jax_model.ModelConfig(**arch, dtype=jnp.float32,
                                  attention="einsum"),
            model.ModelConfig(**arch, dtype=torch.float32))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, s)).astype(np.int32)


def _topk_gap(logits, k) -> float:
    """The smallest gap, over tokens, between the k-th and (k+1)-th
    router probability: what a routing flip needs to be rounding."""
    probs = np.sort(np.asarray(jax.nn.softmax(np.asarray(logits), -1)), -1)
    return float((probs[..., -k] - probs[..., -k - 1]).min())


def _assert_same_routing(jlogits, tlogits, k, cap):
    """route_topk on each package's own [b, n, e] logits, each row a
    pool: the integers equal, or a failure naming the logits' difference
    and the top-k gap."""
    a = jax.vmap(lambda row: jax_moe.route_topk(row, k, cap))(
        jnp.asarray(jlogits))
    b = moe.route_topk(torch.as_tensor(tlogits), k, cap)
    for i, name in ((0, "expert"), (1, "rank"), (3, "keep")):
        ok = np.array_equal(np.asarray(a[i]), _np(b[i]))
        assert ok, (f"routing flip in {name}: |dlogits| "
                    f"{np.abs(np.asarray(jlogits) - _np(tlogits)).max()}, "
                    f"top-{k} gap {_topk_gap(jlogits, k)}")


# -- the routing rule -----------------------------------------------------


def _route_logits(case, n=32, e=8):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    if case == "ties":
        logits[::3] = 0.0                    # uniform rows
        logits[1::3, :4] = 1.5               # four-way ties at the top
    elif case == "balanced":
        # tests/test_moe.py's round-robin peaked logits.
        logits = np.full((n, e), -10.0, np.float32)
        logits[np.arange(n), np.arange(n) % e] = 10.0
    return logits


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case,cap", [("random", 64), ("ties", 64),
                                      ("drops", 2), ("balanced", 64),
                                      ("ties-drops", 3)])
def test_route_topk_matches_jax(case, cap, k):
    """The same logits through both rules: expert, rank and keep exactly
    equal (ties take the lower expert first in both), gates and the
    router losses within 1e-6."""
    logits = _route_logits(case.split("-")[0])
    want = jax_moe.route_topk(jnp.asarray(logits), k, cap)
    got = moe.route_topk(torch.from_numpy(logits), k, cap)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(_np(got[i]), np.asarray(want[i]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]),
                               rtol=GATE_TOL, atol=GATE_TOL)
    for name in ("balance_loss", "z_loss", "expert_fraction"):
        np.testing.assert_allclose(_np(got[4][name]),
                                   np.asarray(want[4][name]),
                                   rtol=GATE_TOL, atol=GATE_TOL, err_msg=name)
    keep = _np(got[3])
    assert keep.all() == (case in ("random", "ties", "balanced"))


def test_route_topk_batched_equals_per_pool():
    """Leading dims are independent pools: routing a [3, n, e] stack
    equals routing each [n, e] pool alone."""
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 16, 8)).astype(np.float32))
    stacked = moe.route_topk(logits, 2, 3)
    for g in range(3):
        alone = moe.route_topk(logits[g], 2, 3)
        for i in range(4):
            assert torch.equal(stacked[i][g], alone[i])
        for name in alone[4]:
            assert torch.equal(stacked[4][name][g], alone[4][name])


@pytest.mark.parametrize("top_k,capacity", [(1, None), (2, None), (2, 6)])
def test_moe_reference_matches_jax(top_k, capacity):
    cfg = jax_moe.MoeConfig(num_experts=8, top_k=top_k)
    params = jax_moe.init_moe_params(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32)
    want = jax_moe.moe_reference(params, jnp.asarray(x), capacity, top_k)
    got = moe.moe_reference(model.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"), torch.from_numpy(x),
        capacity, top_k)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=FFN_TOL,
                               atol=FFN_TOL)
    if capacity is not None:       # some tokens dropped entirely
        assert (np.abs(_np(got)).sum(axis=1) == 0).any()


def test_init_moe_params_shapes_and_seed():
    cfg = moe.MoeConfig(d_model=16, d_ff=24, num_experts=4)
    a = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "router": (16, 4), "w1": (4, 16, 24), "w2": (4, 24, 16)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="top_k must be in"):
        moe.MoeConfig(num_experts=4, top_k=5)


# -- the model ------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"moe_top_k": 1},
                                {"moe_capacity_factor": 0.5}],
                         ids=["top2", "top1", "drops"])
def test_moe_ffn_matches_jax(kw):
    """moe_ffn on the same [b, s, d] activations and layer: the routing
    of each row equal, the output within 2e-5, the row-mean router
    losses within 1e-6."""
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, seed=2)
    y = np.random.default_rng(5).standard_normal((3, 16, 32)).astype(
        np.float32)
    jlayer = {n: w[1] for n, w in jp["blocks"].items()}
    tlayer = {n: w[1] for n, w in tp["blocks"].items()}
    want, jaux = jax_model.moe_ffn(jnp.asarray(y), jlayer, jcfg)
    got, taux = model.moe_ffn(torch.from_numpy(y), tlayer, tcfg)
    cap = max(1, int(tcfg.moe_capacity_factor * 16 * tcfg.moe_top_k / 8))
    _assert_same_routing(
        jnp.einsum("bsd,de->bse", y, jlayer["router"]),
        torch.from_numpy(y) @ tlayer["router"], tcfg.moe_top_k, cap)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=FFN_TOL,
                               atol=FFN_TOL)
    for name in ("balance_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=GATE_TOL, atol=GATE_TOL)


def test_moe_params_and_loss_match_jax():
    """MoE leaves in param_shapes/init_params, and loss_and_metrics (the
    cross-entropy plus the weighted per-layer-mean router losses) within
    2e-5 relative of JAX's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    want_shapes = {p: tuple(v.shape) for p, v in model._flatten(tp)}
    assert dict(model._flatten(model.param_shapes(tcfg))) == want_shapes
    assert want_shapes["blocks/router"] == (2, 32, 8)
    assert want_shapes["blocks/w1"] == (2, 8, 32, 64)
    mine = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {p: tuple(v.shape) for p, v in model._flatten(mine)} \
        == want_shapes
    tokens = _tokens(3, 17, seed=1)
    jl, jm = jax_model.loss_and_metrics(jp, jnp.asarray(tokens), jcfg)
    tl, tm = model.loss_and_metrics(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for name in ("ce", "balance_loss", "z_loss"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert float(tl) > float(tm["ce"])


def test_cast_params_keeps_the_router_f32():
    _, tcfg = _cfgs()
    tp = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    cast = model.cast_params(tp, torch.bfloat16)
    assert cast["blocks"]["router"].dtype == torch.float32
    assert torch.equal(cast["blocks"]["router"], tp["blocks"]["router"])
    assert cast["blocks"]["w1"].dtype == torch.bfloat16


def test_train_steps_match_jax():
    """Five make_train_step steps against JAX make_sharded_train_step on
    a one-device mesh from the same params and batches: losses within
    2e-5 relative, params within 2e-4."""
    jcfg, tcfg = _cfgs()
    mesh = jax_model.make_mesh(jax.devices()[:1])
    jinit, jstep = jax_model.make_sharded_train_step(mesh, jcfg)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    _, tstep = model.make_train_step(tcfg, device="cpu")
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    for step in range(5):
        tokens = _tokens(4, 17, seed=20 + step)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = dict(model._flatten(jax.tree.map(np.asarray, jparams)))
    for path, t in model._flatten(tparams):
        np.testing.assert_allclose(_np(t), want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)


# -- serving and generate -------------------------------------------------


def _run_lockstep(jeng, teng, jreqs, treqs):
    """Tick both engines together; after every tick each request's
    greedy tokens so far are equal."""
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    for tick in range(1000):
        if jeng.idle and teng.idle:
            break
        jeng.tick()
        teng.tick()
        assert [list(map(int, r.generated)) for r in treqs] \
            == [list(map(int, r.generated)) for r in jreqs], f"tick {tick}"
    assert jeng.idle and teng.idle and all(r.done for r in treqs)
    assert teng.ticks == jeng.ticks


ENGINES = {
    "linear": dict(kw={}, eng=dict(slots=3, max_len=64, chunk=8)),
    "ring": dict(kw=dict(n_kv_heads=2, attention_window=16),
                 eng=dict(slots=3, max_len=64, chunk=8, ring=True)),
    "paged": dict(kw={}, eng=dict(slots=3, max_len=64, block_size=8,
                                  num_blocks=9, chunk=8, prefill_lanes=2)),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_jax_engine_tick_by_tick(name):
    """A MoE model through the port's engine and the JAX one in lockstep
    (5 requests of mixed prompt lengths, so chunks are padded and the
    pads route): greedy tokens equal after every tick; the paged pool
    preempts."""
    spec = ENGINES[name]
    jcfg, tcfg = _cfgs(seq_len=64, **spec["kw"])
    jp, tp = _params(jcfg, seed=7)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 17, 33, 9, 41)]
    new = (6, 4, 8, 3, 5)
    if name == "paged":
        jmod, tmod = jax_paged, paged
        teng = paged.PagedBatcher(tp, tcfg, device="cpu", **spec["eng"])
        jeng = jax_paged.PagedBatcher(jp, jcfg, **spec["eng"])
    else:
        jmod, tmod = jax_serving, serving
        teng = serving.ContinuousBatcher(tp, tcfg, device="cpu",
                                         **spec["eng"])
        jeng = jax_serving.ContinuousBatcher(jp, jcfg, **spec["eng"])
    jreqs = [jmod.Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, new)]
    treqs = [tmod.Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, new)]
    _run_lockstep(jeng, teng, jreqs, treqs)
    if name == "paged":
        assert teng.preemptions == jeng.preemptions > 0


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2, "moe_top_k": 1}],
                         ids=["mha-top2", "gqa-top1"])
def test_generate_greedy_equals_jax(kw):
    """decode.generate on a MoE model: prefill routes each prompt row,
    each decode step one token per row; greedy tokens equal JAX's."""
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, seed=4)
    prompt = _tokens(3, 7, seed=1)
    want = np.asarray(jax_decode.generate(jp, jnp.asarray(prompt), jcfg, 8))
    got = decode.generate(tp, torch.from_numpy(prompt), tcfg, 8,
                          device="cpu")
    np.testing.assert_array_equal(_np(got), want)


# -- expert parallelism ---------------------------------------------------


@pytest.mark.parametrize("with_aux,capacity_factor",
                         [(True, 1.25), (False, 8.0)])
def test_moe_layer_matches_jax(with_aux, capacity_factor):
    """make_moe_layer over 4 ranks (pool routing per rank, the exchange a
    list transpose) against JAX's over a 4-device ep mesh; at ample
    capacity both equal the unsharded reference."""
    cfg = jax_moe.MoeConfig(num_experts=8, top_k=2,
                            capacity_factor=capacity_factor)
    params = jax_moe.init_moe_params(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("ep",))
    want = jax_moe.make_moe_layer(jmesh, cfg, with_aux=with_aux)(
        params, jnp.asarray(x))
    tparams = model.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    got = moe.make_moe_layer(["cpu"] * 4, moe.MoeConfig(
        **dataclasses.asdict(cfg)), with_aux=with_aux)(
        tparams, torch.from_numpy(x))
    if with_aux:
        (want, jaux), (got, taux) = want, got
        for name in ("balance_loss", "z_loss", "expert_fraction"):
            np.testing.assert_allclose(_np(taux[name]),
                                       np.asarray(jaux[name]),
                                       rtol=GATE_TOL, atol=GATE_TOL)
    else:
        ref = moe.moe_reference(tparams, torch.from_numpy(x), top_k=2)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=FFN_TOL,
                                   atol=FFN_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=FFN_TOL,
                               atol=FFN_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        moe.make_moe_layer(["cpu"] * 3, moe.MoeConfig(num_experts=8))


def test_ep_mesh_grid_and_refusals():
    """make_ep_mesh is JAX's (data, ep) or (data, ep, model) mesh, with
    JAX's errors; ep×tp, which slice 10 refused, trains."""
    for n, ep, tp in ((8, 4, 1), (4, None, 1), (8, 2, 2), (4, None, 2)):
        jmesh = jax_moe.make_ep_mesh(jax.devices()[:n], ep=ep, tp=tp)
        mesh = moe.make_ep_mesh(["cpu"] * n, ep=ep, tp=tp)
        assert dict(mesh.shape) == dict(jmesh.shape), (n, ep, tp)
        assert mesh.axis_names == jmesh.axis_names
        assert mesh.ranks == [torch.device("cpu")] * n
    with pytest.raises(ValueError, match="not divisible by ep"):
        moe.make_ep_mesh(["cpu"] * 6, ep=4)
    _, tcfg = _cfgs()
    grid = moe.make_ep_mesh(["cpu"] * 8, ep=4)
    with pytest.raises(ValueError, match="moe_experts"):
        moe.make_ep_train_step(grid, dataclasses.replace(
            tcfg, moe_experts=None))
    with pytest.raises(ValueError, match="not divisible"):
        moe.make_ep_train_step(moe.make_ep_mesh(["cpu"] * 3, ep=3), tcfg)
    init_fn, step = moe.make_ep_train_step(
        moe.make_ep_mesh(["cpu"] * 4, ep=2, tp=2), tcfg)
    _, opt, loss, _ = step(*init_fn(torch.Generator().manual_seed(0)),
                           _tokens(4, 17, seed=1))
    assert opt["count"] == 1 and np.isfinite(float(loss))


@pytest.mark.parametrize("data,ep,kw", [
    (2, 4, {}), (1, 4, {"moe_capacity_factor": 1.0, "remat": True})],
    ids=["data2-ep4", "data1-ep4-drops-remat"])
def test_ep_train_steps_match_jax(data, ep, kw):
    """Three make_ep_train_step steps against JAX's on a (data, ep) mesh
    from the same params and batches: loss, ce and router losses within
    2e-5 relative, expert_fraction within 1e-6, params within 2e-4."""
    jcfg, tcfg = _cfgs(**kw)
    jmesh = jax_moe.make_ep_mesh(jax.devices()[:data * ep], ep=ep)
    jinit, jstep = jax_moe.make_ep_train_step(jmesh, jcfg)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    _, tstep = moe.make_ep_train_step(
        moe.make_ep_mesh(["cpu"] * (data * ep), ep=ep), tcfg)
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    for step in range(3):
        tokens = _tokens(8, 17, seed=30 + step)
        jparams, jopt, jl, jm = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl, tm = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        for name in ("ce", "balance_loss", "z_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{name} step {step}")
        np.testing.assert_allclose(_np(tm["expert_fraction"]),
                                   np.asarray(jm["expert_fraction"]),
                                   atol=GATE_TOL)
    want = dict(model._flatten(jax.tree.map(np.asarray, jparams)))
    for path, t in model._flatten(tparams):
        np.testing.assert_allclose(_np(t), want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)


def test_ep_step_without_drops_equals_the_per_row_loss():
    """At ample capacity nothing drops on either dispatch: the ep step's
    cross-entropy equals loss_and_metrics' per-row MoE (tests/
    test_moe.py's no-drop parity)."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=64.0)
    jp, tp = _params(jcfg)
    tokens = _tokens(8, 17, seed=3)
    _, want = model.loss_and_metrics(tp, torch.from_numpy(tokens), tcfg)
    _, tstep = moe.make_ep_train_step(moe.make_ep_mesh(["cpu"] * 8, ep=4),
                                      tcfg)
    opt = model.make_optimizer(model.TrainConfig()).init(tp)
    _, _, _, got = tstep(tp, opt, tokens)
    np.testing.assert_allclose(float(got["ce"]), float(want["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(_np(got["expert_fraction"]).sum()),
                               1.0, rtol=1e-5)


def test_sp_ep_train_steps_match_jax():
    """sp×ep: three make_sp_train_step steps of a MoE model over 4 ranks
    (the einsum ring; each rank owns 2 of 8 experts) against JAX's on a
    (1, 4) sp mesh: the 4-tuple step, losses and router losses within
    2e-4, params within JAX's sp-parity bounds."""
    arch = dict(seq_len=32)
    jcfg, tcfg = _cfgs(**arch)
    jmesh = jax_sp.make_sp_mesh(jax.devices()[:4], sp=4)
    jinit, jstep = jax_sp.make_sp_train_step(jmesh, jcfg, impl="einsum")
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    _, tstep = sp.make_sp_train_step(["cpu"] * 4, tcfg, impl="einsum")
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    rng = np.random.default_rng(4)
    for step in range(3):
        tokens = rng.integers(0, 64, (2, 33)).astype(np.int32)
        jparams, jopt, jl, jm = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl, tm = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {step}")
        for name in ("ce", "balance_loss", "z_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=2e-4, err_msg=name)
    want = dict(model._flatten(jax.tree.map(np.asarray, jparams)))
    for path, t in model._flatten(tparams):
        np.testing.assert_allclose(_np(t), want[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)
    with pytest.raises(ValueError, match="sp×ep needs moe_experts"):
        sp.make_sp_train_step(["cpu"] * 3, dataclasses.replace(
            tcfg, seq_len=30))


# -- checkpoints and the CLIs ---------------------------------------------


def test_moe_checkpoint_round_trip(tmp_path):
    _, tcfg = _cfgs()
    params = model.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    model.save_params(str(tmp_path), 3, params)
    back = model.load_params(str(tmp_path), 3, "cpu")
    assert {p for p, _ in model._flatten(back)} \
        == {p for p, _ in model._flatten(params)}
    for (path, a), (_, b) in zip(model._flatten(params),
                                 model._flatten(back)):
        assert torch.equal(a, b), path


CLI_ARCH = ["--vocab", "64", "--d-model", "32", "--n-layers", "1",
            "--seq-len", "16", "--moe-experts", "4"]


def _cli(module, tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", f"tpu_autoscaler_torch.workloads.{module}",
         "--platform", "cpu", *CLI_ARCH, *args],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_moe_trains_resumes_drains_and_serves(tmp_path):
    """train --moe-experts: 4 steps (a checkpoint every 2), resume to 6
    with --ep 2 (the same checkpoint layout), drain; then generate and
    serve (linear and --paged) read the MoE checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    base = ["--batch", "4", "--checkpoint-dir", ckpt,
            "--checkpoint-every", "2"]
    first = _cli("train", tmp_path, *base, "--steps", "4")
    assert first.returncode == 0, first.stderr
    assert "training complete at step 4" in first.stderr
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]
    second = _cli("train", tmp_path, *base, "--steps", "6", "--ep", "2")
    assert second.returncode == 0, second.stderr
    assert "ep 2 ranks on cpu, cpu" in second.stderr
    assert "resumed from checkpoint step 4" in second.stderr
    annotations = tmp_path / "annotations"
    annotations.write_text('autoscaler.tpu.dev/checkpoint-requested="1"\n')
    drain = _cli("train", tmp_path, *base, "--steps", "5000", "--sp", "2",
                 "--annotations-file", str(annotations))
    assert drain.returncode == 0, drain.stderr
    assert "drain requested: checkpointed at step 6" in drain.stderr
    gen = _cli("generate", tmp_path, "--checkpoint-dir", ckpt, "--prompt",
               "1,2,3", "--batch", "2", "--steps", "5")
    assert gen.returncode == 0, gen.stderr
    want = decode.generate(model.load_params(ckpt, 6, "cpu"),
                           torch.tensor([[1, 2, 3]] * 2),
                           model.ModelConfig(vocab=64, d_model=32,
                                             n_layers=1, seq_len=16,
                                             moe_experts=4), 5,
                           device="cpu").tolist()
    assert gen.stdout.strip().splitlines() == [
        f"{','.join(map(str, r[:3]))} | {','.join(map(str, r[3:]))}"
        for r in want]
    for flags in ([], ["--paged", "--block-size", "8", "--num-blocks",
                       "5", "--max-new-tokens", "30"]):
        res = _cli("serve", tmp_path, "--checkpoint-dir", ckpt, "--random",
                   "4", "--slots", "2", "--max-len", "64", "--chunk", "8",
                   "--annotations-file", str(tmp_path / "none"), *flags)
        assert res.returncode == 0, res.stderr
        assert '"unserved": 0' in res.stdout.splitlines()[-1]


def test_cli_logs_router_losses_on_moe_steps(tmp_path, caplog):
    """--ep and sp×ep go through the MoE step wrapper: the progress log
    carries the router's balance and z losses, as the JAX trainer's."""
    for flags in (["--ep", "2"], ["--sp", "2"]):
        caplog.clear()
        with caplog.at_level("INFO"):
            res = CliRunner().invoke(train_cli.main, [
                "--platform", "cpu", *CLI_ARCH, "--batch", "4", "--steps",
                "10", "--checkpoint-every", "10", "--checkpoint-dir",
                str(tmp_path / flags[0].strip("-")), *flags])
        assert res.exit_code == 0, res.output
        line = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("step 10 loss")]
        assert line and " balance " in line[0] and " z " in line[0], line


@pytest.mark.parametrize("flags", [
    ["--ep", "2"],
    ["--ep", "2", "--moe-experts", "8", "--sp", "2"],
    ["--ep", "2", "--moe-experts", "8", "--pp-stages", "2"],
    ["--ep", "2", "--moe-experts", "8", "--shard", "zero1"],
    ["--ep", "2", "--moe-experts", "8", "--zero1"],
    ["--ep", "8", "--moe-experts", "8", "--batch", "4"],
], ids=["needs-moe", "with-sp", "with-pp", "with-shard", "with-zero1",
        "batch"])
def test_train_cli_ep_usage_errors_match_jax(tmp_path, flags):
    """Each --ep usage error exits 2 with the JAX trainer's message (the
    JAX CLI sees the conftest's 8 devices, the port 8 ranks)."""
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
    assert error and error[0] in mine.output.splitlines(), (mine.output,
                                                             error)
    assert not os.listdir(tmp_path)


def test_train_cli_ep_with_tp_names_the_mesh(tmp_path, caplog):
    """--ep 2 --tp 2 trains dp×ep×tp on the CPU (4 ranks of the one
    device), names its mesh, and checkpoints the one-device layout."""
    caplog.set_level("INFO")
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", *CLI_ARCH, "--batch", "4", "--steps", "2",
        "--checkpoint-dir", str(tmp_path), "--ep", "2", "--tp", "2"])
    assert res.exit_code == 0, res.output
    assert "mesh {'data': 1, 'ep': 2, 'model': 2}" in caplog.text
    assert os.listdir(tmp_path) == ["step_2"]
    params = model.load_params(str(tmp_path), 2, "cpu")
    assert tuple(params["blocks"]["w1"].shape) == (1, 4, 32, 512)
    assert tuple(params["blocks"]["qkv"].shape) == (1, 32, 96)
