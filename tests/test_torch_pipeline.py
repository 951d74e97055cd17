"""The port's pipeline parallelism against the JAX package's, on the CPU:
``workloads/pipeline.py``'s specs, ``make_pipeline_mesh``, the
split-weight tree, the pp-only GPipe loss and step (dense and MoE) and
the dp×pp×tp loss and step.

JAX runs on the conftest's 8 virtual CPU devices, the port on ``cpu``
repeated, on meshes of the same shape: a (pp,) mesh of P ranks, or
``make_pipeline_mesh``'s (data, pp, model).  The same weights (JAX's
``init_params``, carried across with ``params_from_jax``) and
numpy-made batches go through both in f32; each JAX function runs once
per module-scoped fixture.  Tolerances: the loss within 2e-5 relative
and the gradients within rtol 1e-4, atol 1e-5 (JAX's own pipeline
bounds, ``tests/test_pipeline.py``: f32, summation order only); steps'
losses within 1e-3 relative and the params after them within rtol 1e-3,
atol 1e-5 (``test_torch_mesh.py``'s: Adam moves every parameter by
about the LR whatever its gradient, so small gradient differences grow);
specs, shapes, splits and error texts exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import pipeline as jax_pipeline  # noqa: E402
from tpu_autoscaler_torch.workloads import attention  # noqa: E402
from tpu_autoscaler_torch.workloads import model, pipeline  # noqa: E402

ARCH = dict(vocab=64, d_model=32, n_layers=4, n_heads=2, d_ff=64,
            seq_len=16)
ARCH4 = dict(ARCH, n_heads=4)
MOE = dict(moe_experts=4, moe_top_k=2)
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_LOSS_RTOL = 1e-3
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(**arch):
    return (jax_model.ModelConfig(**arch, dtype=jnp.float32),
            model.ModelConfig(**arch, dtype=torch.float32))


def _tokens(batch, seed=3):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (batch, ARCH["seq_len"] + 1)).astype(np.int32)


def _pp_meshes(n):
    return (JaxMesh(np.asarray(jax.devices()[:n]), axis_names=("pp",)),
            model.Mesh(np.array(["cpu"] * n, dtype=object), ("pp",)))


def _meshes3d(dp, pp, tp):
    n = dp * pp * tp
    return (jax_pipeline.make_pipeline_mesh(jax.devices()[:n], pp=pp, tp=tp),
            pipeline.make_pipeline_mesh(["cpu"] * n, pp=pp, tp=tp))


def _jax_paths(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(jcfg):
    return jax_model.init_params(jax.random.PRNGKey(0), jcfg)


def _placed(tmesh, tcfg, jparams):
    """JAX's params as the port's pipeline state (fresh moments)."""
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    return pipeline.shard_pipeline_state(tmesh, tcfg,
                                         {"params": params, "opt": opt})


def _grads(loss_of, params, tokens):
    """The loss and its gradient with respect to every block of the
    Sharded ``params`` (each block's summed over the ranks that hold
    it), gathered to the one-device layout."""
    live = {path: dataclasses.replace(leaf, blocks={
        r: t.detach().requires_grad_() for r, t in leaf.blocks.items()})
        for path, leaf in model._flatten(params)}
    value = loss_of(model._unflatten(live), tokens)
    keys = [(path, r) for path, leaf in live.items() for r in leaf.blocks]
    grads = torch.autograd.grad(value, [live[p].blocks[r] for p, r in keys],
                                allow_unused=True)
    out = {path: dataclasses.replace(leaf, blocks={})
           for path, leaf in live.items()}
    for (path, r), g in zip(keys, grads):
        leaf = live[path]
        first = leaf.first_holders(leaf.blocks)[leaf.indices[r]]
        g = torch.zeros_like(leaf.blocks[r]) if g is None else g
        if first in out[path].blocks:
            g = out[path].blocks[first] + g
        out[path].blocks[first] = g
    return value, dict(model._flatten(model.gather_params(
        next(iter(live.values())).mesh, model._unflatten(out))))


# ---- specs, mesh, split ------------------------------------------------


def _spec_entries(tree):
    return {path: tuple(spec) for path, spec in model._flatten(tree)}


def _jax_spec_entries(tree):
    return {"/".join(k.key for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                   PartitionSpec))[0]}


@pytest.mark.parametrize("kind", ["dense", "moe", "3d", "3d-axes"])
def test_specs_equal_jax(kind):
    """pipeline_param_specs (dense and MoE) and pipeline3d_param_specs
    (default and renamed axes) equal JAX's entry for entry."""
    jcfg, tcfg = _cfgs(**ARCH, **(MOE if kind == "moe" else {}))
    if kind in ("dense", "moe"):
        want = jax_pipeline.pipeline_param_specs(jcfg)
        got = pipeline.pipeline_param_specs(tcfg)
    else:
        axes = ("stage", "tp") if kind == "3d-axes" else ("pp", "model")
        want = jax_pipeline.pipeline3d_param_specs(jcfg, *axes)
        got = pipeline.pipeline3d_param_specs(tcfg, *axes)
    assert _spec_entries(got) == _jax_spec_entries(want)


@pytest.mark.parametrize("n,pp,tp", [(8, 2, 2), (8, 2, 1), (8, 4, 2),
                                     (4, 2, 2), (8, 8, 1), (8, 3, 1),
                                     (6, 2, 2)])
def test_make_pipeline_mesh_matches_jax(n, pp, tp):
    """make_pipeline_mesh's (data, pp, model) shape, and its error text
    when pp·tp does not divide the devices, equal JAX's; a device may
    repeat."""
    try:
        jmesh = jax_pipeline.make_pipeline_mesh(jax.devices()[:n], pp=pp,
                                                tp=tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pipeline.make_pipeline_mesh(["cpu"] * n, pp=pp, tp=tp)
        assert str(got.value) == str(e)
        return
    tmesh = pipeline.make_pipeline_mesh(["cpu"] * n, pp=pp, tp=tp)
    assert tmesh.axis_names == tuple(jmesh.axis_names)
    assert dict(tmesh.shape) == dict(jmesh.shape)
    assert tmesh.ranks == [torch.device("cpu")] * n


def test_split_merge_round_trip_bit_for_bit():
    """split_qkv_weights equals JAX's split leaf for leaf, bit for bit,
    and merge_qkv_weights inverts it exactly, for params and for an
    optimizer state's moments (which JAX's optimizer.init makes on the
    split tree: zeros of the same shapes)."""
    jcfg, tcfg = _cfgs(**dict(ARCH4, n_layers=2, n_kv_heads=2))
    jparams = _jax_params(jcfg)
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    want = _jax_paths(jax_pipeline.split_qkv_weights(jparams, jcfg))
    split = pipeline.split_qkv_weights(params, tcfg)
    got = dict(model._flatten(split))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(_np(t), want[path], err_msg=path)
    back = dict(model._flatten(pipeline.merge_qkv_weights(split, tcfg)))
    for path, t in model._flatten(params):
        assert torch.equal(back[path], t), path
    state = model.make_optimizer(model.TrainConfig()).init(params)
    state["mu"] = model._map_tree(torch.randn_like, state["mu"])
    split_state = pipeline.split_qkv_weights(state, tcfg)
    assert split_state["count"] == 0
    for key in ("mu", "nu"):
        assert {p: tuple(t.shape) for p, t in model._flatten(
            split_state[key])} == {p: v.shape for p, v in want.items()}
        merged = pipeline.merge_qkv_weights(split_state, tcfg)[key]
        for path, t in model._flatten(state[key]):
            assert torch.equal(dict(model._flatten(merged))[path], t)


def _jax_device_bytes(jmesh, jparams, jopt) -> list:
    """The bytes of JAX's params and Adam moments in each device's
    addressable shards, in rank order."""
    moments = [leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jopt)[0]
               if any(getattr(k, "name", None) in ("mu", "nu")
                      for k in path)]
    out = [0] * jmesh.size
    for x in jax.tree_util.tree_leaves(jparams) + moments:
        by_device = {s.device: s for s in x.addressable_shards}
        for r, dev in enumerate(jmesh.devices.flat):
            out[r] += by_device[dev].data.nbytes
    return out


def test_params_shard_over_stages_and_model():
    """Each rank's blocks have JAX's shard shapes: 4 layers over 4
    stages, stage r holding layer r (moments the same); under data 2 ×
    pp 2 × model 2, wq [2, 32, 16], w2 [2, 32, 32]; each rank's stored
    bytes, its own blocks and its own copy of the replicated leaves,
    are JAX's addressable shards' on its device."""
    jcfg, tcfg = _cfgs(**ARCH)
    jmesh, tmesh = _pp_meshes(4)
    init_fn, _ = pipeline.make_pipeline_train_step(tmesh, tcfg, 2)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    for tree in (params, opt["mu"], opt["nu"]):
        leaf = tree["blocks"]["qkv"]
        assert sorted(leaf.blocks) == list(range(4))
        assert [leaf.indices[r] for r in range(4)] == [(i, 0, 0)
                                                       for i in range(4)]
        assert all(t.shape[0] == 1 for t in leaf.blocks.values())
    jp, jo = jax_pipeline.make_pipeline_train_step(jmesh, jcfg, 2)[0](
        jax.random.PRNGKey(0))
    assert model.rank_state_bytes(tmesh, params, opt) \
        == _jax_device_bytes(jmesh, jp, jo)

    _, tcfg4 = _cfgs(**ARCH4)
    _, tmesh3 = _meshes3d(2, 2, 2)
    init3, _ = pipeline.make_pipeline_train_step(tmesh3, tcfg4, 2)
    params3, opt3 = init3(torch.Generator().manual_seed(0))
    blocks = params3["blocks"]
    assert "wq" in blocks and "qkv" not in blocks
    assert {tuple(t.shape) for t in blocks["wq"].blocks.values()} \
        == {(2, 32, 16)}
    assert {tuple(t.shape) for t in blocks["w2"].blocks.values()} \
        == {(2, 32, 32)}
    assert {tuple(t.shape) for t in opt3["mu"]["blocks"]["wq"]
            .blocks.values()} == {(2, 32, 16)}


# ---- the pp-only GPipe loss and step ----------------------------------


@pytest.fixture(scope="module")
def jax_pp_losses():
    """JAX's pipelined losses, once per (stages, microbatches)."""
    jcfg, _ = _cfgs(**ARCH)
    jparams = _jax_params(jcfg)
    tokens = _tokens(8)
    out = {}
    for stages, m in ((2, 4), (4, 2), (4, 8)):
        loss = jax.jit(jax_pipeline.make_pipeline_loss(
            _pp_meshes(stages)[0], jcfg, num_microbatches=m))
        out[stages, m] = float(loss(jparams, jnp.asarray(tokens)))
    return jparams, tokens, out


@pytest.mark.parametrize("stages,m", [(2, 4), (4, 2), (4, 8)])
def test_pipeline_loss_matches_jax(jax_pp_losses, stages, m):
    """make_pipeline_loss on JAX's params and batch equals JAX's
    pipelined loss and the unpipelined loss within 2e-5 relative; the
    bubble slots are skipped, so it runs m·P stage forwards."""
    jparams, tokens, want = jax_pp_losses
    _, tcfg = _cfgs(**ARCH)
    _, tmesh = _pp_meshes(stages)
    state = _placed(tmesh, tcfg, jparams)
    loss = pipeline.make_pipeline_loss(tmesh, tcfg, m)
    got = float(loss(state["params"], tokens))
    assert got == pytest.approx(want[stages, m], rel=LOSS_RTOL)
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ref = float(model.loss_fn(params, torch.from_numpy(tokens), tcfg))
    assert got == pytest.approx(ref, rel=LOSS_RTOL)
    assert loss.counts["stage_forwards"] == m * stages


@pytest.fixture(scope="module")
def jax_pp_grads():
    """jax.grad of JAX's pipelined loss at P 4, m 2, batch 4."""
    jcfg, _ = _cfgs(**ARCH)
    jparams = _jax_params(jcfg)
    tokens = _tokens(4)
    loss = jax_pipeline.make_pipeline_loss(_pp_meshes(4)[0], jcfg,
                                           num_microbatches=2)
    return jparams, tokens, _jax_paths(jax.jit(jax.grad(loss))(
        jparams, jnp.asarray(tokens)))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_pipeline_gradients_match_jax(jax_pp_grads, remat):
    """The gradient of make_pipeline_loss with respect to every stage's
    block (with and without remat) against jax.grad of JAX's pipelined
    loss, gathered leaf for leaf within rtol 1e-4, atol 1e-5."""
    jparams, tokens, want = jax_pp_grads
    _, tcfg = _cfgs(**ARCH)
    _, tmesh = _pp_meshes(4)
    state = _placed(tmesh, tcfg, jparams)
    loss = pipeline.make_pipeline_loss(tmesh, tcfg, 2, remat=remat)
    _, grads = _grads(loss, state["params"], tokens)
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(_np(g), want[path], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)


STEP_CASES = {"adamw": {},
              "recipe": dict(learning_rate=3e-3, warmup_steps=2,
                             decay_steps=16, grad_clip=1.0)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pipeline_train_step_matches_jax(case):
    """Five make_pipeline_train_step steps (P 2, m 4, remat on) against
    JAX's from the same params and batches, with bare AdamW and with
    JAX's recipe test's warmup, cosine decay and clip: losses within
    1e-3 relative at every step, the gathered params within rtol 1e-3,
    atol 1e-5."""
    jcfg, tcfg = _cfgs(**ARCH)
    jmesh, tmesh = _pp_meshes(2)
    kw = STEP_CASES[case]
    jinit, jstep = jax_pipeline.make_pipeline_train_step(
        jmesh, jcfg, num_microbatches=4,
        train=jax_model.TrainConfig(**kw))
    _, tstep = pipeline.make_pipeline_train_step(
        tmesh, tcfg, 4, train=model.TrainConfig(**kw))
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    state = _placed(tmesh, tcfg, jparams)
    tparams, topt = state["params"], state["opt"]
    for step in range(5):
        tokens = _tokens(8, 30 + step)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert tstep.counts["stage_forwards"] == 5 * 4 * 2
    want = _jax_paths(jparams)
    got = pipeline.gather_pipeline_state(tmesh, tcfg, {
        "params": tparams, "opt": topt})["params"]
    for path, t in model._flatten(got):
        np.testing.assert_allclose(_np(t), want[path], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)


@pytest.fixture(scope="module")
def jax_moe_losses():
    """JAX's pipelined MoE losses (P 2) at m 1 and m 4."""
    jcfg, _ = _cfgs(**ARCH, **MOE)
    jparams = _jax_params(jcfg)
    tokens = _tokens(8)
    out = {}
    for m in (1, 4):
        loss = jax.jit(jax_pipeline.make_pipeline_loss(
            _pp_meshes(2)[0], jcfg, num_microbatches=m))
        out[m] = float(loss(jparams, jnp.asarray(tokens)))
    return jparams, tokens, out


@pytest.mark.parametrize("m", [1, 4])
def test_moe_pipeline_loss_matches_jax(jax_moe_losses, m):
    """The MoE pipeline (P 2) equals JAX's pipelined loss at m 1 and m
    4 (each stage routes its microbatch, the router losses summed over
    the real (stage, microbatch) slots), and the unpipelined loss too:
    routing and capacity are per row, so a microbatch of whole rows
    routes as the whole batch does (JAX's own test pins m 1)."""
    jparams, tokens, want = jax_moe_losses
    _, tcfg = _cfgs(**ARCH, **MOE)
    _, tmesh = _pp_meshes(2)
    state = _placed(tmesh, tcfg, jparams)
    got = float(pipeline.make_pipeline_loss(tmesh, tcfg, m)(
        state["params"], tokens))
    assert got == pytest.approx(want[m], rel=LOSS_RTOL)
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ref, _ = model.loss_and_metrics(params, torch.from_numpy(tokens), tcfg)
    assert got == pytest.approx(float(ref), rel=LOSS_RTOL)


def test_moe_pipeline_step_trains():
    """Six MoE pipeline steps (P 2, m 4) stay finite and learn, as JAX's
    test_moe_trains_through_pipeline asks of its own."""
    _, tcfg = _cfgs(**ARCH, **MOE)
    _, tmesh = _pp_meshes(2)
    init_fn, step_fn = pipeline.make_pipeline_train_step(tmesh, tcfg, 4)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    tokens = _tokens(8)
    losses = []
    for _ in range(6):
        params, opt, loss = step_fn(params, opt, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1


# ---- dp×pp×tp ------------------------------------------------------------


CASES3D = {"2-2-2-2": (2, 2, 2, 2, {}), "1-2-4-4": (1, 2, 4, 4, {}),
           "4-2-1-2": (4, 2, 1, 2, {}),
           "2-2-2-2-gqa": (2, 2, 2, 2, dict(n_kv_heads=2))}


@pytest.fixture(scope="module")
def jax_3d_losses():
    """JAX's dp×pp×tp losses, once per case."""
    tokens = _tokens(8)
    out = {}
    for name, (dp, pp, tp, m, kw) in CASES3D.items():
        jcfg, _ = _cfgs(**ARCH4, **kw)
        jparams = _jax_params(jcfg)
        loss = jax.jit(jax_pipeline.make_pipeline3d_loss(
            _meshes3d(dp, pp, tp)[0], jcfg, num_microbatches=m))
        out[name] = (jparams, float(loss(
            jax_pipeline.split_qkv_weights(jparams, jcfg),
            jnp.asarray(tokens))))
    return tokens, out


@pytest.mark.parametrize("case", list(CASES3D))
def test_pipeline3d_loss_matches_jax(jax_3d_losses, case):
    """make_pipeline3d_loss on the split tree of JAX's params equals
    JAX's dp×pp×tp loss and the unpipelined loss within 2e-5 relative:
    the batch over data, GPipe over pp, Megatron over model."""
    tokens, want = jax_3d_losses
    dp, pp, tp, m, kw = CASES3D[case]
    _, tcfg = _cfgs(**ARCH4, **kw)
    _, tmesh = _meshes3d(dp, pp, tp)
    jparams, jloss = want[case]
    state = _placed(tmesh, tcfg, jparams)
    loss = pipeline.make_pipeline3d_loss(tmesh, tcfg, m)
    got = float(loss(state["params"], tokens))
    assert got == pytest.approx(jloss, rel=LOSS_RTOL)
    params = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ref = float(model.loss_fn(params, torch.from_numpy(tokens), tcfg))
    assert got == pytest.approx(ref, rel=LOSS_RTOL)
    assert loss.counts["stage_forwards"] == m * pp


def test_pipeline3d_train_step_matches_jax():
    """Three steps of the 2 × 2 × 2 dp×pp×tp step (m 2, remat on)
    through make_pipeline_train_step's dispatch on the 3-axis mesh,
    against JAX's from the same params and batches: losses within 1e-3
    relative, the params merged back (qkv packed) within rtol 1e-3,
    atol 1e-5."""
    jcfg, tcfg = _cfgs(**ARCH4)
    jmesh, tmesh = _meshes3d(2, 2, 2)
    jinit, jstep = jax_pipeline.make_pipeline_train_step(
        jmesh, jcfg, num_microbatches=2)
    _, tstep = pipeline.make_pipeline_train_step(tmesh, tcfg, 2)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    merged = jax_pipeline.merge_qkv_weights(jparams, jcfg)
    state = _placed(tmesh, tcfg, merged)
    tparams, topt = state["params"], state["opt"]
    for step in range(3):
        tokens = _tokens(8, 30 + step)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = _jax_paths(jax_pipeline.merge_qkv_weights(jparams, jcfg))
    got = pipeline.gather_pipeline_state(tmesh, tcfg, {
        "params": tparams, "opt": topt})
    for path, t in model._flatten(got["params"]):
        np.testing.assert_allclose(_np(t), want[path], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)
    assert tuple(got["opt"]["mu"]["blocks"]["qkv"].shape) == (4, 32, 96)
    assert got["opt"]["count"] == 3


def test_pipeline3d_state_round_trips_through_the_one_device_layout():
    """shard_pipeline_state then gather_pipeline_state gives back the
    one-device state bit for bit (params and moments, qkv packed)."""
    _, tcfg = _cfgs(**dict(ARCH4, n_kv_heads=2))
    _, tmesh = _meshes3d(2, 2, 2)
    params = model.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    opt["nu"] = model._map_tree(torch.rand_like, opt["nu"])
    state = {"params": params, "opt": opt}
    back = pipeline.gather_pipeline_state(
        tmesh, tcfg, pipeline.shard_pipeline_state(tmesh, tcfg, state))
    for path, t in model._flatten(state):
        got = dict(model._flatten(back))[path]
        assert got == t if isinstance(t, int) else torch.equal(got, t), path


# ---- the kernel route on the CPU ---------------------------------------


@pytest.fixture
def kernel_route(monkeypatch):
    """Send the port down its kernel route on the CPU (the plain versions
    of K1 and K2 through flash_attention's autograd.Function), counting
    the forward's and the backward's calls and their shapes."""
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    calls = {"forward": 0, "backward": 0, "shapes": set()}
    fwd, bwd = attention._attention_forward, attention.flash_attention_backward

    def spy_fwd(q, *args, **kwargs):
        calls["forward"] += 1
        calls["shapes"].add(tuple(q.shape))
        return fwd(q, *args, **kwargs)

    def spy_bwd(*args, **kwargs):
        calls["backward"] += 1
        return bwd(*args, **kwargs)

    monkeypatch.setattr(attention, "_attention_forward", spy_fwd)
    monkeypatch.setattr(attention, "flash_attention_backward", spy_bwd)
    return calls


@pytest.mark.parametrize("kind", ["pp", "3d"])
def test_kernel_route_counts_per_stage_shard(kernel_route, kind):
    """One step with remat on the kernel route: K1 runs 2·L·m times
    (forward and the recomputed forward) and K2 L·m times on [mb, h, s,
    hd] (pp 2, m 4); on data 2 × pp 2 × model 2 (m 2) once per (data
    row, stage, model rank, microbatch, layer), on [mb, h/tp, s, hd]
    shards."""
    arch = ARCH4
    _, tcfg = _cfgs(**arch)
    if kind == "pp":
        _, tmesh = _pp_meshes(2)
        m, shards, shape = 4, 1, (2, 4, 16, 8)
    else:
        _, tmesh = _meshes3d(2, 2, 2)
        m, shards, shape = 2, 4, (2, 2, 16, 8)
    init_fn, step_fn = pipeline.make_pipeline_train_step(tmesh, tcfg, m)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    _, _, loss = step_fn(params, opt, _tokens(8))
    assert np.isfinite(float(loss))
    per = shards * m * tcfg.n_layers
    assert kernel_route["backward"] == per
    assert kernel_route["forward"] == 2 * per
    assert kernel_route["shapes"] == {shape}


# ---- errors ------------------------------------------------------------


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


ERRORS = {
    "pp-layers": (ARCH, "pp", 8),
    "3d-layers": (dict(ARCH4, n_layers=3), "3d", (1, 2, 2)),
    "3d-heads": (dict(ARCH4, n_heads=2), "3d", (1, 2, 4)),
    "3d-kv-heads": (dict(ARCH4, n_kv_heads=1), "3d", (2, 2, 2)),
    "3d-d-ff": (dict(ARCH4, d_ff=66), "3d", (1, 2, 4)),
    "3d-moe": (dict(ARCH4, **MOE), "3d", (2, 2, 2)),
    "two-axes": (ARCH, "2d", None),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_value_errors_match_jax(case):
    """The refusals of the losses and of the step's dispatch, word for
    word: layers not divisible by the stages, heads / kv heads / d_ff
    not dividing tp, MoE in the tp-composed pipeline, and a two-axis
    mesh handed to make_pipeline_train_step."""
    arch, kind, shape = ERRORS[case]
    jcfg, tcfg = _cfgs(**arch)
    if kind == "pp":
        jmesh, tmesh = _pp_meshes(shape)
        want = _error(lambda: jax_pipeline.make_pipeline_loss(jmesh, jcfg, 2))
        got = _error(lambda: pipeline.make_pipeline_loss(tmesh, tcfg, 2))
        assert got == _error(
            lambda: pipeline.make_pipeline_train_step(tmesh, tcfg, 2))
    elif kind == "3d":
        jmesh, tmesh = _meshes3d(*shape)
        want = _error(
            lambda: jax_pipeline.make_pipeline3d_loss(jmesh, jcfg, 2))
        got = _error(lambda: pipeline.make_pipeline3d_loss(tmesh, tcfg, 2))
        assert got == _error(
            lambda: pipeline.make_pipeline_train_step(tmesh, tcfg, 2))
    else:
        jmesh = jax_model.make_mesh(jax.devices()[:4], tp=2)
        tmesh = model.make_mesh(["cpu"] * 4, tp=2)
        want = _error(
            lambda: jax_pipeline.make_pipeline_train_step(jmesh, jcfg, 2))
        got = _error(
            lambda: pipeline.make_pipeline_train_step(tmesh, tcfg, 2))
    assert got == want


def test_per_data_shard_batch_error_matches_jax():
    """A per-data-shard batch the microbatches do not divide: JAX's
    error text, raised when the loss runs."""
    jcfg, tcfg = _cfgs(**ARCH4)
    jmesh, tmesh = _meshes3d(2, 2, 2)
    jparams = _jax_params(jcfg)
    tokens = _tokens(6)
    want = _error(lambda: jax_pipeline.make_pipeline3d_loss(
        jmesh, jcfg, 2)(jax_pipeline.split_qkv_weights(jparams, jcfg),
                        jnp.asarray(tokens)))
    state = _placed(tmesh, tcfg, jparams)
    got = _error(lambda: pipeline.make_pipeline3d_loss(tmesh, tcfg, 2)(
        state["params"], tokens))
    assert got == want
