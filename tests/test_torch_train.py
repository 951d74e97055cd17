"""The port's trainer against the JAX package's, on the CPU: the
flash-attention backward's plain version (K2) and the autograd.Function
around K1/K2, the loss and its gradient, the optimizer recipe, the train
step and the sequence-parallel train step (``sp.py``, every impl),
checkpoints and resume, the drain loop, the token loader and the
``train`` CLI (``--sp`` too).

The same weights (JAX ``init_params``, carried across with
``params_from_jax``) and the same numpy-made inputs go through both
packages in f32.  The JAX side runs its Pallas kernels in interpret mode
or its einsum path; the port's kernel route is taken on the CPU by
making ``ModelConfig.resolved_attention`` answer "kernel", which sends
the step through ``flash_attention``'s autograd.Function and so through
the plain versions of K1 and K2.  Tolerances: 1e-4 for attention
gradients and, relative to each leaf's largest |grad|, for the loss's
(f32, summation order only); 2e-5 for the loss; 1e-6 relative for the
optimizer (the same f32 arithmetic as optax); 1e-3 relative for losses
after five steps (Adam's first steps move every parameter by about the
LR whatever the gradient's size, so small gradient differences grow);
for the SP step, 2e-4 for its three losses and JAX's own sp-parity
bounds (rtol 1e-3, atol 1e-5) for the params after them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpu_autoscaler import dataio as jax_dataio  # noqa: E402
from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import checkpoint as jax_checkpoint  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import sp as jax_sp  # noqa: E402
from tpu_autoscaler.workloads import train as jax_train  # noqa: E402
from tpu_autoscaler_torch import dataio  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    checkpoint,
    model,
    moe,
    sp,
)
from tpu_autoscaler_torch.workloads import train as train_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=16)
GRAD_TOL = 1e-4
LOSS_TOL = 2e-5
OPT_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-3


def _np(t):
    return t.detach().cpu().numpy()


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, h, s, d))]


def _cfgs(impl="einsum", **kw):
    """The same config in both packages, f32; impl "kernel" is the
    port's kernel route (see kernel_route) against JAX's Pallas one."""
    return (jax_model.ModelConfig(**ARCH, dtype=jnp.float32,
                                  attention="pallas" if impl == "kernel"
                                  else "einsum", **kw),
            model.ModelConfig(**ARCH, dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(b=3, seed=1):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, ARCH["seq_len"] + 1)).astype(np.int32)


@pytest.fixture
def kernel_route(monkeypatch):
    """Send the port down its kernel route on the CPU, and count the
    calls of the autograd.Function's backward."""
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    calls = {"backward": 0}
    real = attention.flash_attention_backward

    def spy(*args, **kwargs):
        calls["backward"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_backward", spy)
    return calls


# -- K2: the plain backward against the JAX kernels and jax.grad ---------


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)],
                         ids=["causal", "full", "window5"])
@pytest.mark.parametrize("s,block", [(37, None), (32, 8)],
                         ids=["s37-one-tile", "s32-blocks8"])
def test_backward_reference_matches_jax_kernels_and_grad(h, hkv, causal,
                                                         window, s, block):
    """dq, dk, dv of flash_attention_backward_reference against JAX
    ``_backward_pallas`` (interpret) on the same forward output and lse
    (the port's forward, held to JAX's in tests/test_torch_decode.py),
    and against jax.vjp of ``reference_attention``; s 37 at the default
    blocks is one tile, s 32 at blocks of 8 is 4 x 4 tiles."""
    q, k, v, do = _qkv(2, h, hkv, s, 8, seed=h * 10 + hkv + s)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = attention.flash_attention_forward(tq, tk, tv, causal=causal,
                                                 window=window)
    got = attention.flash_attention_backward_reference(
        tq, tk, tv, out, lse, tdo, causal=causal, window=window)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    want = jax_attention._backward_pallas(
        jq, jk, jv, jnp.asarray(_np(out)), jnp.asarray(_np(lse)), jdo,
        causal, window, block or 512, block or 1024, True)
    _, vjp = jax.vjp(lambda a, b_, c: jax_attention.reference_attention(
        a, b_, c, causal=causal, window=window), jq, jk, jv)
    for g, w, w_ref in zip(got, want, vjp(jdo)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(_np(g), np.asarray(w_ref), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("h,hkv,causal,window", [
    (4, 2, True, None), (4, 1, True, 5), (4, 4, False, None)],
    ids=["gqa-causal", "mqa-window5", "mha-full"])
def test_function_gradients_match_jax_flash_attention(h, hkv, causal,
                                                      window):
    """torch.autograd.grad through the port's flash_attention (the
    autograd.Function on CPU tensors) against jax.vjp through JAX
    flash_attention (interpret), with one backward call."""
    q, k, v, do = _qkv(2, h, hkv, 24, 8, seed=7 + hkv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, b_, c: jax_attention.flash_attention(
        a, b_, c, causal=causal, window=window, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_backward_rejects_mismatched_residuals():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 8, 8, 0))
    out, lse = attention.flash_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="must match q"):
        attention.flash_attention_backward(q, k, v, out[:, :2], lse, do)
    with pytest.raises(ValueError, match="lse must be f32"):
        attention.flash_attention_backward(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        attention.flash_attention_backward_reference(
            q[:, :3], k, v, out[:, :3], lse[:, :3], do[:, :3])


# -- loss, and its gradient through both routes --------------------------


@pytest.mark.parametrize("ce_chunk", [None, 4, 5],
                         ids=["full", "chunk4", "chunk5-falls-back"])
def test_loss_and_metrics_match_jax(ce_chunk):
    jcfg, tcfg = _cfgs(ce_chunk=ce_chunk)
    jp, tp = _params(jcfg)
    tokens = _tokens()
    jl, jm = jax_model.loss_and_metrics(jp, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, tm = model.loss_and_metrics(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


def _grads(params, tokens, cfg):
    paths, leaves = zip(*model._flatten(params))
    leaves = [p.detach().clone().requires_grad_() for p in leaves]
    loss = model.loss_fn(model._unflatten(dict(zip(paths, leaves))),
                         torch.from_numpy(tokens), cfg)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("impl,kw", [
    ("einsum", {}),
    ("kernel", {}),
    ("einsum", {"remat": True, "ce_chunk": 4}),
    ("kernel", {"remat": True, "n_kv_heads": 2, "attention_window": 5}),
    ("kernel", {"n_kv_heads": 1, "rope": False}),
], ids=["einsum", "kernel", "einsum-remat-chunk4", "kernel-remat-gqa-window",
        "kernel-mqa-no-rope"])
def test_loss_gradient_matches_jax(request, impl, kw):
    """autograd.grad of the port's loss_fn against jax.grad of JAX's,
    every leaf within 1e-4 of its largest |grad|; the kernel route runs
    the attention backward once per layer (twice the forward's work
    under remat, but still one backward per layer)."""
    calls = request.getfixturevalue("kernel_route") if impl == "kernel" \
        else None
    jcfg, tcfg = _cfgs(impl, **kw)
    jp, tp = _params(jcfg, seed=2)
    tokens = _tokens(seed=3)
    jl, jg = jax.value_and_grad(jax_model.loss_fn)(jp, jnp.asarray(tokens),
                                                   jcfg)
    tl, tg = _grads(tp, tokens, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    jflat = dict(model._flatten(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == set(tg)
    for path, want in jflat.items():
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(tg[path]) / scale, want / scale,
                                   rtol=0, atol=GRAD_TOL, err_msg=path)
    if calls is not None:
        assert calls["backward"] == ARCH["n_layers"]


def test_remat_gradient_equals_plain_gradient():
    """remat changes what the backward keeps, not what it computes."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=4)
    tokens = _tokens(seed=5)
    la, ga = _grads(tp, tokens, tcfg)
    lb, gb = _grads(tp, tokens, dataclasses.replace(tcfg, remat=True))
    assert torch.equal(la, lb)
    for path in ga:
        assert torch.allclose(ga[path], gb[path], rtol=0, atol=1e-7), path


def test_moe_and_sharded_modes_name_their_slice():
    """MoE trains on one device and the sharded state modes run there
    (a one-device mesh); ep×tp trains over a (data, ep, model) mesh."""
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32, moe_experts=4)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    loss, metrics = model.loss_and_metrics(params, torch.from_numpy(
        _tokens()), cfg)
    assert float(loss) > float(metrics["ce"]) > 0
    mesh = moe.make_ep_mesh(["cpu"] * 4, ep=2, tp=2)
    assert dict(mesh.shape) == {"data": 1, "ep": 2, "model": 2}
    ep_init, ep_step = moe.make_ep_train_step(mesh, cfg)
    _, ep_opt, ep_loss, _ = ep_step(*ep_init(
        torch.Generator().manual_seed(0)), _tokens(b=4))
    assert ep_opt["count"] == 1 and np.isfinite(float(ep_loss))
    init_fn, step_fn = model.make_train_step(cfg, device="cpu",
                                             shard="fsdp")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    params, opt, loss = step_fn(params, opt, _tokens())
    assert opt["count"] == 1 and np.isfinite(float(loss))


# -- TrainConfig, schedules and the optimizer against optax -------------


OPT_CONFIGS = {
    "constant": {},
    "warmup2": {"warmup_steps": 2},
    "cosine-w1-d6": {"warmup_steps": 1, "decay_steps": 6},
    "clip-active": {"grad_clip": 0.5},
    "clip-idle": {"grad_clip": 100.0},
    "accum2-cosine": {"accum_steps": 2, "warmup_steps": 1, "decay_steps": 6},
    "accum3-warmup-clip": {"accum_steps": 3, "warmup_steps": 2,
                           "grad_clip": 1.0},
}


def _tree(rng):
    return {"embed": rng.standard_normal((5, 3)).astype(np.float32),
            "blocks": {"w1": rng.standard_normal((2, 3, 4)).astype(
                np.float32)},
            "ln_f": rng.standard_normal((3,)).astype(np.float32)}


def _to_torch(tree):
    return model._map_tree(torch.from_numpy, tree)


def _assert_tree_close(got, want, what):
    want = dict(model._flatten(jax.tree.map(np.asarray, want)))
    got = dict(model._flatten(got))
    assert set(got) == set(want), what
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(got[path]) / scale, w / scale,
                                   rtol=0, atol=OPT_RTOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("kw", list(OPT_CONFIGS.values()),
                         ids=list(OPT_CONFIGS))
def test_optimizer_matches_optax(kw):
    """Six updates from identical params and grads: params and Adam's
    moments within 1e-6 of each leaf's largest |value|, the accumulator
    and MultiSteps' counters too, and zero updates between emits."""
    rng = np.random.default_rng(11)
    params = _tree(rng)
    tcfg = model.TrainConfig(**kw)
    tx = jax_model.make_optimizer(jax_model.TrainConfig(**kw))
    update = jax.jit(lambda g, st, p: (lambda u, st2: (
        optax.apply_updates(p, u), st2, u))(*tx.update(g, st, p)))
    opt = model.make_optimizer(tcfg)
    jp, js = params, tx.init(params)
    tp = _to_torch(params)
    ts = opt.init(tp)
    for i in range(6):
        grads = _tree(rng)
        jp, js, _ = update(grads, js, jp)
        tu, ts = opt.update(_to_torch(grads), ts, tp)
        tp = model.apply_updates(tp, tu)
        _assert_tree_close(tp, jp, f"params after update {i}")
        _assert_tree_close(ts["mu"], optax.tree.get(js, "mu"), "mu")
        _assert_tree_close(ts["nu"], optax.tree.get(js, "nu"), "nu")
        if tcfg.accum_steps > 1:
            _assert_tree_close(ts["acc"], js.acc_grads, "acc")
            assert ts["mini_step"] == int(js.mini_step)
            assert ts["gradient_step"] == int(js.gradient_step)
        if (i + 1) % tcfg.accum_steps:      # between emits: no update
            assert not any(bool(u.any()) for _, u in model._flatten(tu))
    assert ts["count"] == 6 // tcfg.accum_steps


@pytest.mark.parametrize("kw", [OPT_CONFIGS[k] for k in (
    "constant", "warmup2", "cosine-w1-d6")] + [
    {"warmup_steps": 3, "decay_steps": 10, "min_lr_ratio": 0.0}],
    ids=["constant", "warmup2", "cosine-w1-d6", "cosine-to-zero"])
def test_lr_schedule_matches_optax(kw):
    """lr_at for steps 0..12 (past the decay's end) equals the JAX
    TrainConfig's, which reads optax's schedules; the first step of a
    warmup has LR 0."""
    ours, theirs = model.TrainConfig(**kw), jax_model.TrainConfig(**kw)
    for step in range(13):
        assert ours.lr_at(step) == pytest.approx(theirs.lr_at(step),
                                                 rel=1e-6, abs=1e-12)
    if kw.get("warmup_steps"):
        assert ours.lr_at(0) == 0.0


@pytest.mark.parametrize("kw,match", [
    ({"warmup_steps": -1}, "warmup_steps must be >= 0"),
    ({"warmup_steps": 5, "decay_steps": 5}, "must exceed"),
    ({"grad_clip": 0.0}, "grad_clip must be > 0"),
    ({"accum_steps": 0}, "accum_steps must be >= 1"),
], ids=["warmup", "decay", "clip", "accum"])
def test_train_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        model.TrainConfig(**kw)
    with pytest.raises(ValueError, match=match):
        jax_model.TrainConfig(**kw)


# -- the train step against JAX make_sharded_train_step ------------------


@pytest.mark.parametrize("impl,train_kw,arch_kw", [
    ("einsum", {}, {}),
    ("einsum", {"warmup_steps": 2, "grad_clip": 1.0}, {"ce_chunk": 4}),
    ("kernel", {}, {"n_kv_heads": 2}),
], ids=["einsum-default", "einsum-warmup-clip-chunk4", "kernel-gqa"])
def test_train_steps_match_jax(request, impl, train_kw, arch_kw):
    """Five make_train_step steps against JAX make_sharded_train_step on
    a one-device mesh, from the same params and batches: losses within
    1e-3 relative at every step."""
    if impl == "kernel":
        request.getfixturevalue("kernel_route")
    jcfg, tcfg = _cfgs(impl, **arch_kw)
    mesh = jax_model.make_mesh(jax.devices()[:1])
    jinit, jstep = jax_model.make_sharded_train_step(
        mesh, jcfg, train=jax_model.TrainConfig(**train_kw))
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tinit, tstep = model.make_train_step(
        tcfg, train=model.TrainConfig(**train_kw), device="cpu")
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig(**train_kw)).init(tparams)
    for step in range(5):
        tokens = _tokens(b=4, seed=20 + step)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl),
                                   rtol=STEP_LOSS_RTOL, err_msg=f"{step}")
    assert topt["count"] == 5


SP_ARCH = dict(ARCH, seq_len=32)
SP_LOSS_TOL = 2e-4


@pytest.mark.parametrize("impl,world,arch_kw", [
    ("einsum", 2, {}),
    ("pallas", 4, {}),
    ("ulysses", 2, {}),
    ("pallas", 2, {"n_kv_heads": 2, "attention_window": 12, "remat": True}),
    ("einsum", 4, {"ce_chunk": 4}),
], ids=["einsum-sp2", "pallas-sp4", "ulysses-sp2",
        "pallas-sp2-gqa-window-remat", "einsum-sp4-chunk4"])
def test_sp_train_steps_match_jax(impl, world, arch_kw):
    """Three make_sp_train_step steps against JAX make_sp_train_step on a
    (1, sp) mesh of the virtual CPU devices, from the same params
    (params_from_jax) and batches: the losses within 2e-4 and the params
    after them within JAX's own sp-parity bounds.  The port's ranks are
    CPU devices, so "pallas" runs the plain versions of K5 and K6."""
    jcfg = jax_model.ModelConfig(**SP_ARCH, dtype=jnp.float32, **arch_kw)
    tcfg = model.ModelConfig(**SP_ARCH, dtype=torch.float32, **arch_kw)
    mesh = jax_sp.make_sp_mesh(jax.devices()[:world], sp=world)
    jinit, jstep = jax_sp.make_sp_train_step(mesh, jcfg, impl=impl)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    devices = sp.make_sp_mesh(["cpu"] * world, sp=world)
    assert devices.ranks == [torch.device("cpu")] * world
    assert dict(devices.shape) == dict(mesh.shape)
    _, tstep = sp.make_sp_train_step(devices, tcfg, impl=impl)
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    rng = np.random.default_rng(world)
    for step in range(3):
        tokens = rng.integers(0, SP_ARCH["vocab"],
                              (2, SP_ARCH["seq_len"] + 1)).astype(np.int32)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        tparams, topt, tl = tstep(tparams, topt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=SP_LOSS_TOL,
                                   atol=SP_LOSS_TOL, err_msg=f"{step}")
    want = dict(model._flatten(jax.tree.map(np.asarray, jparams)))
    for path, t in model._flatten(tparams):
        np.testing.assert_allclose(_np(t), want[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)


def test_sp_step_equals_single_device_step():
    """The kernel ring over 4 ranks of one device and the single-device
    step: the same loss and params after two steps (f32, summation
    order only)."""
    cfg = model.ModelConfig(**SP_ARCH, dtype=torch.float32, n_kv_heads=2)
    init_fn, step_fn = model.make_train_step(cfg, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(3))
    _, sp_step = sp.make_sp_train_step(["cpu"] * 4, cfg, impl="pallas")
    a = b = (params, opt)
    for seed in range(2):
        tokens = np.random.default_rng(seed).integers(
            0, 64, (2, 33)).astype(np.int32)
        *a, la = step_fn(*a, tokens)
        *b, lb = sp_step(*b, tokens)
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    for (path, x), (_, y) in zip(model._flatten(a[0]),
                                 model._flatten(b[0])):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_sp_refusals_match_jax_and_name_slice_6():
    """JAX's usage errors (sp×ep's expert divisibility among them); sp×tp
    and ZeRO-1 under sp, which slice 6 refused, build and step."""
    cfg = model.ModelConfig(**SP_ARCH, dtype=torch.float32)
    jcfg = jax_model.ModelConfig(**SP_ARCH, dtype=jnp.float32)
    jmesh = jax_sp.make_sp_mesh(jax.devices()[:4], sp=4)
    for kw, match in [({"shard": "fsdp"}, "fsdp belongs to the dp/tp step"),
                      ({"impl": "ring"}, "unknown sp impl")]:
        with pytest.raises(ValueError, match=match):
            sp.make_sp_train_step(["cpu"] * 4, cfg, **kw)
        with pytest.raises(ValueError, match=match):
            jax_sp.make_sp_train_step(jmesh, jcfg, **kw)
    gqa = dict(n_kv_heads=2)
    with pytest.raises(ValueError, match="impl='ulysses' needs"):
        sp.make_sp_train_step(["cpu"] * 4, model.ModelConfig(
            **SP_ARCH, **gqa), impl="ulysses")
    with pytest.raises(ValueError, match="impl='ulysses' needs"):
        jax_sp.make_sp_train_step(jmesh, jax_model.ModelConfig(
            **SP_ARCH, **gqa), impl="ulysses")
    with pytest.raises(ValueError, match="not divisible by the sp axis"):
        sp.make_sp_train_step(["cpu"] * 3, cfg)
    mesh = sp.make_sp_mesh(["cpu"] * 4, sp=2, tp=2)
    assert dict(mesh.shape) == dict(jax_sp.make_sp_mesh(
        jax.devices()[:4], sp=2, tp=2).shape)
    for m, shard in ((mesh, "none"), (["cpu"] * 2, "zero1")):
        init_fn, step_fn = sp.make_sp_train_step(m, cfg, shard=shard)
        *_, loss = step_fn(*init_fn(torch.Generator().manual_seed(0)),
                           np.random.default_rng(0).integers(
                               0, 64, (2, 33)).astype(np.int32))
        assert np.isfinite(float(loss))
    moe_kw = dict(moe_experts=6)
    with pytest.raises(ValueError, match="sp×ep needs moe_experts"):
        sp.make_sp_train_step(["cpu"] * 4, model.ModelConfig(
            **SP_ARCH, **moe_kw))
    with pytest.raises(ValueError, match="sp×ep needs moe_experts"):
        jax_sp.make_sp_train_step(jmesh, jax_model.ModelConfig(
            **SP_ARCH, **moe_kw))


def test_init_fn_is_seeded_and_on_device():
    init_fn, _ = model.make_train_step(model.ModelConfig(**ARCH),
                                       device="cpu")
    a, opt = init_fn(torch.Generator().manual_seed(0))
    b, _ = init_fn(torch.Generator().manual_seed(0))
    for (path, x), (_, y) in zip(model._flatten(a), model._flatten(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32, path
    assert opt["count"] == 0 and set(opt) == {"count", "mu", "nu"}


# -- checkpoints, resume and the drain loop ------------------------------


def _small_run(accum_steps):
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    init_fn, step_fn = model.make_train_step(
        cfg, train=model.TrainConfig(accum_steps=accum_steps,
                                     warmup_steps=1, decay_steps=8),
        device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    return {"params": params, "opt": opt}, step_fn


def _advance(state, step_fn, steps):
    for step in steps:
        params, opt, _ = step_fn(state["params"], state["opt"],
                                 _tokens(b=2, seed=step))
        state = {"params": params, "opt": opt}
    return state


def _assert_states_equal(a, b):
    flat_a = checkpoint.snapshot(a)
    flat_b = checkpoint.snapshot(b)
    for name in ("params", "opt"):
        assert set(flat_a[name]) == set(flat_b[name])
        for key, value in flat_a[name].items():
            np.testing.assert_array_equal(value, flat_b[name][key],
                                          err_msg=f"{name}/{key}")


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_resume_is_bit_exact(tmp_path, accum_steps):
    """Four steps straight equal two, save_checkpoint, restore_checkpoint
    and two more, bit for bit, params and optimizer state."""
    state, step_fn = _small_run(accum_steps)
    straight = _advance(state, step_fn, range(4))
    half = _advance(state, step_fn, range(2))
    path = checkpoint.save_checkpoint(str(tmp_path), 2, half)
    assert sorted(os.listdir(path)) == ["opt.npz", "params.npz"]
    restored = checkpoint.restore_checkpoint(str(tmp_path), 2, "cpu")
    _assert_states_equal(restored, half)
    _assert_states_equal(_advance(restored, step_fn, range(2, 4)), straight)
    # params.npz is what serve and generate read.
    loaded = model.load_params(str(tmp_path), 2, "cpu")
    for path_, t in model._flatten(half["params"]):
        assert torch.equal(dict(model._flatten(loaded))[path_], t)


def test_save_replaces_a_step_and_leaves_no_temporaries(tmp_path):
    state, _ = _small_run(1)
    checkpoint.save_checkpoint(str(tmp_path), 3, state)
    bumped = {"params": model._map_tree(lambda t: t + 1, state["params"]),
              "opt": state["opt"]}
    checkpoint.save_checkpoint(str(tmp_path), 3, bumped)
    assert os.listdir(tmp_path) == ["step_3"]
    _assert_states_equal(
        checkpoint.restore_checkpoint(str(tmp_path), 3, "cpu"), bumped)
    (tmp_path / "step_9.tmp-1").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 3


def test_async_writer_snapshots_and_reraises(tmp_path, monkeypatch):
    """save copies the state to the host before returning (a later
    in-place change does not reach the file) and writes in the
    background; a write error surfaces at the next save or at wait."""
    state, _ = _small_run(1)
    writer = checkpoint.AsyncCheckpointWriter()
    writer.save(str(tmp_path), 1, state)
    before = {k: v.copy() for k, v in
              checkpoint.snapshot(state)["params"].items()}
    state["params"]["ln_f"].add_(5.0)
    writer.wait()
    with np.load(tmp_path / "step_1" / "params.npz") as npz:
        np.testing.assert_array_equal(npz["ln_f"], before["ln_f"])

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "write_step", broken)
    writer.save(str(tmp_path), 2, state)
    with pytest.raises(OSError, match="disk full"):
        writer.save(str(tmp_path), 3, state)
    writer.save(str(tmp_path), 4, state)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()


def _drain_trace(module, tmp_path, drain_after, **kw):
    """Run ``module``'s train_until_drained with a counting step_fn, a
    callable watcher that fires after ``drain_after`` steps, and a
    recording save_fn: (result, saves, on_step calls)."""
    annotations: dict = {}
    watcher = module.DrainWatcher(lambda: annotations, min_poll_interval=0.0)
    saves, hooks = [], []

    def step_fn(state, batch):
        if drain_after is not None and state + 1 >= drain_after:
            annotations[module.CHECKPOINT_ANNOTATION] = "now"
        return state + 1

    result = module.train_until_drained(
        step_fn, 0, watcher=watcher, checkpoint_dir=str(tmp_path),
        make_batch=lambda i: i,
        on_step=lambda step, state: hooks.append((step, state)),
        save_fn=lambda d, step, state: saves.append((step, state)), **kw)
    return result, saves, hooks


@pytest.mark.parametrize("drain_after,kw", [
    (None, {"num_steps": 5}),
    (3, {"num_steps": 100}),
    (None, {"num_steps": 7, "checkpoint_every": 3}),
    (None, {"num_steps": 6, "checkpoint_every": 3}),
    (4, {"num_steps": 9, "checkpoint_every": 2, "start_step": 1}),
    (1, {"num_steps": 2, "start_step": 2}),
], ids=["complete", "drain", "every3", "every3-at-end", "resumed-drain",
        "nothing-to-do"])
def test_train_until_drained_matches_jax(tmp_path, drain_after, kw):
    """The same returns, saves and hook calls as the JAX loop."""
    ours = _drain_trace(checkpoint, tmp_path / "a", drain_after, **kw)
    theirs = _drain_trace(jax_checkpoint, tmp_path / "b", drain_after, **kw)
    assert ours == theirs


# -- the token loader ----------------------------------------------------


def test_dataio_stream_matches_jax(tmp_path):
    shard = str(tmp_path / "tokens.bin")
    dataio.write_token_file(shard, np.random.default_rng(0).integers(
        0, 50_000, 4096, dtype=np.uint32))
    ours = dataio.open_token_loader(shard, batch=4, window=17, seed=3)
    theirs = jax_dataio.PyTokenLoader(shard, batch=4, window=17, seed=3)
    # The native engine wherever it builds (g++), as JAX's picks.
    assert isinstance(ours, dataio.NativeTokenLoader
                      if dataio.native_available() else dataio.PyTokenLoader)
    assert ours.n_tokens == theirs.n_tokens == 4096
    for step in (0, 1, 7, 123456):
        np.testing.assert_array_equal(ours.next(step), theirs.next(step))
    for args in [(0, 0, 0, 10), (5, 99, 3, 4080), (2**40, 7, 1, 17)]:
        assert dataio.row_offset(*args) == jax_dataio.row_offset(*args)
    with pytest.raises(ValueError, match="at least one window"):
        dataio.PyTokenLoader(shard, batch=1, window=5000)


# -- the train CLI -------------------------------------------------------


def _train(tmp_path, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.train",
         "--platform", "cpu", "--vocab", "64", "--d-model", "32",
         "--n-layers", "1", "--seq-len", "16", "--batch", "4",
         "--checkpoint-dir", str(tmp_path / "ckpt"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_trains_resumes_and_generate_reads_it(tmp_path):
    """Train 20 steps with a checkpoint every 10, resume to 30, then the
    port's generate CLI serves the trainer's checkpoint."""
    first = _train(tmp_path, "--steps", "20", "--checkpoint-every", "10")
    assert first.returncode == 0, first.stderr
    assert "step 10 loss" in first.stderr and "step 20 loss" in first.stderr
    assert "training complete at step 20" in first.stderr
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_10", "step_20"]
    second = _train(tmp_path, "--steps", "30", "--checkpoint-every", "10")
    assert second.returncode == 0, second.stderr
    assert "resumed from checkpoint step 20" in second.stderr
    assert "training complete at step 30" in second.stderr
    gen = subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.generate",
         "--platform", "cpu", "--vocab", "64", "--d-model", "32",
         "--n-layers", "1", "--seq-len", "16", "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--prompt", "1,2,3", "--batch", "2",
         "--steps", "6"], capture_output=True, text=True, timeout=240,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert gen.returncode == 0, gen.stderr
    assert "loaded step 30" in gen.stderr
    lines = gen.stdout.strip().splitlines()
    assert len(lines) == 2
    prompt, out = lines[0].split(" | ")
    assert prompt == "1,2,3" and len(out.split(",")) == 6


def test_cli_synthetic_stream_is_the_jax_trainers(tmp_path):
    """The CLI's first step trains on the JAX trainer's synthetic batch 0
    from the CLI's seed-0 params (CPU generator): its checkpoint equals
    that step taken here."""
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", "--vocab", "64", "--d-model", "32",
        "--n-layers", "1", "--seq-len", "16", "--batch", "4", "--steps",
        "1", "--checkpoint-dir", str(tmp_path)])
    assert res.exit_code == 0, res.output
    cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=1, seq_len=16)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = np.random.default_rng((0 << 16) | 0).integers(
        0, 64, (4, 17), dtype=np.int32)
    _, step_fn = model.make_train_step(cfg, device="cpu")
    want = step_fn(params, model.make_optimizer(model.TrainConfig()).init(
        params), tokens)[0]
    got = dict(model._flatten(model.load_params(str(tmp_path), 1, "cpu")))
    for path, t in model._flatten(want):
        assert torch.equal(got[path], t), path


def test_cli_drain_contract_checkpoints_and_exits(tmp_path):
    annotations = tmp_path / "annotations"
    annotations.write_text('autoscaler.tpu.dev/checkpoint-requested="1"\n')
    res = _train(tmp_path, "--steps", "5000", "--annotations-file",
                 str(annotations))
    assert res.returncode == 0, res.stderr
    assert "drain requested: checkpointed at step 0" in res.stderr
    assert os.listdir(tmp_path / "ckpt") == ["step_0"]


def test_cli_flags_wired_through(tmp_path):
    """GQA, a window, --ce-chunk, --no-rope, --remat and the LR recipe
    reach the model and the optimizer, and train end to end."""
    res = _train(tmp_path, "--steps", "4", "--checkpoint-every", "4",
                 "--n-kv-heads", "2", "--attention-window", "6",
                 "--ce-chunk", "8", "--no-rope", "--remat",
                 "--lr-schedule", "cosine", "--warmup-steps", "1",
                 "--grad-clip", "1.0", "--accum-steps", "2")
    assert res.returncode == 0, res.stderr
    assert "training complete at step 4" in res.stderr
    params = model.load_params(str(tmp_path / "ckpt"), 4, "cpu")
    # 4 heads of head_dim 8 over 2 KV heads: qkv is 32 + 2 * 2 * 8 wide.
    assert tuple(params["blocks"]["qkv"].shape) == (1, 32, 64)
    with np.load(tmp_path / "ckpt" / "step_4" / "opt.npz") as npz:
        assert int(npz["count"]) == 2 and int(npz["gradient_step"]) == 2


def test_cli_trains_from_token_shard(tmp_path):
    shard = str(tmp_path / "tokens.bin")
    dataio.write_token_file(shard, np.random.default_rng(0).integers(
        0, 50_000, 2048, dtype=np.uint32))
    res = _train(tmp_path, "--steps", "3", "--checkpoint-every", "3",
                 "--data-file", shard)
    assert res.returncode == 0, res.stderr
    engine = ("NativeTokenLoader" if dataio.native_available()
              else "PyTokenLoader")
    assert "token shard" in res.stderr and f"({engine} loader)" in res.stderr
    # The run's kernel launches, logged at its end: none on the CPU.
    assert "kernel launches " + json.dumps(
        {name: 0 for name in attention.LAUNCHES}) in res.stderr
    assert "aliased with modulo" in res.stderr
    assert "training complete at step 3" in res.stderr


def test_cli_bad_n_kv_heads_is_rejected(tmp_path):
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", "--steps", "1", "--n-kv-heads", "3",
        "--checkpoint-dir", str(tmp_path)])
    assert res.exit_code == 2
    assert "multiple of n_kv_heads" in res.output
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,item", [
    (["--ep", "2", "--moe-experts", "4", "--tp", "2"],
     "ep 2 ranks on cpu, cpu, cpu, cpu; mesh {'data': 1, 'ep': 2, "
     "'model': 2}"),
    (["--pp-stages", "2", "--n-layers", "2"],
     "pp 2 stages on cpu, cpu; mesh {'pp': 2}, 4 microbatches"),
    (["--sp", "2", "--shard", "zero1"],
     "mesh {'data': 1, 'sp': 2}, shard zero1"),
    (["--sp", "2", "--tp", "2"],
     "mesh {'data': 1, 'sp': 2, 'model': 2}, shard none"),
    (["--moe-experts", "4", "--sp", "2", "--tp", "2"],
     "mesh {'data': 1, 'sp': 2, 'model': 2}, shard none")],
    ids=["ep", "pp", "sp", "sp-tp", "moe"])
def test_cli_refuses_unported_parallelism(tmp_path, caplog, flags, item):
    """The strategies and compositions the port's trainer once refused
    (--pp-stages, --ep with --tp, --sp with --shard zero1 or --tp,
    sp×ep×tp) train 2 steps on the CPU and checkpoint the one-device
    layout (--pp-stages 2 on 2 layers, one a stage)."""
    caplog.set_level("INFO")
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", "--vocab", "64", "--d-model", "32",
        "--n-layers", "1", "--seq-len", "16", "--batch", "4", "--steps",
        "2", "--checkpoint-dir", str(tmp_path), *flags])
    assert res.exit_code == 0, res.output
    assert item in caplog.text
    assert os.listdir(tmp_path) == ["step_2"]
    layers = 2 if "--pp-stages" in flags else 1
    params = model.load_params(str(tmp_path), 2, "cpu")
    assert tuple(params["blocks"]["qkv"].shape) == (layers, 32, 96)
    opt = checkpoint.restore_checkpoint(str(tmp_path), 2, "cpu")["opt"]
    assert opt["count"] == 2
    assert tuple(opt["mu"]["blocks"]["w1"].shape) == tuple(
        params["blocks"]["w1"].shape)


def test_cli_pp_tp_checkpoints_merged_and_resumes(tmp_path, caplog):
    """--pp-stages 2 --tp 2 --pp-microbatches 2 (data 1 × pp 2 × model 2
    on the CPU) checkpoints the one-device layout, qkv packed (L, d, 3d)
    in the params and in the moments; 2 steps, then a resume to 4, land
    on the params of 4 uninterrupted steps."""
    caplog.set_level("INFO")
    base = ["--platform", "cpu", "--vocab", "64", "--d-model", "32",
            "--n-layers", "2", "--seq-len", "16", "--batch", "4",
            "--checkpoint-every", "2", "--pp-stages", "2", "--tp", "2",
            "--pp-microbatches", "2"]
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    for steps, directory in (("4", whole), ("2", split), ("4", split)):
        res = CliRunner().invoke(train_cli.main, base + [
            "--steps", steps, "--checkpoint-dir", directory])
        assert res.exit_code == 0, res.output
    assert "mesh {'data': 1, 'pp': 2, 'model': 2}, 2 microbatches" \
        in caplog.text
    assert "resumed from checkpoint step 2" in caplog.text
    assert sorted(os.listdir(split)) == ["step_2", "step_4"]
    got = checkpoint.restore_checkpoint(split, 4, "cpu")
    want = checkpoint.restore_checkpoint(whole, 4, "cpu")
    assert tuple(got["params"]["blocks"]["qkv"].shape) == (2, 32, 96)
    assert tuple(got["opt"]["nu"]["blocks"]["qkv"].shape) == (2, 32, 96)
    assert "wq" not in got["params"]["blocks"]
    assert got["opt"]["count"] == want["opt"]["count"] == 4
    for path, t in model._flatten(want["params"]):
        np.testing.assert_allclose(
            _np(dict(model._flatten(got["params"]))[path]), _np(t),
            rtol=0, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("flags", [
    ["--pp-stages", "2", "--shard", "zero1"],
    ["--pp-stages", "2", "--zero1"],
    ["--pp-stages", "2", "--batch", "6"],
    ["--pp-stages", "2", "--n-layers", "3", "--batch", "4"],
    ["--pp-stages", "3", "--tp", "2", "--batch", "8"],
    ["--pp-stages", "2", "--tp", "2", "--batch", "4"],
    ["--pp-stages", "2", "--tp", "4", "--n-kv-heads", "2", "--batch", "4"],
], ids=["shard", "zero1", "microbatches", "layers", "pp-tp-devices",
        "pp-tp-batch", "pp-tp-heads"])
def test_cli_pp_usage_errors_match_jax(tmp_path, monkeypatch, flags):
    """With 8 devices visible to both trainers (the port's cards patched
    to 8 CPU ranks, JAX's the conftest's virtual devices), --pp-stages'
    usage errors are JAX's, word for word: --shard/--zero1, a batch the
    microbatches do not divide, layers the stages do not divide, pp×tp
    not dividing the devices, a batch not dividing over data ×
    microbatches, heads not dividing tp."""
    monkeypatch.setattr(train_cli, "_cards",
                        lambda device, ranks: [device] * 8)
    base = ["--steps", "1", "--vocab", "64", "--d-model", "32",
            "--n-layers", "2", "--seq-len", "16", "--checkpoint-dir",
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


@pytest.mark.parametrize("flags", [
    ["--ep", "3", "--moe-experts", "6"],
    ["--ep", "2", "--moe-experts", "4", "--batch", "6"],
    ["--ep", "2", "--moe-experts", "4", "--tp", "2", "--batch", "6"],
    ["--sp", "3"],
    ["--sp", "2", "--tp", "2", "--batch", "3"],
    ["--sp", "2", "--tp", "3"],
], ids=["ep-devices", "ep-batch", "ep-tp-batch", "sp-devices", "sp-batch",
        "sp-tp-devices"])
def test_cli_composition_usage_errors_match_jax(tmp_path, monkeypatch,
                                                flags):
    """With 8 devices visible to both trainers (the port's cards
    patched to 8 CPU ranks, JAX's the conftest's virtual devices), the
    --ep/--sp/--tp device and batch errors are JAX's, word for word."""
    monkeypatch.setattr(train_cli, "_cards",
                        lambda device, ranks: [device] * 8)
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


@pytest.mark.parametrize("flags,mesh", [
    (["--tp", "2"], "{'data': 1, 'model': 2}, shard none"),
    (["--zero1"], "{'data': 1, 'model': 1}, shard zero1"),
    (["--shard", "fsdp"], "{'data': 1, 'model': 1}, shard fsdp"),
    (["--shard", "zero1", "--tp", "2"],
     "{'data': 1, 'model': 2}, shard zero1")],
    ids=["tp", "zero1", "fsdp", "shard-zero1"])
def test_cli_runs_the_mesh_flags(tmp_path, caplog, flags, mesh):
    """--tp, --zero1 and --shard train on the (data, model) mesh (ranks
    repeat the one CPU) and checkpoint the one-device layout."""
    caplog.set_level("INFO")
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", "--vocab", "64", "--d-model", "32",
        "--n-layers", "1", "--seq-len", "16", "--batch", "4", "--steps",
        "2", "--checkpoint-dir", str(tmp_path), *flags])
    assert res.exit_code == 0, res.output
    assert f"mesh {mesh} on cpu" in caplog.text
    assert os.listdir(tmp_path) == ["step_2"]
    params = model.load_params(str(tmp_path), 2, "cpu")
    assert tuple(params["blocks"]["qkv"].shape) == (1, 32, 96)


def test_cli_refuses_a_missing_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(train_cli.main, [
        "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    assert res.exit_code == 2, res.output
    assert "--platform cpu" in res.output


def test_cli_sp_trains_resumes_and_drains(tmp_path):
    """--sp 2 on the CPU (the einsum ring, auto): 4 steps with a
    checkpoint every 2, resume to 6, then drain with a checkpoint; the
    checkpoints hold the single-device layout (generate and serve read
    them)."""
    first = _train(tmp_path, "--sp", "2", "--steps", "4",
                   "--checkpoint-every", "2")
    assert first.returncode == 0, first.stderr
    assert "sp 2 ranks (auto) on cpu, cpu" in first.stderr
    assert "training complete at step 4" in first.stderr
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2", "step_4"]
    second = _train(tmp_path, "--sp", "2", "--steps", "6",
                    "--checkpoint-every", "2", "--sp-impl", "ulysses")
    assert second.returncode == 0, second.stderr
    assert "resumed from checkpoint step 4" in second.stderr
    assert "training complete at step 6" in second.stderr
    annotations = tmp_path / "annotations"
    annotations.write_text('autoscaler.tpu.dev/checkpoint-requested="1"\n')
    drain = _train(tmp_path, "--sp", "2", "--steps", "5000",
                   "--annotations-file", str(annotations))
    assert drain.returncode == 0, drain.stderr
    assert "drain requested: checkpointed at step 6" in drain.stderr
    params = model.load_params(str(tmp_path / "ckpt"), 6, "cpu")
    assert tuple(params["blocks"]["qkv"].shape) == (1, 32, 96)


@pytest.mark.parametrize("flags,match", [
    (["--sp", "2", "--sp-impl", "pallas"], "needs --platform cuda"),
    (["--sp", "3"], "--sp 3 must divide --seq-len 64"),
    (["--sp", "4", "--sp-impl", "ulysses", "--n-kv-heads", "2"],
     "impl='ulysses' needs"),
    (["--sp", "2", "--shard", "fsdp"], "--shard fsdp composes with the "
                                       "dp+tp step, not --sp"),
], ids=["pallas-on-cpu", "seq-len", "ulysses-heads", "fsdp"])
def test_cli_sp_usage_errors(tmp_path, flags, match):
    res = CliRunner().invoke(train_cli.main, [
        "--platform", "cpu", "--steps", "1", "--checkpoint-dir",
        str(tmp_path), *flags])
    assert res.exit_code == 2, res.output
    assert match in " ".join(res.output.split())
    assert not os.listdir(tmp_path)
