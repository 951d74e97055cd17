"""Head dims the port's kernels are not built for (48, 80, 96, 192: what
the CLIs' 4 heads make of --d-model 192, 320, 384 and 768), on the CPU.

The whole-activation kernels run such a head_dim zero-padded to the next
built width with the true scale (``attention.call_padded``).  The plain
versions take the same ``scale``, so the padded round trip runs here
through each of the six plain versions and must equal the plain version
at the true width.  Then the slice serves and trains a --d-model 384
model (head_dim 96) against the JAX package, as the other parity tests
do, in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    model,
    serving,
)

PAD_TOL = 2e-6     # f32: the zero columns add exact zeros to each sum
PARITY_TOL = 2e-5  # f32 against the JAX package: summation order only


def _rnd(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _attention_case(rng, d):
    q, k, v = _rnd(rng, 2, 4, 37, d), _rnd(rng, 2, 2, 37, d), \
        _rnd(rng, 2, 2, 37, d)
    return attention.flash_attention_reference, (q, k, v), (0, 1, 2), \
        dict(window=9)


def _backward_case(rng, d):
    q, k, v, do = _rnd(rng, 2, 4, 37, d), _rnd(rng, 2, 2, 37, d), \
        _rnd(rng, 2, 2, 37, d), _rnd(rng, 2, 4, 37, d)
    o, lse = attention.flash_attention_reference(q, k, v, window=9)
    return attention.flash_attention_backward_reference, \
        (q, k, v, o, lse, do), (0, 1, 2, 3, 5), dict(window=9)


def _decode_case(rng, d):
    q, k, v = _rnd(rng, 3, 4, 1, d), _rnd(rng, 3, 2, 24, d), \
        _rnd(rng, 3, 2, 24, d)
    lengths = torch.tensor([1, 20, 50])
    return attention.flash_decode_reference, (q, k, v, lengths), (0, 1, 2), \
        dict(window=16, ring=True)


def _paged_case(rng, d):
    q, k, v = _rnd(rng, 3, 4, 1, d), _rnd(rng, 20, 2, 8, d), \
        _rnd(rng, 20, 2, 8, d)
    tables = torch.from_numpy(rng.permutation(20)[:15].reshape(3, 5))
    tables[1, 1] = -1
    lengths = torch.tensor([3, 33, 40])
    return attention.paged_flash_decode_reference, \
        (q, k, v, tables, lengths), (0, 1, 2), dict(window=30)


def _ring_step_case(rng, d):
    q, k, v = _rnd(rng, 2, 4, 21, d), _rnd(rng, 2, 2, 30, d), \
        _rnd(rng, 2, 2, 30, d)
    m, l_ = _rnd(rng, 2, 4, 21, 1), _rnd(rng, 2, 4, 21, 1).abs() + 0.5
    acc = _rnd(rng, 2, 4, 21, d)
    return attention.ring_flash_step_reference, (q, k, v, m, l_, acc), \
        (0, 1, 2, 5), dict(offset=5, masked=True, window=20)


def _ring_bwd_case(rng, d):
    q, k, v, do = _rnd(rng, 2, 4, 21, d), _rnd(rng, 2, 2, 30, d), \
        _rnd(rng, 2, 2, 30, d), _rnd(rng, 2, 4, 21, d)
    lse = _rnd(rng, 2, 4, 21, 1).abs() + 2.0
    delta = _rnd(rng, 2, 4, 21, 1)
    return attention.ring_flash_bwd_step_reference, \
        (q, k, v, do, lse, delta), (0, 1, 2, 3), \
        dict(offset=30, masked=False)


PLAIN_CASES = {"flash_attention": _attention_case,
               "flash_attention_backward": _backward_case,
               "flash_decode": _decode_case,
               "paged_flash_decode": _paged_case,
               "ring_flash_step": _ring_step_case,
               "ring_flash_bwd_step": _ring_bwd_case}


@pytest.mark.parametrize("d", [48, 80, 96, 192])
@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_padded_round_trip_equals_plain_version(name, d):
    """call_padded pads the head_dim inputs to kernel_width(d), runs the
    plain version there with the true scale d^-0.5 and slices back: the
    same function as the plain version at d."""
    rng = np.random.default_rng(d)
    fn, args, pad, kw = PLAIN_CASES[name](rng, d)
    assert attention.kernel_width(d) not in (d, None)
    want = fn(*args, **kw)
    got = attention.call_padded(fn, args, pad, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert (g - w).abs().max().item() <= PAD_TOL


def test_kernel_width_and_head_dim_limit():
    assert [attention.kernel_width(d) for d in (1, 32, 33, 96, 129, 256)] \
        == [32, 32, 64, 128, 256, 256]
    with pytest.raises(ValueError, match="up to 256"):
        attention.kernel_width(264)
    t = torch.zeros(2, 3, 5, 64)
    assert attention.pad_head_dim(t, 64) is t
    assert attention.pad_head_dim(t, 128).shape == (2, 3, 5, 128)


ARCH384 = dict(vocab=64, d_model=384, n_layers=2, n_heads=4, d_ff=128,
               seq_len=32)


def _cfgs(**kw):
    """--d-model 384 (head_dim 96) in both packages, f32."""
    return (jax_model.ModelConfig(**ARCH384, dtype=jnp.float32, **kw),
            model.ModelConfig(**ARCH384, dtype=torch.float32, **kw))


def _params(jcfg, seed):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
def test_d_model_384_serves_as_the_jax_engine(impl):
    """A head_dim 96 GQA model through both engines: the prefill chunk's
    logits within 2e-5, then 4 requests through 2 slots give the JAX
    engine's greedy tokens and ticks."""
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jcfg = dataclasses.replace(jcfg, attention=impl)
    assert tcfg.head_dim == 96
    jp, tp = _params(jcfg, seed=11)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 64, 8).astype(np.int32)
    jcache = jax_serving.SlotKVCache.zeros(jcfg, 2, 32)
    tcache = serving.SlotKVCache.zeros(tcfg, 2, 32, "cpu")
    jl, _ = jax_serving.make_prefill_chunk(jcfg, 8)(
        jp, jcache, jnp.int32(1), jnp.asarray(toks), jnp.int32(6))
    with torch.no_grad():
        tl, _ = serving.make_prefill_chunk(tcfg, 8)(
            tp, tcache, 1, torch.from_numpy(toks), 6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PARITY_TOL,
                               atol=PARITY_TOL)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 11, 3, 9)]
    jeng = jax_serving.ContinuousBatcher(jp, jcfg, slots=2, max_len=32,
                                         chunk=8)
    teng = serving.ContinuousBatcher(tp, tcfg, slots=2, max_len=32, chunk=8,
                                     device="cpu")
    out = []
    for eng, req_cls in ((jeng, jax_serving.Request),
                         (teng, serving.Request)):
        reqs = [req_cls(prompt=p, max_new_tokens=n)
                for p, n in zip(prompts, (4, 6, 3, 5))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        out.append([list(map(int, r.generated)) for r in reqs])
    assert out[1] == out[0]
    assert teng.ticks == jeng.ticks


def test_d_model_384_trains_as_jax():
    """The loss and every gradient leaf of a head_dim 96 GQA model
    against jax.value_and_grad of the JAX loss (loss within 2e-5, each
    leaf within 1e-4 of its largest |grad|), then three train steps
    against JAX make_sharded_train_step with losses within 2e-5."""
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jp, tp = _params(jcfg, seed=13)
    tokens = np.random.default_rng(14).integers(
        0, 64, (2, ARCH384["seq_len"] + 1)).astype(np.int32)
    jl, jg = jax.value_and_grad(jax_model.loss_fn)(jp, jnp.asarray(tokens),
                                                   jcfg)
    paths, leaves = zip(*model._flatten(tp))
    leaves = [p.detach().clone().requires_grad_() for p in leaves]
    tl = model.loss_fn(model._unflatten(dict(zip(paths, leaves))),
                       torch.from_numpy(tokens), tcfg)
    tg = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=PARITY_TOL, atol=PARITY_TOL)
    for path, want in model._flatten(jax.tree.map(np.asarray, jg)):
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(tg[path].numpy() / scale, want / scale,
                                   rtol=0, atol=1e-4, err_msg=path)
    mesh = jax_model.make_mesh(jax.devices()[:1])
    jinit, jstep = jax_model.make_sharded_train_step(mesh, jcfg)
    jparams, jopt = jinit(jax.random.PRNGKey(15))
    _, tstep = model.make_train_step(tcfg, device="cpu")
    tparams = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    topt = model.make_optimizer(model.TrainConfig()).init(tparams)
    for step in range(3):
        batch = np.random.default_rng(16 + step).integers(
            0, 64, (2, ARCH384["seq_len"] + 1)).astype(np.int32)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(batch))
        tparams, topt, tl = tstep(tparams, topt, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=PARITY_TOL,
                                   atol=PARITY_TOL, err_msg=f"{step}")
