"""A replica per data rank: the port's training state placed where JAX
places it, on the CPU.

JAX runs on the conftest's 8 virtual CPU devices, the port on
``make_mesh(["cpu"] * 8)``: dp 4 × tp 2 on both sides.  In each shard
mode every rank holds its own blocks, so each rank's
``rank_state_bytes`` must equal the bytes of JAX's addressable shards on
the matching device, at init and after the steps, and no two ranks may
share a storage.  Five steps of ``make_sharded_train_step`` (GQA, the
global-norm clip on, so the norm must count each block once) from JAX's
params on the same numpy-made batches: losses within 1e-3 relative and
the gathered params within rtol 1e-3, atol 1e-5 (``test_torch_mesh.py``'s
bounds).  After them the replicas of every block of the params and the
moments must be equal bit for bit: the step sums the replicas'
gradients in one order and updates every copy alike.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler_torch.workloads import model  # noqa: E402

ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, seq_len=16)
TRAIN = dict(grad_clip=1.0)
STEPS = 5
STEP_LOSS_RTOL = 1e-3
BATCH = 8


def _paths(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_device_bytes(jmesh, jparams, jopt) -> list:
    """The bytes of JAX's params and Adam moments in each device's
    addressable shards, in rank order (the optimizer's counts left
    out, as ``rank_state_bytes`` leaves out the port's host ints)."""
    moments = [leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jopt)[0]
               if any(getattr(k, "name", None) in ("mu", "nu")
                      for k in path)]
    out = [0] * jmesh.size
    for x in [*_paths(jparams).values(), *moments]:
        by_device = {s.device: s for s in x.addressable_shards}
        for r, dev in enumerate(jmesh.devices.flat):
            out[r] += by_device[dev].data.nbytes
    return out


def _blocks(params, opt):
    return [(f"{tree_name}/{path}", leaf)
            for tree_name, tree in (("params", params), ("mu", opt["mu"]),
                                    ("nu", opt["nu"]))
            for path, leaf in model._flatten(tree)]


def _storages_distinct(params, opt) -> None:
    tensors = [t for _, leaf in _blocks(params, opt)
               for t in leaf.blocks.values()]
    assert len({t.untyped_storage().data_ptr() for t in tensors}) \
        == len(tensors)


@pytest.mark.parametrize("shard", ["none", "zero1", "fsdp"])
def test_replicas_match_jax_layout_and_steps(shard):
    jcfg = jax_model.ModelConfig(**ARCH, dtype=jnp.float32)
    tcfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    jmesh = jax_model.make_mesh(jax.devices()[:8])
    tmesh = model.make_mesh(["cpu"] * 8)
    jinit, jstep = jax_model.make_sharded_train_step(
        jmesh, jcfg, train=jax_model.TrainConfig(**TRAIN), shard=shard)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    _, tstep = model.make_sharded_train_step(
        tmesh, tcfg, train=model.TrainConfig(**TRAIN), shard=shard)
    one = model.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = model.make_optimizer(model.TrainConfig(**TRAIN)).init(one)
    params = model.shard_params(tmesh, tcfg, one, shard)
    opt = model.shard_opt_state(tmesh, tcfg, opt, shard)
    assert model.rank_state_bytes(tmesh, params, opt) \
        == _jax_device_bytes(jmesh, jparams, jopt)
    _storages_distinct(params, opt)

    rng = np.random.default_rng(7)
    for step in range(STEPS):
        tokens = rng.integers(0, ARCH["vocab"], (BATCH, ARCH["seq_len"] + 1)
                              ).astype(np.int32)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(tokens))
        params, opt, tl = tstep(params, opt, tokens)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = _paths(jax.tree.map(np.asarray, jparams))
    for path, t in model._flatten(model.gather_params(tmesh, params)):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-3,
                                   atol=1e-5, err_msg=path)
    assert model.rank_state_bytes(tmesh, params, opt) \
        == _jax_device_bytes(jmesh, jparams, jopt)
    _storages_distinct(params, opt)

    replicated = 0
    for path, leaf in _blocks(params, opt):
        groups = collections.defaultdict(list)
        for r, t in leaf.blocks.items():
            groups[leaf.index_of(r)].append(t)
        for index, copies in groups.items():
            replicated += len(copies) > 1
            for t in copies[1:]:
                np.testing.assert_array_equal(t.numpy(), copies[0].numpy(),
                                              err_msg=f"{path} {index}")
    assert replicated
