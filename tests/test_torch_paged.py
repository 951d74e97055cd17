"""The port's paged engine against the JAX package's, on the CPU.

The same weights (JAX ``init_params``, carried across with
``params_from_jax``), the same numpy-made pools, tables and prompts go
through both packages in f32.  Attention agrees within 2e-5 (the JAX
package's kernel-vs-einsum tolerance); step logits and pools within
2e-4, with exactly the same pool entries written (a dropped write
leaves its entry bit for bit as it was); the engines' greedy tokens,
preemption counts, lengths and block tables agree exactly, tick by
tick.  The JAX engine runs with ``attention="pallas"`` (the paged
kernel, interpreted off-TPU) and ``"einsum"``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import paged as jax_paged  # noqa: E402
from tpu_autoscaler_torch.obs.trace import DeviceCounter  # noqa: E402
from tpu_autoscaler_torch.serving.drain import DrainReceipt  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    model,
    paged,
    serve,
    serving,
)

# tests/test_paged.py's CFG.
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=64)
ATTN_TOL = 2e-5
STEP_TOL = 2e-4


def _cfgs(jax_attention_impl="auto", **kw):
    return (jax_model.ModelConfig(**ARCH, dtype=jnp.float32,
                                  attention=jax_attention_impl, **kw),
            model.ModelConfig(**ARCH, dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _np(t):
    return t.detach().cpu().numpy()


def test_block_allocator_round_trip_matches_jax():
    mine, theirs = paged.BlockAllocator(4), jax_paged.BlockAllocator(4)
    for a in (mine, theirs):
        got = [a.alloc() for _ in range(4)]
        assert sorted(got) == [0, 1, 2, 3]
        assert a.alloc() is None and a.free_blocks == 0
        a.free([2, -1, 0])                 # -1 (no block) is ignored
        assert a.free_blocks == 2 and a.used_blocks == 2
    # The same free-list order: both hand out the same blocks next.
    assert [mine.alloc() for _ in range(3)] \
        == [theirs.alloc() for _ in range(3)]


# ---- attention: the kernel's plain version ---------------------------

SLOTS, H, HKV, D, BS, TPR, NB = 4, 4, 2, 16, 8, 4, 10


def _pool_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((SLOTS, H, 1, D)).astype(np.float32)
    kp = rng.standard_normal((NB, HKV, BS, D)).astype(np.float32)
    vp = rng.standard_normal((NB, HKV, BS, D)).astype(np.float32)
    return q, kp, vp


# Tables whose every live position has a block, one id past the pool
# (12 -> clamped to block 9) and a row of length 0: the kernel and the
# gather route agree on these.
GATHERABLE = (np.array([[3, 7, -1, -1], [1, 0, 12, 5], [2, -1, -1, -1],
                        [6, 4, 8, -1]], np.int32),
              np.array([12, 29, 5, 0], np.int32))
# A -1 below a row's length (row 0's block 1, row 2's block 1 under its
# length 12): the kernel hides the whole block, the gather route reads
# block 0 there.
HOLES = (np.array([[3, -1, 7, -1], [1, 0, 12, 5], [2, -1, -1, -1],
                   [6, 4, 8, -1]], np.int32),
         np.array([20, 29, 12, 0], np.int32))


def _port_paged(q, kp, vp, tables, lengths, window):
    return _np(attention.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths), window=window))


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("case", ["gatherable", "holes"])
def test_paged_reference_matches_jax_kernel(case, window):
    """The plain version against the JAX paged kernel (interpreted), and
    on gatherable tables also against JAX flash_decode over the gathered
    rows; a row of length 0 gives zeros."""
    tables, lengths = GATHERABLE if case == "gatherable" else HOLES
    q, kp, vp = _pool_inputs(seed=1 if window is None else 2)
    got = _port_paged(q, kp, vp, tables, lengths, window)
    want = np.asarray(jax_attention.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), window=window,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert not got[3].any()
    safe = np.clip(tables, 0, NB - 1)
    rows = [p[safe].transpose(0, 2, 1, 3, 4).reshape(SLOTS, HKV, TPR * BS, D)
            for p in (kp, vp)]
    gathered = np.asarray(jax_attention.flash_decode(
        jnp.asarray(q), jnp.asarray(rows[0]), jnp.asarray(rows[1]),
        jnp.asarray(lengths), window=window, interpret=True))
    if case == "gatherable":
        np.testing.assert_allclose(got, gathered, rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
    else:
        for row in (0, 2):
            assert np.abs(got[row] - gathered[row]).max() > 1e-3


def test_paged_wrapper_rejections():
    q = torch.zeros((2, 4, 1, 16))
    pool = torch.zeros((5, 2, 8, 16))
    tables = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="single-token"):
        attention.paged_flash_decode(torch.zeros((2, 4, 2, 16)), pool, pool,
                                     tables, lengths)
    with pytest.raises(ValueError, match="does not fit"):
        attention.paged_flash_decode(torch.zeros((2, 3, 1, 16)), pool, pool,
                                     tables, lengths)
    with pytest.raises(ValueError, match="do not fit"):
        attention.paged_flash_decode(q, pool, pool, tables[:1], lengths)
    with pytest.raises(ValueError, match="window"):
        attention.paged_flash_decode(q, pool, pool, tables, lengths,
                                     window=0)
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32, attention="kernel")
    with pytest.raises(ValueError, match="needs CUDA"):
        paged._paged_attend(q, pool, pool, tables, lengths, cfg)


# ---- one decode step and one batched prefill -------------------------

def _pools(cfg_layers, seed):
    """Random [layers, NB, HKV, BS, hd] pools: a dropped write leaves
    its entry exactly as it was, which a zero pool would not show."""
    rng = np.random.default_rng(seed)
    shape = (cfg_layers, NB, HKV, BS, 32 // 4)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _both_caches(k0, v0, lengths):
    return (jax_paged.PagedKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                                   lengths=jnp.asarray(lengths)),
            paged.PagedKVCache(k=torch.from_numpy(k0.copy()),
                               v=torch.from_numpy(v0.copy()),
                               lengths=torch.from_numpy(lengths.copy())))


def _compare_pools(tcache, jcache, k0, v0):
    for got, want, before in ((tcache.k, jcache.k, k0),
                              (tcache.v, jcache.v, v0)):
        got, want = _np(got), np.asarray(want)
        np.testing.assert_array_equal(got != before, want != before)
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_array_equal(_np(tcache.lengths),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
def test_decode_step_matches_jax(impl):
    """Two batched decode steps with inactive rows (which write
    nothing), a position whose table entry is past the pool (its write
    drops) and a row of length 0."""
    jcfg, tcfg = _cfgs(impl, n_kv_heads=HKV)
    jp, tp = _params(jcfg, seed=3)
    k0, v0 = _pools(jcfg.n_layers, seed=4)
    tables = np.array([[3, 7, -1, -1], [1, 0, 12, -1], [2, 5, -1, -1],
                       [4, -1, -1, -1]], np.int32)
    lengths = np.array([12, 16, 9, 0], np.int32)
    active = np.array([True, True, False, False])
    jcache, tcache = _both_caches(k0, v0, lengths)
    jstep = jax_paged.make_paged_decode_step(jcfg, TPR * BS)
    tstep = paged.make_paged_decode_step(tcfg, TPR * BS)
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, 64, SLOTS).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tables), jnp.asarray(toks),
                           jnp.asarray(active))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(tables),
                           torch.from_numpy(toks), torch.from_numpy(active))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=STEP_TOL,
                                   atol=STEP_TOL)
        _compare_pools(tcache, jcache, k0, v0)
    np.testing.assert_array_equal(_np(tcache.lengths), [14, 18, 9, 0])


@pytest.mark.parametrize("all_logits", [False, True])
def test_batched_prefill_matches_jax(all_logits):
    """Three lanes: one crossing a block boundary at an offset, one
    whose later positions map past the pool (dropped), one unused."""
    jcfg, tcfg = _cfgs(n_kv_heads=HKV)
    jp, tp = _params(jcfg, seed=6)
    k0, v0 = _pools(jcfg.n_layers, seed=7)
    lanes, chunk = 3, 8
    tables = np.array([[3, 7, -1, -1], [1, 0, 12, -1], [-1, -1, -1, -1]],
                      np.int32)
    offsets = np.array([4, 10, 0], np.int32)
    n_valid = np.array([8, 8, 0], np.int32)
    toks = np.random.default_rng(8).integers(0, 64, (lanes, chunk)).astype(
        np.int32)
    jcache, tcache = _both_caches(k0, v0, np.zeros(SLOTS, np.int32))
    jfill = jax_paged.make_paged_prefill(jcfg, chunk, lanes, TPR * BS,
                                         return_all_logits=all_logits)
    tfill = paged.make_paged_prefill(tcfg, chunk, lanes, TPR * BS,
                                     return_all_logits=all_logits)
    jl, jcache = jfill(jp, jcache, jnp.asarray(tables), jnp.asarray(toks),
                       jnp.asarray(offsets), jnp.asarray(n_valid))
    tl, tcache = tfill(tp, tcache, torch.from_numpy(tables),
                       torch.from_numpy(toks), torch.from_numpy(offsets),
                       torch.from_numpy(n_valid))
    assert tl.shape == ((lanes, chunk, 64) if all_logits else (lanes, 64))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=STEP_TOL,
                               atol=STEP_TOL)
    _compare_pools(tcache, jcache, k0, v0)


# ---- the engine ------------------------------------------------------

ENGINE_CASES = {
    # tests/test_paged.py's scenarios.
    "full-pool": dict(kw={}, engine=dict(slots=3, max_len=64, block_size=8,
                                         chunk=8, prefill_lanes=2),
                      prompts=(5, 17, 33, 9, 41), new=(6, 4, 8, 3, 5),
                      preempts=False),
    "pressure": dict(kw={}, engine=dict(slots=3, max_len=64, block_size=8,
                                        num_blocks=13, chunk=8),
                     prompts=(40, 40, 40), new=(8, 8, 8), preempts=True),
    "collected-lane": dict(kw={}, engine=dict(slots=3, max_len=64,
                                              block_size=8, num_blocks=14,
                                              chunk=16, prefill_lanes=3),
                           prompts=(48, 48, 48), new=(4, 4, 4),
                           preempts=True),
    "gqa-window": dict(kw=dict(n_kv_heads=2, attention_window=16),
                       engine=dict(slots=2, max_len=64, block_size=16,
                                   chunk=8),
                       prompts=(21, 6), new=(4, 4), preempts=False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine_tick_by_tick(case):
    """The port's PagedBatcher and the JAX one (paged kernel,
    interpreted) run the same requests in lockstep: after every tick the
    lengths, block tables and allocator agree and the accounting holds;
    at the end the greedy tokens, preemption counts and stats agree and
    the drained engines hold no block."""
    spec = ENGINE_CASES[case]
    jcfg, tcfg = _cfgs("pallas", **spec["kw"])
    jp, tp = _params(jcfg, seed=0)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in spec["prompts"]]
    jeng = jax_paged.PagedBatcher(jp, jcfg, **spec["engine"])
    teng = paged.PagedBatcher(tp, tcfg, device="cpu", **spec["engine"])
    jreqs = [jax_paged.Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, spec["new"])]
    treqs = [paged.Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, spec["new"])]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    for _ in range(1000):
        if jeng.idle and teng.idle:
            break
        jeng.tick()
        teng.tick()
        np.testing.assert_array_equal(_np(teng.cache.lengths),
                                      np.asarray(jeng.cache.lengths))
        np.testing.assert_array_equal(teng.tables, jeng.tables)
        assert teng.allocator.used_blocks == jeng.allocator.used_blocks
        teng.check_accounting()
    assert jeng.idle and teng.idle
    assert [list(map(int, r.generated)) for r in treqs] \
        == [list(map(int, r.generated)) for r in jreqs]
    assert all(r.done for r in treqs)
    assert teng.preemptions == jeng.preemptions
    assert (teng.preemptions > 0) == spec["preempts"]
    assert teng.ticks == jeng.ticks
    assert teng.stats().as_dict() | {"epoch": 0} \
        == jeng.stats().as_dict() | {"epoch": 0}
    assert teng.allocator.used_blocks == 0 and (teng.tables == -1).all()


# ---- the decode step's token writes ----------------------------------

#: A small dropless MoE (as tests/test_torch_mellum.py builds one):
#: SwiGLU experts on grouped products, every token to its 2 of 4.
DROPLESS = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=None)


def _jax_token_writes(k_pool, v_pool, k, v, tables, positions, active):
    """The JAX package's dropping scatter of one layer's new k/v, on
    copies of the pools: (k_pool, v_pool) as numpy."""
    idx = [jnp.asarray(_np(t)) for t in (tables, positions, active)]
    return tuple(np.asarray(jax_paged._scatter_token(
        jnp.asarray(_np(pool)), jnp.asarray(_np(new)), *idx))
        for pool, new in ((k_pool, k), (v_pool, v)))


@pytest.mark.parametrize("kw", [{}, DROPLESS], ids=["dense", "dropless"])
@pytest.mark.parametrize("case", ["full-pool", "pressure"])
def test_decode_step_writes_match_jax_scatter(monkeypatch, case, kw):
    """Every layer's token write in an engine run's decode steps, as the
    one-device step makes it (``paged._scatter_token``: every slot
    through ``paged_token_write``, on the CPU its plain version), equals
    the JAX package's dropping scatter (``mode="drop"``) of the same
    k/v, tables, positions and mask on the same pools, bit for bit.
    The runs hold inactive rows (slots mid-prefill), released slots
    (tables all -1), writes crossing into a new block and, under pool
    pressure, preemptions."""
    spec = ENGINE_CASES[case]
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32, **kw)
    params = model.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    eng = paged.PagedBatcher(params, cfg, device="cpu", **spec["engine"])
    write, seen, calls = paged._scatter_token, set(), []

    def checked(k_pool, v_pool, k, v, tables, positions, active):
        want = _jax_token_writes(k_pool, v_pool, k, v, tables, positions,
                                 active)
        before = k_pool.clone()
        write(k_pool, v_pool, k, v, tables, positions, active)
        np.testing.assert_array_equal(_np(k_pool), want[0])
        np.testing.assert_array_equal(_np(v_pool), want[1])
        calls.append(int((k_pool != before).any(-1).sum()))
        seen.update(
            name for name, hit in (
                ("inactive", bool((~active & (tables >= 0).any(1)).any())),
                ("released", bool((tables < 0).all(1).any())),
                ("block edge", bool((positions[active] % eng.block_size
                                     == 0).any())))
            if hit)

    monkeypatch.setattr(paged, "_scatter_token", checked)
    rng = np.random.default_rng(9)
    reqs = [paged.Request(prompt=rng.integers(0, 64, (n,)).astype(np.int32),
                          max_new_tokens=m)
            for n, m in zip(spec["prompts"], spec["new"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert len(calls) == eng.decode_steps * cfg.n_layers > 0
    assert sum(calls) > 0
    assert seen == {"inactive", "released", "block edge"}
    assert (eng.preemptions > 0) == spec["preempts"]
    assert eng.decode_eager_steps == eng.decode_steps
    assert eng.decode_graph_replays == eng.decode_graph_captures == 0


#: One row each that must not write, against rows that must: (row,
#: what is done to it) on 4 rows of 3 entries over a pool of 16 blocks
#: of 4; every other row writes.
EDGE_ROWS = {
    "inactive": (1, "inactive"),
    "dead entry": (2, "dead"),
    "past the pool": (0, "past the pool"),
    "past the table": (3, "past the table"),
}


@pytest.mark.parametrize("case", list(EDGE_ROWS))
def test_token_write_matches_jax_scatter_at_the_edges(case):
    """``paged_token_write`` (on the CPU its plain version) against the
    JAX package's dropping scatter: an inactive row, a row whose entry
    is -1 and one whose entry is past the pool write nothing; a row
    whose position lies past its table writes into its last entry, as
    the JAX package's clipped index does."""
    g = torch.Generator().manual_seed(5)
    nb, hkv, bs, hd, slots, tpr = 16, 2, 4, 3, 4, 3
    pools = torch.randn((2, nb, hkv, bs, hd), generator=g)
    tables = torch.randperm(nb, generator=g)[:slots * tpr].reshape(
        slots, tpr).to(torch.int32)
    positions = torch.tensor([5, 2, 8, 11], dtype=torch.int32)
    active = torch.ones(slots, dtype=torch.bool)
    new = torch.randn((2, slots, hkv, 1, hd), generator=g)
    row, what = EDGE_ROWS[case]
    at = int(positions[row]) // bs
    if what == "inactive":
        active[row] = False
    elif what == "dead":
        tables[row, at] = -1
    elif what == "past the pool":
        tables[row, at] = nb + 3
    else:
        positions[row] = tpr * bs + 1
    want = _jax_token_writes(pools[0], pools[1], new[0], new[1], tables,
                             positions, active)
    got = pools.clone()
    attention.paged_token_write(got[0], got[1], new[0], new[1], tables,
                                positions, active)
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1]), want[1])
    written = int((got[0] != pools[0]).any(-1).any(1).sum())
    assert written == (slots if what == "past the table" else slots - 1)
    if what == "past the table":
        last = int(tables[row, -1])
        assert torch.equal(got[0, last, :, 1], new[0, row, :, 0])


@pytest.mark.parametrize("capacity", [64, 10])
def test_device_counter_add_rows_equals_repeated_add(capacity):
    """add_rows of [n, width] keeps and drops what n calls of add would,
    in order, past the counter's capacity too."""
    rows = torch.arange(4 * 3 * 5, dtype=torch.int32).reshape(4, 3, 5)
    one, many = DeviceCounter(), DeviceCounter()
    one.capacity = many.capacity = capacity
    for block in rows:
        for row in block:
            one.add(row)
        many.add_rows(block)
    assert many.read() == one.read() and many.rows == one.rows
    assert many.dropped == one.dropped == max(0, 12 - capacity)


def test_paged_engine_tokens_equal_linear_engine():
    """At a pool that forces preemption, the paged engine's greedy
    tokens equal the linear engine's (a preempted request re-prefills
    from scratch)."""
    _, tcfg = _cfgs()
    tp = model.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (40, 40, 40)]
    out = []
    for eng in (serving.ContinuousBatcher(tp, tcfg, slots=3, max_len=64,
                                          chunk=8, device="cpu"),
                paged.PagedBatcher(tp, tcfg, slots=3, max_len=64,
                                   block_size=8, num_blocks=13, chunk=8,
                                   device="cpu")):
        reqs = [serving.Request(prompt=p, max_new_tokens=8) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.append([r.generated for r in reqs])
    assert eng.preemptions > 0
    assert out[1] == out[0]


def test_batched_prefill_seeds_a_burst_in_one_tick():
    """Four one-chunk prompts on four lanes all seed generation on the
    first tick (the linear engine prefills one chunk per tick)."""
    _, tcfg = _cfgs()
    tp = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    eng = paged.PagedBatcher(tp, tcfg, slots=4, max_len=64, block_size=8,
                             chunk=8, prefill_lanes=4, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [serving.Request(prompt=rng.integers(0, 64, (6,)).astype(
        np.int32), max_new_tokens=3) for _ in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    assert [s.seeded for s in eng._slots] == [True] * 4
    assert [len(r.generated) for r in reqs] == [2] * 4   # seed + 1 decode
    eng.run()
    assert all(r.done for r in reqs)
    assert len({r.request_id for r in reqs}) == 4


def test_paged_engine_refusals():
    _, tcfg = _cfgs()
    tp = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        paged.PagedBatcher(tp, tcfg, max_len=60, block_size=8, device="cpu")
    eng = paged.PagedBatcher(tp, tcfg, slots=2, max_len=64, block_size=8,
                             num_blocks=4, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="never be scheduled"):
        eng.submit(serving.Request(prompt=np.arange(40, dtype=np.int32),
                                   max_new_tokens=8))
    moe = dataclasses.replace(tcfg, moe_experts=4, dtype=torch.bfloat16)
    eng = paged.PagedBatcher(
        model.init_params(torch.Generator().manual_seed(0), moe, "cpu"),
        moe, device="cpu")
    assert eng.params["blocks"]["router"].dtype == torch.float32
    assert eng.params["blocks"]["w1"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paged.PagedBatcher(tp, tcfg)


# ---- the CLI ---------------------------------------------------------

def _checkpoint(tmp_path):
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(vocab=64, d_model=32,
                                                 n_layers=2, seq_len=16),
                               "cpu")
    model.save_params(str(tmp_path / "ckpt"), 1, params)
    return ["--checkpoint-dir", str(tmp_path / "ckpt"), "--vocab", "64",
            "--d-model", "32", "--n-layers", "2", "--seq-len", "16",
            "--platform", "cpu", "--annotations-file",
            str(tmp_path / "none")]


def test_serve_cli_paged_serves_every_request(tmp_path):
    """Six random requests through a 5-block pool: preemptions happen,
    and the receipt still shows every request served."""
    res = CliRunner().invoke(serve.main, _checkpoint(tmp_path) + [
        "--random", "6", "--slots", "2", "--max-len", "64", "--chunk", "8",
        "--paged", "--block-size", "8", "--num-blocks", "5",
        "--max-new-tokens", "30"])
    assert res.exit_code == 0, res.output
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 7
    assert all(json.loads(line)["done"] for line in lines[:-1])
    receipt = DrainReceipt.parse_line(lines[-1])
    assert receipt.served == 6 and receipt.unserved == 0
    assert receipt.stats["preempted_total"] > 0
    assert receipt.stats["kv_capacity"] == 5 * 8


@pytest.mark.parametrize("flags,message", [
    (["--paged", "--ring", "--attention-window", "16"], "pick one"),
    (["--paged", "--chunk", "32", "--block-size", "8", "--num-blocks",
      "3"], "cannot hold even one"),
    (["--paged", "--block-size", "24"], "multiple of --block-size"),
])
def test_serve_cli_paged_usage_errors(tmp_path, flags, message):
    res = CliRunner().invoke(serve.main, _checkpoint(tmp_path) + [
        "--random", "2", "--max-len", "64", "--chunk", "8"] + flags)
    assert res.exit_code == 2
    assert message in res.output
