"""The port's serving path against the JAX package's, on the CPU.

The same weights (JAX ``init_params``, carried across with
``params_from_jax``) and the same numpy-made inputs go through both
packages in f32.  Block pieces agree within 2e-5; decode-step and
prefill-chunk logits and caches within 2e-4 (the JAX package's own
cached-vs-teacher-forced tolerance); the engines' greedy tokens agree
exactly.  The JAX engine runs with ``attention="pallas"`` (interpreted
off-TPU) and with ``"einsum"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.serving.drain import (  # noqa: E402
    DrainReceipt as JaxDrainReceipt,
)
from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler_torch.serving.drain import DrainReceipt  # noqa: E402
from tpu_autoscaler_torch.workloads import decode, model, serving  # noqa: E402
from tpu_autoscaler_torch.workloads.checkpoint import (  # noqa: E402
    CHECKPOINT_ANNOTATION,
    DrainWatcher,
    latest_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=64)


def _cfgs(**kw):
    """The same config in both packages, f32."""
    return (jax_model.ModelConfig(**ARCH, dtype=jnp.float32, **kw),
            model.ModelConfig(**ARCH, dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, model.params_from_jax(tree, "cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_params_from_jax_and_checkpoint_round_trip(tmp_path):
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jp, tp = _params(jcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 9
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    assert tp["blocks"]["qkv"].shape == (2, 32, 32 + 2 * 2 * 8)
    model.save_params(str(tmp_path), 3, tp)
    model.save_params(str(tmp_path), 7, tp)
    (tmp_path / "step_9.tmp").mkdir()          # an interrupted save
    assert latest_step(str(tmp_path)) == 7
    back = model.load_params(str(tmp_path), 7, "cpu")
    for name in ("embed", "ln_f", "unembed"):
        assert torch.equal(back[name], tp[name])
    for name, w in tp["blocks"].items():
        assert torch.equal(back["blocks"][name], w)
    # The port's own init has the JAX layout.
    mine = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert jax.tree.map(np.shape, jp) == {
        k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
            if isinstance(v, dict) else tuple(v.shape))
        for k, v in mine.items()}


def test_block_pieces_match_jax():
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    gain = rng.standard_normal(32).astype(np.float32)
    _close(model._rmsnorm(torch.from_numpy(x), torch.from_numpy(gain)),
           jax_model._rmsnorm(jnp.asarray(x), jnp.asarray(gain)), 2e-5)
    layer_j = jax.tree.map(lambda w: w[1], jp["blocks"])
    layer_t = {k: w[1] for k, w in tp["blocks"].items()}
    for got, want in zip(
            model._split_qkv(torch.from_numpy(x), layer_t["qkv"], tcfg),
            jax_model._split_qkv(jnp.asarray(x), layer_j["qkv"], jcfg)):
        _close(got, want, 2e-5)
    y = rng.standard_normal((3, 5, 32)).astype(np.float32)
    _close(model._ffn_residual(torch.from_numpy(x), torch.from_numpy(y),
                               layer_t, tcfg),
           jax_model._ffn_residual(jnp.asarray(x), jnp.asarray(y),
                                   layer_j, jcfg), 2e-5)
    qh = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    pos = np.array([0, 7, 300], np.int32)
    qh_t = torch.from_numpy(qh)
    _close(serving._rope_rows(qh_t, 10000.0, torch.from_numpy(pos)),
           jax_serving._rope_rows(jnp.asarray(qh), 10000.0,
                                  jnp.asarray(pos)), 2e-5)
    _close(model._rope(qh_t, 10000.0, torch.tensor(41, dtype=torch.int32)),
           jax_model._rope(jnp.asarray(qh), 10000.0, jnp.int32(41)), 2e-5)


def _compare_cache(tcache, jcache, tol=2e-4):
    _close(tcache.k, jcache.k, tol)
    _close(tcache.v, jcache.v, tol)
    np.testing.assert_array_equal(_np(tcache.lengths),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("ring,impl", [(False, "pallas"), (False, "einsum"),
                                       (True, "pallas"), (True, "einsum")])
def test_prefill_chunk_and_decode_step_match_jax(ring, impl):
    """Chunks at offset 0 and > 0 (wrapping the ring), then two batched
    decode steps with one slot inactive."""
    window = 16 if ring else None
    jcfg, tcfg = _cfgs(n_kv_heads=2, attention_window=window)
    jcfg = dataclasses.replace(jcfg, attention=impl)
    jp, tp = _params(jcfg, seed=3)
    slots, chunk = 3, 8
    width = 16 + chunk if ring else 48
    jcache = jax_serving.SlotKVCache.zeros(jcfg, slots, width)
    tcache = serving.SlotKVCache.zeros(tcfg, slots, width, "cpu")
    jfill = jax_serving.make_prefill_chunk(jcfg, chunk, ring=ring)
    tfill = serving.make_prefill_chunk(tcfg, chunk, ring=ring)
    rng = np.random.default_rng(4)
    fills = [(0, 8), (0, 8), (0, 8), (0, 5), (2, 3)]
    for slot, n_valid in fills:
        toks = np.zeros(chunk, np.int32)
        toks[:n_valid] = rng.integers(0, 64, n_valid)
        jl, jcache = jfill(jp, jcache, jnp.int32(slot), jnp.asarray(toks),
                           jnp.int32(n_valid))
        tl, tcache = tfill(tp, tcache, slot, torch.from_numpy(toks),
                           n_valid)
        _close(tl, jl, 2e-4)
    _compare_cache(tcache, jcache)
    jstep = jax_serving.make_slot_decode_step(jcfg, ring=ring)
    tstep = serving.make_slot_decode_step(tcfg, ring=ring)
    active = np.array([True, False, True])
    for _ in range(2):
        toks = rng.integers(0, 64, slots).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks),
                           jnp.asarray(active))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks),
                           torch.from_numpy(active))
        _close(tl, jl, 2e-4)
        _compare_cache(tcache, jcache)


CHURN = ((5, 17, 33, 9, 41), (6, 4, 8, 3, 5))


@pytest.mark.parametrize("ring,impl", [(False, "pallas"), (False, "einsum"),
                                       (True, "pallas"), (True, "einsum")])
def test_engine_churn_matches_jax_engine(ring, impl):
    """5 requests of different prompt lengths through 3 slots (admit/
    evict churn): the port's greedy tokens equal the JAX engine's token
    for token.  Ring: window 16, buffer 24, sequences wrap."""
    kw = dict(n_kv_heads=2, attention_window=16) if ring else {}
    jcfg, tcfg = _cfgs(**kw)
    jcfg = dataclasses.replace(jcfg, attention=impl)
    jp, tp = _params(jcfg, seed=7 if ring else 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in CHURN[0]]
    jeng = jax_serving.ContinuousBatcher(jp, jcfg, slots=3, max_len=64,
                                         chunk=8, ring=ring)
    teng = serving.ContinuousBatcher(tp, tcfg, slots=3, max_len=64,
                                     chunk=8, ring=ring, device="cpu")
    out = []
    for eng, req_cls in ((jeng, jax_serving.Request),
                         (teng, serving.Request)):
        reqs = [req_cls(prompt=p, max_new_tokens=n)
                for p, n in zip(prompts, CHURN[1])]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        out.append([list(map(int, r.generated)) for r in reqs])
    assert out[1] == out[0]
    assert teng.ticks == jeng.ticks
    assert teng.stats().as_dict() | {"epoch": 0} \
        == jeng.stats().as_dict() | {"epoch": 0}


def test_warp_logits_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    for temp, top_k, top_p in ((0.7, 5, None), (1.3, None, 0.8),
                               (1.0, 10, 0.5), (0.5, None, 0.95)):
        got = _np(decode._warp_logits(torch.from_numpy(logits), temp,
                                      top_k, top_p))
        want = np.asarray(jax_decode._warp_logits(
            jnp.asarray(logits), temp, top_k, top_p))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        keep = ~np.isinf(want)
        np.testing.assert_allclose(got[keep], want[keep], rtol=2e-5,
                                   atol=2e-5)
    g = torch.Generator().manual_seed(0)
    row = torch.from_numpy(logits[0])
    assert int(decode._sample(row, g, 0.0, None)) == int(np.argmax(logits[0]))
    allowed = set(np.argsort(-logits[0])[:3].tolist())
    assert {int(decode._sample(row, g, 1.0, 3)) for _ in range(20)} <= allowed


def test_sampled_and_truncated_requests_batch_together():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    eng = serving.ContinuousBatcher(tp, tcfg, slots=3, max_len=64, chunk=8,
                                    device="cpu")
    prompt = np.arange(6, dtype=np.int32)
    greedy = serving.Request(prompt=prompt, max_new_tokens=5)
    hot = serving.Request(prompt=prompt, max_new_tokens=5, temperature=0.9)
    top1 = serving.Request(prompt=prompt, max_new_tokens=5,
                           temperature=2.0, top_k=1)
    for r in (greedy, hot, top1):
        eng.submit(r)
    eng.run()
    # top_k=1 sampling is greedy whatever the temperature.
    assert top1.generated == greedy.generated
    assert all(0 <= t < 64 for t in hot.generated)
    with pytest.raises(ValueError, match="temperature > 0"):
        eng.submit(serving.Request(prompt=prompt, max_new_tokens=1,
                                   top_k=3))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(serving.Request(prompt=prompt, max_new_tokens=60))


def test_drain_finishes_in_flight_and_stops_admitting():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    eng = serving.ContinuousBatcher(tp, tcfg, slots=1, max_len=64, chunk=8,
                                    device="cpu")
    annotations = {}
    watcher = DrainWatcher(lambda: annotations, min_poll_interval=0)
    first = serving.Request(prompt=np.zeros((4,), np.int32),
                            max_new_tokens=6)
    second = serving.Request(prompt=np.zeros((4,), np.int32),
                             max_new_tokens=2)
    eng.submit(first)
    eng.submit(second)
    eng.tick()
    annotations[CHECKPOINT_ANNOTATION] = "1"
    eng.run(watcher=watcher)
    assert first.done and len(first.generated) == 6
    assert not second.done and second.generated == []
    assert eng.draining


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.ContinuousBatcher(tp, tcfg, slots=1)


def test_serve_cli_receipt_parses_in_both_packages(tmp_path):
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(vocab=64, d_model=32,
                                                 n_layers=2, seq_len=16),
                               "cpu")
    model.save_params(str(tmp_path / "ckpt"), 1, params)
    cmd = [sys.executable, "-m", "tpu_autoscaler_torch.workloads.serve",
           "--checkpoint-dir", str(tmp_path / "ckpt"), "--random", "6",
           "--slots", "2", "--max-len", "64", "--chunk", "8", "--vocab",
           "64", "--d-model", "32", "--n-layers", "2", "--seq-len", "16",
           "--platform", "cpu", "--final-stats",
           str(tmp_path / "final.json"),
           "--annotations-file", str(tmp_path / "none")]
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=240)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 7
    for line in lines[:-1]:
        assert json.loads(line)["done"] is True
    mine = DrainReceipt.parse_line(lines[-1])
    theirs = JaxDrainReceipt.parse_line(lines[-1])
    assert mine.unserved == theirs.unserved == 0
    assert mine.served == theirs.served == 6
    assert mine.drained is False
    assert all(lat == w + e for lat, w, e in zip(
        mine.request_latency_ticks, mine.request_wait_ticks,
        mine.request_exec_ticks))
    assert json.loads((tmp_path / "final.json").read_text()) \
        == json.loads(lines[-1])


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    probe = textwrap.dedent("""
        import importlib, pkgutil, sys
        before = set(sys.modules)
        import tpu_autoscaler_torch
        for info in pkgutil.walk_packages(tpu_autoscaler_torch.__path__,
                                          "tpu_autoscaler_torch."):
            importlib.import_module(info.name)
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in
                     ("jax", "jaxlib", "tpu_autoscaler", "optax", "orbax"))
        mods = sorted(m for m in new
                      if m.startswith("tpu_autoscaler_torch."))
        print(" ".join(mods), "|", bad)
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    mods, bad = res.stdout.split("|")
    assert bad.strip() == "[]"
    assert set(mods.split()) >= {
        f"tpu_autoscaler_torch.{m}" for m in (
            "concurrency", "dataio", "obs.blackbox", "obs.recorder",
            "obs.trace", "serving.drain", "serving.reqtrace",
            "serving.stats", "workloads._cli",
            "workloads.attention", "workloads.checkpoint",
            "workloads.decode", "workloads.generate", "workloads.model",
            "workloads.paged", "workloads.ring_attention",
            "workloads.serve", "workloads.serving",
            "workloads.spec_serving", "workloads.sp",
            "workloads.train", "workloads.ulysses")}
