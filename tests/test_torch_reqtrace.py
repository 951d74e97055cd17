"""Request tracing in the port against the JAX package's, on the CPU.

``tpu_autoscaler_torch/serving/reqtrace.py`` and the modules it builds
on (``obs/trace.py``, ``obs/recorder.py``, ``concurrency.py``) are
copies of the JAX package's.  The sampler's own
contract is tested here against the copy, as ``tests/test_reqtrace.py``
tests the original; the same event scripts then go through both
samplers, and the port's engines and the JAX engines serve the same
traffic with ``sample_rate=1.0``: their span trees (names, order,
parents, tick times, attributes) and counters agree exactly, ids aside.
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

from tpu_autoscaler.serving import reqtrace as jax_reqtrace  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import paged as jax_paged  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler.workloads import spec_serving as jax_spec  # noqa: E402
from tpu_autoscaler_torch.obs.recorder import trace_gaps  # noqa: E402
from tpu_autoscaler_torch.serving import reqtrace  # noqa: E402
from tpu_autoscaler_torch.serving.drain import DrainReceipt  # noqa: E402
from tpu_autoscaler_torch.serving.reqtrace import (  # noqa: E402
    RequestTraceSampler,
    head_sampled,
)
from tpu_autoscaler_torch.serving.stats import (  # noqa: E402
    ServingStatsRecorder,
)
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    model,
    paged,
    serve,
    serving,
    spec_serving,
)


def _root(dump):
    return next(sp for sp in dump["spans"] if sp["name"] == "request")


def _spans(dump):
    """A dump's spans without ids or recording counters: name, trace,
    parent's name, tick times, attributes, events, in recording order."""
    by_id = {sp["span_id"]: sp["name"] for sp in dump["spans"]}
    return [(sp["name"], sp["trace_id"], by_id.get(sp["parent_id"]),
             sp["start"], sp["end"], sp["duration_s"], sp["attrs"],
             sp["events"]) for sp in dump["spans"]]


# ---- the sampler (tests/test_reqtrace.py's cases, against the copy) ------

def test_head_sampling_is_deterministic_and_rate_shaped():
    ids = [f"r{i}" for i in range(20_000)]
    picked = [rid for rid in ids if head_sampled(rid, 0.01)]
    assert picked == [rid for rid in ids if head_sampled(rid, 0.01)]
    assert picked == [rid for rid in ids
                      if jax_reqtrace.head_sampled(rid, 0.01)]
    assert 0.003 < len(picked) / len(ids) < 0.03
    assert not any(head_sampled(r, 0.0) for r in ids[:100])
    assert all(head_sampled(r, 1.0) for r in ids[:100])


def test_unsampled_fast_request_leaves_nothing():
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=100)
    s.note_submit("r1", 0)
    s.note_admit("r1", 1)
    s.note_seeded("r1", 2)
    assert s.note_finish("r1", 5) is None
    assert s.sampled_total == 0 and s.pending == 0
    assert s.dump()["spans"] == []


def test_slo_miss_is_tail_captured_and_gap_free():
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=4)
    s.note_submit("r1", 0)
    s.note_admit("r1", 3)
    s.note_seeded("r1", 4)
    tid = s.note_finish("r1", 9, tokens=5)
    assert tid == "request-rep-r1"
    dump = s.dump()
    assert trace_gaps(dump, tid) == []
    root = _root(dump)
    assert root["attrs"]["slo_miss"] is True
    assert root["attrs"]["sampled"] == "tail"
    assert {"queue_wait", "prefill", "decode"} <= {
        sp["name"] for sp in dump["spans"]}
    assert s.tail_captured_total == 1


def test_preempted_request_is_captured_with_requeue_span():
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=10_000)
    s.note_submit("r1", 0)
    s.note_admit("r1", 1)
    s.note_seeded("r1", 2)
    s.note_preempt("r1", 5)
    s.note_admit("r1", 8)
    s.note_seeded("r1", 9)
    tid = s.note_finish("r1", 12)
    dump = s.dump()
    assert trace_gaps(dump, tid) == []
    requeue = [sp for sp in dump["spans"] if sp["name"] == "preempt_requeue"]
    assert [(sp["start"], sp["end"]) for sp in requeue] == [(5, 8)]
    assert sum(sp["name"] == "decode" for sp in dump["spans"]) == 2


def test_drain_lost_and_forwarded_requests():
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=None)
    s.note_submit("r9", 0)
    tid = s.note_drain_lost("r9", 7)
    dump = s.dump()
    assert trace_gaps(dump, tid) == []
    assert _root(dump)["attrs"]["lost"] is True
    assert any(sp["name"] == "drain_handoff" for sp in dump["spans"])
    f = RequestTraceSampler("rep", sample_rate=1.0)
    f.note_submit("r1", 0)
    f.note_forward("r1")
    assert f.pending == 0 and f.rerouted_total == 1
    assert f.dump()["spans"] == []


def test_note_cohort_fast_path_and_promotion():
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=10.0)
    assert s.note_cohort("c1", arrival=0.0, finish=5.0, n=7,
                         exec_time=2.0) is None
    tid = s.note_cohort("c1", arrival=0.0, finish=30.0, n=3, exec_time=2.0)
    dump = s.dump()
    assert trace_gaps(dump, tid) == []
    assert _root(dump)["attrs"]["n"] == 3
    qw = next(sp for sp in dump["spans"] if sp["name"] == "queue_wait")
    assert qw["end"] - qw["start"] == pytest.approx(28.0)


def test_exemplar_and_counters_mirror_into_stats():
    rec = ServingStatsRecorder(slots=4, slo_ticks=4)
    s = RequestTraceSampler("rep", sample_rate=0.0, slo_ticks=4, stats=rec)
    s.note_submit("r1", 0)
    s.note_admit("r1", 1)
    s.note_seeded("r1", 2)
    tid = s.note_finish("r1", 9)
    snap = rec.snapshot()
    assert (snap.exemplar_trace_id, snap.exemplar_value,
            snap.exemplar_seq) == (tid, 9.0, 1)
    assert snap.trace_sampled_total == snap.trace_tail_total == 1


def test_bounds_pending_events_and_ring():
    rec = ServingStatsRecorder(slots=1)
    s = RequestTraceSampler("rep", sample_rate=1.0, max_pending=8, stats=rec)
    for i in range(50):
        s.note_submit(f"r{i}", i)
    assert s.pending == 8 and s.dropped_total == 42
    assert rec.snapshot().trace_dropped_total == 42
    assert s.note_finish("r49", 100) is not None
    t = RequestTraceSampler("rep", sample_rate=1.0, max_events=6)
    t.note_submit("r1", 0)
    for i in range(1, 30):
        t.note_preempt("r1", i)
    tid = t.note_finish("r1", 40)
    dump = t.dump()
    assert _root(dump)["attrs"]["truncated"] is True
    assert trace_gaps(dump, tid) == []
    r = RequestTraceSampler("rep", sample_rate=1.0, max_traces=4)
    for i in range(40):
        r.note_cohort(f"c{i}", arrival=0.0, finish=1.0)
    assert r.sampled_total == 40 and len(r.dump()["spans"]) <= 4 * 8


SCRIPT = [  # (hook, rid, tick[, kwargs]): two requests, one preempted
    ("note_submit", "r1", 0), ("note_submit", "r2", 0),
    ("note_admit", "r1", 1), ("note_seeded", "r1", 2),
    ("note_admit", "r2", 2), ("note_preempt", "r2", 4),
    ("note_finish", "r1", 6, dict(tokens=5, attrs={"accept_rate": 0.5})),
    ("note_admit", "r2", 7), ("note_seeded", "r2", 9),
    ("note_finish", "r2", 14, dict(tokens=3)),
    ("note_submit", "r3", 15), ("note_drain_lost", "r3", 16),
]


@pytest.mark.parametrize("rate,slo", [(1.0, None), (0.0, 5), (0.5, 8)])
def test_copy_emits_what_the_jax_sampler_emits(rate, slo):
    """One event script through both samplers, each wired to its own
    package's stats recorder: the same spans, counters and snapshot."""
    out = []
    for mod, stats_mod in ((reqtrace, ServingStatsRecorder),
                           (jax_reqtrace, None)):
        if stats_mod is None:
            from tpu_autoscaler.serving.stats import ServingStatsRecorder \
                as stats_mod
        rec = stats_mod(slots=2, slo_ticks=slo)
        s = mod.RequestTraceSampler("rep", sample_rate=rate, slo_ticks=slo,
                                    stats=rec)
        for hook, rid, tick, *kw in SCRIPT:
            getattr(s, hook)(rid, tick, **(kw[0] if kw else {}))
        out.append((_spans(s.dump()), s.debug_state(),
                    rec.snapshot().as_dict() | {"epoch": 0}))
    assert out[0] == out[1]
    assert out[0][1]["sampled_total"] > 0


# ---- the engines' hooks against the JAX engines ---------------------------

ARCH = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
            seq_len=32)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_model.ModelConfig(**ARCH, dtype=jnp.float32)
    tcfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


class _DrainAfter:
    """A drain watcher that asks for the slice back after ``n`` polls."""

    def __init__(self, n):
        self.n = n

    def drain_requested(self):
        self.n -= 1
        return self.n < 0


SLO_TICKS = 6


def _engines(case, models):
    """(JAX engine, port engine) for ``case``, each with its own
    package's sampler at rate 1.0."""
    jcfg, tcfg, jp, tp = models
    samplers = [mod.RequestTraceSampler("eng", sample_rate=1.0,
                                        slo_ticks=SLO_TICKS)
                for mod in (jax_reqtrace, reqtrace)]
    jkw = dict(slo_ticks=SLO_TICKS, reqtrace=samplers[0])
    tkw = dict(slo_ticks=SLO_TICKS, reqtrace=samplers[1], device="cpu")
    if case in ("continuous", "drain-handoff"):
        kw = dict(slots=1 if case == "drain-handoff" else 2, max_len=32,
                  chunk=8)
        return (jax_serving.ContinuousBatcher(jp, jcfg, **kw, **jkw),
                serving.ContinuousBatcher(tp, tcfg, **kw, **tkw))
    kw = dict(slots=2, max_len=32, block_size=8, chunk=8)
    jkw, tkw = dict(jkw, **kw), dict(tkw, **kw)
    if case == "paged-preemption":
        return (jax_paged.PagedBatcher(jp, jcfg, num_blocks=5, **jkw),
                paged.PagedBatcher(tp, tcfg, num_blocks=5, **tkw))
    jd = dataclasses.replace(jcfg, n_layers=1)
    td = dataclasses.replace(tcfg, n_layers=1)
    return (jax_spec.SpeculativePagedBatcher(
                jp, jcfg, {**jp, "blocks": jax.tree.map(
                    lambda x: x[:1], jp["blocks"])}, jd, k=2, **jkw),
            spec_serving.SpeculativePagedBatcher(
                tp, tcfg, {**tp, "blocks": {n: w[:1] for n, w in
                                            tp["blocks"].items()}},
                td, k=2, **tkw))


TRAFFIC = {
    "continuous": ((3, 5, 2, 9), 3),
    "paged-preemption": ((20, 20, 20), 6),
    "spec-economics": ((4, 11, 6), 6),
    "drain-handoff": ((3, 3, 3), 2),
}


@pytest.mark.parametrize("case", list(TRAFFIC))
def test_engine_traces_match_jax(models, case):
    """The port's engine and the JAX engine, each with its own sampler
    at rate 1.0, serve the same greedy traffic: every span tree (and the
    preemption, requeue and drain-handoff spans among them), the
    sampler's counters and the stats snapshot agree; each trace is gap
    free.  The spec engine's roots carry its accept economics; the
    drain case loses the queued requests and traces them as lost."""
    lengths, new = TRAFFIC[case]
    rng = np.random.default_rng(len(case))
    prompts = [rng.integers(0, 32, (n,)).astype(np.int32) for n in lengths]
    engines = _engines(case, models)
    out = []
    for eng, mod in zip(engines, (jax_serving, serving)):
        reqs = [mod.Request(prompt=p, max_new_tokens=new) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run(watcher=_DrainAfter(2) if case == "drain-handoff" else None)
        out.append((_spans(eng._reqtrace.dump()),
                    eng._reqtrace.debug_state(),
                    eng.stats().as_dict() | {"epoch": 0},
                    [list(map(int, r.generated)) for r in reqs],
                    [r.done for r in reqs]))
    assert out[1] == out[0]
    spans, state, snap, _, done = out[1]
    dump = engines[1]._reqtrace.dump()
    roots = [sp for sp in dump["spans"] if sp["name"] == "request"]
    assert len(roots) == len(prompts) == state["sampled_total"]
    for root in roots:
        assert trace_gaps(dump, root["trace_id"]) == []
    names = {sp[0] for sp in spans}
    if case == "paged-preemption":
        assert engines[1].preemptions > 0 and "preempt_requeue" in names
        assert sum(r["attrs"]["preemptions"] for r in roots) \
            == engines[1].preemptions == snap["preempted_total"]
    if case == "spec-economics":
        assert all({"accept_rate", "target_pass_ratio"} <= set(r["attrs"])
                   for r in roots)
    if case == "drain-handoff":
        lost = [r for r in roots if r["attrs"].get("lost")]
        assert lost and len(lost) == done.count(False)
        assert "drain_handoff" in names


def test_engine_links_its_stats_to_the_sampler(models):
    """A sampler passed without stats is wired to the engine's recorder,
    so promotions ride the engine's snapshot."""
    _, tcfg, _, tp = models
    sampler = RequestTraceSampler("eng", sample_rate=1.0)
    eng = paged.PagedBatcher(tp, tcfg, slots=2, max_len=32, block_size=8,
                             chunk=8, device="cpu", reqtrace=sampler)
    assert sampler.stats is eng._stats
    eng.submit(serving.Request(prompt=np.arange(5, dtype=np.int32),
                               max_new_tokens=3))
    eng.run()
    snap = eng.stats()
    assert snap.trace_sampled_total == 1
    assert snap.exemplar_trace_id == "request-eng-r1"


def test_serve_cli_trace_sample_puts_trace_in_the_receipt(tmp_path):
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(vocab=64, d_model=32,
                                                 n_layers=2, seq_len=16),
                               "cpu")
    model.save_params(str(tmp_path / "ckpt"), 1, params)
    res = CliRunner().invoke(serve.main, [
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--vocab", "64",
        "--d-model", "32", "--n-layers", "2", "--seq-len", "16",
        "--platform", "cpu", "--annotations-file", str(tmp_path / "none"),
        "--random", "6", "--slots", "2", "--max-len", "64", "--chunk", "8",
        "--paged", "--block-size", "8", "--num-blocks", "5",
        "--max-new-tokens", "30", "--trace-sample", "1.0", "--slo-ticks",
        "4"])
    assert res.exit_code == 0, res.output
    last = res.stdout.strip().splitlines()[-1]
    receipt = DrainReceipt.parse_line(last)
    assert receipt.served == 6 and receipt.unserved == 0
    trace = json.loads(last)["trace"]
    assert trace["sample_rate"] == 1.0 and trace["slo_ticks"] == 4
    assert trace["sampled_total"] == 6 and trace["pending"] == 0
    assert trace["tail_captured_total"] >= 1
