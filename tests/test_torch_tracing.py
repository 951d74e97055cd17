"""Spans inside the port's serving tick and train step, on the CPU.

The engines (``serving.ContinuousBatcher``, ``paged.PagedBatcher``,
``spec_serving.SpeculativePagedBatcher``) and the train step
(``model.make_train_step``) take a ``tracer``
(``obs.trace.Tracer``): every tick is one ``serve.tick`` tree and every
step one ``train.step`` tree, each live span a ``torch.profiler`` range
of its name on the profiler's clock; each request's first token closes
a ``serve.request.prefill`` span with its lane wait.  Without a tracer
the engines and the step give the same numbers and record nothing.
"""

from __future__ import annotations

import dataclasses
import gc
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from torch.profiler import ProfilerActivity, profile

from tpu_autoscaler_torch.obs.recorder import SpanTotals
from tpu_autoscaler_torch.obs.trace import Tracer, maybe_span
from tpu_autoscaler_torch.serving.drain import DrainReceipt
from tpu_autoscaler_torch.workloads import (
    model,
    paged,
    serve,
    serving,
    spec_serving,
)

ARCH = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
            seq_len=32)

#: Each span name's parent in a tick's tree (None: a root).
PARENT = {
    "serve.tick": None,
    "serve.admit": "serve.tick",
    "serve.prefill.plan": "serve.tick",
    "serve.prefill.step": "serve.tick",
    "serve.prefill.inputs": "serve.prefill.step",
    "serve.prefill.sample": "serve.tick",
    "serve.decode.plan": "serve.tick",
    "serve.decode.step": "serve.tick",
    "serve.decode.inputs": "serve.decode.step",
    "serve.decode.sample": "serve.tick",
    "serve.stats": "serve.tick",
    "serve.request.prefill": None,
}
#: serve.sync's parents: the two sampling phases.
SYNC_PARENTS = {"serve.prefill.sample", "serve.decode.sample"}
#: The order of a tick's children.
ORDER = ["serve.admit", "serve.prefill.plan", "serve.prefill.step",
         "serve.prefill.sample", "serve.decode.plan", "serve.decode.step",
         "serve.decode.sample", "serve.stats"]
STEPS = ("serve.prefill.step", "serve.decode.step")


class Spans(list):
    """A tracer sink keeping every span it is handed."""

    def record_span(self, span):
        self.append(span)


@pytest.fixture(scope="module")
def tiny():
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    return cfg, model.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")


def _engine(kind, tiny, tracer=None, **kw):
    cfg, params = tiny
    kw = dict(dict(slots=3, max_len=32, chunk=8, device="cpu"), **kw)
    if kind == "linear":
        return serving.ContinuousBatcher(params, cfg, tracer=tracer, **kw)
    kw = dict(kw, block_size=8)
    if kind == "paged":
        return paged.PagedBatcher(params, cfg, tracer=tracer, **kw)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    draft = {**params, "blocks": {n: w[:1] for n, w in
                                  params["blocks"].items()}}
    return spec_serving.SpeculativePagedBatcher(params, cfg, draft, dcfg,
                                                k=2, tracer=tracer, **kw)


def _serve(eng, lengths=(5, 11, 19, 3), new=6):
    """Submit greedy requests of the prompt ``lengths`` and tick until
    all are served; (generated tokens, ticks run)."""
    rng = np.random.default_rng(7)
    reqs = [serving.Request(prompt=rng.integers(0, 32, (n,)).astype(
        np.int32), max_new_tokens=new) for n in lengths]
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while not eng.idle:
        eng.tick()
        ticks += 1
    assert all(r.done for r in reqs)
    return [list(map(int, r.generated)) for r in reqs], ticks


def _by_id(spans):
    return {s.span_id: s for s in spans}


@pytest.mark.parametrize("kind", ["linear", "paged"])
def test_every_tick_is_one_span_tree(tiny, kind):
    """One ``serve.tick`` per ``tick()``; every span under its parent
    of the documented tree, inside the parent's interval, the tick's
    children in phase order; the paged engine opens every name."""
    spans = Spans()
    eng = _engine(kind, tiny, Tracer(recorder=spans))
    _, ticks = _serve(eng)
    ids = _by_id(spans)
    roots = [s for s in spans if s.name == "serve.tick"]
    assert len(roots) == ticks == eng.ticks
    assert [r.attrs["tick"] for r in roots] == list(range(1, ticks + 1))
    for s in spans:
        assert s.end is not None and s.end >= s.start
        parent = ids.get(s.parent_id)
        if s.name == "serve.sync":
            assert parent.name in SYNC_PARENTS
        else:
            assert (parent and parent.name) == PARENT[s.name], s.name
        if parent is not None:
            assert parent.start <= s.start <= s.end <= parent.end
    for root in roots:
        kids = sorted((s for s in spans if s.parent_id == root.span_id),
                      key=lambda s: s.start)
        names = [k.name for k in kids]
        assert names == sorted(names, key=ORDER.index)
        assert names[0] == "serve.admit" and names[-1] == "serve.stats"
    seen = {s.name for s in spans}
    if kind == "paged":
        assert seen == set(PARENT) | {"serve.sync"}
    else:
        assert seen == (set(PARENT) | {"serve.sync"}) - {
            "serve.prefill.inputs", "serve.decode.inputs",
            "serve.decode.plan"}
    assert sum(s.name == "serve.request.prefill" for s in spans) == 4


@pytest.mark.parametrize("kind", ["linear", "paged"])
def test_tick_attrs_count_the_work(tiny, kind):
    """The tick's attrs sum to the engine's counters: decode rows to
    the decoded tokens, prefill lanes to the chunks, prompt tokens to
    the prompts."""
    spans = Spans()
    eng = _engine(kind, tiny, Tracer(recorder=spans))
    _serve(eng)
    ticks = [s.attrs for s in spans if s.name == "serve.tick"]
    assert sum(a["decode_rows"] for a in ticks) == eng.decode_tokens > 0
    assert sum(a["prefill_lanes"] for a in ticks) == eng.prefill_chunks
    assert sum(a["prompt_tokens"] for a in ticks) == eng.prefill_tokens \
        == 5 + 11 + 19 + 3
    if kind == "paged":
        assert max(a["prefill_lanes"] for a in ticks) == 2
    assert eng.prefill_chunks == 1 + 2 + 3 + 1


def test_host_launch_and_sync_split_the_tick(tiny):
    """Per tick the step calls and the syncs are disjoint spans inside
    it, so the tick's host time (the rest) is never negative and the
    three add up to the tick."""
    spans = Spans()
    _serve(_engine("paged", tiny, Tracer(recorder=spans)))
    ids = _by_id(spans)

    def tick_of(s):
        while s.name != "serve.tick":
            s = ids[s.parent_id]
        return s.span_id

    for root in (s for s in spans if s.name == "serve.tick"):
        parts = sorted(((s.start, s.end) for s in spans
                        if s.name in STEPS + ("serve.sync",)
                        and tick_of(s) == root.span_id))
        assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
        launch_sync = sum(e - s for s, e in parts)
        host = root.duration - launch_sync
        assert host >= 0
        assert host + launch_sync == pytest.approx(root.duration)


@pytest.mark.parametrize("kind", ["linear", "paged"])
def test_lane_wait_worked_by_hand(tiny, kind):
    """Three prompts of 3 chunks, one lane, a clock that reads the
    engine's tick: the first request waits for no lane, the second for
    the first's 3 ticks, the third for 6; each was admitted at once and
    seeded on its third chunk's tick."""
    spans = Spans()
    clock = {"eng": None}
    tracer = Tracer(recorder=spans,
                    clock=lambda: float(clock["eng"].ticks))
    kw = dict(prefill_lanes=1) if kind == "paged" else {}
    eng = clock["eng"] = _engine(kind, tiny, tracer, chunk=4, **kw)
    _serve(eng, lengths=(12, 12, 12), new=4)
    got = [(s.attrs["lane_wait_s"], s.attrs["queue_s"], s.attrs["chunks"],
            s.start, s.end) for s in spans
           if s.name == "serve.request.prefill"]
    assert got == [(0.0, 0.0, 3, 0.0, 3.0), (3.0, 0.0, 3, 0.0, 6.0),
                   (6.0, 0.0, 3, 0.0, 9.0)]


@pytest.mark.parametrize("kind", ["linear", "paged", "spec"])
def test_tracer_off_gives_the_same_tokens_and_records_nothing(tiny, kind):
    """The same traffic with and without a tracer: the same tokens bit
    for bit; untraced, no span and, under the profiler, no ``serve.``
    range; the speculative engine's ticks are ``serve.tick`` spans."""
    spans = Spans()
    traced, ticks = _serve(_engine(kind, tiny, Tracer(recorder=spans)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain, _ = _serve(_engine(kind, tiny))
    assert traced == plain
    assert sum(s.name == "serve.tick" for s in spans) == ticks
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("serve.")]


def test_live_spans_are_profiler_ranges_on_its_clock(tiny):
    """Under ``torch.profiler`` (CPU) every live span is a range of its
    name, nested as the spans are, on the same clock with no offset:
    each range lies inside its span's interval (entered after the stamp,
    exited before the end's), and starts within 100 us of the span;
    the retroactive ``serve.request.prefill`` spans open none."""
    spans = Spans()
    eng = _engine("paged", tiny, Tracer(recorder=spans))
    eng.tick()                       # the profiler sees warm seams
    before = len(spans)
    # A collection of the test process's heap between a span's stamp
    # and its range's (tens of ms) is not the clock's doing.
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # The session's first event on a thread pays the profiler's
            # own set-up (~0.3 ms here) before its stamp; the benchmark's
            # window range takes it, as this one does.
            with torch.profiler.record_function("window"):
                _serve(eng)
    finally:
        gc.enable()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in
                    prof.profiler.kineto_results.events()
                    if e.name().startswith("serve."))
    live = sorted((s for s in spans[before:]
                   if s.name != "serve.request.prefill"),
                  key=lambda s: s.start)
    assert [r[2] for r in ranges] == [s.name for s in live]
    ids = _by_id(spans)
    where = {s.span_id: r for s, r in zip(live, ranges)}
    lags = []
    for s, (r0, r1, _) in zip(live, ranges):
        # 1 us of room for the float seconds' rounding.
        assert s.start * 1e9 - 1e3 <= r0 <= r1 <= s.end * 1e9 + 1e3
        lags.append(r0 - s.start * 1e9)
        if s.parent_id in where:
            p0, p1, _ = where[s.parent_id]
            assert p0 <= r0 <= r1 <= p1
        else:
            assert ids.get(s.parent_id) is None
    # The lag is the range's entry; a busy host stretches a few.
    assert np.median(lags) < 100e3
    assert np.mean(np.asarray(lags) < 100e3) >= 0.9, sorted(lags)[-5:]


def test_retroactive_spans_open_no_range_and_errors_close_theirs():
    """``record`` and ``start(t=...)`` open no profiler range; a live
    span that raises still ends, and its range with it."""
    spans = Spans()
    tracer = Tracer(recorder=spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.record("old", start=1.0, end=2.0)
        tracer.end(tracer.start("given", t=3.0), t=4.0)
        with pytest.raises(ValueError):
            with maybe_span(tracer, "boom"):
                raise ValueError("x")
        with maybe_span(tracer, "after"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name() in ("old", "given", "boom", "after")]
    assert names == ["boom", "after"]
    assert [s.name for s in spans] == ["old", "given", "boom", "after"]
    assert spans[2].attrs["error"] == "ValueError: x"
    assert tracer.active_spans() == []


def test_maybe_span_without_a_tracer_is_one_shared_null_context():
    a, b = maybe_span(None, "a"), maybe_span(None, "b", {"k": 1})
    assert a is b
    with a as span:
        assert span is None


@pytest.mark.parametrize("has_aux", [False, True])
def test_train_step_spans_and_same_numbers(tiny, has_aux):
    """A traced step records ``train.step`` over one forward, backward
    and update, in that order and inside it; its params, state and loss
    equal the untraced step's bit for bit."""
    cfg, _ = tiny
    tokens = torch.randint(0, 32, (2, 9), generator=torch.Generator()
                           .manual_seed(1))
    opt = model.make_optimizer(model.TrainConfig())

    def loss_of(tree, toks):
        loss = model.loss_fn(tree, toks, cfg)
        return (loss, {"twice": 2 * loss}) if has_aux else loss

    out = []
    for tracer in (Tracer(recorder=Spans()), None):
        init_fn, step_fn = model._make_step(cfg, opt, torch.device("cpu"),
                                            loss_of, has_aux, tracer=tracer)
        params, state = init_fn(torch.Generator().manual_seed(0))
        out.append(step_fn(params, state, tokens))
        if tracer is not None:
            spans = tracer.recorder
    (p1, s1, l1, *_), (p0, s0, l0, *_) = out
    assert torch.equal(l1, l0)
    for a, b in zip(model._flatten(p1), model._flatten(p0)):
        assert torch.equal(a[1], b[1])
    for a, b in zip(model._flatten(s1["mu"]), model._flatten(s0["mu"])):
        assert torch.equal(a[1], b[1])
    names = [s.name for s in sorted(spans, key=lambda s: s.start)]
    assert names == ["train.step", "train.forward", "train.backward",
                     "train.update"]
    step = next(s for s in spans if s.name == "train.step")
    for s in spans:
        if s is not step:
            assert s.parent_id == step.span_id
            assert step.start <= s.start <= s.end <= step.end


def test_make_train_step_threads_the_tracer(tiny):
    cfg, _ = tiny
    spans = Spans()
    init_fn, step_fn = model.make_train_step(cfg, device="cpu",
                                             tracer=Tracer(recorder=spans))
    params, state = init_fn(torch.Generator().manual_seed(0))
    for _ in range(2):
        params, state, loss = step_fn(params, state, torch.zeros(
            (2, 9), dtype=torch.int64))
    assert [s.name for s in spans].count("train.backward") == 2
    assert loss.dim() == 0


def test_span_totals_count_sum_and_take_the_p95_of_the_last():
    totals = SpanTotals(keep=4)
    tracer = Tracer(recorder=totals)
    for i, took in enumerate([9.0, 1.0, 2.0, 3.0, 4.0]):
        tracer.record("a", start=10.0 * i, end=10.0 * i + took)
    tracer.record("b", start=0.0, end=0.5)
    got = totals.summary()
    assert list(got) == ["a", "b"]
    assert got["a"]["count"] == 5 and got["a"]["total_s"] == 19.0
    assert got["a"]["p95_ms"] == pytest.approx(
        1e3 * np.percentile([1.0, 2.0, 3.0, 4.0], 95))
    assert got["b"] == {"count": 1, "total_s": 0.5, "p95_ms": 500.0}


def test_serve_cli_trace_sample_reports_span_totals(tmp_path):
    """``serve --trace-sample`` also traces the engine: the receipt's
    ``trace`` carries each span name's count, total seconds and p95."""
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(vocab=64, d_model=32,
                                                 n_layers=2, seq_len=16),
                               "cpu")
    model.save_params(str(tmp_path / "ckpt"), 1, params)
    res = CliRunner().invoke(serve.main, [
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--vocab", "64",
        "--d-model", "32", "--n-layers", "2", "--seq-len", "16",
        "--platform", "cpu", "--annotations-file", str(tmp_path / "none"),
        "--random", "5", "--slots", "2", "--max-len", "64", "--chunk", "8",
        "--paged", "--block-size", "8", "--max-new-tokens", "12",
        "--trace-sample", "0.5"])
    assert res.exit_code == 0, res.output
    last = res.stdout.strip().splitlines()[-1]
    receipt = DrainReceipt.parse_line(last)
    spans = json.loads(last)["trace"]["spans"]
    assert spans["serve.tick"]["count"] == receipt.ticks
    assert spans["serve.request.prefill"]["count"] == receipt.served == 5
    assert spans["serve.decode.step"]["count"] >= 11
    for name, row in spans.items():
        assert set(row) == {"count", "total_s", "p95_ms"}
        assert row["total_s"] >= 0 and row["p95_ms"] >= 0, name
    assert spans["serve.tick"]["total_s"] >= \
        spans["serve.decode.step"]["total_s"]
