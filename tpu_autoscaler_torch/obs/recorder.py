"""Flight recorder: bounded in-memory history of completed spans and
per-pass decision records, dumpable from a LIVE process.

Why: when a production controller is stuck or slow, the
Prometheus endpoint says *that* something is wrong, not *why*.  The
recorder keeps the last N completed spans (the per-phase latency
anatomy of recent scale-ups) and the last M reconcile decision records
("why did/didn't we provision") in two lock-guarded ring buffers, and
exposes them as ``dump()``, a JSON-able copy taken under the lock
(``/debugz`` on the JAX package's metrics port serves it).

Retention is bounded by construction (``collections.deque`` maxlen):
the recorder can never grow past ``max_spans + max_passes`` entries no
matter how long the process runs — crash-only discipline applied to
introspection state.  Everything in a dump is JSON-serializable with
``allow_nan=False`` (guarded empty-summary exports; no ``inf`` leaks).
"""

from __future__ import annotations

import collections
import time
from typing import Any

import numpy as np

from tpu_autoscaler_torch import concurrency
from tpu_autoscaler_torch.obs.trace import Span

#: Ring bounds (docs/OBSERVABILITY.md).  4096 spans ≈ 500 scale-ups of
#: 8 spans each; 512 passes ≈ 40 min of 5 s-interval history.
DEFAULT_MAX_SPANS = 4096
DEFAULT_MAX_PASSES = 512


class FlightRecorder:
    """Lock-guarded ring buffers of spans + decision records.

    Writers: the reconcile thread (most spans, every pass record) and
    the informer watch threads (relist spans) — hence the lock.  The
    readers go through ``dump()``, which copies under the lock.
    """

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS,
                 max_passes: int = DEFAULT_MAX_PASSES) -> None:
        self._lock = concurrency.Lock()
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=max_spans)
        self._passes: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=max_passes)
        self._spans_recorded = 0
        self._passes_recorded = 0

    # -- writers ----------------------------------------------------------

    def record_span(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._spans_recorded += 1

    def record_pass(self, record: dict[str, Any]) -> None:
        with self._lock:
            self._passes.append(record)
            self._passes_recorded += 1

    # -- readers ----------------------------------------------------------

    def dump(self, tracer: Any = None) -> dict[str, Any]:
        """JSON-able snapshot: completed spans (recording order — causal
        within a thread), decision records, and — when the owning tracer
        is passed — still-open spans (the "what is it stuck on" view)."""
        with self._lock:
            spans = [s.as_dict() for s in self._spans]
            passes = list(self._passes)
            counts = {"spans_recorded": self._spans_recorded,
                      "passes_recorded": self._passes_recorded,
                      "spans_retained": len(spans),
                      "passes_retained": len(passes)}
        out: dict[str, Any] = {"generated_at": time.time(),
                               "counts": counts,
                               "spans": spans, "passes": passes}
        if tracer is not None:
            out["active_spans"] = [s.as_dict()
                                   for s in tracer.active_spans()]
        return out


class SpanTotals:
    """A tracer's sink that keeps, per span name, how many spans ended,
    their total seconds and the last ``keep`` durations (bounded, like
    the rings above): what ``serve --trace-sample`` reports of the
    engine's tick spans (``summary()``)."""

    def __init__(self, keep: int = DEFAULT_MAX_SPANS) -> None:
        self._lock = concurrency.Lock()
        self._keep = keep
        #: name -> [count, total seconds, recent durations]
        self._by_name: dict[str, list] = {}

    def record_span(self, span: Span) -> None:
        took = span.duration or 0.0
        with self._lock:
            entry = self._by_name.get(span.name)
            if entry is None:
                entry = self._by_name[span.name] = [
                    0, 0.0, collections.deque(maxlen=self._keep)]
            entry[0] += 1
            entry[1] += took
            entry[2].append(took)

    def summary(self) -> dict[str, dict[str, float]]:
        """Per span name: ``count``, ``total_s`` and ``p95_ms``, the 95th
        percentile of the last ``keep`` durations."""
        with self._lock:
            return {name: {"count": n, "total_s": total,
                           "p95_ms": 1e3 * float(np.percentile(recent, 95))}
                    for name, (n, total, recent) in
                    sorted(self._by_name.items())}


def trace_gaps(dump: dict[str, Any], trace_id: str) -> list[str]:
    """Completeness check for one recorded trace: the chaos
    engine's "every scale-up trace is complete" invariant, also usable
    against any ``/debugz`` / SIGUSR1 dump.

    Returns human-readable gaps (empty == complete):

    - the root span (``scale_up`` or ``slice_repair``) exists and is
      closed;
    - every span of the trace is closed (``end`` set);
    - a scale-up that dispatched work carries the full phase anatomy
      (observe/plan/dispatch/provision/node_registration) plus
      ``pods_running``; one that bound existing supply needs only
      ``pods_running``;
    - a slice repair carries its drain phase;
    - a repack migration carries its drain phase and, when
      completed, the chip-seconds-saved attribution on the root;
    - a sampled request trace (serving/reqtrace.py) carries
      its ``queue_wait`` phase and — unless the request was lost to a
      drain handoff — a ``decode`` phase; a lost request carries the
      ``drain_handoff`` span instead.  Roots whose event journal
      overflowed (``truncated`` attr) are exempt from the phase
      checks (the truncation is declared, not silent).
    """
    spans = [s for s in dump.get("spans", []) if s["trace_id"] == trace_id]
    if not spans:
        return [f"trace {trace_id}: no spans recorded"]
    gaps: list[str] = []
    names = {s["name"] for s in spans}
    roots = [s for s in spans if s["parent_id"] is None]
    if not roots:
        gaps.append(f"trace {trace_id}: no root span")
    for s in spans:
        if s["end"] is None:
            gaps.append(f"trace {trace_id}: span {s['name']} "
                        f"({s['span_id']}) never closed")
    if "scale_up" in names:
        required: tuple[str, ...] = ("pods_running",)
        if "dispatch" in names:
            required += ("observe", "plan")
            # A trace whose every dispatched provision FAILED can still
            # complete off existing supply; one that provisioned must
            # show the registration phase too.
            if "provision" in names:
                required += ("node_registration",)
            elif "provision_failed" not in names:
                required += ("provision",)
        aborted = any(s["name"] == "scale_up" and "aborted" in s["attrs"]
                      for s in spans)
        if not aborted:
            for phase in required:
                if phase not in names:
                    gaps.append(f"trace {trace_id}: missing {phase} span")
    elif "slice_repair" in names:
        abandoned = any(s["name"] == "slice_repair"
                        and ("error" in s["attrs"]
                             or "aborted" in s["attrs"]) for s in spans)
        if not abandoned and "repair_drain" not in names:
            gaps.append(f"trace {trace_id}: missing repair_drain span")
    elif "request" in names:
        # A promoted data-plane request trace.  The phase
        # contract is shared by the real engines and the queueing-
        # model replay replicas, so it names only what BOTH record.
        for s in spans:
            if s["name"] != "request" or s["end"] is None:
                continue
            attrs = s["attrs"]
            if attrs.get("truncated"):
                continue
            if attrs.get("lost"):
                # A drain-lost request may never have been admitted
                # at all; its story is the handoff span alone.
                if "drain_handoff" not in names:
                    gaps.append(f"trace {trace_id}: lost request "
                                f"missing drain_handoff span")
                continue
            if "queue_wait" not in names:
                gaps.append(f"trace {trace_id}: missing queue_wait "
                            f"span")
            if "decode" not in names:
                gaps.append(f"trace {trace_id}: missing decode span")
            if attrs.get("preemptions", 0) \
                    and "preempt_requeue" not in names:
                gaps.append(f"trace {trace_id}: preempted request "
                            f"missing preempt_requeue span")
    elif "repack" in names:
        closed = [s for s in spans if s["name"] == "repack"
                  and s["end"] is not None]
        aborted = any("error" in s["attrs"] or "aborted" in s["attrs"]
                      for s in closed)
        if not aborted and closed and "repack_drain" not in names:
            gaps.append(f"trace {trace_id}: missing repack_drain span")
        for s in closed:
            if "aborted" in s["attrs"] or "error" in s["attrs"]:
                continue
            # A completed migration's root must carry its bill — the
            # chip-seconds-saved attribution IS the acceptance surface.
            if "chip_seconds_saved" not in s["attrs"]:
                gaps.append(f"trace {trace_id}: completed repack root "
                            f"missing chip_seconds_saved attribution")
    return gaps
