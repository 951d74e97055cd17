"""Flight recorder: bounded in-memory history of completed spans and
per-pass decision records, dumpable from a LIVE process.

Why: when a production controller is stuck or slow, the
Prometheus endpoint says *that* something is wrong, not *why*.  The
recorder keeps the last N completed spans (the per-phase latency
anatomy of recent scale-ups) and the last M reconcile decision records
("why did/didn't we provision") in two lock-guarded ring buffers, and
exposes them two ways that both work without a restart:

- ``/debugz`` on the metrics port (``Metrics.serve(port, debugz=...)``)
  returns the dump as JSON;
- SIGUSR1 (``install_sigusr1``) writes the dump to a timestamped file
  under ``/tmp`` — for controllers whose metrics port is firewalled or
  was never enabled.

Retention is bounded by construction (``collections.deque`` maxlen):
the recorder can never grow past ``max_spans + max_passes`` entries no
matter how long the process runs — crash-only discipline applied to
introspection state.  Everything in a dump is JSON-serializable with
``allow_nan=False`` (guarded empty-summary exports; no ``inf`` leaks).
"""

from __future__ import annotations

import collections
import logging
import signal
import time
from typing import Any, Callable

from tpu_autoscaler_torch import concurrency
from tpu_autoscaler_torch.obs.trace import Span

log = logging.getLogger(__name__)

#: Ring bounds (docs/OBSERVABILITY.md).  4096 spans ≈ 500 scale-ups of
#: 8 spans each; 512 passes ≈ 40 min of 5 s-interval history.
DEFAULT_MAX_SPANS = 4096
DEFAULT_MAX_PASSES = 512


class FlightRecorder:
    """Lock-guarded ring buffers of spans + decision records.

    Writers: the reconcile thread (most spans, every pass record) and
    the informer watch threads (relist spans) — hence the lock.  The
    ``/debugz`` HTTP handler and the SIGUSR1 handler read via
    ``dump()``, which copies under the lock.
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


def install_sigusr1(dump_fn: Callable[[], dict[str, Any]],
                    path_prefix: str = "/tmp/tpu-autoscaler-debugz") -> bool:
    """SIGUSR1 → write ``dump_fn()`` as JSON to a timestamped file.

    Returns False on platforms without SIGUSR1 (Windows).  Install from
    the main thread only (a Python signal.signal constraint).  The
    handler is crash-only: a failing dump logs and never takes the
    process down.

    File names are UNIQUE per capture (UTC stamp + pid + a monotonic
    counter, obs/blackbox.py): two signals in the same second used to
    clobber each other's dump — exactly the double-capture an incident
    produces — and the write is atomic (tmp + rename), so a reader
    polling the directory never sees a half-written dump.

    The dump runs on a THROWAWAY THREAD, never inline in the handler:
    Python signal handlers interrupt the main thread between bytecodes,
    and ``dump_fn`` acquires the recorder/tracer/metrics locks — all
    non-reentrant.  An inline dump that lands while the interrupted
    reconcile frame holds one of those locks would deadlock the very
    controller it exists to diagnose; a thread just blocks until the
    main thread releases the lock and then writes the file.
    """
    if not hasattr(signal, "SIGUSR1"):
        return False

    def _write() -> None:
        from tpu_autoscaler_torch.obs.blackbox import (
            unique_dump_path,
            write_atomic,
        )

        path = unique_dump_path(path_prefix)
        try:
            write_atomic(path, dump_fn())
            log.warning("SIGUSR1: flight-recorder dump written to %s", path)
        except Exception:  # noqa: BLE001 — diagnostics must not kill
            log.exception("SIGUSR1 flight-recorder dump failed")

    def _handler(signum: int, frame: Any) -> None:
        # Raw threading on purpose: this fires only in production
        # processes (main.run), outside any scheduler's lifetime.
        import threading

        threading.Thread(target=_write, daemon=True,
                         name="debugz-dump").start()

    signal.signal(signal.SIGUSR1, _handler)
    return True
