"""Request-level data-plane tracing: sampled request spans.

The control plane is fully traced (obs/trace.py: one ``scaleup-*``
trace per gang) but the data plane that users actually feel was a
black box: the batcher family exports only aggregate rings
(serving/stats.py), so when ``serving_slo_attainment`` burns nothing
says *which* requests missed or *where* their time went.  This module
is the missing per-request decomposition, built to the same discipline
as :class:`~tpu_autoscaler_torch.serving.stats.ServingStatsRecorder`:

- **zero device syncs** — every hook is called from the host-side
  scheduling bookkeeping the engines already do (submit / admit /
  seeded / preempt / finish);
- **O(1) amortized on the tick path** — while a request is in flight
  the sampler only appends ``(event, tick)`` int pairs to a bounded
  per-request list; span objects are built once, at completion, and
  only for requests that get promoted;
- **bounded memory** — pending tracking, events-per-request and the
  retained trace store (a :class:`FlightRecorder` ring) are all capped
  by construction, so a replica restart or an unbounded queue can
  never grow the sampler.

Sampling policy (docs/OBSERVABILITY.md "Request spans & exemplars"):

- **head sampling** — a deterministic hash of the request id
  (``crc32 % 10000``) against ``sample_rate``: the same request id
  samples identically on every replica and every replay, so offline
  re-runs see the same trace set;
- **always-on tail capture** — any request whose latency exceeds
  ``slo_ticks``, any request that was preempted, and any request lost
  to a drain handoff is promoted regardless of the head decision.
  The slow tail is never invisible, whatever the sampling rate.

A promoted request becomes one ``request-<replica>-<rid>`` trace:

```
request                       submit → finish   [latency, slo_miss, …]
├─ queue_wait                 submit → first admission
├─ prefill                    admission → prompt seeded
├─ decode                     seeded → finish/preempt  (batched ticks
│                             annotated — NEVER a span per token)
├─ preempt_requeue            preempt → re-admission (per requeue)
│   └─ (prefill/decode again after each requeue)
└─ drain_handoff              last progress → drain exit (lost only)
```

``obs.recorder.trace_gaps`` knows this shape (the chaos `serving`
profile asserts gap-free trees for every tail capture), and promotion
feeds the owning stats recorder an **exemplar** ``(trace_id,
latency)`` — the hook that lets ``serving_request_latency_ticks`` p99
on ``/debugz/tsdb`` resolve to a concrete slow-request trace
(obs/tsdb.py exemplars).
"""

from __future__ import annotations

import zlib
from typing import Any

from tpu_autoscaler_torch.obs.recorder import FlightRecorder
from tpu_autoscaler_torch.obs.trace import Tracer

#: Head-sampling hash denominator (rate quantum = 0.01%).
SAMPLE_DENOM = 10_000

#: Default bounds (FlightRecorder-shaped: fixed rings, never grows).
DEFAULT_MAX_TRACES = 256
DEFAULT_MAX_PENDING = 2048
DEFAULT_MAX_EVENTS = 64

#: Event codes in a pending request's compact journal.
_SUBMIT, _ADMIT, _SEEDED, _PREEMPT, _FINISH, _DRAIN = range(6)


def head_sampled(rid: str, sample_rate: float) -> bool:
    """Deterministic head-sampling verdict for one request id: stable
    across replicas, processes and offline replays (the offline
    tail-report must see the same head set the live sampler kept)."""
    if sample_rate <= 0.0:
        return False
    bar = int(sample_rate * SAMPLE_DENOM)
    return zlib.crc32(rid.encode()) % SAMPLE_DENOM < bar


class RequestTraceSampler:
    """Per-replica request-span sampler for one serving engine.

    ``slo_ticks``: latency bound (in the caller's tick/clock units)
    past which a finished request is tail-captured (None = head
    sampling only, plus preempted/lost capture).  ``stats``: the
    engine's ServingStatsRecorder — promotion counters and the latest
    exemplar are mirrored into it so they ride the existing snapshot
    export path.  ``recorder``: span sink; pass a shared
    FlightRecorder (e.g. the controller's) to land request traces in
    the same ``/debugz`` dumps and incident bundles as the
    control-plane traces, or leave None for a private bounded ring.

    Single-threaded like the engines that own it (the batcher tick
    loop); nothing here takes a device sync or an unbounded
    allocation.
    """

    def __init__(self, replica_id: str, *, sample_rate: float = 0.01,
                 slo_ticks: float | None = None,
                 max_traces: int = DEFAULT_MAX_TRACES,
                 max_pending: int = DEFAULT_MAX_PENDING,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 stats: Any = None,
                 recorder: FlightRecorder | None = None) -> None:
        self.replica_id = replica_id
        self.sample_rate = float(sample_rate)
        self.slo_ticks = slo_ticks
        self.max_pending = int(max_pending)
        self.max_events = int(max_events)
        self.stats = stats
        self.recorder = recorder if recorder is not None else \
            FlightRecorder(max_spans=max_traces * 8, max_passes=16)
        # Spans carry explicit engine-tick times; the tracer clock is
        # never consulted (clock=0 would stamp garbage loudly if it
        # ever were).
        self._tracer = Tracer(recorder=self.recorder,
                              clock=lambda: 0.0)
        #: rid -> [head_sampled, preempts, [(event, tick), ...]]
        self._pending: dict[str, list] = {}
        self._cohort_seq = 0
        # Lifetime counters (mirrored into ``stats`` on change).
        self.sampled_total = 0        # promoted traces (head or tail)
        self.tail_captured_total = 0  # promoted by the tail rules
        self.dropped_total = 0        # pending/event-cap overflow
        self.rerouted_total = 0       # forwarded to another replica

    # -- engine hooks (all O(1) appends) ------------------------------

    def note_submit(self, rid: str, tick: float) -> None:
        """Request entered the queue.  Over ``max_pending`` the OLDEST
        tracked request is dropped (counted): a runaway queue degrades
        sampling coverage, never sampler memory."""
        if rid in self._pending:
            return
        if len(self._pending) >= self.max_pending:
            victim = next(iter(self._pending))
            del self._pending[victim]
            self._drop()
        self._pending[rid] = [head_sampled(rid, self.sample_rate), 0,
                              [(_SUBMIT, tick)]]

    def note_admit(self, rid: str, tick: float) -> None:
        self._event(rid, _ADMIT, tick)

    def note_seeded(self, rid: str, tick: float) -> None:
        """Prompt fully prefilled; first token sampled."""
        self._event(rid, _SEEDED, tick)

    def note_preempt(self, rid: str, tick: float) -> None:
        ent = self._pending.get(rid)
        if ent is not None:
            ent[1] += 1
        self._event(rid, _PREEMPT, tick)

    def note_forward(self, rid: str) -> None:
        """The request re-routed to another replica (drain handoff of
        a QUEUED request — it is not lost; the receiving replica's
        sampler owns it from its original submit time)."""
        if self._pending.pop(rid, None) is not None:
            self.rerouted_total += 1

    def note_finish(self, rid: str, tick: float, *, tokens: int = 0,
                    attrs: dict[str, Any] | None = None) -> str | None:
        """Request completed; returns the trace id iff promoted."""
        return self._close(rid, _FINISH, tick, tokens=tokens,
                           attrs=attrs)

    def note_drain_lost(self, rid: str, tick: float) -> str | None:
        """Request still queued when the engine exited its drain: the
        caller re-dispatches it elsewhere, but THIS replica's story
        ends in a drain handoff — always captured (a lost request is
        tail by definition)."""
        return self._close(rid, _DRAIN, tick)

    def note_cohort(self, rid: str, *, arrival: float, finish: float,
                    n: int = 1, exec_time: float = 0.0,
                    head: bool | None = None,
                    attrs: dict[str, Any] | None = None) -> str | None:
        """Whole-lifecycle convenience for queueing-model replicas
        (serving/replay.py): one call per scored completion cohort —
        submit at ``arrival``, execution over the trailing
        ``exec_time``, finish at ``finish``.  ``rid`` keys the head-
        sampling hash (one verdict per cohort however it splits); the
        minted trace id is made unique per call.

        Unlike the event-driven engine path (where tail is unknown
        until completion, so every request journals), the whole
        lifecycle is known HERE — an unpromoted cohort costs one hash
        and one compare, nothing else (the traced-vs-untraced bench
        gate rides on this fast path).  ``head``: pass the cohort's
        precomputed ``head_sampled`` verdict to skip even the hash
        (callers that score one cohort over many completion chunks
        hash once at assignment)."""
        latency = finish - arrival
        if head is None:
            head = head_sampled(rid, self.sample_rate)
        slo_miss = (self.slo_ticks is not None
                    and latency > self.slo_ticks)
        if not (head or slo_miss):
            return None
        self._cohort_seq += 1
        unique = f"{rid}.{self._cohort_seq}"
        exec_start = max(arrival, finish - exec_time)
        events = [(_SUBMIT, arrival), (_ADMIT, exec_start),
                  (_SEEDED, exec_start), (_FINISH, finish)]
        return self._emit(unique, events, latency=latency,
                          lost=False, slo_miss=slo_miss, preempts=0,
                          head=head, tail=slo_miss, tokens=0,
                          truncated=False, end=finish,
                          attrs={"n": n, **(attrs or {})})

    # -- internals ----------------------------------------------------

    def _drop(self) -> None:
        self.dropped_total += 1
        if self.stats is not None:
            self.stats.note_trace_drop()

    def _event(self, rid: str, kind: int, tick: float) -> None:
        ent = self._pending.get(rid)
        if ent is None:
            return
        events = ent[2]
        if len(events) >= self.max_events:
            # Journal full: keep the entry (the close still promotes
            # and emits a truncated trace) but stop appending.
            return
        events.append((kind, tick))

    def _close(self, rid: str, kind: int, tick: float, *,
               tokens: int = 0,
               attrs: dict[str, Any] | None = None) -> str | None:
        ent = self._pending.pop(rid, None)
        if ent is None:
            return None
        head, preempts, events = ent
        truncated = len(events) >= self.max_events
        if not truncated:
            events.append((kind, tick))
        submit = events[0][1]
        latency = tick - submit
        lost = kind == _DRAIN
        slo_miss = (self.slo_ticks is not None
                    and latency > self.slo_ticks)
        tail = slo_miss or lost or preempts > 0
        if not (head or tail):
            return None
        return self._emit(rid, events, latency=latency, lost=lost,
                          slo_miss=slo_miss, preempts=preempts,
                          head=head, tail=tail, tokens=tokens,
                          truncated=truncated, end=tick,
                          attrs=attrs)

    def _emit(self, rid: str, events: list, *, latency: float,
              lost: bool, slo_miss: bool, preempts: int, head: bool,
              tail: bool, tokens: int, truncated: bool, end: float,
              attrs: dict[str, Any] | None) -> str:
        """Build the span tree for one promoted request — the only
        non-O(1) step, bounded by ``max_events`` and paid once per
        PROMOTED request, never on the tick path."""
        trace_id = f"request-{self.replica_id}-{rid}"
        submit = events[0][1]
        sampled = ("head+tail" if head and tail
                   else "tail" if tail else "head")
        root_attrs: dict[str, Any] = {
            "rid": rid, "replica": self.replica_id,
            "latency_ticks": latency, "slo_miss": slo_miss,
            "preemptions": preempts, "sampled": sampled,
        }
        if tokens:
            root_attrs["tokens"] = tokens
        if lost:
            root_attrs["lost"] = True
        if truncated:
            root_attrs["truncated"] = True
        if attrs:
            root_attrs.update(attrs)
        root = self._tracer.start("request", trace_id=trace_id,
                                  parent=None, t=submit,
                                  attrs=root_attrs)
        if not truncated:
            self._child_spans(root, events, end)
        self._tracer.end(root, t=end)
        self.sampled_total += 1
        if tail:
            self.tail_captured_total += 1
        if self.stats is not None:
            self.stats.note_trace(tail=tail)
            self.stats.note_exemplar(trace_id, float(latency))
        return trace_id

    def _child_spans(self, root, events: list, end: float) -> None:
        """Phase children from the event journal.  Decode is one span
        per (seeded → preempt/finish) window with the batched tick
        count as an attr — never per-token."""
        rec = self._tracer.record
        wait_from = events[0][1]          # submit (or last preempt)
        wait_kind = "first_schedule"
        admit_at: float | None = None
        seeded_at: float | None = None
        progress_at = events[0][1]
        for kind, t in events[1:]:
            if kind == _ADMIT:
                rec("queue_wait" if wait_kind == "first_schedule"
                    else "preempt_requeue",
                    start=wait_from, end=t, parent=root,
                    attrs={"wait_ticks": t - wait_from})
                admit_at = t
                progress_at = t
            elif kind == _SEEDED:
                rec("prefill",
                    start=admit_at if admit_at is not None else t,
                    end=t, parent=root)
                seeded_at = t
                progress_at = t
            elif kind in (_PREEMPT, _FINISH):
                if seeded_at is not None:
                    rec("decode", start=seeded_at, end=t, parent=root,
                        attrs={"ticks": t - seeded_at})
                    seeded_at = None
                if kind == _PREEMPT:
                    wait_from = t
                    wait_kind = "requeue"
                    admit_at = None
                progress_at = t
            elif kind == _DRAIN:
                rec("drain_handoff", start=progress_at, end=t,
                    parent=root,
                    attrs={"stalled_ticks": t - progress_at})

    # -- export -------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    def dump(self) -> dict[str, Any]:
        """The retained request traces, FlightRecorder dump shape —
        ``trace_gaps`` and the render helpers consume it directly."""
        return self.recorder.dump()

    def debug_state(self) -> dict[str, Any]:
        return {
            "replica": self.replica_id,
            "sample_rate": self.sample_rate,
            "slo_ticks": self.slo_ticks,
            "pending": len(self._pending),
            "sampled_total": self.sampled_total,
            "tail_captured_total": self.tail_captured_total,
            "dropped_total": self.dropped_total,
            "rerouted_total": self.rerouted_total,
        }
