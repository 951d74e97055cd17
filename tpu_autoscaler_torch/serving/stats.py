"""Per-tick serving statistics: fixed numpy rings, O(1) snapshots.

The batcher family (``workloads/serving.py``, ``paged.py``,
``spec_serving.py``) owns one :class:`ServingStatsRecorder` each and
calls ``end_tick`` once per engine tick and ``note_*`` from the
admission/preemption/completion bookkeeping it already does.  The
design constraint is the decode hot path: every write is an int
increment or one row-assignment into a preallocated numpy ring — no
per-request Python objects, no device sync (engines pass host-side
mirrors, never ``jax.Array`` reads), no allocation after construction.

``snapshot()`` is the export surface: a frozen dataclass of plain
scalars whose cost is a handful of fixed-width ring reductions —
independent of how many requests or ticks the engine has served.  The
``(epoch, seq)`` pair orders snapshots fleet-wide: ``seq`` is the tick
counter (monotone within a process), ``epoch`` changes when a recorder
is rebuilt (replica restart), which is how the aggregation adapter
(``serving/adapter.py``) tells a counter reset from a stale delivery.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np

#: Tick-series ring width: the throughput/queue window a snapshot
#: summarizes.  Fixed so snapshot cost never grows with uptime.
TICK_WINDOW = 256

#: Completed-request latency ring width (per-request SLO attainment is
#: measured over the last this-many completions).
LATENCY_WINDOW = 512

#: Epoch source: a rebuilt recorder (replica restart) gets a fresh,
#: LARGER epoch, so downstream consumers can tell "counters restarted"
#: (epoch advanced) from "stale snapshot re-delivered" (epoch or seq
#: regressed).  Epochs must stay increasing ACROSS process restarts —
#: a counter alone would restart at 1 and the aggregation adapter
#: would drop the reborn replica's snapshots as stale for its whole
#: catch-up window — so the base is a millisecond timestamp taken at
#: import (fresh per process), with a per-process counter in the low
#: bits for uniqueness inside one process.
_EPOCH_BASE = (time.time_ns() // 1_000_000) << 12
_EPOCHS = itertools.count(1)


def _next_epoch() -> int:
    return _EPOCH_BASE + next(_EPOCHS)


@dataclasses.dataclass(frozen=True)
class ServingSnapshot:
    """One engine's exported state at a tick: cumulative counters (the
    adapter differences them into rates) plus windowed summaries."""

    epoch: int                  # recorder incarnation (restart marker)
    seq: int                    # tick count at snapshot time
    queue_depth: int            # requests queued, not yet admitted
    active: int                 # slots holding live requests
    slots: int                  # concurrent-sequence capacity
    kv_used: int                # KV token-slots (or block tokens) live
    kv_capacity: int            # KV token-slot capacity
    admitted_total: int
    preempted_total: int
    finished_total: int
    slo_ok_total: int           # finished within the latency target
    decode_tokens_total: int
    queue_depth_mean: float     # over the tick window
    tokens_per_tick: float      # over the tick window
    latency_p50_ticks: float    # over the latency window (0 if none)
    latency_p95_ticks: float
    # Queue-wait vs execute split: submitted_tick
    # is preserved across preemption re-queues, so end-to-end latency
    # alone cannot say whether time went to waiting or to serving.
    first_scheduled_total: int = 0   # requests that reached a slot
    queue_wait_ticks_total: int = 0  # submit -> FIRST admission
    requeue_wait_ticks_total: int = 0  # preempt -> re-admission
    queue_wait_p95_ticks: float = 0.0  # over the wait window
    # Request-trace sampler counters (serving/reqtrace.py), riding the
    # same cumulative-counter delta path as the admission counters.
    trace_sampled_total: int = 0
    trace_tail_total: int = 0
    trace_dropped_total: int = 0
    # Latest promoted request-trace exemplar: (trace_id, latency) the
    # aggregation layer forwards into the TSDB so latency series
    # resolve to a concrete sampled trace.  ``exemplar_seq`` is
    # monotone per recorder so the adapter never re-takes one.
    exemplar_trace_id: str | None = None
    exemplar_value: float = 0.0
    exemplar_seq: int = 0

    @property
    def slo_attainment(self) -> float:
        """Lifetime fraction of completions inside the target (1.0
        when nothing finished yet, or no target was configured)."""
        if self.finished_total <= 0:
            return 1.0
        return self.slo_ok_total / self.finished_total

    @property
    def kv_occupancy(self) -> float:
        if self.kv_capacity <= 0:
            return 0.0
        return self.kv_used / self.kv_capacity

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["slo_attainment"] = round(self.slo_attainment, 4)
        d["kv_occupancy"] = round(self.kv_occupancy, 4)
        return d


class ServingStatsRecorder:
    """Fixed-ring tick statistics for one serving engine.

    ``slo_ticks``: completions within this many engine ticks of
    submission count as SLO-attained (None = no target; everything
    attains).  All state is host-side numpy + ints; nothing here ever
    touches a device array.
    """

    def __init__(self, slots: int, slo_ticks: int | None = None,
                 tick_window: int = TICK_WINDOW,
                 latency_window: int = LATENCY_WINDOW) -> None:
        self.epoch = _next_epoch()
        self.slots = int(slots)
        self.slo_ticks = slo_ticks
        self._seq = 0
        # Cumulative counters (plain ints: the cheapest possible write).
        self.admitted_total = 0
        self.preempted_total = 0
        self.finished_total = 0
        self.slo_ok_total = 0
        self._decode_tokens_total = 0
        # Tick rings (per-tick instantaneous series).
        self._w = int(tick_window)
        self._q_ring = np.zeros(self._w, np.int64)
        self._tok_ring = np.zeros(self._w, np.int64)
        # Completed-request latency ring (ticks from submit to done).
        self._lw = int(latency_window)
        self._lat_ring = np.zeros(self._lw, np.int64)
        self._lat_n = 0
        # Queue-wait split: first-schedule +
        # requeue waits, cumulative and windowed.
        self.first_scheduled_total = 0
        self.queue_wait_ticks_total = 0
        self.requeue_wait_ticks_total = 0
        self._wait_ring = np.zeros(self._lw, np.int64)
        self._wait_n = 0
        # Request-trace sampler mirror (serving/reqtrace.py).
        self.trace_sampled_total = 0
        self.trace_tail_total = 0
        self.trace_dropped_total = 0
        self._exemplar: tuple[str, float] | None = None
        self._exemplar_seq = 0
        # Last gauge values (the snapshot's instantaneous fields).
        self._queue_depth = 0
        self._active = 0
        self._kv_used = 0
        self._kv_capacity = 0

    # -- engine-side hooks (all O(1)) -------------------------------------

    def note_admit(self, n: int = 1) -> None:
        self.admitted_total += n

    def note_preempt(self, n: int = 1) -> None:
        self.preempted_total += n

    def note_finish(self, latency_ticks: int) -> None:
        self.finished_total += 1
        if self.slo_ticks is None or latency_ticks <= self.slo_ticks:
            self.slo_ok_total += 1
        self._lat_ring[self._lat_n % self._lw] = latency_ticks
        self._lat_n += 1

    def note_first_scheduled(self, wait_ticks: int) -> None:
        """Request reached a slot for the FIRST time: the submit→admit
        wait lands in the queue-wait split (end-to-end latency minus
        these waits is pure execute time)."""
        self.first_scheduled_total += 1
        self.queue_wait_ticks_total += wait_ticks
        self._wait_ring[self._wait_n % self._lw] = wait_ticks
        self._wait_n += 1

    def note_requeue_wait(self, wait_ticks: int) -> None:
        """A preempted request re-reached a slot: the preempt→re-admit
        wait is attributed separately (it previously lumped invisibly
        into end-to-end latency)."""
        self.requeue_wait_ticks_total += wait_ticks
        self._wait_ring[self._wait_n % self._lw] = wait_ticks
        self._wait_n += 1

    def note_trace(self, tail: bool = False) -> None:
        """One request trace promoted by the sampler."""
        self.trace_sampled_total += 1
        if tail:
            self.trace_tail_total += 1

    def note_trace_drop(self) -> None:
        self.trace_dropped_total += 1

    def note_exemplar(self, trace_id: str, value: float) -> None:
        """Latest promoted-trace exemplar (last wins: the sampler only
        promotes head samples and the slow tail, so during a burn the
        exemplar is a current slow request)."""
        self._exemplar = (trace_id, float(value))
        self._exemplar_seq += 1

    def end_tick(self, *, queue_depth: int, active: int, kv_used: int,
                 kv_capacity: int, decode_tokens_total: int) -> None:
        """Close one engine tick.  ``decode_tokens_total`` is the
        engine's existing cumulative counter — the ring stores the
        per-tick delta so throughput windows need no second counter."""
        i = self._seq % self._w
        self._q_ring[i] = queue_depth
        self._tok_ring[i] = decode_tokens_total - self._decode_tokens_total
        self._decode_tokens_total = decode_tokens_total
        self._queue_depth = queue_depth
        self._active = active
        self._kv_used = kv_used
        self._kv_capacity = kv_capacity
        self._seq += 1

    # -- export -----------------------------------------------------------

    def snapshot(self) -> ServingSnapshot:
        """O(1) export: fixed-width ring reductions + scalar reads."""
        n = min(self._seq, self._w)
        if n:
            q_mean = float(self._q_ring[:n].mean())
            tok_rate = float(self._tok_ring[:n].mean())
        else:
            q_mean = tok_rate = 0.0
        ln = min(self._lat_n, self._lw)
        if ln:
            lat = self._lat_ring[:ln]
            p50 = float(np.percentile(lat, 50))
            p95 = float(np.percentile(lat, 95))
        else:
            p50 = p95 = 0.0
        wn = min(self._wait_n, self._lw)
        wait_p95 = float(np.percentile(self._wait_ring[:wn], 95)) \
            if wn else 0.0
        ex_id, ex_val = (self._exemplar if self._exemplar is not None
                         else (None, 0.0))
        return ServingSnapshot(
            epoch=self.epoch, seq=self._seq,
            queue_depth=self._queue_depth, active=self._active,
            slots=self.slots, kv_used=self._kv_used,
            kv_capacity=self._kv_capacity,
            admitted_total=self.admitted_total,
            preempted_total=self.preempted_total,
            finished_total=self.finished_total,
            slo_ok_total=self.slo_ok_total,
            decode_tokens_total=self._decode_tokens_total,
            queue_depth_mean=q_mean, tokens_per_tick=tok_rate,
            latency_p50_ticks=p50, latency_p95_ticks=p95,
            first_scheduled_total=self.first_scheduled_total,
            queue_wait_ticks_total=self.queue_wait_ticks_total,
            requeue_wait_ticks_total=self.requeue_wait_ticks_total,
            queue_wait_p95_ticks=wait_p95,
            trace_sampled_total=self.trace_sampled_total,
            trace_tail_total=self.trace_tail_total,
            trace_dropped_total=self.trace_dropped_total,
            exemplar_trace_id=ex_id, exemplar_value=ex_val,
            exemplar_seq=self._exemplar_seq)
