"""In-process tracing: spans inside the port's serving tick and train
step (``workloads/serving.py``, ``paged.py``, ``model.py``), and the
request-trace sampler's span trees (``serving/reqtrace.py``).

A tracer whose spans mirror OpenTelemetry's shape (name, trace_id,
span_id, parent, start/end, attrs, events) without the SDK.  It began
as a copy of the JAX package's module of the same name, whose model
follows; the port adds the profiler ranges and drops the metrics feed.

Model (docs/OBSERVABILITY.md):

- a **trace** is one gang scale-up: the reconciler mints a trace_id the
  first time a gang is seen Unschedulable and ends the root span when
  its last pod runs, so the whole story renders as ONE tree;
- **spans** carry explicit timestamps.  Call sites pass the injected
  reconcile clock (``now``) so simulated-time runs produce coherent
  traces; ``seq`` (a global monotonic counter) breaks ties between
  spans recorded at the same timestamp — recording order IS causal
  order within a thread;
- spans can be recorded **retroactively** (``record``): a reconcile
  pass serves many gangs, so its observe/plan timings are emitted into
  a gang's trace only when that pass actually dispatches work for it;
- **context**: the active span lives in a ``contextvars.ContextVar``.
  It deliberately does NOT leak across the actuation pool boundary —
  worker thunks never touch the tracer (docs/ACTUATION.md thread
  model); instead ``ActuationExecutor.submit`` captures the submitting
  span on the reconcile thread and the drain-time completion ends it
  there, so TAT2xx/TAR5xx stay clean by construction;
- **profiler ranges**: a span opened live (``start`` without ``t``)
  is also a ``torch.profiler`` range of the same name while a profiler
  records, entered and exited as ``torch.profiler.record_function``
  does, so the port's serving tick and train step land in the device
  trace; a retroactive span (``record``, or ``start`` with ``t``) opens
  none.  The default clock, ``time.time``, is the profiler's: a live
  span's ``start`` in ns lies just before its range's ``start_ns()``
  (the range is entered after the span is stamped and exited before
  the span's end is), with no offset to apply.

Thread-safety: the tracer is called from the reconcile thread AND the
informer watch threads; every mutation of shared tracer state
(the active-span registry, the seq counters) happens under one
``concurrency.Lock``.  Span objects themselves are single-writer: the
thread that starts a span is the thread that ends it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
import uuid
from typing import Any, Iterator

import torch

from tpu_autoscaler_torch import concurrency

#: The active span for the calling thread/context (see module docstring).
_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tpu_autoscaler_current_span", default=None)


def current_span() -> "Span | None":
    """The span active in this context (None outside any ``use()``)."""
    return _CURRENT.get()


def current_trace_id() -> str | None:
    span = _CURRENT.get()
    return span.trace_id if span is not None else None


@dataclasses.dataclass
class Span:
    """One timed phase.  ``end is None`` means still open (a stuck
    controller's ``/debugz`` dump shows exactly which phase is stuck)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float
    end: float | None = None
    seq: int = 0
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    events: list[dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def as_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_s": self.duration,
            "seq": self.seq,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class DeviceCounter:
    """Counts a traced step keeps on the device: each :meth:`add`
    copies one row (a 1-d tensor of counts, on the device) into a tensor
    allocated at the first row, one launch and no sync (:meth:`add_rows`
    several rows in one); :meth:`read`
    brings the rows kept so far to the host (the one sync, after the
    steps), :meth:`reset` starts over.  Rows past ``capacity`` are not
    kept; ``dropped`` counts them."""

    capacity = 8192

    def __init__(self) -> None:
        self.rows = 0
        self.dropped = 0
        self._buf: torch.Tensor | None = None

    def add(self, values: torch.Tensor) -> None:
        if self._buf is None:
            self._buf = values.new_zeros((self.capacity, values.shape[0]))
        if self.rows == self.capacity:
            self.dropped += 1
            return
        self._buf[self.rows].copy_(values)
        self.rows += 1

    def add_rows(self, rows: torch.Tensor) -> None:
        """:meth:`add` of each row of ``rows`` [n, width] (on the device)
        in order, in one copy."""
        if self._buf is None:
            self._buf = rows.new_zeros((self.capacity, rows.shape[1]))
        kept = min(rows.shape[0], self.capacity - self.rows)
        self.dropped += rows.shape[0] - kept
        if kept:
            self._buf[self.rows:self.rows + kept].copy_(rows[:kept])
            self.rows += kept

    def read(self) -> list[list]:
        """The rows kept since the last :meth:`reset`, on the host."""
        if self._buf is None:
            return []
        return self._buf[:self.rows].tolist()

    def reset(self) -> None:
        self.rows = 0
        self.dropped = 0


class Tracer:
    """Span factory + sink.  ``recorder=None`` still produces spans (so
    trace ids propagate) but retains nothing — the zero-retention mode
    the overhead bench compares against is ``tracer=None`` at each
    instrumentation seam, which skips span work entirely."""

    def __init__(self, recorder: Any = None, clock: Any = time.time) -> None:
        self.recorder = recorder
        self.clock = clock
        self._lock = concurrency.Lock()
        self._active: dict[str, Span] = {}
        # span_id -> the profiler range a live span holds open.
        self._ranges: dict[str, Any] = {}
        self._seq = 0
        self._trace_seq = 0
        #: Device-side counters by name (:meth:`counter`).
        self.counters: dict[str, DeviceCounter] = {}
        # Distinguishes traces across controller restarts in aggregated
        # log stores (trace ids repeat their counter after a crash-only
        # restart; the run id keeps them globally unique).
        self._run_id = uuid.uuid4().hex[:6]  # analysis: allow=TAD902 the run id exists to be unique ACROSS restarts BY DESIGN (see comment above); replay oracles compare span structure and attribution, never trace-id bytes

    # -- ids --------------------------------------------------------------

    def new_trace(self, prefix: str = "trace") -> str:
        with self._lock:
            self._trace_seq += 1
            return f"{prefix}-{self._run_id}-{self._trace_seq}"

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def counter(self, name: str) -> DeviceCounter:
        """The device counter ``name``, made at its first use: a traced
        step records into it and the caller reads it after the steps
        (the MoE layers' ``serve.moe``: a row per call, its group ends
        over the experts)."""
        with self._lock:
            if name not in self.counters:
                self.counters[name] = DeviceCounter()
            return self.counters[name]

    # -- span lifecycle ---------------------------------------------------

    def start(self, name: str, *, trace_id: str | None = None,
              parent: Span | None = None, t: float | None = None,
              attrs: dict[str, Any] | None = None) -> Span:
        """Open a span.  Parent defaults to the context's current span;
        trace_id defaults to the parent's (or a fresh anonymous one).
        Without ``t`` the span is live: stamped now and, while a
        profiler records, entered as a profiler range of its name."""
        if parent is None:
            parent = _CURRENT.get()
        if trace_id is None:
            trace_id = (parent.trace_id if parent is not None
                        else self.new_trace())
        seq = self._next_seq()
        span = Span(name=name, trace_id=trace_id,
                    span_id=f"s{seq}",
                    parent_id=parent.span_id if parent is not None else None,
                    start=self.clock() if t is None else t,
                    seq=seq, attrs=dict(attrs or {}))
        live = None
        if t is None and torch._C._autograd._profiler_enabled():
            live = torch.profiler.record_function(name)
            live.__enter__()
        with self._lock:
            self._active[span.span_id] = span
            if live is not None:
                self._ranges[span.span_id] = live
        return span

    def end(self, span: Span | None, *, t: float | None = None,
            attrs: dict[str, Any] | None = None) -> None:
        """Close ``span``, and the profiler range it holds open."""
        if span is None:
            return
        with self._lock:
            live = self._ranges.pop(span.span_id, None)
        if live is not None:
            live.__exit__(None, None, None)
        # Span fields are single-writer by construction — the thread
        # that starts a span is the only one that ends it — and readers
        # on other threads only ever see (a) ring entries AFTER this
        # write completes (published through the recorder's lock) or
        # (b) lock-guarded COPIES of still-open spans (active_spans).
        # The lockset model cannot express that handoff, hence the
        # waivers (same shape as the informer pump() waiver).
        with self._lock:
            span.end = self.clock() if t is None else t  # analysis: allow=TAR503 single-writer; published via recorder/active_spans locks
            if attrs:
                span.attrs.update(attrs)  # analysis: allow=TAR503 single-writer; published via recorder/active_spans locks
            self._active.pop(span.span_id, None)
        if self.recorder is not None:
            self.recorder.record_span(span)

    def record(self, name: str, *, start: float, end: float,
               trace_id: str | None = None, parent: Span | None = None,
               attrs: dict[str, Any] | None = None) -> Span:
        """Emit a retroactive span with explicit start/end — how a
        reconcile pass's shared observe/plan timings land in each served
        gang's trace after the fact.  It opens no profiler range."""
        span = self.start(name, trace_id=trace_id, parent=parent, t=start,
                          attrs=attrs)
        self.end(span, t=end)
        return span

    def annotate(self, span: Span | None, **attrs: Any) -> None:
        """Attach attrs to a still-open span, under the tracer lock —
        the only safe way to decorate a span that ``active_spans()``
        may be copying concurrently (e.g. from the /debugz thread)."""
        if span is None:
            return
        with self._lock:
            span.attrs.update(attrs)

    def event(self, span: Span | None, name: str,
              attrs: dict[str, Any] | None = None,
              t: float | None = None) -> None:
        """Append a point-in-time event (e.g. a retry) to ``span``.
        Single-writer contract: call only from the thread that owns the
        span."""
        if span is None:
            return
        span.events.append({"name": name,
                            "t": self.clock() if t is None else t,
                            **(attrs or {})})

    def event_current(self, name: str,
                      attrs: dict[str, Any] | None = None) -> None:
        """Event on the context's current span (no-op outside a span —
        notably on executor worker threads, where the context var is
        deliberately unset)."""
        self.event(_CURRENT.get(), name, attrs)

    # -- context ----------------------------------------------------------

    @contextlib.contextmanager
    def use(self, span: Span | None) -> Iterator[Span | None]:
        """Make ``span`` the context's current span for the block."""
        token = _CURRENT.set(span)
        try:
            yield span
        finally:
            _CURRENT.reset(token)

    # -- introspection ----------------------------------------------------

    def active_spans(self) -> list[Span]:
        """Lock-guarded COPIES of still-open spans (the "what is the
        pass stuck on" view): the owning thread may end the originals
        at any moment, so readers never touch the live objects."""
        with self._lock:
            return [dataclasses.replace(s, attrs=dict(s.attrs),
                                        events=list(s.events))
                    for s in self._active.values()]


#: What :func:`maybe_span` returns without a tracer: a context that
#: does nothing and yields None (stateless, so one serves every seam).
_NO_SPAN = contextlib.nullcontext()


def maybe_span(tracer: Tracer | None, name: str,
               attrs: dict[str, Any] | None = None):
    """Span-if-traced: the pattern for optional instrumentation seams
    (the port's serving tick and train step).  ``tracer=None`` costs
    one ``if`` and hands back a shared do-nothing context.  With a
    tracer the span is live (a profiler range too, while one records)
    and made current, so nested seams attach to it; an exception is
    recorded on the span and re-raised."""
    if tracer is None:
        return _NO_SPAN
    return _live_span(tracer, name, attrs)


@contextlib.contextmanager
def _live_span(tracer: Tracer, name: str,
               attrs: dict[str, Any] | None) -> Iterator[Span]:
    span = tracer.start(name, attrs=attrs)
    with tracer.use(span):
        try:
            yield span
        except Exception as e:
            tracer.end(span, attrs={"error": f"{e.__class__.__name__}: {e}"})
            raise
        else:
            tracer.end(span)
