"""In-process tracing for the detection→actuation path.

The north-star metric (``scale_up_latency_seconds``) is a single opaque
summary; when a scale-up is slow nothing says whether the time went to
observation, planning, dispatch, cloud provisioning, node registration
or scheduler binding.  This module is the missing decomposition: a
dependency-free tracer whose spans mirror OpenTelemetry's shape (name,
trace_id, span_id, parent, start/end, attrs, events) without the SDK —
the controller must not grow a third-party runtime dep for its own
introspection.

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
- **metrics**: ending a span with ``metric=`` feeds the duration (or an
  explicit ``value``) into the wired :class:`Metrics` registry — the
  phase histograms (reconciler.PHASE_LATENCY_METRICS) are fed by the
  same span ends that build the trace, so the two can never disagree.

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


class Tracer:
    """Span factory + sink.  ``recorder=None`` still produces spans (so
    trace ids propagate and ``metric=`` feeds still fire) but retains
    nothing — the zero-retention mode the overhead bench compares
    against is ``tracer=None`` at each instrumentation seam, which
    skips span work entirely."""

    def __init__(self, recorder: Any = None, metrics: Any = None,
                 clock: Any = time.time) -> None:
        self.recorder = recorder
        self._metrics = metrics
        self.clock = clock
        self._lock = concurrency.Lock()
        self._active: dict[str, Span] = {}
        self._seq = 0
        self._trace_seq = 0
        # Distinguishes traces across controller restarts in aggregated
        # log stores (trace ids repeat their counter after a crash-only
        # restart; the run id keeps them globally unique).
        self._run_id = uuid.uuid4().hex[:6]  # analysis: allow=TAD902 the run id exists to be unique ACROSS restarts BY DESIGN (see comment above); replay oracles compare span structure and attribution, never trace-id bytes

    # -- wiring -----------------------------------------------------------

    def bind_metrics(self, metrics: Any) -> None:
        """Adopt a metrics registry if none was injected (the Controller
        calls this so ``metric=`` span feeds land in ITS registry)."""
        with self._lock:
            if self._metrics is None:
                self._metrics = metrics

    # -- ids --------------------------------------------------------------

    def new_trace(self, prefix: str = "trace") -> str:
        with self._lock:
            self._trace_seq += 1
            return f"{prefix}-{self._run_id}-{self._trace_seq}"

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    # -- span lifecycle ---------------------------------------------------

    def start(self, name: str, *, trace_id: str | None = None,
              parent: Span | None = None, t: float | None = None,
              attrs: dict[str, Any] | None = None) -> Span:
        """Open a span.  Parent defaults to the context's current span;
        trace_id defaults to the parent's (or a fresh anonymous one)."""
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
        with self._lock:
            self._active[span.span_id] = span
        return span

    def end(self, span: Span | None, *, t: float | None = None,
            attrs: dict[str, Any] | None = None,
            metric: str | None = None,
            value: float | None = None) -> None:
        """Close ``span``; with ``metric=`` also observe its duration
        (or the explicit ``value``) on the wired metrics registry —
        the phase-histogram feed."""
        if span is None:
            return
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
            metrics = self._metrics
        if metric is not None and metrics is not None:
            metrics.observe(
                metric, value if value is not None else (span.duration or 0.0))
        if self.recorder is not None:
            self.recorder.record_span(span)

    def record(self, name: str, *, start: float, end: float,
               trace_id: str | None = None, parent: Span | None = None,
               attrs: dict[str, Any] | None = None,
               metric: str | None = None,
               value: float | None = None) -> Span:
        """Emit a retroactive span with explicit start/end — how a
        reconcile pass's shared observe/plan timings land in each served
        gang's trace after the fact."""
        span = self.start(name, trace_id=trace_id, parent=parent, t=start,
                          attrs=attrs)
        self.end(span, t=end, metric=metric, value=value)
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


@contextlib.contextmanager
def maybe_span(tracer: Tracer | None, name: str,
               attrs: dict[str, Any] | None = None) -> Iterator[Span | None]:
    """Span-if-traced: the pattern for optional instrumentation seams
    (actuators, informer).  ``tracer=None`` costs one ``if`` — the
    untraced baseline the overhead gate (bench.py trace) holds the
    traced path to.  The span is also made current, so nested calls
    (and log records) attach to it; an exception is recorded on the
    span and re-raised."""
    if tracer is None:
        yield None
        return
    span = tracer.start(name, attrs=attrs)
    with tracer.use(span):
        try:
            yield span
        except Exception as e:
            tracer.end(span, attrs={"error": f"{e.__class__.__name__}: {e}"})
            raise
        else:
            tracer.end(span)
