"""The program's own spans (``tpu_autoscaler_torch.obs.trace``: the
serving tick's ``serve.*`` tree and the train step's ``train.*``) for
the per-layer metrics that read them.

- :class:`Sink`, the recorder of the ``Tracer`` a driver hands the
  engine (``PagedBatcher(..., tracer=Tracer(recorder=sink))``) or the
  step (``make_train_step(..., tracer=...)``): per bucket it keeps each
  span name's count and seconds, and every ``serve.request.prefill``
  span's attrs; the driver puts ``sink.buckets`` in the record under
  ``program``.
- :func:`program_ranges`, the reduction of a profiled window's events
  to each program range's count, host seconds and the device seconds
  of the work it launched; :mod:`perfbench.trace` puts it in the
  profile under ``programs``.
- :func:`tick_split` and :func:`device_ms`, the arithmetic of the
  readers in ``metrics/``.

The program opens its spans only when handed a tracer, so a record
without these keys (a program or a driver that hands none) gives the
readers nothing to read: they return None.
"""

from __future__ import annotations

import heapq

import numpy as np

PREFIXES = ("serve.", "train.")
#: Span names whose time a tick spends issuing the step functions, and
#: waiting for the device.
STEPS = ("serve.prefill.step", "serve.decode.step")
SYNC = "serve.sync"
#: Names of host ranges, the program's and the harness's own, whose
#: device-side shadows are no work.
SHADOWS = PREFIXES + ("perfbench.",)
#: The CUDA runtime's and driver's calls, which launch the device work
#: that carries their correlation id.
RUNTIME = ("cuda", "cu")


class Sink:
    """A tracer's recorder.  While ``bucket`` names one (``"window"``,
    ``"profile"``), each span that ends counts in ``buckets[bucket]``:
    ``{"spans": {name: {"count", "s"}}, "requests": [attrs of each
    serve.request.prefill]}``; with ``bucket`` None (set-up) it is
    dropped."""

    def __init__(self) -> None:
        self.bucket: str | None = None
        self.buckets: dict[str, dict] = {}

    def record_span(self, span) -> None:
        if self.bucket is None:
            return
        into = self.buckets.setdefault(self.bucket,
                                       {"spans": {}, "requests": []})
        row = into["spans"].setdefault(span.name, {"count": 0, "s": 0.0})
        row["count"] += 1
        row["s"] += span.end - span.start
        if span.name == "serve.request.prefill":
            into["requests"].append(dict(span.attrs))


def program_ranges(events, prefixes=PREFIXES) -> dict:
    """``{name: {"count", "host_s", "device_s"}}`` for every program
    range (a span named with one of ``prefixes``, opened while the
    profiler recorded) among ``events``, the profiler's
    ``prof.profiler.kineto_results.events()``.  Each kernel, copy or set
    counts under the innermost program range whose host interval holds
    the runtime call that launched it (the ``cuda*`` or ``cu*`` call
    with its correlation id), on any thread: ``torch.autograd.grad``
    launches the backward from the autograd engine's thread, where the
    range opened on the main thread has no children, and a kernel
    launched through ``ctypes`` has no op to be linked to."""
    ranges, launches, device = [], {}, []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            # A range's device-side shadow runs nothing.
            if not e.is_user_annotation() and not name.startswith(SHADOWS):
                device.append((e.correlation_id(), e.duration_ns() / 1e9))
        elif name.startswith(RUNTIME):
            launches[e.correlation_id()] = e.start_ns() / 1e9
        elif name.startswith(prefixes):
            ranges.append((e.start_ns() / 1e9, e.end_ns() / 1e9, name))
    return attribute(ranges, [(launches[corr], spent)
                              for corr, spent in device if corr in launches])


def attribute(ranges, launched) -> dict:
    """``ranges`` ``(start, end, name)`` and ``launched`` ``(at,
    device seconds)``, in seconds: per range name its count, host
    seconds and the device seconds launched inside it and inside no
    range that starts later (the innermost)."""
    out: dict[str, dict] = {}
    for start, end, name in ranges:
        row = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                    "device_s": 0.0})
        row["count"] += 1
        row["host_s"] += end - start
    ranges = sorted(ranges)
    active: list = []          # heap of (end, start, name)
    i = 0
    for at, spent in sorted(launched):
        while i < len(ranges) and ranges[i][0] <= at:
            heapq.heappush(active, (ranges[i][1], ranges[i][0],
                                    ranges[i][2]))
            i += 1
        while active and active[0][0] <= at:
            heapq.heappop(active)
        if active:
            out[max(active, key=lambda a: a[1])[2]]["device_s"] += spent
    return out


def tick_split(record, bucket: str = "window") -> dict | None:
    """The mean tick of ``bucket`` split three ways, in ms: ``launch``
    (the step calls), ``sync`` (waiting for the device) and ``host``
    (the rest of ``serve.tick``: the scheduler's own time); None
    without ticks."""
    spans = record.get("program", {}).get(bucket, {}).get("spans", {})
    ticks = spans.get("serve.tick")
    if not ticks or not ticks["count"]:
        return None

    def total(name):
        return spans.get(name, {}).get("s", 0.0)

    launch = sum(total(name) for name in STEPS)
    sync = total(SYNC)
    per = 1e3 / ticks["count"]
    return {"host": (ticks["s"] - launch - sync) * per,
            "launch": launch * per, "sync": sync * per}


def lane_wait_p95_ms(record, bucket: str = "window") -> float | None:
    """The 95th percentile of the lane wait of the requests seeded in
    ``bucket``, in ms; None without one."""
    waits = [r["lane_wait_s"] for r in record.get("program", {})
             .get(bucket, {}).get("requests", [])]
    return 1e3 * float(np.percentile(waits, 95)) if waits else None


def device_ms(record, name: str, *inner: str) -> float | None:
    """Device ms a ``name`` range of the profiled window, of the work
    launched under it and under the ranges ``inner`` it holds; None
    where it launched nothing."""
    ranges = (record.get("profile") or {}).get("programs", {})
    row = ranges.get(name)
    if not row or not row["count"]:
        return None
    spent = row["device_s"] + sum(ranges.get(n, {}).get("device_s", 0.0)
                                  for n in inner)
    return 1e3 * spent / row["count"] if spent > 0 else None
