"""The traced sub-window: ``torch.profiler`` over a few steady steps or
ticks, reduced in memory to what the per-layer readers and the result's
``breakdown`` need.  Nothing is written to disk.

Host-side regions are marked with :func:`region` (a profiler range
named ``perfbench.<name>``): the harness's own calls into the program.
The device's busy time is the union of its kernel, copy and set
intervals over the window (:mod:`metrics._arith`), and each idle gap is
put down to what the host was doing when it opened: the innermost host
event then, under the innermost ``perfbench`` region.
"""

from __future__ import annotations

import heapq

from perfbench.metrics import _arith

PREFIX = "perfbench."
WINDOW = PREFIX + "window"


def region(name: str):
    """A profiler range around a call into the program; a plain context
    when the profiler is off costs a few microseconds."""
    import torch

    return torch.profiler.record_function(PREFIX + name)


def _device_us(evt) -> float:
    return float(evt.device_time_total or 0.0)


def _on_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA")


def _is_device(evt) -> bool:
    """A kernel, copy or set on the device; not the device-side shadow
    of a host range (a user annotation), which runs nothing."""
    return _on_device(evt) and not evt.name.startswith(PREFIX) \
        and not getattr(evt, "is_user_annotation", False)


def profile(torch, work) -> dict:
    """Run ``work()`` under the profiler and reduce the trace: the
    window's seconds, the device's busy seconds, every device interval
    ``(name, start_us, end_us)``, per ``perfbench`` region its count and
    the device seconds of the kernels launched under it, and the
    breakdown (top device classes, idle gaps by host activity)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            work()
            torch.cuda.synchronize()
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW)
    lo, hi = win.time_range.start, win.time_range.end
    device = [(e.name, e.time_range.start, e.time_range.end)
              for e in events if _is_device(e)
              and e.time_range.end > lo and e.time_range.start < hi]
    intervals = [(s, e) for _, s, e in device]
    busy_us = _arith.busy(intervals, lo, hi)
    regions: dict[str, dict] = {}
    for e in events:
        if e.name.startswith(PREFIX) and e.name != WINDOW \
                and not _on_device(e):
            r = regions.setdefault(e.name[len(PREFIX):],
                                   {"count": 0, "device_s": 0.0})
            r["count"] += 1
            r["device_s"] += _device_us(e) / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _on_device(e) and e.name != WINDOW
            and e.time_range.end > lo and e.time_range.start < hi]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "device": device, "regions": regions,
            "top_kernels": _top(device, 30),
            "breakdown": {"device_ops": _top(device),
                          "idle_gaps": _idle_by_host(
                              _arith.gaps(intervals, lo, hi), host)}}


def short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0][:80]


def _top(device, n: int = 10) -> list:
    """Device seconds by operation (``<class>: <kernel>``), largest
    first."""
    totals: dict[str, float] = {}
    for name, s, e in device:
        key = f"{device_class(name)}: {short_name(name)}"
        totals[key] = totals.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            ][:n]


_FAMILIES = (("K4 paged_decode_kernel", "paged_decode_kernel"),
             ("K3 flash_decode_kernel", "flash_decode_kernel"),
             ("K1 fwd_tc_kernel", "fwd_tc_kernel"),
             ("K2 bwd_dq_tc_kernel", "bwd_dq_tc_kernel"),
             ("K2 bwd_dkv_tc_kernel", "bwd_dkv_tc_kernel"))


def device_class(name: str) -> str:
    """A device interval's class for the breakdown: the program's
    kernels by family, else the frozen KERNEL_CLASSES, else a coarse
    split of PyTorch's own kernels."""
    for label, pattern in _FAMILIES:
        if pattern in name:
            return label
    cls = _arith.kernel_class(name)
    if cls != "other":
        return cls
    for label, pattern in (("index/scatter", ("index", "scatter", "gather")),
                           ("softmax", ("softmax",)),
                           ("elementwise", ("elementwise", "vectorized",
                                            "unrolled")),
                           ("set", ("Memset", "fill"))):
        if any(p in name for p in pattern):
            return label
    return "other"


def _idle_by_host(idle, host, n: int = 10) -> list:
    """Idle device seconds by what the host was doing as each gap
    opened: ``<region> / <innermost host event>``, largest first."""
    host = sorted(host)
    totals: dict[str, float] = {}
    active: list = []          # heap of (end, start, name)
    i = 0
    for g0, g1 in idle:
        while i < len(host) and host[i][0] <= g0:
            heapq.heappush(active, (host[i][1], host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] <= g0:
            heapq.heappop(active)
        inner = max(active, key=lambda a: a[1], default=None)
        outer = max((a for a in active if a[2].startswith(PREFIX)),
                    key=lambda a: a[1], default=None)
        parts = [a[2] for a in (outer, inner) if a is not None]
        label = " / ".join(dict.fromkeys(parts)) or "no host event"
        totals[label] = totals.get(label, 0.0) + (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            ][:n]
