"""Threading seam: one place the control plane's primitives come from.

Like ``backoff.py`` for retry arithmetic, this is drift-prone plumbing
centralized: every concurrent subsystem (k8s/informer.py watch threads,
controller/watch.py, actuators/executor.py's worker pool, gcp.py's
TokenProvider, the metrics registry, FakeKube's watch condition)
constructs its threads and synchronization primitives HERE instead of
reaching for ``threading`` directly.

In production the seam is a 1:1 pass-through to ``threading`` /
``concurrent.futures`` — zero behavior change, zero overhead beyond one
attribute read.  Under test, the deterministic-schedule harness
(``tpu_autoscaler/testing/sched.py``) installs a scheduler here; every
primitive constructed while it is active is scheduler-controlled, which
is what lets the harness serialize execution, permute interleavings at
sync points, and run its vector-clock happens-before checker over the
real informer/executor/reconciler code paths (docs/ANALYSIS.md).

Module-level primitives created at import time (e.g. the parse-memo
lock in ``k8s/objects.py``) deliberately stay on raw ``threading``: they
outlive any one scheduler activation, and a scheduler-owned primitive
must never escape its scheduler's lifetime.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import threading as _threading
from typing import Any, Optional

#: The active deterministic scheduler, or None (production).  Installed
#: only by tpu_autoscaler/testing/sched.py; never set in production.
_scheduler: Any = None

#: The active lock-order witness, or None (production).  Installed only
#: by the race tier (tests/test_lockwitness.py); never set in
#: production — the seam stays a zero-overhead pass-through there.
_witness: "LockOrderWitness | None" = None

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(filename: str) -> str:
    return os.path.relpath(filename, _REPO_ROOT).replace(os.sep, "/")


def _external_site() -> tuple[str, int]:
    """File:line of the nearest frame OUTSIDE this module — where a
    primitive was constructed or acquired."""
    f: Any = sys._getframe(1)
    here = f.f_code.co_filename
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:                     # pragma: no cover — defensive
        return ("<unknown>", 0)
    return (_rel(f.f_code.co_filename), f.f_lineno)


class LockOrderWitness:
    """Runtime half of the TAL7xx lock-order analysis
    (tpu_autoscaler/analysis/lockorder.py, docs/ANALYSIS.md).

    While installed (``install_witness`` — test harness only), every
    Lock/RLock/Condition constructed through this seam is wrapped so
    each acquisition records, per acquiring thread, the order edges
    (already-held → acquired).  Locks are keyed by their CREATION SITE
    (file:line of the construction call) — the same identity the
    static pass carries on its graph nodes (``ClassInfo.attr_sites`` /
    ``ModuleInfo.global_sites``), which is what lets the race tier
    join the two graphs: a witnessed edge between two package locks
    that is absent from the static order graph means the static pass
    has a blind spot (an unresolved call edge hiding a nested
    acquisition), and ``analysis.lockorder.witness_gaps`` turns it
    into a race-tier failure instead of silent under-reporting.

    Thread-safety: held stacks are thread-local; the shared edge map
    is guarded by a raw (never-witnessed, never-scheduled) lock.
    """

    def __init__(self) -> None:
        #: (held site, acquired site) -> file:line of the acquisition
        #: that created the edge (the witness's evidence).
        self.edges: dict[tuple[tuple[str, int], tuple[str, int]],
                         tuple[str, int]] = {}
        #: Every creation site that constructed a primitive while this
        #: witness was installed — the coverage set cross-check tests
        #: assert against (a run that witnessed nothing proves nothing).
        self.sites: set[tuple[str, int]] = set()
        self._tls = _threading.local()
        self._mu = _threading.Lock()

    # -- registration (called by the seam constructors) -------------------

    def register(self, site: tuple[str, int]) -> None:
        with self._mu:
            self.sites.add(site)

    # -- acquisition bookkeeping (called by _WitnessedLock) ---------------

    def _stack(self) -> list[tuple[str, int]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st  # analysis: allow=TAT201 threading.local IS the isolation: every thread reads/writes only its own cell, no lock needed
        return st

    def note_acquired(self, site: tuple[str, int]) -> None:
        st = self._stack()
        if st:
            at = _external_site()
            with self._mu:
                for held in st:
                    if held != site:   # re-entry is TAL703's business
                        self.edges.setdefault((held, site), at)
        st.append(site)

    def note_released(self, site: tuple[str, int]) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == site:
                del st[i]
                return


class _WitnessedLock:
    """Pass-through proxy reporting acquisitions to the witness.  Wraps
    production threading primitives AND scheduler shims alike — the
    bookkeeping lives at the wrapper layer, so the scheduler's own
    deadlock/handoff modeling is untouched.  ``Condition.wait`` is
    deliberately NOT unwound from the held stack: the waiter reholds
    the lock when it returns, and no acquisition can happen on the
    waiting thread in between."""

    __slots__ = ("_inner", "_site", "_w")

    def __init__(self, inner: Any, site: tuple[str, int],
                 witness: LockOrderWitness) -> None:
        self._inner = inner
        self._site = site
        self._w = witness

    def acquire(self, *args: Any, **kwargs: Any) -> bool:
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            self._w.note_acquired(self._site)
        return bool(ok)

    def release(self) -> None:
        self._inner.release()
        self._w.note_released(self._site)

    def __enter__(self) -> "_WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.release()
        return False

    def __getattr__(self, name: str) -> Any:
        # wait/notify/locked/... delegate to the wrapped primitive.
        return getattr(self._inner, name)


def install_witness(witness: "LockOrderWitness | None") -> None:
    """Install (or, with None, remove) the lock-order witness.
    Harness-only; refuses to stack two witnesses."""
    global _witness
    if witness is not None and _witness is not None:
        raise RuntimeError("a lock-order witness is already active")
    _witness = witness


def active_witness() -> "LockOrderWitness | None":
    return _witness


def _maybe_witness(primitive: Any) -> Any:
    w = _witness
    if w is None:
        return primitive
    site = _external_site()
    w.register(site)
    return _WitnessedLock(primitive, site, w)


def install_scheduler(sched: Any) -> None:
    """Install (or, with None, remove) the deterministic scheduler.
    Harness-only; refuses to stack two schedulers."""
    global _scheduler
    if sched is not None and _scheduler is not None:
        raise RuntimeError("a deterministic scheduler is already active")
    _scheduler = sched


def active_scheduler() -> Any:
    return _scheduler


class Thread(_threading.Thread):
    """``threading.Thread`` that an active deterministic scheduler
    adopts at ``start()`` time (its ``run()`` becomes a managed,
    schedule-controlled thread); identical to ``threading.Thread``
    otherwise."""

    def start(self) -> None:
        sched = _scheduler
        if sched is not None:
            sched.adopt_thread(self)
        else:
            super().start()

    def join(self, timeout: Optional[float] = None) -> None:
        sched = _scheduler
        if sched is not None and sched.owns_thread(self):
            sched.join_thread(self)
        else:
            super().join(timeout)


def Lock():  # noqa: N802 — mirrors the threading API it stands in for
    sched = _scheduler
    return _maybe_witness(
        sched.create_lock() if sched is not None else _threading.Lock())


def RLock():  # noqa: N802
    sched = _scheduler
    return _maybe_witness(
        sched.create_rlock() if sched is not None else _threading.RLock())


def Event():  # noqa: N802
    sched = _scheduler
    return sched.create_event() if sched is not None else _threading.Event()


def Condition(lock=None):  # noqa: N802
    sched = _scheduler
    if isinstance(lock, _WitnessedLock):
        # Hand the condition the REAL primitive; the wrapper keeps
        # witnessing direct acquisitions of the lock itself.
        lock = lock._inner
    cond = (sched.create_condition(lock) if sched is not None
            else _threading.Condition(lock))
    return _maybe_witness(cond)


def pool_executor(max_workers: int, thread_name_prefix: str = ""):
    """A ``ThreadPoolExecutor``-shaped pool (``submit`` returning a
    ``concurrent.futures.Future``, ``shutdown``).  Under the harness,
    every submitted thunk runs as a managed thread so the scheduler can
    interleave worker execution with the reconcile thread."""
    sched = _scheduler
    if sched is not None:
        return sched.create_pool(max_workers)
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=thread_name_prefix)
