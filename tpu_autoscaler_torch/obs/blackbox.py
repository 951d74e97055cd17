"""Black-box incident capture: when something goes wrong,
keep the evidence.

A production incident used to leave only whatever happened to still be
in the bounded rings by the time a human looked.  The black box flips
that: the moment an alert FIRES (or on operator demand — SIGUSR1, the
``/debugz`` surfaces), the controller atomically dumps a
self-contained **incident bundle**: the flight-recorder dump (spans,
decision records, still-open spans), the metrics snapshot, the TSDB
windows behind the alert verdict, the alert engine's rules + state,
informer store digests, policy/serving debug state, and a config
summary.  ``python -m tpu_autoscaler.obs replay <bundle>`` then
re-renders the traces and re-evaluates the alert rules offline — any
chaos seed or production incident becomes a deterministic artifact.

Write discipline:

- **atomic**: the bundle is written to ``<name>.tmp`` and
  ``os.replace``d into place — a reader never sees a half bundle;
- **unique**: names carry a UTC timestamp, the pid and a monotonic
  counter, so two captures in the same second never clobber each
  other (the bug the SIGUSR1 dump path had — fixed alongside);
- **bounded**: at most ``max_bundles`` are retained; older ones are
  pruned oldest-first.  Capture is rate-limited (``min_interval``)
  per *reason* so a flapping alert cannot fill a disk;
- **crash-only**: a failing capture logs and counts, never takes a
  pass down.

Captures NEVER run on the reconcile thread: the alert-fire path
schedules them onto a throwaway thread (``capture_async``) just like
SIGUSR1 — building and serializing a full bundle is
O(series × retained points) and would stall the control loop exactly
during the incident it is documenting.  Every read a capture performs
goes through the guarded read paths (recorder lock, TSDB seqlock,
bounded-retry copies), so a capture can never deadlock the controller
either; BlackBox's own bookkeeping is lock-guarded because the writer
thread and the scheduler share it.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Any, Callable

from tpu_autoscaler_torch import concurrency

log = logging.getLogger(__name__)

#: Bundle format version (bumped on breaking layout changes; the
#: replay CLI refuses versions it does not know).
BUNDLE_VERSION = 1

_counter = itertools.count(1)


def unique_dump_path(prefix: str, now: float | None = None,
                     ext: str = ".json") -> str:
    """A dump path that is unique even for same-second captures:
    UTC timestamp + pid + process-lifetime counter."""
    now = time.time() if now is None else now
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
    return f"{prefix}-{stamp}-{os.getpid()}-{next(_counter):04d}{ext}"


def write_atomic(path: str, body: dict[str, Any]) -> str:
    """JSON-dump ``body`` to ``path`` atomically (tmp + rename).
    ``allow_nan=False``: an ``inf`` anywhere in a bundle is a bug and
    must fail at capture time, not in a strict parser later.  A
    FAILED write unlinks its tmp before re-raising: captures retry on
    the next firing (the rate-limit slot is only consumed by
    success), and uniquely-named half-written tmps would otherwise
    accumulate outside ``_prune``'s ``.json`` filter — an unbounded
    disk leak exactly when disk pressure is likeliest."""
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f, indent=2, default=str, allow_nan=False)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    return path


class BlackBox:
    """Incident-bundle writer.  ``bundle_fn`` is the zero-arg producer
    (``Controller.incident_bundle``); everything else is file and
    thread discipline.  ``metrics``: optional registry — a successful
    capture counts ``incident_bundles_written``, wherever it ran."""

    def __init__(self, directory: str,
                 bundle_fn: Callable[[], dict[str, Any]],
                 clock: Callable[[], float] = time.time,
                 min_interval_seconds: float = 300.0,
                 max_bundles: int = 16,
                 prefix: str = "tpu-autoscaler-incident",
                 metrics: Any = None) -> None:
        self.directory = directory
        self.bundle_fn = bundle_fn
        self.clock = clock
        self.min_interval_seconds = min_interval_seconds
        self.max_bundles = max_bundles
        self.prefix = prefix
        self.metrics = metrics
        # Shared between the scheduling (reconcile) thread and the
        # throwaway writer threads.
        self._lock = concurrency.Lock()
        self._last_capture: dict[str, float] = {}
        self._in_flight: set[str] = set()
        self.captured = 0
        self.errors = 0

    def _limited(self, reason: str, now: float) -> bool:
        last = self._last_capture.get(reason)
        return (last is not None
                and now - last < self.min_interval_seconds)

    def capture(self, reason: str, force: bool = False) -> str | None:
        """Write one bundle SYNCHRONOUSLY (operator/SIGUSR1/test
        paths — never call from the reconcile thread; the alert-fire
        path uses ``capture_async``).  Returns the path, or None when
        rate-limited or failed.  ``force`` bypasses the rate limit."""
        now = self.clock()
        with self._lock:
            if not force and self._limited(reason, now):
                log.debug("incident capture for %r rate-limited",
                          reason)
                return None
        # The rate-limit slot is consumed only by a SUCCESSFUL write
        # (below): a transient failure (disk full, unwritable dir)
        # must not suppress the retry for min_interval — the one
        # artifact the black box exists to preserve would be lost
        # exactly during the incident.
        try:
            body = dict(self.bundle_fn())
            body.setdefault("bundle", {}).update(
                {"version": BUNDLE_VERSION, "reason": reason,
                 "captured_at": now})
            os.makedirs(self.directory, exist_ok=True)
            path = unique_dump_path(
                os.path.join(self.directory, self.prefix), now=now)
            write_atomic(path, body)
            with self._lock:
                self._last_capture[reason] = now
                self.captured += 1
            if self.metrics is not None:
                self.metrics.inc("incident_bundles_written")
            log.warning("incident bundle (%s) written to %s", reason,
                        path)
            self._prune()
            return path
        except Exception:  # noqa: BLE001 — diagnostics must not kill
            with self._lock:
                self.errors += 1
            log.exception("incident capture for %r failed", reason)
            return None

    def capture_async(self, reason: str) -> bool:
        """Schedule a capture on a throwaway thread (the alert-fire
        path): building + serializing a bundle is O(series × retained
        points) and must never stall a reconcile pass.
        Returns True when scheduled; False when rate-limited or a
        capture for the same reason is still in flight."""
        now = self.clock()
        with self._lock:
            if reason in self._in_flight or self._limited(reason, now):
                return False
            self._in_flight.add(reason)

        def _run() -> None:
            try:
                self.capture(reason)
            finally:
                with self._lock:
                    self._in_flight.discard(reason)

        concurrency.Thread(target=_run, daemon=True,
                           name="incident-capture").start()
        return True

    def _prune(self) -> None:
        try:
            mine = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith(self.prefix) and n.endswith(".json"))
            for name in mine[:-self.max_bundles]:
                os.unlink(os.path.join(self.directory, name))
        except OSError:
            log.debug("incident-bundle prune failed", exc_info=True)


def load_bundle(path: str) -> dict[str, Any]:
    """Read + version-check one bundle (the replay CLI's loader).
    Plain flight-recorder dumps (no ``bundle`` key) load too — the
    replay degrades to trace rendering without alert re-evaluation."""
    with open(path, encoding="utf-8") as f:
        body = json.load(f)
    meta = body.get("bundle")
    if meta is not None and meta.get("version", 0) > BUNDLE_VERSION:
        raise ValueError(
            f"bundle {path!r} has version {meta.get('version')}; this "
            f"build reads <= {BUNDLE_VERSION}")
    return body
