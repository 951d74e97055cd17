"""Checkpoint-aware drain: the job-side contract.

The controller reclaims slices by annotating workload pods with
``autoscaler.tpu.dev/checkpoint-requested`` and waiting a drain grace
period before force eviction.  A job that wants graceful preemption
runs a ``DrainWatcher``:

- the pod mounts its own annotations via the downward API
  (``/etc/podinfo/annotations``, the standard ``key="value"`` lines format);
- between steps the job calls ``watcher.drain_requested()``;
- on True a server stops admitting and finishes its in-flight requests,
  well inside the drain window.

A copy of the framework-free half of the JAX package's
``workloads/checkpoint.py``.  The port's own parameter checkpoints
(``step_N/params.npz``) are written by ``model.save_params``;
``latest_step`` finds them with the same semantics as the trainer's.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Mapping

log = logging.getLogger(__name__)

CHECKPOINT_ANNOTATION = "autoscaler.tpu.dev/checkpoint-requested"
DEFAULT_ANNOTATIONS_PATH = "/etc/podinfo/annotations"


def parse_downward_annotations(text: str) -> dict[str, str]:
    """Parse the downward-API annotations file (``key="escaped value"``)."""
    out: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        if value.startswith('"') and value.endswith('"') and len(value) >= 2:
            value = value[1:-1].encode().decode("unicode_escape")
        out[key.strip()] = value
    return out


class DrainWatcher:
    """Polls a source of pod annotations for the checkpoint request.

    ``source`` is either a path to a downward-API annotations file or a
    callable returning the annotation dict (tests, or a kube-API poller).
    """

    def __init__(self,
                 source: str | Callable[[], Mapping[str, str]]
                 = DEFAULT_ANNOTATIONS_PATH,
                 min_poll_interval: float = 2.0):
        self._source = source
        self._min_interval = min_poll_interval
        self._last_poll = 0.0
        self._cached = False

    def _annotations(self) -> Mapping[str, str]:
        if callable(self._source):
            return self._source()
        try:
            with open(self._source) as f:
                return parse_downward_annotations(f.read())
        except OSError:
            return {}

    def drain_requested(self) -> bool:
        """Cheap enough to call every engine tick (rate-limited poll)."""
        now = time.monotonic()
        if self._cached or now - self._last_poll < self._min_interval:
            return self._cached
        self._last_poll = now
        self._cached = CHECKPOINT_ANNOTATION in self._annotations()
        if self._cached:
            log.info("drain requested via %s annotation",
                     CHECKPOINT_ANNOTATION)
        return self._cached


def latest_step(directory: str) -> int | None:
    """Largest completed step in the checkpoint dir.

    Tolerates atomic-save leftovers (``step_N.<suffix>`` from a save
    interrupted by preemption) and any other non-numeric entries.
    """
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = []
    for name in names:
        if not name.startswith("step_"):
            continue
        suffix = name[len("step_"):]
        if suffix.isdigit():
            steps.append(int(suffix))
    return max(steps) if steps else None
