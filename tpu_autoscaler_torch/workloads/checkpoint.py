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

The counterpart of the JAX package's ``workloads/checkpoint.py``.  The
drain half is a copy; the JAX trainer's orbax checkpoints are replaced
by the port's own ``step_N/`` directories: ``params.npz`` in exactly
the layout of ``model.save_params`` (which ``serve`` and ``generate``
read) and ``opt.npz``, the optimizer state (``model.Optimizer``), each
written into a temporary directory renamed into place, so
``latest_step`` never sees half a checkpoint.  The training loop,
``train_until_drained``, is the JAX package's line for line.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Mapping

import numpy as np
import torch

from tpu_autoscaler_torch.workloads.model import (
    _flatten,
    _unflatten,
    load_params,
    resolve_device,
)

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


# ---- step_N checkpoint io -----------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place changes cannot reach."""
    return t.detach().to("cpu", copy=True).numpy()


def snapshot(state: Mapping) -> dict[str, dict[str, np.ndarray]]:
    """The trainer state ``{"params": tree, "opt": optimizer state}`` as
    host arrays per file: ``params`` keyed by '/'-joined tree path (the
    layout of ``model.save_params``), ``opt`` the same with the int
    counts as 0-d int64 arrays."""
    opt: dict[str, np.ndarray] = {}
    for key, value in state["opt"].items():
        if isinstance(value, dict):
            opt.update({f"{key}/{path}": _host(t)
                        for path, t in _flatten(value)})
        else:
            opt[key] = np.asarray(value, dtype=np.int64)
    return {"params": {path: _host(t)
                       for path, t in _flatten(state["params"])},
            "opt": opt}


def write_step(directory: str, step: int,
               files: Mapping[str, Mapping[str, np.ndarray]]) -> str:
    """Write ``<directory>/step_<step>/<name>.npz`` for each of
    ``files`` into a temporary directory renamed into place; an earlier
    checkpoint of the same step is replaced.  Returns the step dir."""
    final = os.path.join(os.path.abspath(directory), f"step_{step}")
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, arrays in files.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
    old = None
    if os.path.exists(final):
        old = f"{final}.old-{os.getpid()}"
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def save_checkpoint(directory: str, step: int, state) -> str:
    """Save the trainer state (blocking); returns the checkpoint path."""
    return write_step(directory, step, snapshot(state))


def restore_checkpoint(directory: str, step: int, device=None) -> dict:
    """The state :func:`save_checkpoint` wrote at ``step``, on
    ``device``: ``{"params": tree, "opt": optimizer state}``."""
    dev = resolve_device(device)
    path = os.path.join(os.path.abspath(directory), f"step_{step}",
                        "opt.npz")
    opt: dict = {}
    trees: dict[str, dict] = {}
    with np.load(path) as npz:
        for key in npz.files:
            name, _, rest = key.partition("/")
            if rest:
                trees.setdefault(name, {})[rest] = \
                    torch.from_numpy(npz[key]).to(dev)
            else:
                opt[key] = int(npz[key])
    opt.update({name: _unflatten(flat) for name, flat in trees.items()})
    return {"params": load_params(directory, step, dev), "opt": opt}


class AsyncCheckpointWriter:
    """Overlap checkpoint writes with training steps.

    ``save`` waits for the previous write (re-raising its error), copies
    the state to the host, hands the files to one background thread and
    returns; the train loop keeps stepping during the disk write.
    ``wait()`` blocks until the last write lands and re-raises its
    error; call it before a drain exit or process shutdown so the final
    checkpoint is durable.
    """

    def __init__(self):
        self._pool: ThreadPoolExecutor | None = None
        self._pending: Future | None = None

    def _finish_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def save(self, directory: str, step: int, state) -> str:
        self._finish_pending()
        files = snapshot(state)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-writer")
        self._pending = self._pool.submit(write_step, directory, step,
                                          files)
        return os.path.join(os.path.abspath(directory), f"step_{step}")

    def wait(self) -> None:
        try:
            self._finish_pending()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


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


def train_until_drained(step_fn: Callable, state, num_steps: int,
                        watcher: DrainWatcher, checkpoint_dir: str,
                        make_batch: Callable[[int], object],
                        start_step: int = 0,
                        checkpoint_every: int | None = None,
                        on_step: Callable[[int, object], None]
                        | None = None,
                        save_fn: Callable[[str, int, object], object]
                        | None = None) -> tuple[object, int, bool]:
    """Training loop honoring the drain contract.

    Returns ``(state, steps_done, drained)``; saves a checkpoint and stops
    early when the watcher fires, and every ``checkpoint_every`` steps when
    set.  ``on_step(step, state)`` is a logging/metrics hook.  The loop
    (poll between steps, save, exit cleanly) is THE drain-contract loop —
    tpu_autoscaler_torch.workloads.train drives this same function, so
    fixes to the semantics land everywhere at once.
    """
    save = save_fn or save_checkpoint
    step = start_step
    while step < num_steps:
        if watcher.drain_requested():
            save(checkpoint_dir, step, state)
            return state, step, True
        state = step_fn(state, make_batch(step))
        step += 1
        if checkpoint_every and step % checkpoint_every == 0 \
                and step != num_steps:
            save(checkpoint_dir, step, state)
        if on_step is not None:
            on_step(step, state)
    save(checkpoint_dir, step, state)
    return state, step, False
