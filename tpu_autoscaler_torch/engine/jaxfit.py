"""Tensor-vectorized shape scoring: the fit engine's accelerated path.

The PyTorch twin of the JAX package's ``engine/jaxfit.py`` (the module
name kept so the counterpart is easy to find).  ``choose_shape_for_gang``
is O(shapes) Python per gang; at fleet scale (thousands of queued gangs
scored against the whole catalog: batch admission control, what-if
capacity planning) the same math vectorizes into one ``[gangs, shapes]``
feasibility/cost tensor, computed on the card unless the caller asks for
the CPU.

The scorer is pure tensor code (masking instead of branching), float32
throughout: the division ``cph / max(per_pod, 1)`` is IEEE on every
device, and ``torch.argmin`` returns the first minimum, so it makes
``best_shapes_np``'s decision for every gang.

Scope: scoring is over the CHIP axes (total, per-pod, host slots), the
dimensions that decide TPU shape choice in practice; the Python engine
additionally binds host cpu/memory and is authoritative when those axes
constrain.  Use this scorer for bulk triage.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from tpu_autoscaler_torch.topology.catalog import SLICE_SHAPES
from tpu_autoscaler_torch.workloads.model import resolve_device

_BIG = np.float32(1e9)


def catalog_arrays(generation: str | None = None
                   ) -> tuple[list[str], Any, Any, Any]:
    """(names, chips[S], chips_per_host[S], hosts[S]) as numpy arrays."""
    shapes = [s for s in SLICE_SHAPES.values()
              if generation is None or s.generation == generation]
    shapes.sort(key=lambda s: (s.generation, s.chips))
    names = [s.name for s in shapes]
    chips = np.array([s.chips for s in shapes], np.float32)
    cph = np.array([s.chips_per_host for s in shapes], np.float32)
    hosts = np.array([s.hosts for s in shapes], np.float32)
    return names, chips, cph, hosts


def _score_kernel(total_chips: torch.Tensor, per_pod_chips: torch.Tensor,
                  n_pods: torch.Tensor, chips: torch.Tensor,
                  cph: torch.Tensor, hosts: torch.Tensor) -> torch.Tensor:
    """Vectorized feasibility + stranded-chip cost, as plain tensor ops
    on the inputs' device.

    Inputs: per-gang demand vectors [G]; catalog vectors [S], all f32.
    Output: cost [G, S]: stranded chips, or _BIG where infeasible."""
    big = torch.tensor(_BIG, device=chips.device)
    total = total_chips[:, None]
    per_pod = per_pod_chips[:, None]
    pods = n_pods[:, None]
    slots = hosts[None, :] * torch.floor(
        torch.where(per_pod > 0, cph[None, :] / torch.clamp_min(per_pod, 1),
                    big))
    feasible = ((chips[None, :] >= total)
                & (cph[None, :] >= per_pod)
                & (slots >= pods))
    stranded = chips[None, :] - total
    return torch.where(feasible, stranded, big)


def make_batch_scorer(generation: str | None = None, device=None
                      ) -> tuple[list[str], Callable[[Any], Any]]:
    """Returns (names, score_fn) where score_fn(gang_demands) -> (best
    index [G] int64, stranded cost [G] f32) tensors on ``device`` (the
    card unless given "cpu").

    ``gang_demands`` is a float32 array or tensor [G, 3] of
    (total_chips, per_pod_chips, n_pods)."""
    dev = resolve_device(device)
    names, chips, cph, hosts = catalog_arrays(generation)
    chips_t, cph_t, hosts_t = (torch.from_numpy(a).to(dev)
                               for a in (chips, cph, hosts))

    def score(demands):
        d = torch.as_tensor(demands, dtype=torch.float32).to(dev)
        cost = _score_kernel(d[:, 0], d[:, 1], d[:, 2], chips_t, cph_t,
                             hosts_t)
        return torch.argmin(cost, dim=1), torch.amin(cost, dim=1)

    return names, score


def best_shapes(demands: np.ndarray, generation: str | None = None,
                device=None) -> list[tuple[str | None, float]]:
    """Convenience wrapper: [(shape_name | None, stranded), ...] per gang."""
    names, score = make_batch_scorer(generation, device)
    best, cost = score(np.asarray(demands, np.float32))
    out: list[tuple[str | None, float]] = []
    for b, c in zip(best.cpu().numpy(), cost.cpu().numpy()):
        out.append((None, float("inf")) if c >= _BIG
                   else (names[int(b)], float(c)))
    return out


def best_shapes_np(demands: Any, generation: str | None = None
                   ) -> list[tuple[str | None, float]]:
    """Pure-numpy twin of ``best_shapes`` — same kernel math, no jax
    import (usable from the planner's batch path without paying jax's
    import/jit latency inside a reconcile pass).

    The catalog is sorted ascending by chips with unique chip counts
    per generation, and ``argmin`` returns the first minimum, so the
    pick matches the per-gang Python scan (and the native kernel)
    decision-for-decision on the chip axes.
    """
    names, chips, cph, hosts = catalog_arrays(generation)
    d = np.asarray(demands, np.float32).reshape(-1, 3)
    total = d[:, 0:1]
    per_pod = d[:, 1:2]
    pods = d[:, 2:3]
    with np.errstate(divide="ignore"):
        slots = hosts[None, :] * np.floor(
            np.where(per_pod > 0, cph[None, :] / np.maximum(per_pod, 1),
                     _BIG))
    feasible = ((chips[None, :] >= total)
                & (cph[None, :] >= per_pod)
                & (slots >= pods))
    cost = np.where(feasible, chips[None, :] - total, _BIG)
    best = cost.argmin(axis=1)
    best_cost = cost.min(axis=1)
    return [(None, float("inf")) if c >= _BIG else (names[int(b)], float(c))
            for b, c in zip(best, best_cost)]
