"""The slice-shape catalog: data, not code.

TPU-native analog of the reference's hard-coded Azure SKU dict
(capacity.py §get_capacity_for_instance_type).  SURVEY.md §6.6 calls for the
capacity table to become *data*; everything here is declarative and the
lookup functions are pure, so the whole layer is testable without clusters.

Conventions (documented, deliberate):

- Shape names are ``{generation}-{chips}`` — the eval configs
  (BASELINE.md) use the suffix as chip count (v5e-8 = 8 chips, v5p-256 =
  256 chips).  Where the Cloud TPU *product* name counts TensorCores
  instead (v4/v5p), the entry records ``product_name``.
- ``google.com/tpu`` is the extended resource one host exposes
  (== chips_per_host), the TPU analog of the reference's
  ``alpha.kubernetes.io/nvidia-gpu`` requests.
- Host vCPU/memory figures are approximate GKE allocatable values; the fit
  math for TPU gangs is driven by chips + selectors, with cpu/mem as a
  sanity check.
"""

from __future__ import annotations

import functools

from tpu_autoscaler_torch.topology.shapes import CpuShape, SliceShape

# Kubernetes extended-resource name for TPU chips on GKE.
TPU_RESOURCE = "google.com/tpu"

# GKE node labels that define the TPU placement contract.
ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"

# Well-known label carried by every GKE node with its machine type; the
# analog of the reference's `beta.kubernetes.io/instance-type` node label
# (kube.py §KubeNode.instance_type).
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"

# Label this autoscaler stamps on nodes it provisions, recording slice
# membership: every host of one slice shares a slice id. Replaces the
# reference's per-VM identity (engine_scaler.py derived pool membership from
# VM name prefixes) with an explicit, slice-atomic identity.
SLICE_ID_LABEL = "autoscaler.tpu.dev/slice-id"
POOL_LABEL = "autoscaler.tpu.dev/pool"

GiB = 1024**3


def _v5e(chips: int, topology: tuple[int, ...], chips_per_host: int,
         machine_type: str, host_cpu_m: int, host_memory: int,
         accelerator_type: str) -> SliceShape:
    return SliceShape(
        generation="v5e", chips=chips, topology=topology,
        chips_per_host=chips_per_host, accelerator_type=accelerator_type,
        machine_type=machine_type, host_cpu_m=host_cpu_m,
        host_memory=host_memory,
    )


def _v5p(chips: int, topology: tuple[int, ...]) -> SliceShape:
    # v5p: 3-D torus, 4 chips per host VM (ct5p-hightpu-4t), 2 TensorCores
    # per chip, so the marketing name's core count is 2x the chip count.
    return SliceShape(
        generation="v5p", chips=chips, topology=topology, chips_per_host=4,
        accelerator_type="tpu-v5p-slice", machine_type="ct5p-hightpu-4t",
        host_cpu_m=208_000, host_memory=448 * GiB,
        product_name=f"v5p-{chips * 2}",
    )


def _v4(chips: int, topology: tuple[int, ...]) -> SliceShape:
    return SliceShape(
        generation="v4", chips=chips, topology=topology, chips_per_host=4,
        accelerator_type="tpu-v4-podslice", machine_type="ct4p-hightpu-4t",
        host_cpu_m=240_000, host_memory=407 * GiB,
        product_name=f"v4-{chips * 2}",
    )


def _v6e(chips: int, topology: tuple[int, ...], chips_per_host: int,
         machine_type: str) -> SliceShape:
    return SliceShape(
        generation="v6e", chips=chips, topology=topology,
        chips_per_host=chips_per_host, accelerator_type="tpu-v6e-slice",
        machine_type=machine_type, host_cpu_m=180_000, host_memory=720 * GiB,
    )


_ALL_SHAPES: tuple[SliceShape, ...] = (
    # ---- v5e (2-D torus; single-host machines expose 1/4/8 chips, multi-host
    # slices use 4-chip hosts). Single-host shapes use the *-device
    # accelerator type, multi-host the *-podslice type, per GKE semantics.
    _v5e(1, (1, 1), 1, "ct5lp-hightpu-1t", 24_000, 48 * GiB, "tpu-v5-lite-device"),
    _v5e(4, (2, 2), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-device"),
    _v5e(8, (2, 4), 8, "ct5lp-hightpu-8t", 224_000, 400 * GiB, "tpu-v5-lite-device"),
    _v5e(16, (4, 4), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-podslice"),
    _v5e(32, (4, 8), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-podslice"),
    _v5e(64, (8, 8), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-podslice"),
    _v5e(128, (8, 16), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-podslice"),
    _v5e(256, (16, 16), 4, "ct5lp-hightpu-4t", 112_000, 192 * GiB, "tpu-v5-lite-podslice"),
    # ---- v5p (3-D torus, 4-chip hosts)
    _v5p(4, (2, 2, 1)),
    _v5p(8, (2, 2, 2)),
    _v5p(16, (2, 2, 4)),
    _v5p(32, (2, 4, 4)),
    _v5p(64, (4, 4, 4)),
    _v5p(128, (4, 4, 8)),
    _v5p(256, (4, 8, 8)),
    _v5p(512, (8, 8, 8)),
    _v5p(1024, (8, 8, 16)),
    # ---- v4 (3-D torus, 4-chip hosts)
    _v4(8, (2, 2, 2)),
    _v4(16, (2, 2, 4)),
    _v4(32, (2, 4, 4)),
    _v4(64, (4, 4, 4)),
    _v4(128, (4, 4, 8)),
    _v4(256, (4, 8, 8)),
    _v4(512, (8, 8, 8)),
    # ---- v6e (Trillium; 2-D torus like v5e)
    _v6e(1, (1, 1), 1, "ct6e-standard-1t"),
    _v6e(4, (2, 2), 4, "ct6e-standard-4t"),
    _v6e(8, (2, 4), 8, "ct6e-standard-8t"),
    _v6e(16, (4, 4), 4, "ct6e-standard-4t"),
    _v6e(32, (4, 8), 4, "ct6e-standard-4t"),
    _v6e(64, (8, 8), 4, "ct6e-standard-4t"),
    _v6e(128, (8, 16), 4, "ct6e-standard-4t"),
    _v6e(256, (16, 16), 4, "ct6e-standard-4t"),
)

SLICE_SHAPES: dict[str, SliceShape] = {s.name: s for s in _ALL_SHAPES}

# CPU-only node shapes for the plain agent-node path (BASELINE config #1) —
# the analog of the reference capacity table's Standard_D* rows.  Allocatable
# is machine size minus typical GKE system reservation.
CPU_SHAPES: dict[str, CpuShape] = {
    s.machine_type: s
    for s in (
        CpuShape("e2-standard-4", cpu_m=3_920, memory=13 * GiB),
        CpuShape("e2-standard-8", cpu_m=7_910, memory=27 * GiB),
        CpuShape("e2-standard-16", cpu_m=15_890, memory=56 * GiB),
        CpuShape("n2-standard-8", cpu_m=7_910, memory=27 * GiB),
        CpuShape("n2-standard-16", cpu_m=15_890, memory=56 * GiB),
        CpuShape("n2-standard-32", cpu_m=31_850, memory=115 * GiB),
    )
}

DEFAULT_CPU_SHAPE = CPU_SHAPES["e2-standard-8"]


def shape_by_name(name: str) -> SliceShape:
    """Look up a shape by catalog name, e.g. ``"v5e-64"``."""
    try:
        return SLICE_SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown slice shape {name!r}; known: {sorted(SLICE_SHAPES)}"
        ) from None


def cpu_shape_by_name(machine_type: str) -> CpuShape:
    try:
        return CPU_SHAPES[machine_type]
    except KeyError:
        raise KeyError(
            f"unknown CPU machine type {machine_type!r}; known: {sorted(CPU_SHAPES)}"
        ) from None


def shapes_for_generation(generation: str) -> list[SliceShape]:
    """All shapes of one TPU generation, ascending by chip count."""
    out = [s for s in SLICE_SHAPES.values() if s.generation == generation]
    if not out:
        raise KeyError(f"unknown TPU generation {generation!r}")
    return sorted(out, key=lambda s: s.chips)


def smallest_shape_for_chips(generation: str, chips: int) -> SliceShape | None:
    """Smallest catalog shape of ``generation`` with >= ``chips`` chips.

    The core of the stranded-chip objective: picking the smallest satisfying
    shape minimizes (chips provisioned - chips requested).  Returns None if
    no shape of the generation is large enough.
    """
    for shape in shapes_for_generation(generation):
        if shape.chips >= chips:
            return shape
    return None


def shape_from_selectors(selectors: dict[str, str]) -> SliceShape | None:
    """Resolve the slice shape a pod's nodeSelector pins it to, if any.

    A GKE TPU workload declares placement via the accelerator + topology
    labels; this inverts that contract back to a catalog entry.  Returns
    None when the selectors name no TPU shape (CPU workloads), raises
    KeyError when they name one the catalog doesn't know.
    """
    acc = selectors.get(ACCELERATOR_LABEL)
    topo = selectors.get(TOPOLOGY_LABEL)
    if acc is None and topo is None:
        return None
    return _shape_for_labels(acc, topo)


@functools.lru_cache(maxsize=256)
def _shape_for_labels(acc: str | None, topo: str | None) -> SliceShape:
    """Catalog scan memo: the tracker and the repair detector resolve
    every slice's shape from its labels each reconcile pass — a ~30-row
    scan per unit that is pure in the (static) catalog."""
    matches = [
        s
        for s in SLICE_SHAPES.values()
        if (acc is None or s.accelerator_type == acc)
        and (topo is None or s.topology_label == topo)
    ]
    if not matches:
        raise KeyError(
            f"no catalog shape matches accelerator={acc!r} topology={topo!r}"
        )
    # Accelerator alone can match many sizes; prefer exact topology pins,
    # else the smallest (caller can widen with chip-count demand).
    return sorted(matches, key=lambda s: s.chips)[0]
