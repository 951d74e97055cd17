"""Dataclasses for TPU slice shapes and CPU node shapes.

Analog of the reference's ``autoscaler/capacity.py`` SKU table entries, but a
TPU slice is an *atomic multi-host unit*: the capacity model must expose not
just per-node resources but the whole-slice chip count, host count, and ICI
topology, because provisioning / draining / deleting all operate on whole
slices (SURVEY.md §6.7, §8 "slice-atomic semantics").
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class SliceShape:
    """One provisionable TPU slice shape (an atomic ICI domain).

    Naming convention: ``{generation}-{chips}`` (e.g. ``v5e-64`` = 64 chips,
    8x8 2-D torus, 16 hosts).  This matches the eval configs
    (BASELINE.md: "v5e-8", "v5e-64", "2×v5p-128", "v5p-256") which use the
    suffix as the *chip count*.  Real Cloud TPU product names for v4/v5p use
    TensorCore counts (so product "v5p-256" is 128 chips); the catalog keys
    on chips to stay consistent with the fit math — the ``product_name``
    field records the marketing name where it differs.
    """

    generation: str            # "v4" | "v5e" | "v5p" | "v6e"
    chips: int                 # total chips in the slice == prod(topology)
    topology: tuple[int, ...]  # ICI torus dims, e.g. (8, 8) or (4, 4, 8)
    chips_per_host: int        # chips on each host VM in this shape
    accelerator_type: str      # cloud.google.com/gke-tpu-accelerator value
    machine_type: str          # GKE machine type for the node pool
    host_cpu_m: int            # allocatable vCPU per host, millicores (approx)
    host_memory: int           # allocatable memory per host, bytes (approx)
    host_pods: int = 110       # pod capacity per host
    product_name: str | None = None  # marketing name when != "{gen}-{chips}"

    def __post_init__(self) -> None:
        prod = 1
        for d in self.topology:
            prod *= d
        if prod != self.chips:
            raise ValueError(
                f"topology {self.topology} has {prod} chips, expected {self.chips}"
            )
        if self.chips % self.chips_per_host != 0:
            raise ValueError(
                f"{self.chips} chips not divisible by {self.chips_per_host}/host"
            )

    @property
    def name(self) -> str:
        return f"{self.generation}-{self.chips}"

    @property
    def hosts(self) -> int:
        """Number of host VMs (== k8s nodes) in one slice."""
        return self.chips // self.chips_per_host

    @property
    def topology_label(self) -> str:
        """Value of the ``cloud.google.com/gke-tpu-topology`` node label."""
        return "x".join(str(d) for d in self.topology)

    @property
    def multi_host(self) -> bool:
        return self.hosts > 1

    def node_selectors(self) -> dict[str, str]:
        """The nodeSelector a gang must carry to land on this shape.

        Mirrors how a pending pod in the reference carried
        ``beta.kubernetes.io/instance-type`` expectations (kube.py §KubeNode
        .is_match); in GKE the contract is the accelerator + topology labels.
        """
        from tpu_autoscaler_torch.topology.catalog import ACCELERATOR_LABEL, TOPOLOGY_LABEL

        return {
            ACCELERATOR_LABEL: self.accelerator_type,
            TOPOLOGY_LABEL: self.topology_label,
        }

    def node_capacity(self) -> Mapping[str, float]:
        """Allocatable resources of ONE host in this slice, as a plain dict.

        Analog of capacity.py §get_capacity_for_instance_type: lets the fit
        engine reason about nodes that do not exist yet.
        """
        from tpu_autoscaler_torch.topology.catalog import TPU_RESOURCE

        return {
            "cpu": self.host_cpu_m / 1000.0,
            "memory": float(self.host_memory),
            "pods": float(self.host_pods),
            TPU_RESOURCE: float(self.chips_per_host),
        }


@dataclasses.dataclass(frozen=True)
class CpuShape:
    """A CPU-only node shape (BASELINE config #1: plain agent nodes).

    Direct analog of the non-GPU rows of the reference capacity table
    (capacity.py: Standard_D*/Standard_A* entries).
    """

    machine_type: str
    cpu_m: int       # allocatable millicores
    memory: int      # allocatable bytes
    pods: int = 110

    @property
    def name(self) -> str:
        return self.machine_type

    def node_capacity(self) -> Mapping[str, float]:
        return {
            "cpu": self.cpu_m / 1000.0,
            "memory": float(self.memory),
            "pods": float(self.pods),
        }


@dataclasses.dataclass(frozen=True)
class MultiSliceSpec:
    """N identical slices composed over DCN (BASELINE config #4: 2×v5p-128).

    Chips within each slice communicate over ICI; slices communicate over
    DCN.  The autoscaler provisions each slice atomically and treats the
    group as one demand unit for gang scheduling, but each slice remains the
    unit of drain/delete (SURVEY.md §6.8).
    """

    shape: SliceShape
    num_slices: int

    def __post_init__(self) -> None:
        if self.num_slices < 1:
            raise ValueError("num_slices must be >= 1")

    @property
    def name(self) -> str:
        return f"{self.num_slices}x{self.shape.name}"

    @property
    def total_chips(self) -> int:
        return self.shape.chips * self.num_slices

    @property
    def total_hosts(self) -> int:
        return self.shape.hosts * self.num_slices
