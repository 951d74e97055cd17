"""Slice-shape / topology catalog (L3b capacity model).

TPU-native analog of the reference's ``autoscaler/capacity.py`` (Azure VM
SKU -> resource-vector table): answers "what does one new unit of supply
provide?" *before* that unit exists.  For TPUs the unit of supply is a whole
ICI slice, not a single node — a v5e-64 slice is 16 hosts that must be
provisioned and deleted atomically.
"""

from tpu_autoscaler_torch.topology.shapes import (
    CpuShape,
    MultiSliceSpec,
    SliceShape,
)
from tpu_autoscaler_torch.topology.catalog import (
    ACCELERATOR_LABEL,
    CPU_SHAPES,
    DEFAULT_CPU_SHAPE,
    SLICE_SHAPES,
    TOPOLOGY_LABEL,
    TPU_RESOURCE,
    cpu_shape_by_name,
    shape_by_name,
    shape_from_selectors,
    shapes_for_generation,
    smallest_shape_for_chips,
)

__all__ = [
    "ACCELERATOR_LABEL",
    "CPU_SHAPES",
    "DEFAULT_CPU_SHAPE",
    "CpuShape",
    "MultiSliceSpec",
    "SLICE_SHAPES",
    "SliceShape",
    "TOPOLOGY_LABEL",
    "TPU_RESOURCE",
    "cpu_shape_by_name",
    "shape_by_name",
    "shape_from_selectors",
    "shapes_for_generation",
    "smallest_shape_for_chips",
]
