"""Multi-host / multi-slice bootstrap for jobs under this autoscaler, on
PyTorch.

The counterpart of the JAX package's ``workloads/distributed.py``: the
job side of the hardware the autoscaler provisions.

- **multi-host**: every pod calls :func:`initialize_from_env`; the
  coordinator address and the process index come from the GKE env
  contract (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``), and the
  process group is brought up over it (``torch.distributed``: NCCL
  between CUDA processes, gloo on the CPU).  The processes then share
  one mesh (:func:`make_process_mesh`), each holding the data rows of
  its own cards: the step averages the gradients over the processes
  (:func:`process_mean`), and ZeRO-1 and FSDP cut the state over the
  global data axes, so the data parallelism crosses hosts while tensor
  parallelism stays inside each.
- **multi-slice**: the mesh gains a leading ``dcn`` axis, one coordinate
  per slice (``MEGASCALE_SLICE_ID``, or the JobSet job index).  The batch
  is cut over (dcn, data), tensor parallelism stays inside each slice
  (:func:`make_multislice_mesh`).

``HostTopology`` and ``parse_gke_tpu_env`` are the JAX package's, code
for code: this module imports nothing of it.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
from typing import Mapping

import numpy as np

log = logging.getLogger(__name__)

_COORDINATOR_PORT = 8476


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """One process's view of the job topology, parsed from env."""

    coordinator: str          # "host:port" of process 0
    num_processes: int
    process_id: int
    slice_id: int = 0         # which DCN slice this host belongs to
    num_slices: int = 1

    @property
    def single_process(self) -> bool:
        return self.num_processes <= 1


def parse_gke_tpu_env(env: Mapping[str, str] | None = None
                      ) -> HostTopology | None:
    """Read the GKE TPU env contract; None when not on a TPU node pool.

    - ``TPU_WORKER_HOSTNAMES``: comma-separated hostnames of all workers
      (pods) in this slice, index order == worker id;
    - ``TPU_WORKER_ID``: this pod's index within the slice;
    - ``MEGASCALE_SLICE_ID`` / ``MEGASCALE_NUM_SLICES``: multi-slice
      coordinates (fall back to the JobSet job index label when absent).
    """
    env = os.environ if env is None else env
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
                 if h]
    if not hostnames:
        return None
    worker_id = int(env.get("TPU_WORKER_ID", "0"))
    slice_id = int(env.get("MEGASCALE_SLICE_ID",
                           env.get("JOB_COMPLETION_INDEX", "0")) or 0)
    num_slices = int(env.get("MEGASCALE_NUM_SLICES", "1") or 1)
    hosts_per_slice = len(hostnames)
    return HostTopology(
        coordinator=f"{hostnames[0]}:{_COORDINATOR_PORT}",
        num_processes=hosts_per_slice * num_slices,
        process_id=slice_id * hosts_per_slice + worker_id,
        slice_id=slice_id,
        num_slices=num_slices,
    )


def initialize_from_env(env: Mapping[str, str] | None = None,
                        backend: str = "nccl") -> HostTopology:
    """Bring up ``torch.distributed`` from the GKE TPU environment.

    Safe single-host: without the env contract (local dev, one host) it
    does nothing and returns a 1-process topology.  Otherwise it joins
    the process group at the coordinator over ``backend`` ("nccl" for
    CUDA processes, "gloo" on the CPU); a failure to join propagates.
    """
    topo = parse_gke_tpu_env(env)
    if topo is None or topo.single_process:
        return topo or HostTopology(coordinator="localhost:0",
                                    num_processes=1, process_id=0)
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://{topo.coordinator}",
                            world_size=topo.num_processes,
                            rank=topo.process_id)
    log.info("torch.distributed up: process %d/%d (slice %d/%d)",
             topo.process_id, topo.num_processes, topo.slice_id,
             topo.num_slices)
    return topo


def process_mean(tensors: list) -> list:
    """``tensors`` averaged over the processes of the group (one
    all-reduce per device and dtype, over the tensors flattened into one
    buffer): what the step over a mesh of several processes applies to
    its loss and the gradients every process holds before the optimizer,
    so the processes train one model on the global batch.  Identity when
    no group is up."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(tensors)
    world = dist.get_world_size()
    groups = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        groups[t.device, t.dtype].append(i)
    out = list(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat /= world
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def make_process_mesh(devices=None, tp: int | None = None,
                      num_slices: int = 1):
    """The mesh of every process of the job, as the JAX trainer's one
    mesh over ``jax.devices()``: each process brings the same count of
    ``devices`` (default: every visible CUDA card; a device may repeat),
    cut into data rows of ``tp`` model ranks as ``model.make_mesh`` cuts
    them (tp's default from the local count), and process p's rows
    follow process p - 1's on the data axis, so ZeRO-1 and FSDP cut over
    the global data parallelism.  The grid holds this process's devices,
    and None at the other processes' ranks (``Mesh.local``).  With
    ``num_slices`` > 1 it is the (dcn, data, model) mesh, slice-major.
    Without a process group, the mesh of this process alone."""
    import torch.distributed as dist

    from tpu_autoscaler_torch.workloads.model import Mesh, make_mesh

    local = make_mesh(devices, tp=tp)
    up = dist.is_initialized()
    n_proc, pid = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    dp, tp = local.devices.shape
    grid = np.full((n_proc * dp, tp), None, dtype=object)
    grid[pid * dp:(pid + 1) * dp] = local.devices
    if num_slices == 1:
        return Mesh(grid, ("data", "model"))
    if (n_proc * dp) % num_slices:
        raise ValueError(f"{n_proc * dp} data rows not divisible by "
                         f"num_slices = {num_slices}")
    return Mesh(grid.reshape(num_slices, -1, tp), ("dcn", "data", "model"))


def make_multislice_mesh(num_slices: int, model: int = 2, devices=None):
    """(dcn, data, model) mesh: TP inside slices, DP within and across,
    as the port's ``model.Mesh`` over ``devices`` (default: every
    visible CUDA card; a device may repeat, so ranks share a card).  The
    JAX package orders real multi-slice devices with its hybrid mesh
    helper; the port's mesh is the plain reshape, slice-major."""
    import torch

    from tpu_autoscaler_torch.workloads.model import Mesh, _device

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if n % (num_slices * model):
        raise ValueError(
            f"{n} devices not divisible by num_slices*model = "
            f"{num_slices * model}")
    data = n // (num_slices * model)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(num_slices, data, model),
                axis_names=("dcn", "data", "model"))
