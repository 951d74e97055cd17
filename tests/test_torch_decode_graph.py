"""The one-device paged decode step as a CUDA graph, on the card.

The token-write kernel against its plain version, and the step replayed
from its graph against the same step run eagerly over a whole engine
run (``chip_smoke.phase_paged_decode_graph_check``: tokens, ticks,
preemptions and MoE counter rows equal; kernel launches, a replay's read
from the captured graph's kernel nodes, as counted; a changed pool
recaptured).  These need a CUDA device: a graph and a hand-written
kernel have no CPU mode, so each test skips without one.  They import
no JAX, so they run on a GPU machine as they are:

    python -m pytest tests/test_torch_decode_graph.py -m cuda -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_autoscaler_torch.workloads import (
    attention,
    model,
    paged,
    serving,
)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the token-write "
                    "kernel have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_token_write_kernel_equals_plain_version(dtype):
    """Bit for bit, with inactive rows, dead and out-of-pool entries,
    block edges, and new k/v as views of the packed qkv."""
    _need_cuda()
    rec = chip_smoke._token_write_check(torch, attention, dtype)
    assert rec["views"] and rec["contiguous"], rec
    assert rec["views_entries_written"] > 0, rec


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["dense", "moe"])
def test_replayed_decode_step_equals_eager_step(label):
    _need_cuda()
    arch = chip_smoke.FULL if label == "dense" else chip_smoke.GRAPH_MOE
    rec = chip_smoke.phase_paged_decode_graph_check(
        torch, np, attention, model, serving, paged, label, arch)
    assert rec["tokens_equal"] and rec["recapture"]["captures"] == 1
