"""The port's CUDA kernels against their plain PyTorch versions.

These need a CUDA device: a hand-written kernel has no CPU mode, so
each test skips without one.  They import no JAX, so they run on a GPU
machine as they are:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from chip_smoke import TOL_REASON, err_over_tol
from tpu_autoscaler_torch.workloads import attention


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_cuda_kernel_matches_plain_version(dtype, d):
    """The CUDA kernel against its plain version on the card (linear,
    window and ring), with chip_smoke.py's tolerances (TOL_REASON)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, hkv, max_len = 4, 16, 2, 384

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(b, h, 1, d), rnd(b, hkv, max_len, d), rnd(b, hkv, max_len, d)
    cases = [(torch.tensor([0, 1, 65, 384]), {}),
             (torch.tensor([1, 255, 300, 384]), {"window": 256}),
             (torch.tensor([1, 383, 385, 5000]),
              {"window": 256, "ring": True})]
    for lengths, kw in cases:
        lengths = lengths.to("cuda", torch.int32)
        got = attention.flash_decode(q, k, v, lengths, **kw)
        want = attention.flash_decode_reference(q, k, v, lengths, **kw)
        torch.cuda.synchronize()
        err, share = err_over_tol(torch, got, want)
        assert share <= 1.0, (kw, err, share, TOL_REASON[str(dtype)])
