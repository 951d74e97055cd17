"""The identities the tensor-core flash-attention kernels rest on, on the
CPU, as exact equalities of the port's plain versions:

- K1 (``flash_attention``) is K5 (``ring_flash_step``) at offset 0 over
  its own block from a fresh carry (m = -1e30, l = 0, acc = 0), then
  normalised: out = (acc / l) in q's dtype, lse = m + log(l);
- K2 (``flash_attention_backward``) is K6 (``ring_flash_bwd_step``) at
  offset 0 with delta = rowsum(do * out), each f32 output cast to the
  input dtype.

A causal call is a masked hop (its window the hop's window), a full one
an unmasked hop.  So the bf16 K1 and K2 run the ring hop's wgmma tiles
(``csrc/flash_fwd_tc.cuh``, ``csrc/flash_bwd_tc.cuh``) with another
prologue and epilogue; those kernels are held to these plain versions on
the card by tests/test_torch_kernels.py and chip_smoke.py.

Inputs are made with numpy from a seed.  In f32 at head_dim 32 each case
also holds the port's plain versions to the JAX package's Pallas kernels
in interpret mode (``_forward_pallas``, ``_backward_pallas``), within
2e-5 for out and lse and 1e-4 for the gradients (f32, summation order
only; the gradients' bound is tests/test_torch_train.py's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler_torch.workloads import attention  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (causal, window) of a flash_attention call.
MASKS = {"causal": (True, None), "window1": (True, 1),
         "window7": (True, 7), "full": (False, None)}
HEADS = {"mha": (4, 4), "gqa": (4, 2), "mqa": (4, 1)}
HEAD_DIMS = (32, 64, 128)
SEQS = (1, 17, 33)
CASES = pytest.mark.parametrize(
    "dtype,mask,heads,d,s",
    [(dt, m, hd, d, s) for dt in DTYPES for m in MASKS for hd in HEADS
     for d in HEAD_DIMS for s in SEQS])


def _np(t):
    return t.detach().float().cpu().numpy()


def _inputs(dtype, heads, d, s):
    """q, k, v, do from numpy at a seed fixed by the shape, in dtype."""
    h, hkv = HEADS[heads]
    rng = np.random.default_rng(1000 * d + 10 * s + h + hkv)
    shapes = ((2, h, s, d), (2, hkv, s, d), (2, hkv, s, d), (2, h, s, d))
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(DTYPES[dtype]) for shape in shapes]


def _runs_jax(dtype, d) -> bool:
    return dtype == "f32" and d == 32


@CASES
def test_forward_is_a_fresh_hop_normalised(dtype, mask, heads, d, s):
    """flash_attention_reference equals ring_flash_step_reference at
    offset 0 from a fresh carry, normalised, bit for bit."""
    causal, window = MASKS[mask]
    q, k, v, _ = _inputs(dtype, heads, d, s)
    out, lse = attention.flash_attention_reference(q, k, v, causal=causal,
                                                   window=window)
    b, h = q.shape[:2]
    m0 = torch.full((b, h, s, 1), attention.NEG_INF)
    l0 = torch.zeros((b, h, s, 1))
    acc0 = torch.zeros((b, h, s, d))
    m, l_, acc = attention.ring_flash_step_reference(
        q, k, v, m0, l0, acc0, offset=0, masked=causal, window=window)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert torch.equal(out, (acc / l_).to(q.dtype))
    assert torch.equal(lse, m + torch.log(l_))
    if _runs_jax(dtype, d):
        jout, jlse = jax_attention._forward_pallas(
            *(jnp.asarray(_np(t)) for t in (q, k, v)), causal, window, 512,
            1024, True)
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(lse), np.asarray(jlse).reshape(
            lse.shape), rtol=TOL, atol=TOL)


@CASES
def test_backward_is_a_hop_at_offset_0_cast(dtype, mask, heads, d, s):
    """flash_attention_backward_reference equals
    ring_flash_bwd_step_reference at offset 0 on delta = rowsum(do *
    out), each f32 gradient cast to the input dtype, bit for bit."""
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(dtype, heads, d, s)
    out, lse = attention.flash_attention_reference(q, k, v, causal=causal,
                                                   window=window)
    got = attention.flash_attention_backward_reference(
        q, k, v, out, lse, do, causal=causal, window=window)
    hop = attention.ring_flash_bwd_step_reference(
        q, k, v, do, lse, attention._delta(out, do), offset=0,
        masked=causal, window=window)
    for g, w, like in zip(got, hop, (q, k, v)):
        assert w.dtype == torch.float32 and g.dtype == like.dtype
        assert torch.equal(g, w.to(like.dtype))
    if _runs_jax(dtype, d):
        want = jax_attention._backward_pallas(
            *(jnp.asarray(_np(t)) for t in (q, k, v, out, lse, do)), causal,
            window, 512, 1024, True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=GRAD_TOL,
                                       atol=GRAD_TOL)
