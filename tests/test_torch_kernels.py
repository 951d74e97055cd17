"""The port's CUDA kernels against their plain PyTorch versions.

These need a CUDA device: a hand-written kernel has no CPU mode, so
each test skips without one.  They import no JAX, so they run on a GPU
machine as they are:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from chip_smoke import (
    TOL_REASON,
    err_over_tol,
    grad_err_over_tol,
    hop_err_over_tol,
)
from tpu_autoscaler_torch.workloads import attention


HEAD_DIMS = [(torch.bfloat16, 64), (torch.float32, 128),
             (torch.bfloat16, 32), (torch.float32, 32),
             (torch.bfloat16, 256), (torch.float32, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", HEAD_DIMS)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", HEAD_DIMS)
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_cuda_kernel_matches_plain_version(dtype, d, bs):
    """The paged kernel against its plain version on the card: linear
    and windowed, scrambled block ids, a -1 entry below a row's length,
    an id past the pool, a row of length 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    slots, h, hkv, tpr = 4, 16, 2, 384 // bs
    nb = slots * tpr + 16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = rnd(slots, h, 1, d)
    k, v = rnd(nb, hkv, bs, d), rnd(nb, hkv, bs, d)
    tables = torch.randperm(nb, generator=g, device="cuda")[
        :slots * tpr].reshape(slots, tpr).to(torch.int32)
    tables[1, 2] = -1
    tables[2, 0] = nb + 5
    lengths = torch.tensor([0, 100, 383, 384], dtype=torch.int32,
                           device="cuda")
    for window in (None, 256):
        got = attention.paged_flash_decode(q, k, v, tables, lengths,
                                           window=window)
        want = attention.paged_flash_decode_reference(q, k, v, tables,
                                                      lengths, window=window)
        torch.cuda.synchronize()
        err, share = err_over_tol(torch, got, want)
        assert share <= 1.0, (window, err, share, TOL_REASON[str(dtype)])
    with pytest.raises(ValueError, match="head_dim"):
        attention.paged_flash_decode(*_too_wide(q, k, v), tables, lengths)


LSE_TOL = 1e-4   # f32 in both versions; only the summation order differs


def _too_wide(*tensors):
    """The tensors zero-padded to head_dim 264: wider than any kernel
    takes (256), so the wrappers must raise."""
    return [torch.nn.functional.pad(t, (0, 264 - t.shape[-1]))
            for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 128)])
def test_flash_attention_cuda_kernel_matches_plain_version(dtype, d):
    """K1 against its plain version on the card: causal, windowed (a
    window smaller than a tile, and of 1) and non-causal, GQA and MHA,
    at s 1, 2 and tails that are not a multiple of the tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = [(2, 4, 2, 100, {}), (2, 4, 2, 100, {"window": 17}),
             (2, 4, 2, 70, {"window": 1}), (2, 4, 2, 77, {"causal": False}),
             (1, 4, 4, 33, {}), (3, 8, 1, 1, {}), (2, 4, 2, 2, {})]
    for b, h, hkv, s, kw in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        q, k, v = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        want, want_lse = attention.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err, share = err_over_tol(torch, out, want)
        assert share <= 1.0, (s, kw, err, share, TOL_REASON[str(dtype)])
        assert (lse - want_lse).abs().max().item() <= LSE_TOL, (s, kw)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention(*_too_wide(q, k, v))
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.flash_attention(q.half(), k.half(), v.half())
    # Inputs that require grad take the autograd.Function: K1 forward,
    # K2 backward, finite gradients of q's shape.
    qg = q.detach().requires_grad_()
    (dq,) = torch.autograd.grad(attention.flash_attention(qg, k, v).float()
                                .sum(), (qg,))
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())


# (b, h, hkv, s, kwargs): the bf16 tensor-core K1 and K2 at s 1, 17 and
# 1000 (a tail past 7 full 128-row tiles), causal, windowed (1, and one
# cutting the q-tiles' key ranges), non-causal, MHA, GQA and MQA.
TC_ATTN_CASES = [(3, 4, 2, 1, {}), (2, 4, 2, 17, {}), (2, 4, 4, 17,
                                                       {"causal": False}),
                 (1, 4, 2, 1000, {}), (1, 4, 2, 1000, {"window": 1}),
                 (1, 8, 1, 1000, {"window": 300}),
                 (1, 4, 1, 1000, {"causal": False}), (2, 8, 1, 17,
                                                       {"window": 1})]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_attention_tensor_core_kernels_match_plain_versions(d):
    """The bf16 K1 (out and lse) and K2 (dq, dk, dv) on wgmma at every
    built head_dim and at 96 (run padded to 128) against their plain
    versions, K2 on K1's own out and lse; each gradient comes out in
    bf16, as the plain version's does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    for b, h, hkv, s, kw in TC_ATTN_CASES:
        q, k, v, do = _bwd_inputs(g, torch.bfloat16, b, h, hkv, s, d)
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        want, want_lse = attention.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err, share = err_over_tol(torch, out, want)
        assert share <= 1.0, (s, kw, err, share)
        assert (lse - want_lse).abs().max().item() <= LSE_TOL, (s, kw)
        got = attention.flash_attention_backward(q, k, v, out, lse, do, **kw)
        want = attention.flash_attention_backward_reference(
            q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
            assert gt.dtype == torch.bfloat16 and gt.shape == wt.shape
            err, share = grad_err_over_tol(torch, gt, wt)
            assert share <= 1.0, (name, s, kw, err, share)


# (b, h, hkv, s, kwargs): causal, windowed (a window smaller than a tile,
# and of 1), non-causal; MHA, GQA and MQA; s 1, 2, 33 and tails that are
# not a multiple of the 32-row tiles.
BWD_CASES = [(2, 4, 2, 100, {}), (2, 4, 2, 100, {"window": 17}),
             (2, 4, 2, 70, {"window": 1}), (2, 4, 2, 77, {"causal": False}),
             (1, 4, 4, 33, {}), (2, 8, 1, 65, {}), (3, 4, 2, 1, {}),
             (2, 4, 2, 2, {}), (1, 4, 2, 300, {"window": 40})]


def _bwd_inputs(g, dtype, b, h, hkv, s, d):
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 128)])
def test_flash_attention_backward_cuda_kernels_match_plain_version(dtype, d):
    """K2 (the dq and the dk/dv kernel) against its plain version on the
    card, per gradient tensor with grad_err_over_tol, on o and lse from
    K1; a head_dim or dtype the kernels do not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    for b, h, hkv, s, kw in BWD_CASES:
        q, k, v, do = _bwd_inputs(g, dtype, b, h, hkv, s, d)
        out, lse = attention.flash_attention_forward(q, k, v, **kw)
        got = attention.flash_attention_backward(q, k, v, out, lse, do, **kw)
        want = attention.flash_attention_backward_reference(
            q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
            assert gt.shape == wt.shape and gt.dtype == wt.dtype
            err, share = grad_err_over_tol(torch, gt, wt)
            assert share <= 1.0, (name, s, kw, err, share)
    wide = _too_wide(q, k, v, out, do)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_backward(*wide[:4], lse, wide[4])
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.flash_attention_backward(q.half(), k.half(), v.half(),
                                           out.half(), lse, do.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_function_backward_on_cuda(dtype):
    """torch.autograd.grad through flash_attention on CUDA tensors runs
    K1 once and each K2 kernel once, and gives the plain backward's
    gradients on the forward's own output and lse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = _bwd_inputs(g, dtype, 2, 8, 2, 130, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attention.reset_launch_counts()
    out = attention.flash_attention(*leaves, window=50)
    got = torch.autograd.grad(out, leaves, do)
    counts = dict(attention.LAUNCHES)
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    o, lse = attention.flash_attention_forward(q, k, v, window=50)
    want = attention.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                        window=50)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert grad_err_over_tol(torch, gt, wt)[1] <= 1.0


# (b, h, hkv, sq, sk, offset, masked, window, carry): K5/K6 cases on the
# card: the ring's hop kinds (diagonal, earlier blocks, window-cut, a
# window inside the block), MHA/GQA/MQA, sq != sk, tails that are not a
# multiple of the 32-row tiles, and rows that see no key of a masked hop
# with a fresh carry (K5 must give the reference's P = 1 for them).
HOP_CASES = [(2, 4, 4, 100, 100, 0, True, None, "fresh"),
             (2, 4, 2, 100, 100, 100, False, None, "random"),
             (2, 4, 1, 77, 77, 154, False, None, "random"),
             (2, 4, 2, 100, 100, 100, True, 130, "random"),
             (2, 4, 2, 100, 100, 0, True, 17, "random"),
             (1, 8, 2, 70, 40, 3, True, 9, "random"),
             (1, 4, 4, 64, 64, -20, True, None, "fresh"),
             (3, 4, 2, 1, 33, 32, True, None, "random")]


def _hop_tensors(g, dtype, b, h, hkv, sq, sk, d, carry):
    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q, k, v = rnd(b, h, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    if carry == "fresh":
        m = torch.full((b, h, sq, 1), -1e30, device="cuda")
        l_ = torch.zeros((b, h, sq, 1), device="cuda")
        acc = torch.zeros((b, h, sq, d), device="cuda")
    else:
        m = rnd(b, h, sq, 1, dt=torch.float32)
        l_ = rnd(b, h, sq, 1, dt=torch.float32).abs() + 0.5
        acc = rnd(b, h, sq, d, dt=torch.float32)
    return q, k, v, m, l_, acc


def _check_hops(dtype, d, cases, seed):
    """K5 (m, l, acc) and K6 (dq_add, dk_add, dv_add) against their plain
    versions on the card in each case; K5 leaves the carry it was given
    as it was."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for b, h, hkv, sq, sk, offset, masked, window, carry in cases:
        kw = dict(offset=offset, masked=masked, window=window)
        q, k, v, m, l_, acc = _hop_tensors(g, dtype, b, h, hkv, sq, sk, d,
                                           carry)
        before = [t.clone() for t in (m, l_, acc)]
        got = attention.ring_flash_step(q, k, v, m, l_, acc, **kw)
        want = attention.ring_flash_step_reference(q, k, v, m, l_, acc, **kw)
        torch.cuda.synchronize()
        for t, t0 in zip((m, l_, acc), before):
            assert torch.equal(t, t0)
        for name, gt, wt in zip(("m", "l", "acc"), got, want):
            err, share = hop_err_over_tol(torch, gt, wt, dtype)
            assert share <= 1.0, (name, sq, sk, kw, err, share)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        lse = torch.rand((b, h, sq, 1), generator=g, device="cuda") * 3 + 1
        delta = torch.randn((b, h, sq, 1), generator=g, device="cuda")
        got = attention.ring_flash_bwd_step(q, k, v, do, lse, delta, **kw)
        want = attention.ring_flash_bwd_step_reference(q, k, v, do, lse,
                                                       delta, **kw)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
            assert gt.dtype == torch.float32 and gt.shape == wt.shape
            err, share = grad_err_over_tol(torch, gt, wt, dtype)
            assert share <= 1.0, (name, sq, sk, kw, err, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", HEAD_DIMS)
def test_ring_hop_cuda_kernels_match_plain_versions(dtype, d):
    """K5 (m, l, acc) and K6 (dq_add, dk_add, dv_add) against their plain
    versions on the card; K5 leaves the carry it was given as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_hops(dtype, d, HOP_CASES, seed=5)


# Hops of many tiles, past the tensor-core kernels' rings of 2-3 stages:
# a diagonal hop, an unmasked one with sq != sk, a window-cut one, and a
# GQA group of 4 streaming through the dk/dv kernel.
LONG_HOP_CASES = [(1, 4, 2, 700, 700, 0, True, None, "fresh"),
                  (1, 4, 2, 300, 500, 400, False, None, "random"),
                  (1, 4, 2, 600, 600, 600, True, 650, "random"),
                  (1, 8, 2, 257, 257, 257, False, None, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_ring_hop_tensor_core_kernels_match_plain_versions(d):
    """The bf16 ring kernels (K5 and K6 on wgmma) at every built head_dim
    and at 96 (run padded to 128): unmasked, diagonal, windowed, sq !=
    sk, tails (sq 100, 77), lone rows with a fresh carry, and hops of
    many tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_hops(torch.bfloat16, d, HOP_CASES + LONG_HOP_CASES, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_kernel_at_head_dim_96(dtype):
    """Head_dim 96, which no kernel is built for: K1 and K2 (padded to
    128), K3 and K4 (the cache read at its true width) and K5/K6 (padded)
    against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    d = 96
    g = torch.Generator(device="cuda").manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = _bwd_inputs(g, dtype, 2, 4, 2, 100, d)
    out, lse = attention.flash_attention_forward(q, k, v, window=40)
    want, want_lse = attention.flash_attention_reference(q, k, v, window=40)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert err_over_tol(torch, out, want)[1] <= 1.0
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    got = attention.flash_attention_backward(q, k, v, out, lse, do, window=40)
    want = attention.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                        window=40)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        assert grad_err_over_tol(torch, gt, wt)[1] <= 1.0
    qd, kc, vc = rnd(4, 16, 1, d), rnd(4, 2, 384, d), rnd(4, 2, 384, d)
    lengths = torch.tensor([1, 100, 383, 384], dtype=torch.int32,
                           device="cuda")
    for kw in ({}, {"window": 256}):
        got = attention.flash_decode(qd, kc, vc, lengths, **kw)
        want = attention.flash_decode_reference(qd, kc, vc, lengths, **kw)
        assert err_over_tol(torch, got, want)[1] <= 1.0
    pool_k, pool_v = rnd(100, 2, 16, d), rnd(100, 2, 16, d)
    tables = torch.randperm(100, generator=g, device="cuda")[:4 * 24] \
        .reshape(4, 24).to(torch.int32)
    got = attention.paged_flash_decode(qd, pool_k, pool_v, tables, lengths)
    want = attention.paged_flash_decode_reference(qd, pool_k, pool_v, tables,
                                                  lengths)
    assert err_over_tol(torch, got, want)[1] <= 1.0
    _check_hops(dtype, d, HOP_CASES[:3], seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 48)])
def test_decode_kernels_at_group_64(dtype, d):
    """K3 and K4 with 64 query heads on one KV head (two CTAs of 32
    heads each per row), against their plain versions, at a head_dim
    whose rows are whole 16-byte vectors and at d 20 (40 bytes in bf16,
    80 in f32), whose rows are staged element-wise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(10)
    for width in (d, 20):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        q, kc, vc = rnd(3, 64, 1, width), rnd(3, 1, 300, width), \
            rnd(3, 1, 300, width)
        lengths = torch.tensor([1, 150, 300], dtype=torch.int32,
                               device="cuda")
        got = attention.flash_decode(q, kc, vc, lengths)
        want = attention.flash_decode_reference(q, kc, vc, lengths)
        assert err_over_tol(torch, got, want)[1] <= 1.0, width
        pool_k, pool_v = rnd(80, 1, 8, width), rnd(80, 1, 8, width)
        tables = torch.randperm(80, generator=g, device="cuda")[:3 * 25] \
            .reshape(3, 25).to(torch.int32)
        tables[1, 3] = -1
        got = attention.paged_flash_decode(q, pool_k, pool_v, tables,
                                           lengths, window=100)
        want = attention.paged_flash_decode_reference(
            q, pool_k, pool_v, tables, lengths, window=100)
        assert err_over_tol(torch, got, want)[1] <= 1.0, width


# The decode kernels' split edges at bf16 d 64 (tests/test_torch_split_
# decode.py holds the same split on the CPU): (b, h, hkv, max_len, d),
# lengths, keyword arguments.
SPLIT_CASES = [
    ((4, 16, 2, 1024, 64), [0, 1, 5, 128], {}),        # < 8 keys; 8 x 16
    ((4, 16, 2, 1024, 64), [129, 127, 17, 1000], {}),
    ((4, 16, 2, 1024, 64), [150, 37, 301, 1024], {"window": 100}),
    ((4, 16, 2, 384, 64), [1, 100, 255, 384], {"window": 256, "ring": True}),
    ((4, 16, 2, 384, 64), [385, 700, 1024, 5000],
     {"window": 256, "ring": True}),
    ((8, 16, 2, 384, 64), [200] * 8, {}),               # generate's shape
    ((2, 4, 4, 300, 64), [77, 300], {}),                # group 1
    ((2, 64, 1, 300, 64), [77, 300], {}),               # group 64
    ((2, 20, 1, 300, 64), [33, 250], {}),               # two m-tiles
    ((4, 16, 2, 300, 48), [5, 63, 129, 300], {}),
    ((4, 16, 2, 300, 96), [5, 63, 129, 300], {"window": 70}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_decode_kernel_split_edges(case):
    """K3 at the split's edges against its plain version, and the same
    inputs twice give equal outputs bit for bit (the cluster merge runs
    in rank order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (b, h, hkv, max_len, d), lengths, kw = SPLIT_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(20 + case)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(b, h, 1, d), rnd(b, hkv, max_len, d), \
        rnd(b, hkv, max_len, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = attention.flash_decode(q, k, v, ln, **kw)
    again = attention.flash_decode(q, k, v, ln, **kw)
    want = attention.flash_decode_reference(q, k, v, ln, **kw)
    torch.cuda.synchronize()
    assert err_over_tol(torch, got, want)[1] <= 1.0
    assert torch.equal(got, again)


# K4's split edges at bf16 d 64: (bs, tpr, lengths, edits, window).
PAGED_SPLIT_CASES = [
    (16, 64, [1024, 300, 5, 128], tuple((0, e, -1) for e in range(24)),
     None),                                             # parts all dead
    (16, 64, [1024, 300, 129, 17], ((1, 3, -1), (2, 0, 10 ** 6)), None),
    (8, 128, [0, 1, 700, 1024], ((2, 5, -1),), 300),
    (64, 16, [0, 65, 700, 1024], ((3, 1, -1),), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CASES)))
def test_paged_decode_kernel_split_edges(case):
    """K4 at the split's edges (parts whose blocks are all dead, a dead
    block below the length, an entry past the pool, block sizes 8 and
    64) against its plain version, bit for bit twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    bs, tpr, lengths, edits, window = PAGED_SPLIT_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(40 + case)
    slots, h, hkv, d = 4, 16, 2, 64
    nb = slots * tpr

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(slots, h, 1, d), rnd(nb, hkv, bs, d), rnd(nb, hkv, bs, d)
    tables = torch.randperm(nb, generator=g, device="cuda").reshape(
        slots, tpr).to(torch.int32)
    for row, entry, block in edits:
        tables[row, entry] = block
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = attention.paged_flash_decode(q, k, v, tables, ln, window=window)
    again = attention.paged_flash_decode(q, k, v, tables, ln, window=window)
    want = attention.paged_flash_decode_reference(q, k, v, tables, ln,
                                                  window=window)
    torch.cuda.synchronize()
    assert err_over_tol(torch, got, want)[1] <= 1.0
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_ring_attention_function_on_cuda():
    """make_ring_attention's kernel impl over 4 ranks on one card: each
    visible hop launches K5 once forward and K6 (dq, dk/dv) once
    backward, 10 each for 4 causal ranks, and the output and gradients
    agree with the einsum ring (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tpu_autoscaler_torch.workloads import ring_attention

    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = _bwd_inputs(g, torch.float32, 2, 8, 2, 256, 64)
    outs, grads = [], []
    for impl in ("pallas", "einsum"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attention.reset_launch_counts()
        out = ring_attention.make_ring_attention(
            ["cuda"] * 4, impl=impl, window=100)(*leaves)
        grads.append(torch.autograd.grad(out, leaves, do))
        outs.append(out)
        if impl == "pallas":
            counts = dict(attention.LAUNCHES)
    # window 100 over s_loc 64: each rank sees its diagonal and up to two
    # earlier blocks (the second cut by the window): 4 + 3 + 2 = 9 hops.
    assert counts["ring_flash_step"] == 9
    assert counts["ring_flash_bwd_dq"] == counts["ring_flash_bwd_dkv"] == 9
    torch.cuda.synchronize()
    assert (outs[0] - outs[1]).abs().max().item() <= 2e-5
    for gt, wt in zip(*grads):
        assert grad_err_over_tol(torch, gt, wt)[1] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_at_a_speculative_draft_tick(dtype):
    """K4 where the speculative engine's draft calls it: a small
    SpeculativePagedBatcher on the card serves mixed prompts; the draft
    pool, block tables and lengths of its median draft step, with a
    random q, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses

    import numpy as np

    from tpu_autoscaler_torch.workloads import model, serving, spec_serving

    cfg = model.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, seq_len=128, dtype=dtype)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    dparams = {**params, "blocks": {n: w[:1]
                                    for n, w in params["blocks"].items()}}
    eng = spec_serving.SpeculativePagedBatcher(
        params, cfg, dparams, dataclasses.replace(cfg, n_layers=1), k=3,
        slots=4, max_len=128, block_size=16, chunk=16, device="cuda")
    seen, step = [], eng._d_decode

    def capture(p, cache, tables, tokens, active):
        seen.append((tables.clone(), (cache.lengths + 1).clone()))
        return step(p, cache, tables, tokens, active)

    eng._d_decode = capture
    rng = np.random.default_rng(0)
    for n in (5, 40, 17, 90, 33):
        eng.submit(serving.Request(prompt=rng.integers(0, 256, (n,)).astype(
            np.int32), max_new_tokens=12))
    eng.run()
    assert seen
    tables, lengths = (t.cuda() for t in seen[len(seen) // 2])
    k_pool, v_pool = eng.d_cache.k[0], eng.d_cache.v[0]
    q = torch.randn((4, 4, 1, cfg.head_dim), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(dtype)
    got = attention.paged_flash_decode(q, k_pool, v_pool, tables, lengths)
    want = attention.paged_flash_decode_reference(q, k_pool, v_pool, tables,
                                                  lengths)
    torch.cuda.synchronize()
    err, share = err_over_tol(torch, got, want)
    assert share <= 1.0, (err, share, TOL_REASON[str(dtype)])


MOE_SMALL = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, seq_len=64, dtype=torch.float32, moe_experts=8,
                 moe_top_k=2)


@pytest.mark.cuda
def test_moe_engine_tick_on_cuda():
    """A small f32 MoE model's decode tick on the card: the kernel route
    (K3) against the einsum route on the same cache and tokens, logits
    within 2e-4; then the whole engine, whose greedy tokens equal the
    einsum route's and whose K3 launches are decode steps x layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses

    import numpy as np

    from tpu_autoscaler_torch.workloads import model, serving

    cfg = model.ModelConfig(**MOE_SMALL)
    ecfg = dataclasses.replace(cfg, attention="einsum")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 33)]
    out, steps = [], []
    for c in (cfg, ecfg):
        eng = serving.ContinuousBatcher(params, c, slots=3, max_len=64,
                                        chunk=8, device="cuda")
        reqs = [serving.Request(prompt=p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            eng.submit(r)
        attention.reset_launch_counts()
        eng.run()
        out.append([list(r.generated) for r in reqs])
        steps.append((eng.decode_steps, attention.LAUNCHES["flash_decode"]))
    assert out[0] == out[1]
    assert steps[0][1] == steps[0][0] * cfg.n_layers > 0
    assert steps[1][1] == 0
    cache = eng.cache
    tokens = torch.tensor([3, 7, 11], device="cuda")
    active = torch.ones(3, dtype=torch.bool, device="cuda")
    copy = serving.SlotKVCache(cache.k.clone(), cache.v.clone(),
                               cache.lengths.clone())
    cast = model.cast_params(params, cfg.dtype, "cuda")
    got, _ = serving.make_slot_decode_step(cfg)(cast, cache, tokens, active)
    want, _ = serving.make_slot_decode_step(ecfg)(cast, copy, tokens, active)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_moe_train_step_on_cuda():
    """One make_train_step step of a small f32 MoE model on the card: the
    kernel route (K1 forward, K2 backward) against the einsum route from
    the same params and batch: losses within 1e-4, the router losses
    within 1e-5, the params after the step within 1e-3 of each leaf's
    largest |value| (Adam's first step moves a param by about the LR
    whatever its gradient's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses

    import numpy as np

    from tpu_autoscaler_torch.workloads import model

    cfg = model.ModelConfig(**MOE_SMALL)
    tokens = np.random.default_rng(1).integers(0, 256, (4, 65)).astype(
        np.int32)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, attention="einsum")):
        init_fn, step_fn = model.make_train_step(c, device="cuda")
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(1))
        _, metrics = model.loss_and_metrics(
            params, torch.from_numpy(tokens).cuda(), c)
        attention.reset_launch_counts()
        params, opt, loss = step_fn(params, opt, tokens)
        runs.append((loss.item(), metrics, params,
                     dict(attention.LAUNCHES)))
    (kl, km, kp, kn), (el, em, ep, en) = runs
    assert abs(kl - el) <= 1e-4
    for name in ("balance_loss", "z_loss"):
        assert abs(km[name].item() - em[name].item()) <= 1e-5, name
    assert kn["flash_attention"] == kn["flash_attention_bwd_dq"] == 2
    assert en["flash_attention"] == 0
    ep = dict(model._flatten(ep))
    for path, a in model._flatten(kp):
        gap = ((a - ep[path]).abs().max() / ep[path].abs().max()).item()
        assert gap <= 1e-3, (path, gap)
