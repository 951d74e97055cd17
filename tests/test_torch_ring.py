"""The port's ring attention against the JAX package's, on the CPU: the
plain versions of the ring hop (K5) and its backward (K6) against the
JAX kernels in interpret mode, ``make_ring_attention`` (einsum and
kernel impls, outputs and gradients) against JAX's on an ``sp`` mesh of
the virtual CPU devices, and ``make_ulysses_attention``.

Inputs are made with numpy from a seed and go through both packages in
f32.  The port's ranks are ``["cpu"] * world``, so the kernel impl runs
the plain versions of K5 and K6 (the CUDA kernels are held to those on
the card by tests/test_torch_kernels.py and chip_smoke.py).  Tolerance
2e-5 for hops, ring outputs and ring gradients (f32, summation order
only).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import ring_attention as jax_ring  # noqa: E402
from tpu_autoscaler.workloads import ulysses as jax_ulysses  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    attention,
    ring_attention,
    ulysses,
)

TOL = 2e-5
S_LOC = 16
HEADS = {"mha": (4, 4), "gqa": (4, 2), "mqa": (4, 1)}
# (heads, sq, sk, offset, masked, window, carry): the hop kinds of the
# ring schedule at s_loc 16 (the diagonal, a whole earlier block, blocks
# two back, blocks a window cuts, a window inside the diagonal block)
# over MHA, GQA and MQA, sq != sk, and a masked hop whose first rows see
# no key while their carry is fresh (m = -1e30), which a lone call can
# make and the ring cannot.
HOPS = {
    "diag-mha": ("mha", S_LOC, S_LOC, 0, True, None, "fresh"),
    "diag-mqa": ("mqa", S_LOC, S_LOC, 0, True, None, "random"),
    "diag-window5-gqa": ("gqa", S_LOC, S_LOC, 0, True, 5, "random"),
    "unmasked-prev-mqa": ("mqa", S_LOC, S_LOC, S_LOC, False, None,
                          "random"),
    "unmasked-2back-gqa": ("gqa", S_LOC, S_LOC, 2 * S_LOC, False, None,
                           "random"),
    "window-cut-20-mha": ("mha", S_LOC, S_LOC, S_LOC, True, 20, "random"),
    "window-cut-20-gqa": ("gqa", S_LOC, S_LOC, S_LOC, True, 20, "fresh"),
    "window-cut-40-2back-mqa": ("mqa", S_LOC, S_LOC, 2 * S_LOC, True, 40,
                                "random"),
    "sq24-sk8-gqa": ("gqa", 24, 8, 3, True, 9, "random"),
    "no-key-fresh-rows-mha": ("mha", S_LOC, S_LOC, -5, True, None, "fresh"),
}


def _np(t):
    return t.detach().cpu().numpy()


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _hop_inputs(hop, seed):
    heads, sq, sk, offset, masked, window, carry = HOPS[hop]
    h, hkv = HEADS[heads]
    b, d = 2, 8
    q, k, v, acc = _rng_arrays(seed, (b, h, sq, d), (b, hkv, sk, d),
                               (b, hkv, sk, d), (b, h, sq, d))
    rng = np.random.default_rng(seed + 1)
    if carry == "fresh":
        m = np.full((b, h, sq, 1), -1e30, np.float32)
        l_ = np.zeros((b, h, sq, 1), np.float32)
        acc = np.zeros_like(acc)
    else:
        m = rng.standard_normal((b, h, sq, 1)).astype(np.float32)
        l_ = rng.uniform(0.5, 3.0, (b, h, sq, 1)).astype(np.float32)
    return (q, k, v, m, l_, acc), dict(offset=offset, masked=masked,
                                       window=window)


@pytest.mark.parametrize("hop", list(HOPS))
def test_ring_step_reference_matches_jax_kernel(hop):
    """K5's plain version against JAX ``ring_flash_step`` (interpret):
    m, l and acc within 2e-5, and the carry passed in left as it was."""
    arrays, kw = _hop_inputs(hop, seed=len(hop) * 7)
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    got = attention.ring_flash_step(*tensors, **kw)
    want = jax_attention.ring_flash_step(*map(jnp.asarray, arrays),
                                         interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TOL, atol=TOL)
    for t, a in zip(tensors, arrays):
        np.testing.assert_array_equal(_np(t), a)
    if hop == "no-key-fresh-rows-mha":
        # Rows 0-4 see no key: the reference's exp(-1e30 - (-1e30)) = 1
        # for every key, l = sk (ROADMAP.md, Queue 3).
        np.testing.assert_array_equal(_np(got[1])[:, :, :5], S_LOC)


@pytest.mark.parametrize("hop", list(HOPS))
def test_ring_bwd_step_reference_matches_jax_kernels(hop):
    """K6's plain version against JAX ``ring_flash_bwd_step``
    (interpret): dq_add, dk_add and dv_add within 2e-5, all f32."""
    (q, k, v, _, _, do), kw = _hop_inputs(hop, seed=len(hop) * 3)
    rng = np.random.default_rng(len(hop))
    lse = rng.uniform(1.0, 4.0, q.shape[:3] + (1,)).astype(np.float32)
    delta = rng.standard_normal(q.shape[:3] + (1,)).astype(np.float32)
    arrays = (q, k, v, do, lse, delta)
    got = attention.ring_flash_bwd_step(*map(torch.from_numpy, arrays), **kw)
    want = jax_attention.ring_flash_bwd_step(*map(jnp.asarray, arrays),
                                             interpret=True, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_ring_hop_wrappers_reject_bad_inputs():
    (q, k, v, m, l_, acc), _ = _hop_inputs("diag-window5-gqa", seed=0)
    q, k, v, m, l_, acc = map(torch.from_numpy, (q, k, v, m, l_, acc))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        attention.ring_flash_step(q[:, :3], k, v, m[:, :3], l_[:, :3],
                                  acc[:, :3], offset=0, masked=True)
    with pytest.raises(ValueError, match="m must be f32"):
        attention.ring_flash_step(q, k, v, m.double(), l_, acc, offset=0,
                                  masked=True)
    with pytest.raises(ValueError, match="k/v shape mismatch"):
        attention.ring_flash_bwd_step(q, k, v[:, :1], q, m, m, offset=0,
                                      masked=False)
    with pytest.raises(ValueError, match="lse must be f32"):
        attention.ring_flash_bwd_step(q, k, v, q, m[..., 0], m, offset=0,
                                      masked=False)


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), axis_names=("sp",))


def _qkv(seed, h=4, hkv=4, s=64, b=2, d=8):
    return _rng_arrays(seed, (b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                       (b, h, s, d))


def _jax_vjp(fn, q, k, v, g):
    """fn's output and the gradients of sum(out * g), in one jit (an
    eager vjp through shard_map dispatches op by op)."""
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    return jax.jit(run)(*map(jnp.asarray, (q, k, v, g)))


RING_CASES = {"causal": dict(causal=True),
              "full": dict(causal=False),
              "gqa-window12": dict(causal=True, window=12, hkv=2),
              "mqa-window40": dict(causal=True, window=40, hkv=1)}


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("impl", ["einsum", "pallas"])
@pytest.mark.parametrize("world", [2, 4])
def test_make_ring_attention_matches_jax(monkeypatch, world, impl, case):
    """Outputs and the gradients of sum(out * g) (torch.autograd.grad
    against jax.grad) within 2e-5 of JAX ``make_ring_attention`` with the
    same impl on an sp mesh of the same size (s 64: s_loc 32 or 16, so
    the windows skip hops, cut them and stay inside one block); the
    kernel impl runs the backward ring once."""
    kw = dict(RING_CASES[case])
    hkv = kw.pop("hkv", 4)
    q, k, v, g = _qkv(world * 10 + len(case), hkv=hkv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    attn = ring_attention.make_ring_attention(["cpu"] * world, impl=impl,
                                              **kw)
    calls = {"bwd": 0}
    real = ring_attention._ring_bwd_local_kernel

    def spy(*args, **kwargs):
        calls["bwd"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(ring_attention, "_ring_bwd_local_kernel", spy)
    out = attn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert calls["bwd"] == (impl == "pallas")
    jout, jgrads = _jax_vjp(jax_ring.make_ring_attention(
        _mesh(world), impl=impl, **kw), q, k, v, g)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for name, gt, w in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(_np(gt), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


def test_ring_matches_single_device_attention():
    """The kernel ring over 4 ranks equals one device's
    flash_attention_reference on the whole sequence (window cutting
    through blocks)."""
    q, k, v, _ = _qkv(5, hkv=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = ring_attention.make_ring_attention(["cpu"] * 4, impl="pallas",
                                             window=20)(tq, tk, tv)
    want, _ = attention.flash_attention_reference(tq, tk, tv, window=20)
    np.testing.assert_allclose(_np(out), _np(want), rtol=TOL, atol=TOL)


def test_ring_hop_modes_match_jax():
    """Every (src, rank) pair of worlds 2-4 at s_loc 16, causal or not,
    with windows inside, across and beyond a block: the same mode and
    offset as JAX ``_hop_mode``."""
    for world in (2, 3, 4):
        for causal, window in ((False, None), (True, None), (True, 5),
                               (True, 16), (True, 17), (True, 40)):
            for my in range(world):
                for src in range(world):
                    got = ring_attention._hop_mode(src, my, 16, causal,
                                                   window)
                    mode, off = jax_ring._hop_mode(src, my, 16, causal,
                                                   window)
                    assert got == (int(mode), int(off)), (world, causal,
                                                          window, my, src)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_ring_rejections_match_jax(impl):
    q, k, v, _ = _qkv(8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    attn = ring_attention.make_ring_attention(["cpu"] * 3, impl=impl)
    with pytest.raises(ValueError, match="must divide by the ring"):
        attn(tq, tk, tv)                                   # 64 % 3
    q3, k2, v2, _ = _qkv(8, h=3, hkv=2)
    with pytest.raises(ValueError, match="heads"):
        ring_attention.make_ring_attention(["cpu"] * 2, impl=impl)(
            *map(torch.from_numpy, (q3, k2, v2)))
    with pytest.raises(ValueError, match="window"):
        ring_attention.make_ring_attention(
            ["cpu"] * 2, causal=False, window=8, impl=impl)(tq, tk, tv)
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring_attention.make_ring_attention(["cpu"] * 2, impl="triton")


@pytest.mark.parametrize("world,hkv,window", [(2, 2, None), (4, 4, 12)],
                         ids=["w2-gqa", "w4-mha-window12"])
def test_make_ulysses_attention_matches_jax(world, hkv, window):
    """Outputs and gradients against JAX ``make_ulysses_attention``
    (impl="einsum") on an sp mesh of the same size; the port's default
    impl ("pallas": flash_attention, its plain versions on the CPU)."""
    q, k, v, g = _qkv(world + hkv, hkv=hkv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ulysses.make_ulysses_attention(["cpu"] * world,
                                         window=window)(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    jout, jgrads = _jax_vjp(jax_ulysses.make_ulysses_attention(
        _mesh(world), impl="einsum", window=window), q, k, v, g)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for gt, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(gt), np.asarray(w), rtol=TOL, atol=TOL)


def test_ulysses_head_divisibility_matches_jax():
    q, k, v, _ = _qkv(9, hkv=2)
    tensors = list(map(torch.from_numpy, (q, k, v)))
    with pytest.raises(ValueError, match="ulysses needs heads divisible"):
        ulysses.make_ulysses_attention(["cpu"] * 4)(*tensors)   # hkv 2
    with pytest.raises(ValueError, match="ulysses needs heads divisible"):
        jax_ulysses.make_ulysses_attention(_mesh(4), impl="einsum")(
            *map(jnp.asarray, (q, k, v)))
    with pytest.raises(ValueError, match="unknown ulysses attention impl"):
        ulysses.make_ulysses_attention(["cpu"] * 2, impl="ring")
