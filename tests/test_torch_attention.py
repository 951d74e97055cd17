"""The port's ``flash_decode`` against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the port's wrapper runs its plain version
(``flash_decode_reference``); the JAX side runs the Pallas kernel in
interpret mode and the einsum references (``decode._cached_attention``,
``serving._slot_ring_attention``).  All in f32, tolerance 2e-5 (the JAX
package's own kernel-vs-einsum tolerance).  The CUDA kernel itself is
held against the plain version on the card
(``tests/test_torch_kernels.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import serving as jax_serving  # noqa: E402
from tpu_autoscaler.workloads.model import (  # noqa: E402
    ModelConfig as JaxConfig,
)
from tpu_autoscaler_torch.workloads import attention  # noqa: E402
from tpu_autoscaler_torch.workloads import serving  # noqa: E402
from tpu_autoscaler_torch.workloads.model import ModelConfig  # noqa: E402

TOL = 2e-5


def _inputs(b, h, hkv, max_len, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, max_len, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, max_len, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, lengths, **kw):
    out = attention.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.as_tensor(lengths), **kw)
    return out.numpy()


def _jax_kernel(q, k, v, lengths, **kw):
    return np.asarray(jax_attention.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32), block_k=8, interpret=True, **kw))


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_linear_matches_jax_kernel_and_einsum(h, hkv):
    """Per-row lengths including 0 (zeros out), a full cache, and the
    scalar length of the fixed-batch path."""
    b, max_len, d = 4, 16, 8
    q, k, v = _inputs(b, h, hkv, max_len, d, seed=h * 10 + hkv)
    lengths = np.array([0, 1, 9, 16], np.int32)
    got = _port(q, k, v, lengths)
    np.testing.assert_allclose(got, _jax_kernel(q, k, v, lengths),
                               rtol=TOL, atol=TOL)
    assert not got[0].any()
    cfg = JaxConfig(vocab=64, d_model=h * d, n_heads=h, n_kv_heads=hkv,
                    dtype=jnp.float32)
    for length in (1, 7, 16):
        want = jax_decode._cached_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.int32(length), cfg)
        np.testing.assert_allclose(_port(q, k, v, np.int32(length)),
                                   np.asarray(want), rtol=TOL, atol=TOL)


def test_window_matches_jax_kernel_and_einsum():
    b, h, hkv, max_len, d, window = 3, 4, 2, 16, 8, 5
    q, k, v = _inputs(b, h, hkv, max_len, d, seed=3)
    lengths = np.array([2, 11, 16], np.int32)
    got = _port(q, k, v, lengths, window=window)
    np.testing.assert_allclose(
        got, _jax_kernel(q, k, v, lengths, window=window),
        rtol=TOL, atol=TOL)
    jcfg = JaxConfig(vocab=64, d_model=h * d, n_heads=h, n_kv_heads=hkv,
                     attention_window=window, dtype=jnp.float32)
    want = jax_serving._slot_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), jcfg)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lengths", [[5, 13], [21, 40]],
                         ids=["before-wrap", "after-wrap"])
def test_ring_matches_jax_kernel_and_ring_einsum(lengths):
    b, h, hkv, width, d, window = 2, 4, 2, 16, 8, 12
    q, k, v = _inputs(b, h, hkv, width, d, seed=8)
    ln = np.array(lengths, np.int32)
    got = _port(q, k, v, ln, window=window, ring=True)
    np.testing.assert_allclose(
        got, _jax_kernel(q, k, v, ln, window=window, ring=True),
        rtol=TOL, atol=TOL)
    jcfg = JaxConfig(vocab=64, d_model=h * d, n_heads=h, n_kv_heads=hkv,
                     attention_window=window, dtype=jnp.float32)
    want = jax_serving._slot_ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        jcfg, window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # The port's own einsum ring path agrees with its kernel's plain
    # version too (the two routes of _slot_attend).
    tcfg = ModelConfig(vocab=64, d_model=h * d, n_heads=h, n_kv_heads=hkv,
                       attention_window=window, dtype=torch.float32)
    mine = serving._slot_ring_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ln), tcfg, window)
    np.testing.assert_allclose(got, mine.numpy(), rtol=TOL, atol=TOL)


def test_wrapper_rejections():
    q = torch.zeros((1, 2, 3, 8))
    kc = torch.zeros((1, 2, 16, 8))
    with pytest.raises(ValueError, match="single-token"):
        attention.flash_decode(q, kc, kc, 4)
    q1 = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError, match="requires a window"):
        attention.flash_decode(q1, kc, kc, 4, ring=True)
    with pytest.raises(ValueError, match="does not fit"):
        attention.flash_decode(torch.zeros((1, 3, 1, 8)), kc, kc, 4)
    cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, dtype=torch.float32,
                      attention="kernel")
    with pytest.raises(ValueError, match="needs CUDA"):
        serving._slot_attend(q1, kc, kc, torch.tensor([4]), cfg)


def test_auto_resolves_by_device_and_head_dim():
    cfg = ModelConfig(d_model=256, n_heads=4)           # head_dim 64
    assert cfg.resolved_attention(torch.device("cpu")) == "einsum"
    assert cfg.resolved_attention(torch.device("cuda")) == "kernel"
    # A head_dim the kernel is not built for still resolves to the
    # kernel on CUDA, which runs it zero-padded to a built width: never a
    # plain run there.
    odd = ModelConfig(d_model=192, n_heads=4)           # head_dim 48
    assert odd.head_dim not in attention.KERNEL_HEAD_DIMS
    assert odd.resolved_attention(torch.device("cuda")) == "kernel"
    assert odd.resolved_attention(torch.device("cpu")) == "einsum"
    assert ModelConfig(attention="einsum").resolved_attention(
        torch.device("cuda")) == "einsum"


# ---- reference_attention ---------------------------------------------------

REF_CASES = {"mha-causal": (4, 4, True, None), "gqa-causal": (4, 2, True, None),
             "mqa-window5": (4, 1, True, 5), "gqa-window3": (4, 2, True, 3),
             "mha-full": (4, 4, False, None), "gqa-full": (4, 2, False, None)}


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_attention_matches_jax(case):
    """``reference_attention`` against JAX's (attention.py's einsum
    oracle) in f32: MHA, GQA and MQA, causal, windowed and non-causal."""
    h, hkv, causal, window = REF_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, h, 24, 8), (2, hkv, 24, 8), (2, hkv, 24, 8)))
    got = attention.reference_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    want = jax_attention.reference_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# The mean |Δ| of the bf16 Ulysses outputs over their mean |value|: the
# einsum route on both sides keeps P in f32, so the two differ only where
# an f32 summation order tips a bf16 rounding.  The kernel's plain
# version casts P to bf16 before PV and lands well above it.
ULYSSES_BF16_REL = 1e-5


def test_ulysses_einsum_matches_jax_in_bf16():
    """The port's einsum Ulysses (``reference_attention`` on each rank's
    heads) against JAX's ``make_ulysses_attention(impl="einsum")`` on an
    sp 2 mesh, in bf16, within ULYSSES_BF16_REL; the kernel's plain
    version (``flash_attention_reference``), the route before, does not
    meet that bound on the same inputs."""
    from jax.sharding import Mesh

    from tpu_autoscaler.workloads import ulysses as jax_ulysses
    from tpu_autoscaler_torch.workloads import ulysses

    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 4, 64, 16), (2, 2, 64, 16), (2, 2, 64, 16)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ulysses.make_ulysses_attention(["cpu"] * 2, impl="einsum")(
        tq, tk, tv)
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("sp",))
    want = np.asarray(jax_ulysses.make_ulysses_attention(
        mesh, impl="einsum")(*(jnp.asarray(x, jnp.bfloat16)
                               for x in (q, k, v))).astype(jnp.float32))
    old = attention.flash_attention_reference(tq, tk, tv)[0]
    assert got.dtype == torch.bfloat16

    def rel(t):
        return float(np.abs(t.float().numpy() - want).mean()
                     / np.abs(want).mean())

    assert rel(got) <= ULYSSES_BF16_REL < rel(old), (rel(got), rel(old))
