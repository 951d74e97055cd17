"""The decode kernels' split and merge (K3 ``flash_decode``, K4
``paged_flash_decode``), modelled in plain PyTorch on the CPU.

A CUDA kernel cannot run here, so the algorithm the kernels run is held
here instead.  Each (row, KV head, chunk of up to 32 query heads) is a
cluster of kSplits CTAs; CTA r folds the r-th contiguous part of the
row's visible positions [lo, hi], cut at whole kGranule-key blocks, into
a carry of its own, tile by tile (bf16: kMmaKeys keys, with P rounded
to bf16 at the running max; f32: kTileBytes of K); the parts' carries
are merged in rank order.  The constants are read from
``csrc/decode_common.cuh`` so the model follows the source.

The model is held against the plain versions (``flash_decode_reference``,
``paged_flash_decode_reference``): within 2e-5 in f32, and within
``chip_smoke.py``'s bf16 tolerance (2^-5 of each row's largest |out|) in
bf16; in f32 also against the JAX package's kernels in interpret mode,
on inputs made with numpy from a seed.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chip_smoke import decode_split, err_over_tol  # noqa: E402
from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler_torch.workloads import attention  # noqa: E402

F32_TOL = 2e-5


def _header_constants() -> dict[str, int]:
    text = (attention.CSRC / "decode_common.cuh").read_text()
    return {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


C = _header_constants()


def test_split_constants_follow_the_source():
    """The split is a portable cluster (at most 8 CTAs, launched without
    the non-portable attribute), and chip_smoke's decode_split counts a
    launch's CTAs from the header: the linear and paged main paths (4
    and 16 rows, 16 heads on 2 KV heads) and a group of 64 (two chunks a
    row)."""
    assert 1 <= C["kSplits"] <= 8
    assert C["kMaxGroup"] == 32
    assert decode_split(4, 16, 2) == (C["kSplits"], 4 * 2 * C["kSplits"])
    assert decode_split(16, 16, 2) == (C["kSplits"], 16 * 2 * C["kSplits"])
    assert decode_split(3, 64, 1) == (C["kSplits"], 3 * 2 * C["kSplits"])
    assert decode_split(4, 16, 2)[1] >= 64  # 8 CTAs before the split


def split_parts(lo: int, hi: int) -> list[tuple[int, int]]:
    """The kernels' split_part for every rank: (first, last), empty when
    first > last."""
    blocks = (hi - lo) // C["kGranule"] + 1 if hi >= lo else 0
    per = -(-blocks // C["kSplits"]) * C["kGranule"]
    return [(lo + r * per, min(hi, lo + r * per + per - 1))
            for r in range(C["kSplits"])]


def _empty(heads: int, d: int):
    return (torch.full((heads,), -1e30), torch.zeros(heads),
            torch.zeros(heads, d))


def _fold(carry, qh, keys, vals, live, scale, rounded):
    """Merge one tile of keys into a carry."""
    m, l, acc = carry
    s = (qh @ keys.T) * scale                                # [H, n]
    s = torch.where(live[None, :], s, torch.tensor(-1e30))
    m_new = torch.maximum(m, s.amax(dim=1))
    corr = torch.exp(m - m_new)
    p = torch.where(live[None, :], torch.exp(s - m_new[:, None]), 0.0)
    pv = p.to(torch.bfloat16).float() if rounded else p
    return m_new, l * corr + p.sum(dim=1), acc * corr[:, None] + pv @ vals


def _merge(carries):
    """Merge carries in their order, as cluster_merge does."""
    m = torch.stack([c[0] for c in carries])                 # [n, H]
    w = torch.exp(m - m.amax(dim=0))
    l = (w * torch.stack([c[1] for c in carries])).sum(dim=0)
    acc = (w[:, :, None] * torch.stack([c[2] for c in carries])).sum(dim=0)
    return m.amax(dim=0), l, acc


def split_decode_model(q, k_rows, v_rows, lo, hi, index, live):
    """The kernels' split and merge: q [b, h, 1, d]; k_rows/v_rows [b,
    hkv, n, d]; the visible positions [lo[i], hi[i]] of row i; index(i,
    pos) gives the rows of k_rows holding positions pos, live(i, pos)
    whether they were copied (not a dead block)."""
    b, h, _, d = q.shape
    hkv = k_rows.shape[1]
    group = h // hkv
    mma = q.dtype == torch.bfloat16
    width = attention.kernel_width(d)
    step = C["kMmaKeys"] if mma else C["kTileBytes"] // (width * 4)
    out = torch.zeros(b, h, d)
    for i in range(b):
        parts = split_parts(lo[i], hi[i])
        for kvh in range(hkv):
            for c0 in range(0, group, C["kMaxGroup"]):
                heads = torch.arange(c0, min(group, c0 + C["kMaxGroup"]))
                qh = q[i, kvh * group + heads, 0].float()
                carries = []
                for first, last in parts:
                    carry = _empty(len(heads), d)
                    for start in range(first, last + 1, step):
                        pos = torch.arange(start, min(last, start + step - 1)
                                           + 1)
                        rows = index(i, pos)
                        carry = _fold(
                            carry, qh, k_rows[i, kvh, rows].float(),
                            v_rows[i, kvh, rows].float(), live(i, pos),
                            d ** -0.5, mma)
                    carries.append(carry)
                _, l_sum, acc = _merge(carries)
                out[i, kvh * group + heads] = acc / l_sum.clamp_min(
                    1e-30)[:, None]
    return out.to(q.dtype).reshape(b, h, 1, d)


def _linear_model(q, k, v, lengths, window, ring):
    max_len = k.shape[2]
    lo, hi = [], []
    for n in lengths:
        qpos = n - 1
        lo.append(max([0] + ([qpos - window + 1] if window else [])
                      + ([qpos - max_len + 1] if ring else [])))
        hi.append(qpos if ring else min(qpos, max_len - 1))
    return split_decode_model(
        q, k, v, lo, hi, lambda i, pos: pos % max_len if ring else pos,
        lambda i, pos: torch.ones(len(pos), dtype=torch.bool))


def _paged_model(q, kp, vp, tables, lengths, window):
    bs = kp.shape[2]
    tpr = tables.shape[1]
    lo = [max(0, n - window) if window else 0 for n in lengths]
    hi = [min(n - 1, tpr * bs - 1) for n in lengths]
    return split_decode_model(
        q, attention.gather_pool_rows(kp, tables),
        attention.gather_pool_rows(vp, tables), lo, hi,
        lambda i, pos: pos, lambda i, pos: tables[i, pos // bs] >= 0)


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


# (label, kind, dims, lengths, window, edits): kind "linear" or "ring"
# (K3: dims b, h, hkv, max_len, d) or "paged" (K4: dims slots, h, hkv,
# nb, bs, tpr, d; edits (row, entry, block id) on a table of distinct
# random blocks, -1 past each row's length).
CASES = [
    # 0, 1, fewer keys than kSplits, exactly kSplits x 16, and one more.
    ("lengths-0-1-5-128", "linear", (4, 16, 2, 160, 64), [0, 1, 5, 128],
     None, ()),
    ("lengths-129-160", "linear", (4, 16, 2, 160, 64), [129, 160, 17, 96],
     None, ()),
    ("window-inside-parts", "linear", (4, 16, 2, 160, 64),
     [100, 150, 37, 160], 45, ()),
    ("ring-before-wrap", "ring", (4, 16, 2, 96, 64), [1, 40, 64, 96], 64,
     ()),
    ("ring-after-wrap", "ring", (4, 16, 2, 96, 64), [97, 150, 300, 1000],
     64, ()),
    ("group-1", "linear", (2, 4, 4, 160, 64), [77, 160], None, ()),
    ("group-64", "linear", (2, 64, 1, 160, 64), [77, 160], None, ()),
    ("group-20-two-m-tiles", "linear", (2, 20, 1, 160, 32), [33, 150],
     None, ()),
    ("d-48", "linear", (4, 16, 2, 160, 48), [1, 63, 129, 160], None, ()),
    ("d-96", "linear", (4, 16, 2, 160, 96), [5, 63, 129, 160], 70, ()),
    ("paged-part-all-dead", "paged", (4, 16, 2, 64, 16, 12, 64),
     [192, 150, 40, 0], None, ((0, 0, -1), (0, 1, -1), (0, 2, -1),
                               (0, 3, -1), (0, 4, -1), (0, 5, -1))),
    ("paged-dead-below-length", "paged", (4, 16, 2, 64, 16, 12, 64),
     [192, 150, 40, 129], None, ((1, 3, -1), (3, 0, -1))),
    ("paged-past-the-pool", "paged", (4, 16, 2, 64, 16, 12, 64),
     [192, 150, 40, 129], 50, ((2, 0, 64), (1, 5, 70))),
    ("paged-bs-8", "paged", (4, 16, 2, 128, 8, 24, 64), [1, 100, 17, 192],
     None, ((1, 2, -1), (3, 7, 130))),
    ("paged-bs-64", "paged", (4, 16, 2, 16, 64, 3, 64), [1, 100, 65, 192],
     70, ((3, 1, -1),)),
    ("paged-d-96-group-64", "paged", (2, 64, 1, 32, 16, 8, 96), [128, 33],
     None, ((0, 2, -1),)),
]


def _run_case(kind, dims, lengths, window, edits, dtype, seed):
    """(model, plain version, JAX kernel or None) on the same inputs."""
    if kind in ("linear", "ring"):
        b, h, hkv, max_len, d = dims
        (qn, kn, vn), (q, k, v) = _inputs(
            seed, dtype, (b, h, 1, d), (b, hkv, max_len, d),
            (b, hkv, max_len, d))
        ln = torch.tensor(lengths, dtype=torch.int32)
        ring = kind == "ring"
        got = _linear_model(q, k, v, lengths, window, ring)
        want = attention.flash_decode_reference(q, k, v, ln, window=window,
                                                ring=ring)
        jx = lambda: jax_attention.flash_decode(  # noqa: E731
            jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(np.array(lengths, np.int32)), window=window,
            ring=ring, interpret=True)
        return got, want, jx
    slots, h, hkv, nb, bs, tpr, d = dims
    (qn, kn, vn), (q, kp, vp) = _inputs(
        seed, dtype, (slots, h, 1, d), (nb, hkv, bs, d), (nb, hkv, bs, d))
    rng = np.random.default_rng(seed + 1000)
    tables = rng.permutation(nb)[:slots * tpr].reshape(slots, tpr) \
        if nb >= slots * tpr else rng.integers(0, nb, (slots, tpr))
    used = -(-np.array(lengths) // bs)
    tables = np.where(np.arange(tpr)[None, :] < used[:, None], tables, -1)
    for row, entry, block in edits:
        tables[row, entry] = block
    tables = tables.astype(np.int32)
    ln = np.array(lengths, np.int32)
    got = _paged_model(q, kp, vp, torch.from_numpy(tables), lengths, window)
    want = attention.paged_flash_decode_reference(
        q, kp, vp, torch.from_numpy(tables), torch.from_numpy(ln),
        window=window)
    jx = lambda: jax_attention.paged_flash_decode(  # noqa: E731
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(tables), jnp.asarray(ln), window=window, interpret=True)
    return got, want, jx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_model_matches_plain_versions(case, dtype):
    """The split-and-merge model against the plain version (and, in
    f32, the JAX kernel interpreted), with the kernels' tolerances."""
    label, kind, dims, lengths, window, edits = case
    got, want, jx = _run_case(kind, dims, lengths, window, edits, dtype,
                              seed=CASES.index(case))
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=F32_TOL)
        if not (kind == "ring" and 0 in lengths):
            np.testing.assert_allclose(got.numpy(), np.asarray(jx()),
                                       rtol=0, atol=F32_TOL)
    else:
        err, share = err_over_tol(torch, got, want)
        assert share <= 1.0, (label, err, share)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].float().any(), label


def test_split_parts_cover_the_range_once():
    """The parts of every range tile it exactly, in rank order, each a
    whole number of blocks but the last non-empty one; a range of n keys
    leaves ceil(n / 16) blocks over the ranks, and fewer than kSplits
    blocks leave the last ranks empty."""
    for lo in (0, 7, 100):
        for n in range(0, 300):
            parts = split_parts(lo, lo + n - 1)
            keys = [p for first, last in parts
                    for p in range(first, last + 1)]
            assert keys == list(range(lo, lo + n))
            sizes = [max(0, last - first + 1) for first, last in parts]
            full = [s for s in sizes if s][:-1]
            assert all(s % C["kGranule"] == 0 for s in full)
            blocks = -(-n // C["kGranule"])
            per = -(-blocks // C["kSplits"])
            assert sum(1 for s in sizes if s) == (-(-blocks // per)
                                                  if blocks else 0)
