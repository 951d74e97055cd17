"""The benchmark's yardstick: peaks, the least time of each kernel's
work, kernel classes, the device's busy time from a trace, and model
flops.

``bound_ms``, ``live_keys``, ``visible_pairs``, ``bwd_flops``,
``bwd_bounds``, ``KERNEL_CLASSES`` and ``kernel_class`` are frozen
copies of ``chip_smoke.py``'s ``_bound_ms``, ``_live_keys``,
``_visible_pairs``, ``_bwd_flops``, ``_bwd_bounds``, ``KERNEL_CLASSES``
and ``_kernel_class`` (code unchanged but for the names), and
``fwd_bound_ms`` is the K1 bound of its ``check_attn_case``.  The busy
time is the union of the device's intervals, not their sum, so two
kernels that overlap count once.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12        # device memory rate
BF16_OPS_PER_S = 989e12          # bf16 tensor-core peak
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores


def live_keys(lengths, max_len: int, window, ring: bool) -> list[int]:
    """Keys each row can see: what the kernel must read."""
    out = []
    for n in lengths:
        if n <= 0:
            out.append(0)
            continue
        live = min(n, max_len)
        if window is not None:
            live = min(live, window)
        out.append(live)
    return out


def bound_ms(b, h, hkv, d, elem, live, dtype_name,
             extra_bytes: int = 0) -> tuple[float, str]:
    """Least time for the work: each live K/V row, q, out, lengths (and
    ``extra_bytes``, e.g. a block table) moved once, against ~4*d flops
    per (query head, live key)."""
    moved = sum(live) * hkv * d * elem * 2 + 2 * b * h * d * elem + 4 * b \
        + extra_bytes
    ops = 4 * d * (h // hkv) * hkv * sum(live)
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs one head of a flash_attention call can see."""
    if not causal:
        return s * s
    w = s if window is None else min(window, s)
    # Query i sees min(i + 1, w) keys.
    return w * (w + 1) // 2 + (s - w) * w


def fwd_bound_ms(b, h, hkv, s, d, elem, pairs,
                 dtype_name) -> tuple[float, str]:
    """Least time of one flash_attention forward: q, k, v and out moved
    once and the f32 lse written, against 4*d flops per visible (query
    head, key) pair."""
    moved = (2 * b * h + 2 * b * hkv) * s * d * elem + b * h * s * 4
    ops = 4 * d * b * h * pairs
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_flops(b, h, d, pairs) -> dict:
    """Flops the backward needs, for the whole backward and for each of
    its two kernels: 2*d per visible (query head, key) pair for each
    product of d-long vectors, 5 for the backward (q.k, do.v, P.do, dS.q,
    dS.k), 3 for dq alone (q.k, do.v, dS.k), 4 for dk/dv alone (q.k,
    do.v, P.do, dS.q)."""
    return {name: products * 2 * d * b * h * pairs
            for name, products in (("all", 5), ("dq", 3), ("dkv", 4))}


def bwd_bounds(b, h, hkv, s, d, elem, pairs, dtype_name):
    """Least times of the backward's work, as (ms, bound_by) for the
    whole backward and for each of its two kernels.  Bytes: each input
    read once and each output written once (q, out, do, dq over h heads;
    k, v, dk, dv over hkv; the f32 lse and delta); operations:
    :func:`bwd_flops`."""
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    q_t, kv_t, row = b * h * s * d * elem, b * hkv * s * d * elem, b * h * s * 4
    moved = {"all": 4 * q_t + 4 * kv_t + 2 * row,
             "dq": 3 * q_t + 2 * kv_t + 2 * row,
             "dkv": 2 * q_t + 4 * kv_t + 2 * row}
    out = {}
    for name, flops in bwd_flops(b, h, d, pairs).items():
        t_bytes = moved[name] / HBM_BYTES_PER_S
        t_ops = flops / peak
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


# Device kernels by class, the first pattern their name matches: the
# port's attention kernels, cuBLAS/CUTLASS products, copies (the casts
# of f32 masters to bf16 and the moves between ranks), adds (the
# replicas' gradient sums, the residual stream, the update), reductions.
KERNEL_CLASSES = (
    ("attention", re.compile(r"flash|ring_|decode_kernel|tc_kernel")),
    ("gemm", re.compile(r"gemm|xmma|cutlass|nvjet|wgmma|sm90_", re.I)),
    ("copy", re.compile(r"copy|Memcpy", re.I)),
    ("add", re.compile(r"add", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
)


def kernel_class(name: str) -> str:
    return next((c for c, pat in KERNEL_CLASSES if pat.search(name)),
                "other")


# ---- the device's busy time ----------------------------------------------

def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of [start, end) intervals clipped to [lo, hi], as
    disjoint intervals in order."""
    out: list[list[float]] = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one interval runs."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi]: where no interval runs."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out


# ---- model flops ----------------------------------------------------------

def attention_flops(pairs: int, heads: int, head_dim: int,
                    layers: int) -> int:
    """Forward flops of attention over ``pairs`` visible (query, key)
    pairs of one head: q.k and p.v, 2*d each, for every head and
    layer."""
    return 4 * head_dim * heads * layers * pairs


def mfu(flops: float, seconds: float) -> float | None:
    """Share of the bf16 peak, in %; None without a window."""
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * BF16_OPS_PER_S)
