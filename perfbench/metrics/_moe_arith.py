"""The yardstick of the expert layer (``model.moe_ffn``'s dropless
route): which device kernels are its grouped products, their least
time per call from the program's ``serve.moe`` counter, and the model
flops of a step of a mixed-kind MoE model.

Least time of one call of the expert half: the larger of its bytes over
the memory rate and its flops over the bf16 peak (:mod:`_arith`'s H100
rates).  Bytes: the weights of every expert that took a token (gate|up
[d, 2 f] and down [f, d]) read once, and the activations of every
assignment moved in and out of each product (d in, 2 f out; f in, d
out).  Flops: 2 per weight element per assignment.
"""

from __future__ import annotations

from perfbench.metrics import _arith

#: Names of the device kernels of ``torch._grouped_mm`` (bf16 on sm_90):
#: CUTLASS's grouped GEMM and the kernel that lays out its problems.
GROUPED_GEMM = ("GroupProblemShape", "prepare_grouped_gemm_data")


def is_grouped_gemm(name: str) -> bool:
    return any(p in name for p in GROUPED_GEMM)


def expert_bytes(assignments: int, experts_hit: int, d: int, f: int,
                 elem: int = 2) -> int:
    weights = experts_hit * (d * 2 * f + f * d)
    activations = assignments * (d + 2 * f + f + d)
    return (weights + activations) * elem


def expert_flops(assignments: int, d: int, f: int) -> int:
    return 2 * assignments * (d * 2 * f + f * d)


def expert_bound_ms(assignments: int, experts_hit: int, d: int,
                    f: int) -> float:
    """Least time of one call's grouped products, in ms."""
    return 1e3 * max(expert_bytes(assignments, experts_hit, d, f)
                     / _arith.HBM_BYTES_PER_S,
                     expert_flops(assignments, d, f)
                     / _arith.BF16_OPS_PER_S)


def attention_pairs(positions, kinds) -> int:
    """Visible (query, key) pairs of one head summed over the layers, for
    queries at absolute ``positions`` (each sees itself and every key
    before it): ``kinds`` lists each layer kind's ``window`` (None =
    full) and its number of ``layers``."""
    total = 0
    for kind in kinds:
        w = kind["window"]
        seen = sum(p + 1 if w is None else min(p + 1, w) for p in positions)
        total += seen * kind["layers"]
    return total


def step_flops(record) -> float:
    """Model flops of the profiled ticks: 2 per active matrix parameter
    (attention, the router, the k experts of every layer) for every
    token a step served (decode rows that were active, prompt tokens
    that were valid), 2 per unembedding parameter for every row whose
    logits were taken, and 4 * head_dim per visible (query head, key)
    pair, counted per layer kind.  Padding does not count."""
    prof, m = record["profile"], record["model"]
    tokens = rows = 0
    positions = []
    for lengths, active in prof["decode_calls"]:
        live = [int(n) for n, a in zip(lengths, active) if a]
        tokens += len(live)
        rows += len(live)
        positions += live
    for offsets, n_valid in prof["prefill_calls"]:
        for off, n in zip(offsets, n_valid):
            if n > 0:
                tokens += int(n)
                rows += 1
                positions += range(int(off), int(off) + int(n))
    pairs = attention_pairs(positions, m["kinds"])
    return (2 * m["active_layer_params"] * tokens
            + 2 * m["unembed_params"] * rows
            + 4 * m["head_dim"] * m["heads"] * pairs)
