"""Model flops of the traced ticks over their seconds at the bf16 peak:
2 flops a matrix parameter for every token a step served (decode rows
that were active, prompt tokens that were valid; the unembedding for
the rows whose logits were taken) plus 4*d a visible (query, key) pair
for every head and layer.  Padding the steps compute anyway does not
count.  Moves ``serve_tokens_per_s``."""

from perfbench.metrics import _arith


def flops(record) -> float:
    prof, m = record["profile"], record["model"]
    total = 0
    attn = 0
    for lengths, active in prof["decode_calls"]:
        rows = int(active.sum())
        total += 2 * (m["block_params"] + m["unembed_params"]) * rows
        attn += sum(min(int(n) + 1, m["window"])
                    for n, a in zip(lengths, active) if a)
    for offsets, n_valid in prof["prefill_calls"]:
        for off, n in zip(offsets, n_valid):
            if n <= 0:
                continue
            total += 2 * m["block_params"] * int(n) + 2 * m["unembed_params"]
            attn += sum(min(int(off) + i + 1, m["window"]) for i in range(n))
    return total + _arith.attention_flops(attn, m["heads"], m["head_dim"],
                                          m["layers"])


def read(record):
    prof = record.get("profile")
    if not prof or not (prof.get("decode_calls") or prof.get("prefill_calls")):
        return None
    return _arith.mfu(flops(record), prof["window_s"])
