"""Model flops of the traced steps over their seconds at the bf16 peak:
6 flops a matrix parameter (the blocks and the unembedding; not the
embedding's gather) for every token, plus 12*d a visible (query, key)
pair for every head and layer (4*d forward, 8*d backward).  Remat's
recompute does not count.  Moves ``train_tokens_per_s``."""

from perfbench.metrics import _arith


def read(record):
    prof, m = record.get("profile"), record["model"]
    if not prof or not prof.get("steps"):
        return None
    tokens = m["batch"] * m["seq"]
    pairs = _arith.visible_pairs(m["seq"], True, m["window"]) * m["batch"]
    step = 6 * (m["block_params"] + m["unembed_params"]) * tokens \
        + 3 * _arith.attention_flops(pairs, m["heads"], m["head_dim"],
                                     m["layers"])
    return _arith.mfu(step * prof["steps"], prof["window_s"])
