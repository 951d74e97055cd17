"""K1 (``flash_attention``'s forward, remat's recompute included)
against its roofline over the traced steps: each launch's least time
(q, k, v, out and lse moved once, or 4*d flops per visible (query
head, key) pair, :func:`_arith.fwd_bound_ms`) times the launches, over
their device time.  Moves ``train_tokens_per_s``."""

from perfbench.metrics import _arith

KERNEL = "fwd_tc_kernel"


def read(record):
    prof, m = record.get("profile"), record["model"]
    if not prof:
        return None
    spans = [e - s for name, s, e in prof["device"] if KERNEL in name]
    if not spans or sum(spans) <= 0:
        return None
    pairs = _arith.visible_pairs(m["seq"], True, m["window"])
    ms, _ = _arith.fwd_bound_ms(m["batch"], m["heads"], m["kv_heads"],
                                m["seq"], m["head_dim"], 2, pairs,
                                "torch.bfloat16")
    return 100.0 * ms * len(spans) / (sum(spans) / 1e3)
