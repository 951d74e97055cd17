"""K2 (``flash_attention``'s backward: the dq and the dk/dv kernels)
against its roofline over the traced steps: each kernel's least time
(:func:`_arith.bwd_bounds`, 6*d and 8*d flops per visible (query head,
key) pair, or its bytes) times its launches, summed over both kernels,
over their device time.  Moves ``train_tokens_per_s``."""

from perfbench.metrics import _arith

KERNELS = {"dq": "bwd_dq_tc_kernel", "dkv": "bwd_dkv_tc_kernel"}


def read(record):
    prof, m = record.get("profile"), record["model"]
    if not prof:
        return None
    pairs = _arith.visible_pairs(m["seq"], True, m["window"])
    bounds = _arith.bwd_bounds(m["batch"], m["heads"], m["kv_heads"],
                               m["seq"], m["head_dim"], 2, pairs,
                               "torch.bfloat16")
    bound = spent = 0.0
    for part, kernel in KERNELS.items():
        spans = [e - s for name, s, e in prof["device"] if kernel in name]
        bound += bounds[part][0] * len(spans)
        spent += sum(spans) / 1e3
    return 100.0 * bound / spent if spent > 0 else None
