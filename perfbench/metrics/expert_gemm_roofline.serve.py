"""The expert layer's grouped products against their roofline over the
traced ticks: the sum of each call's least time
(:func:`_moe_arith.expert_bound_ms`, from the program's ``serve.moe``
counter: the call's assignments and the experts that took a token)
over the device time of the grouped-product kernels.  Moves
``serve_tokens_per_s``."""

from perfbench.metrics import _moe_arith


def read(record):
    prof, m = record.get("profile"), record.get("model", {})
    if not prof or not prof.get("moe_calls"):
        return None
    spent = sum(e - s for name, s, e in prof["device"]
                if _moe_arith.is_grouped_gemm(name)) / 1e3
    if spent <= 0:
        return None
    bound = sum(_moe_arith.expert_bound_ms(int(a), int(hit), m["d_model"],
                                           m["expert_ff"])
                for a, hit in prof["moe_calls"])
    return 100.0 * bound / spent
