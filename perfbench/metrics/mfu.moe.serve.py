"""Model flops of the traced ticks of a mixture-of-experts model with
mixed layer kinds over their seconds at the bf16 peak
(:func:`_moe_arith.step_flops`: the active matrix parameters, the k
experts and not all of them, and each layer kind's visible pairs).
Moves ``serve_tokens_per_s``."""

from perfbench.metrics import _arith, _moe_arith


def read(record):
    prof = record.get("profile")
    if not prof or "kinds" not in record.get("model", {}) or not (
            prof.get("decode_calls") or prof.get("prefill_calls")):
        return None
    return _arith.mfu(_moe_arith.step_flops(record), prof["window_s"])
