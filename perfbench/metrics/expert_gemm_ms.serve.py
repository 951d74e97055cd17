"""Device ms a profiled tick of the expert layer's grouped products
(``torch._grouped_mm``'s kernels, found by name: ``_moe_arith.
GROUPED_GEMM``): their device time over the traced ticks over the
number of ticks.  Moves ``serve_tokens_per_s``."""

from perfbench.metrics import _moe_arith


def read(record):
    prof = record.get("profile")
    if not prof or not prof.get("ticks"):
        return None
    spent = sum(e - s for name, s, e in prof["device"]
                if _moe_arith.is_grouped_gemm(name)) / 1e3
    return spent / prof["ticks"] if spent > 0 else None
