"""Share of the prefill call's lanes x chunk positions that held prompt
tokens, from each call's ``n_valid`` across the window; the rest is
padding the call computes anyway.  As ``prefill_fill.serve`` it moves
``serve_tokens_per_s``."""


def read(record):
    w = record.get("window", {})
    if not w.get("prefill_capacity"):
        return None
    return 100.0 * w["prefill_valid"] / w["prefill_capacity"]
