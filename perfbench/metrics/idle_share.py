"""Share of the traced ticks or steps in which no kernel, copy or set
ran on the device: 1 - (union of the device intervals) / window.
``idle_share.serve`` moves ``serve_tokens_per_s``, ``idle_share.train``
``train_tokens_per_s``."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
