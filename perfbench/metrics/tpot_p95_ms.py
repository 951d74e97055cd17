"""The 95th percentile of time per output token over the requests
finished in the window (host clock), where the card is idle for most of
the window: host-paced, so read beside ``serve_tokens_per_s``."""


def read(record):
    value = record.get("window", {}).get("tpot_p95_ms")
    return value if value == value else None
