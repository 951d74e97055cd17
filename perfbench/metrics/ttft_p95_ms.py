"""The 95th percentile of time to first token over the window's
requests, from submission (host clock), read beside the throughput it
moves, ``serve_tokens_per_s``: in chat the card is idle for most of the
window, so the tail is host-paced; in completion it is the tail of the
~180 requests a window, and which few of them meet a busy lane changes
with the seed by more than a bound can hold."""


def read(record):
    value = record.get("window", {}).get("ttft_p95_ms")
    return value if value == value else None
