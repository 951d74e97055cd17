"""Mean time of one call of the engine's decode step, by CUDA events the
harness records around each call in the window (host launch gaps inside
the call included).  Moves ``serve_tokens_per_s``."""


def read(record):
    ms = record.get("window", {}).get("decode_ms")
    return sum(ms) / len(ms) if ms else None
