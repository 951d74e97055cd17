"""Rows a decode step served: the engine's decode tokens over its decode
steps (``PagedBatcher.decode_tokens`` / ``decode_steps``) across the
window.  Moves ``serve_tokens_per_s``: tokens a tick at a given tick
time."""


def read(record):
    w = record.get("window", {})
    if not w.get("decode_steps"):
        return None
    return w["decode_tokens"] / w["decode_steps"]
