"""Mean time of one call of the engine's batched prefill, by CUDA
events the harness records around each call in the window.  As
``prefill_call_ms.serve`` it moves ``serve_tokens_per_s``."""


def read(record):
    ms = record.get("window", {}).get("prefill_ms")
    return sum(ms) / len(ms) if ms else None
