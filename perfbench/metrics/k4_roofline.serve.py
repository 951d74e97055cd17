"""K4 (``paged_flash_decode``) against its roofline over the traced
ticks: the sum of each launch's least time (the live K/V of every row,
q, out, lengths and the block table moved once, or 4*d flops per (query
head, live key), :func:`_arith.bound_ms`) over the sum of the device
time of its launches.  Each decode call launches it once a layer with
that call's lengths.  Moves ``serve_tokens_per_s``."""

from perfbench.metrics import _arith


def read(record):
    prof, m = record.get("profile"), record["model"]
    if not prof or not prof.get("decode_calls"):
        return None
    spent = sum(e - s for name, s, e in prof["device"]
                if "paged_decode_kernel" in name) / 1e3
    if spent <= 0:
        return None
    tpr = m["max_len"] // m["block_size"]
    bound = 0.0
    for lengths, active in prof["decode_calls"]:
        seen = [int(n) + 1 if (n > 0 or a) else 0
                for n, a in zip(lengths, active)]
        live = _arith.live_keys(seen, m["max_len"], m["window"], False)
        ms, _ = _arith.bound_ms(m["slots"], m["heads"], m["kv_heads"],
                                m["head_dim"], 2, live, "torch.bfloat16",
                                extra_bytes=m["slots"] * tpr * 4)
        bound += ms * m["layers"]
    return 100.0 * bound / spent
