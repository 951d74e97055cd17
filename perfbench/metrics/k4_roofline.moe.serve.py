"""K4 (``paged_flash_decode``) against its roofline over the traced
ticks of a model with mixed layer kinds (Mellum2's window and full
layers): as ``k4_roofline.serve``, the sum of each launch's least time
over the sum of the device time of its launches, but each decode call
launches K4 once a layer of every kind, and a launch's live keys stop
at its kind's window (``record["model"]["kinds"]``).  Moves
``serve_tokens_per_s``."""

from perfbench.metrics import _arith


def read(record):
    prof, m = record.get("profile"), record.get("model", {})
    if not prof or not prof.get("decode_calls") or "kinds" not in m:
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
        for kind in m["kinds"]:
            live = _arith.live_keys(seen, m["max_len"], kind["window"], False)
            ms, _ = _arith.bound_ms(m["slots"], m["heads"], m["kv_heads"],
                                    m["head_dim"], 2, live, "torch.bfloat16",
                                    extra_bytes=m["slots"] * tpr * 4)
            bound += ms * kind["layers"]
    return 100.0 * bound / spent
