"""Host time a tick waits for the device: the mean over the window's
ticks of the program's ``serve.sync`` spans (the logits of a seeded
lane, the sampled tokens to the host).  A host-side gain can raise it:
the host reaches the sync earlier and waits for the same device work.
Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(record):
    split = spans.tick_split(record)
    return None if split is None else split["sync"]
