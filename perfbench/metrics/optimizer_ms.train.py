"""Device time a step of the kernels launched during the optimizer's
update (the ``optimizer_update`` region the harness marks around
``Optimizer.update``), over the traced steps.  Moves
``train_tokens_per_s``."""


def read(record):
    prof = record.get("profile")
    region = (prof or {}).get("regions", {}).get("optimizer_update")
    if not region or not region["count"] or region["device_s"] <= 0:
        return None
    return 1e3 * region["device_s"] / region["count"]
