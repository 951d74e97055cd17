"""Training cells: the program's one-device train step
(``model.make_train_step``'s ``step_fn``), fed a new batch of uniform
token ids, made on the device from the seed, every step.

Set-up builds the step, makes the f32 master weights on the device from
the seed and the optimizer's state (``Optimizer.init``), then runs the
step three times through the same call and feed as the window: these
are the steps the reference follows.  After step 1 the program's first
gradient is read from its state (Adam's first moment is (1 - b1) g), and
after step 3 the change of every leaf since the start.  The window runs
steps until ``seconds`` have passed and ends when the device has
finished them; the rate is the tokens of every step in it over its
seconds.  A step whose loss is not finite counts as failed.

``correct``: the plain reference (f32, TF32 off) follows the same three
steps from the same weights and batches: each step's loss, the worst
leaf's gap between the two first-gradient norms, and the worst leaf's
gap between the two changes after three steps, each gap over the larger
of that leaf's reference norm and the median leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change: Adam moves them by round-off alone.

With ``trace`` the optimizer's update is marked with a profiler range
(the harness wraps the optimizer it hands the step; the program is not
edited) and ``profile_steps`` steps after the window run under the
profiler.  ``--control 1`` also reads the control (the reference in
fp8) and the fault of half the batch left out, after the check.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from perfbench import core, trace as tracing


@contextlib.contextmanager
def _marked_update(pm):
    """Build steps inside this block with their optimizer's ``update``
    marked as the ``optimizer_update`` region."""
    make = pm.make_optimizer

    def marked(train):
        opt = make(train)
        inner = opt.update

        def update(*args, **kwargs):
            with tracing.region("optimizer_update"):
                return inner(*args, **kwargs)

        opt.update = update
        return opt

    pm.make_optimizer = marked
    try:
        yield
    finally:
        pm.make_optimizer = make


def _norms(tree: dict, scale: float = 1.0) -> dict:
    from perfbench.reference.model import leaves

    return {p: float(t.float().norm()) * scale
            for p, t in leaves(tree).items()}


def _changes(config: dict, seed: int, params: dict, device) -> dict:
    """Each leaf's distance from the weights it started at (made again
    from the seed, a leaf at a time)."""
    import torch

    from perfbench.reference.model import leaves

    out = {}
    for path, p in leaves(params).items():
        start = core.make_leaf(config, seed, path, torch.float32, device)
        out[path] = float((p - start).norm())
        del start
    return out


def run(cell: core.Cell, *, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> core.Outcome:
    import torch

    from tpu_autoscaler_torch.workloads import model as pm

    config, mix = cell.config, cell.mix
    opt = mix["optimizer"]
    batch, seq = mix["batch"], mix["seq"]
    cfg = core.port_config(config, seq_len=seq, remat=mix["remat"],
                           ce_chunk=mix["ce_chunk"])
    train = pm.TrainConfig(learning_rate=opt["learning_rate"], b1=opt["b1"],
                           b2=opt["b2"], weight_decay=opt["weight_decay"])
    with _marked_update(pm) if trace else contextlib.nullcontext():
        _, step_fn = pm.make_train_step(cfg, train, device)
    params = core.make_weights(config, seed, torch.float32, device)
    box = [params, pm.make_optimizer(train).init(params)]
    del params

    def tokens(k: int):
        gen = core.torch_generator(seed, device, "batch", k)
        return torch.randint(0, config["vocab_size"], (batch, seq + 1),
                             generator=gen, device=device)

    def step(k: int):
        # Only the step holds the state while it runs, so the old state
        # is freed as the step replaces it.
        params, state, loss = step_fn(box.pop(0), box.pop(0), tokens(k))
        box.extend((params, state))
        return loss

    program = {"loss": []}
    check_s = 0.0
    for k in (1, 2, 3):
        program["loss"].append(float(step(k)))
        t = time.perf_counter()
        if k == 1:
            program["grad"] = _norms(box[1]["mu"], 1.0 / (1.0 - opt["b1"]))
        if k == 3:
            program["change"] = _changes(config, seed, box[0], device)
        core.sync(device)
        check_s += time.perf_counter() - t
    setup_s = time.perf_counter() - started - check_s

    losses = []
    t0 = time.perf_counter()
    k = 4
    while time.perf_counter() - t0 < seconds:
        losses.append(step(k))
        k += 1
    core.sync(device)
    window_s = time.perf_counter() - t0
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    heads = config["num_attention_heads"]
    record = {"model": {"layers": config["num_hidden_layers"],
                        "heads": heads,
                        "kv_heads": config["num_key_value_heads"],
                        "head_dim": config["hidden_size"] // heads,
                        "window": config["sliding_window"], "seq": seq,
                        "batch": batch,
                        "block_params": core.matmul_params(config),
                        "unembed_params": core.unembed_params(config)},
              "window": {"seconds": window_s, "steps": steps}}
    profiled = None
    if trace:
        def steps_():
            nonlocal k
            for _ in range(mix["profile_steps"]):
                with tracing.region("step"):
                    step(k)
                k += 1

        profiled = tracing.profile(torch, steps_)
        profiled["steps"] = mix["profile_steps"]
        record["profile"] = profiled

    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": steps * batch * seq / window_s}
    device_rec = core.device_info(torch, cell.chips, profiled, device)
    box.clear()
    del step_fn, losses
    gc.collect()
    torch.cuda.empty_cache()

    t_check = time.perf_counter()
    want = follow(config, mix, seed, device, tokens)
    got = compare(program, want)
    limits = config["limits"]["train"]
    checks = [core.Check(name, got[name], limits[name]) for name in
              ("loss_gap", "grad_norm_gap", "change_norm_gap")]
    readings = None
    if control:
        from perfbench.reference.control import fp8_linear

        readings = {
            "fp8": compare(follow(config, mix, seed, device, tokens,
                                  quant=fp8_linear), want),
            "half_batch": compare(follow(
                config, mix, seed, device,
                lambda k: tokens(k)[: batch // 2]), want)}
    return core.Outcome(
        e2e=e2e, record=record, checks=checks, attempted=steps,
        failed=failed, device=device_rec, traced=profiled, control=readings,
        notes={"check_s": time.perf_counter() - t_check,
               "program": program, "reference": want})


def follow(config: dict, mix: dict, seed: int, device, tokens,
           quant=None) -> dict:
    """The reference's three steps from the seed's weights on the same
    batches: losses, first-gradient norms, changes after three steps."""
    import torch

    from perfbench.reference import model as ref

    ref.strict_f32()
    opt = mix["optimizer"]
    params = core.make_weights(config, seed, torch.float32, device)
    adam = ref.AdamW(params, learning_rate=opt["learning_rate"], b1=opt["b1"],
                     b2=opt["b2"], eps=opt["eps"],
                     weight_decay=opt["weight_decay"])
    out = {"loss": []}
    for k in (1, 2, 3):
        loss, grads = ref.loss_and_grads(params, tokens(k), config, quant)
        out["loss"].append(loss)
        if k == 1:
            out["grad"] = {p: float(g.norm()) for p, g in grads.items()}
        adam.step(params, grads)
        del grads
    out["change"] = _changes(config, seed, params, device)
    del params, adam
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaf_gap(got: dict, want: dict, paths) -> float:
    """The worst leaf's |got - want| over the larger of want's norm of
    that leaf and the median leaf's."""
    median = float(np.median([want[p] for p in paths]))
    return max(abs(got[p] - want[p]) / max(want[p], median) for p in paths)


def compare(got: dict, want: dict) -> dict:
    """The three numbers compared, of ``got`` against the reference's
    ``want``."""
    grads = want["grad"]
    floor = 1e-3 * float(np.median(list(grads.values())))
    moved = [p for p in grads if grads[p] >= floor]
    return {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"],
                                                       want["loss"])),
            "grad_norm_gap": _leaf_gap(got["grad"], grads, list(grads)),
            "change_norm_gap": _leaf_gap(got["change"], want["change"],
                                         moved)}
