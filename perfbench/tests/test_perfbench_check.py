"""``correct`` at work: a sound run passes; the same run with the timed
path broken underneath fails, once for each fault the cell can have
(its state left unchanged, half the batch left out, a token altered
where it is produced; one chip, so no exchange between chips to leave
out); the control, the reference one precision down, reads above the
program.  The tiny runs skip the harness's look for a chip and drive the
rest of a run on the CPU.  The control at the cells' own sizes runs on
the card (``-m cuda``), as it did to set the limits."""

import pytest
import torch

from perfbench import core
from perfbench.tests import tiny

SERVE = "sc2-3b.chat"
TRAIN = "sc2-7b.train.s4096"


def test_a_sound_serving_run_is_correct():
    r = tiny.run(tiny.cell(SERVE), control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    gap = r["checks"]["served_logit_gap"]["value"]
    assert r["control"]["served_logit_gap"] > gap


def _serve_fault(monkeypatch, fault):
    from tpu_autoscaler_torch.workloads import paged, serving

    if fault == "state_unchanged":
        # The decode step writes nothing into the cache.
        monkeypatch.setattr(paged, "_scatter_token", lambda *a: None)
    elif fault == "half_batch":
        make = paged.make_paged_decode_step

        def half(cfg, tokens_per_row, mesh=None):
            step = make(cfg, tokens_per_row, mesh)

            def run(params, cache, tables, tokens, active):
                kept = active.clone()
                kept[len(kept) // 2:] = False
                logits, cache = step(params, cache, tables, tokens, kept)
                cache.lengths += (active & ~kept).to(torch.int32)
                return logits, cache
            return run
        monkeypatch.setattr(paged, "make_paged_decode_step", half)
    elif fault == "token_altered":
        sample = serving.ContinuousBatcher._batch_sample

        def altered(self, logits, temps, greedy):
            return (sample(self, logits, temps, greedy) + 1) % logits.shape[-1]
        monkeypatch.setattr(serving.ContinuousBatcher, "_batch_sample",
                            altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_a_broken_serving_path_is_not_correct(monkeypatch, fault):
    _serve_fault(monkeypatch, fault)
    r = tiny.run(tiny.cell(SERVE))
    assert not r["correct"], r["checks"]


def test_a_sound_training_run_is_correct():
    r = tiny.run(tiny.cell(TRAIN), control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for reading in r["control"].values():
        assert any(reading[k] > v["value"] for k, v in r["checks"].items())


def _train_fault(monkeypatch, fault):
    from tpu_autoscaler_torch.workloads import model as pm

    if fault == "state_unchanged":
        make = pm.make_train_step

        def unchanged(*args, **kwargs):
            init_fn, step_fn = make(*args, **kwargs)

            def step(params, state, tokens):
                return params, state, step_fn(params, state, tokens)[2]
            return init_fn, step
        monkeypatch.setattr(pm, "make_train_step", unchanged)
    elif fault == "half_batch":
        loss_fn = pm.loss_fn
        monkeypatch.setattr(pm, "loss_fn", lambda p, tokens, cfg: loss_fn(
            p, tokens[: len(tokens) // 2], cfg))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    r = tiny.run(tiny.cell(TRAIN))
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [SERVE, TRAIN, "sc2-3b.complete"])
def test_the_control_fails_at_the_cells_size(name):
    """On the card, at the cell's own size: the program reads within its
    limits and the control (fp8) outside one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full size")
    from perfbench.run import measure

    cell = core.load_cell(name)
    r = measure(cell, seed=2**31 + 404, seconds=5.0, trace=False,
                device=torch.device("cuda", 0), control=True)
    assert r["correct"], r["checks"]
    limits = {k: v["limit"] for k, v in r["checks"].items()}
    readings = r["control"]
    if "fp8" in readings:          # training: the control and the fault
        readings = readings["fp8"]
    assert any(readings[k] > limits[k] for k in readings if k in limits)
