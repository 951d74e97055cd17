"""Tiny cells for the CPU tests: the real files' keys, small sizes."""

from __future__ import annotations

import copy
import time

import torch

from perfbench import core

TINY_MODEL = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": 256, "sliding_window": 48}


def cell(name: str, **mix_overrides) -> core.Cell:
    """Workload ``name`` of BENCHMARK.json at a tiny size: its config
    shrunk to TINY_MODEL (limits kept), its mix to a few clients or a
    short sequence."""
    c = core.load_cell(name)
    c.config = copy.deepcopy(c.config)
    # The same weight scale per unit of width as the real config's.
    c.config["initializer_range"] *= (
        c.config["hidden_size"] / TINY_MODEL["hidden_size"]) ** 0.5
    c.config.update(TINY_MODEL)
    mix = copy.deepcopy(c.mix)
    if mix["driver"] == "serve":
        mix.update(clients=4, block=8,
                   prompt={"median": 20, "sigma": 0.5, "lo": 8, "hi": 40},
                   output={"median": 12, "sigma": 0.5, "lo": 4, "hi": 24},
                   engine={"slots": 4, "max_len": 64, "block_size": 8,
                           "num_blocks": 32, "chunk": 16, "prefill_lanes": 2},
                   check={"requests": 8})
    else:
        mix.update(seq=64, batch=4, ce_chunk=16)
    mix.update(mix_overrides)
    c.mix = mix
    return c


def run(c: core.Cell, seed: int = 12345, seconds: float = 3.0,
        control: bool = False) -> dict:
    from perfbench.run import measure

    return measure(c, seed=seed, seconds=seconds, trace=False,
                   device=torch.device("cpu"), control=control,
                   started=time.perf_counter())
