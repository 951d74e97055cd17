"""The port's batch shape scorer (``tpu_autoscaler_torch/engine/jaxfit.py``)
and its catalog copy against the JAX package's, on the CPU.

The catalog (``topology/catalog.py``'s ``SLICE_SHAPES``) must equal
JAX's field for field; ``best_shapes(device="cpu")`` and
``best_shapes_np`` must make JAX's ``best_shapes`` and ``best_shapes_np``
decisions exactly (the same shape, the same stranded cost) on
``tests/test_jaxfit.py``'s cases and on 20,000 seeded random demands for
the whole catalog and for each generation, ``per_pod = 0`` and gangs no
shape can hold among them.  No tolerance: the scorer is f32 compares,
one f32 division and a floor on both sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from tpu_autoscaler.engine import jaxfit as jax_fit  # noqa: E402
from tpu_autoscaler.topology import catalog as jax_catalog  # noqa: E402
from tpu_autoscaler_torch.engine import jaxfit  # noqa: E402
from tpu_autoscaler_torch.topology import catalog  # noqa: E402

GENERATIONS = (None, "v4", "v5e", "v5p", "v6e")


def test_catalog_copy_equals_jax_field_for_field():
    assert list(catalog.SLICE_SHAPES) == list(jax_catalog.SLICE_SHAPES)
    assert len(catalog.SLICE_SHAPES) == 32
    for name, shape in catalog.SLICE_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_catalog.SLICE_SHAPES[name]), name
    assert {name: dataclasses.asdict(s) for name, s in
            catalog.CPU_SHAPES.items()} == {
        name: dataclasses.asdict(s)
        for name, s in jax_catalog.CPU_SHAPES.items()}
    for gen in GENERATIONS:
        mine, theirs = jaxfit.catalog_arrays(gen), jax_fit.catalog_arrays(gen)
        assert mine[0] == theirs[0]
        for a, b in zip(mine[1:], theirs[1:]):
            np.testing.assert_array_equal(a, b)


def _demand(total, per_pod, pods):
    return [float(total), float(per_pod), float(pods)]


JAX_CASES = {
    "simple": ([_demand(64, 4, 16)], "v5e"),
    "stranded": ([_demand(5, 5, 1)], "v5e"),
    "per-host": ([_demand(24, 8, 3)], "v5e"),
    "batch": ([_demand(8, 8, 1), _demand(256, 4, 64),
               _demand(100000, 4, 25000)], "v5e"),
    "whole-catalog": ([_demand(256, 4, 64)], None),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jaxfit_cases_match_jax(case):
    demands, gen = JAX_CASES[case]
    demands = np.array(demands)
    want = jax_fit.best_shapes(demands, generation=gen)
    assert jaxfit.best_shapes(demands, generation=gen, device="cpu") == want
    assert jaxfit.best_shapes_np(demands, generation=gen) == want
    assert jax_fit.best_shapes_np(demands, generation=gen) == want


def random_demands(rng, n):
    """n gangs: totals 1..2048 chips (the largest shape has 1,024),
    per-pod chips in {0, 1, 2, 3, 4, 8} (0 takes the scorer's
    per_pod == 0 branch; 3 divides no host), pods up to total / per-pod
    plus a few more (shares no shape can hold)."""
    total = rng.integers(1, 2049, n)
    per_pod = rng.choice([0, 1, 2, 3, 4, 8], n)
    most = total // np.maximum(per_pod, 1)
    pods = rng.integers(1, most + 3)
    return np.stack([total, per_pod, pods], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def demands():
    return random_demands(np.random.default_rng(0), 20_000)


@pytest.mark.parametrize("gen", GENERATIONS, ids=lambda g: g or "all")
def test_random_demands_match_jax_decision_for_decision(demands, gen):
    want = jax_fit.best_shapes(demands, generation=gen)
    assert want == jax_fit.best_shapes_np(demands, generation=gen)
    assert jaxfit.best_shapes(demands, generation=gen, device="cpu") == want
    assert jaxfit.best_shapes_np(demands, generation=gen) == want
    picked = [name for name, _ in want]
    assert None in picked and len(set(picked)) > 3
    assert (demands[:, 1] == 0).any()


def test_scorer_returns_tensors_on_its_device(demands):
    names, score = jaxfit.make_batch_scorer("v5e", device="cpu")
    best, cost = score(demands[:10])
    assert best.device.type == cost.device.type == "cpu"
    assert best.dtype == torch.int64 and cost.dtype == torch.float32
    assert tuple(best.shape) == tuple(cost.shape) == (10,)
    assert names == jax_fit.catalog_arrays("v5e")[0]


def test_scorer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jaxfit.make_batch_scorer()


@pytest.mark.cuda
def test_scorer_on_cuda_matches_numpy_twin(demands):
    """The scorer's card route against its numpy twin (chip_smoke.py's
    fit_scorer phase runs the same check on 1,000,000 gangs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scorer's card route")
    for gen in GENERATIONS:
        assert jaxfit.best_shapes(demands, generation=gen) \
            == jaxfit.best_shapes_np(demands, generation=gen)
