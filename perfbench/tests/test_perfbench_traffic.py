"""The traffic generator: the same stream for one seed, the same sizes
in another order for another, within the stated clips and medians."""

import json
import statistics

import numpy as np
import pytest

from perfbench import core, workload

SERVE_MIXES = ["chat", "complete"]


def _mix(name):
    return json.loads(core.traffic_path(name).read_text())


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_a_seed_gives_one_stream(name):
    mix = _mix(name)
    a, b = (workload.Stream(mix, 2**31 + 11, 49152) for _ in range(2))
    for k in (0, 1, mix["block"] + 3, 5 * mix["block"]):
        pa, oa = a.request(k)
        pb, ob = b.request(k)
        assert oa == ob and np.array_equal(pa, pb)


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_seeds_share_the_sizes_of_each_block(name):
    mix = _mix(name)
    n = mix["block"]
    streams = [workload.Stream(mix, s, 49152) for s in (1, 2**40 + 7)]
    got = [[s.sizes(k) for k in range(2 * n, 3 * n)] for s in streams]
    assert got[0] != got[1]
    for i in (0, 1):
        assert sorted(g[i] for g in got[0]) == sorted(g[i] for g in got[1])


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_sizes_keep_their_clips_and_medians(name):
    mix = _mix(name)
    stream = workload.Stream(mix, 99, 49152)
    sizes = [stream.sizes(k) for k in range(4 * mix["block"])]
    for i, law in ((0, mix["prompt"]), (1, mix["output"])):
        values = [s[i] for s in sizes]
        assert min(values) >= law["lo"] and max(values) <= law["hi"]
        assert abs(statistics.median(values) / law["median"] - 1) < 0.02


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_every_request_fits_its_engine(name):
    mix = _mix(name)
    eng = mix["engine"]
    stream = workload.Stream(mix, 5, 49152)
    reqs = stream.cohort(mix["clients"], mix["warmup"]["cohort"]) + [
        stream.request(k) for k in range(2 * mix["block"])]
    for ids, budget in reqs:
        padded = -(-len(ids) // eng["chunk"]) * eng["chunk"]
        assert budget >= 1 and len(ids) >= 1
        assert max(padded, len(ids) + budget) <= eng["max_len"]
        assert ids.min() >= 0 and ids.max() < 49152


def test_a_residual_cohort_is_length_biased_and_part_done():
    mix = _mix("chat")
    stream = workload.Stream(mix, 3, 49152)
    cohort = stream.cohort(mix["clients"], "residual")
    left = sorted(budget for _, budget in cohort)
    budgets = sorted(stream.sizes(k)[1] for k in range(mix["clients"]))
    # Length-biased budgets, met part way: a long tail of what is left,
    # and less left than a fresh budget on the whole.
    assert max(left) > np.percentile(budgets, 90)
    assert np.mean(left) < np.mean(budgets) * 1.2
    assert min(left) >= 1
    # Each context starts at its prompt plus the part already generated.
    prompts = [stream.sizes(k)[0] for k in range(4 * mix["block"])]
    contexts = [len(ids) for ids, _ in cohort]
    assert np.mean(contexts) > np.mean(prompts) + 0.5 * np.mean(left)
    again = stream.cohort(mix["clients"], "residual")
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(cohort, again))


def test_lognormal_set_is_stratified():
    s = workload.lognormal_set(100, 0.5, 10, 1000, 101)
    assert s[50] == 100 and list(s) == sorted(s)
