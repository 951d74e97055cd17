"""The one generator of serving traffic: a mix file's parameters turned
into a request stream, the same for every run of one seed.

Lengths follow a clipped lognormal (``median``, ``sigma``, ``lo``,
``hi``), drawn by stratified quantiles: each block of ``block``
consecutive requests holds the same set of prompt lengths and the same
set of output budgets, each in an order of its own drawn from the seed.
So every seed gives the same sizes in another order, and any stretch of
the stream holds them in their stated proportions.  Token ids are
uniform over the vocabulary, one stream per request.

A closed loop starts with one request per client (the cohort).  With
``"cohort": "residual"`` the cohort stands for a loop that has been
running for ever: budgets drawn in proportion to their length (a long
request is more likely to be in flight), each met at a uniform point of
its life.  Its prompt is the mix's prompt followed by the part already
generated (uniform ids, as a prompt's), so set-up prefills every context
to its steady-state length, and the request asks for the time left.
With ``"fresh"`` the cohort is the stream's first requests.
"""

from __future__ import annotations

import statistics

import numpy as np

from perfbench import core


def lognormal_set(median: float, sigma: float, lo: int, hi: int,
                  n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 1/2) / n of a lognormal, clipped
    to [lo, hi] and rounded; ascending."""
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


class Stream:
    """Request k of run ``seed``: its prompt length, output budget and
    token ids."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.seed, self.vocab = seed, vocab
        self.block = mix["block"]
        self.prompt_law = dict(mix["prompt"])
        self.prompt_set = lognormal_set(**mix["prompt"], n=self.block)
        self.output_set = lognormal_set(**mix["output"], n=self.block)
        self._orders: dict[int, tuple] = {}

    def _order(self, j: int):
        if j not in self._orders:
            r = core.rng(self.seed, "block", j)
            self._orders[j] = (r.permutation(self.block),
                               r.permutation(self.block))
        return self._orders[j]

    def sizes(self, k: int) -> tuple[int, int]:
        p, o = self._order(k // self.block)
        i = k % self.block
        return int(self.prompt_set[p[i]]), int(self.output_set[o[i]])

    def tokens(self, n: int, *key) -> np.ndarray:
        return core.rng(self.seed, "tokens", *key).integers(
            0, self.vocab, size=n, dtype=np.int64).astype(np.int32)

    def request(self, k: int) -> tuple[np.ndarray, int]:
        """(prompt ids, output budget) of request k."""
        plen, budget = self.sizes(k)
        return self.tokens(plen, k), budget

    def cohort(self, clients: int, kind: str) -> list[tuple[np.ndarray, int]]:
        """The loop's first request for each client (see the module's
        docstring); a fresh cohort takes requests 0 .. clients - 1."""
        if kind == "fresh":
            return [self.request(k) for k in range(clients)]
        if kind != "residual":
            raise ValueError(f"unknown cohort {kind!r}")
        r = core.rng(self.seed, "cohort")
        prompts = r.permutation(lognormal_set(**self.prompt_law, n=clients))
        # Budgets at the stratified quantiles of the length-biased law.
        cdf = np.cumsum(self.output_set) / self.output_set.sum()
        at = (np.arange(clients) + 0.5) / clients
        budgets = r.permutation(
            self.output_set[np.searchsorted(cdf, at, side="left")])
        ages = r.permutation((np.arange(clients) + 0.5) / clients)
        out = []
        for c in range(clients):
            age = int(ages[c] * budgets[c])
            ids = self.tokens(int(prompts[c]) + age, "cohort", c)
            out.append((ids, int(budgets[c]) - age))
        return out
