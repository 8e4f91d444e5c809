"""Prompt lengths and tokens of the serving cells, from the workload file and
the seed.

The pool of distinct lengths is fixed by the cell: the quantiles
``(i + 1/2) / pool`` of a lognormal (``median``, ``sigma``) truncated to
``[min, max]``.  The seed only orders them (:class:`Lengths`), so that every
seed serves the same sizes in another order.  Tokens are uniform over the
vocabulary.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

_N = NormalDist()


def pool(p: Dict) -> List[int]:
    """The cell's distinct prompt lengths, ascending."""
    if p["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {p['dist']!r}")
    mu, sigma = math.log(p["median"]), p["sigma"]
    lo = _N.cdf((math.log(p["min"]) - mu) / sigma)
    hi = _N.cdf((math.log(p["max"]) - mu) / sigma)
    n = p["pool"]
    out = [int(round(math.exp(mu + sigma * _N.inv_cdf(lo + (i + 0.5) / n * (hi - lo)))))
           for i in range(n)]
    if len(set(out)) != n or out[0] < p["min"] or out[-1] > p["max"]:
        raise ValueError(f"the pool {out} is not {n} distinct lengths in [{p['min']}, {p['max']}]")
    return out


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of the seed (``stream``)."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), stream]))


class Lengths:
    """The lengths requests take, in the seed's order.

    A round serves every length of the pool once.  The pool (ascending) is
    cut into pairs of neighbours; a round takes one member of every pair, in
    a fixed low-discrepancy order of the pairs, then the other members in the
    same order, and the seed picks which member of each pair goes first.  So
    every prefix of a round holds about its share of each part of the
    distribution, and a window that ends inside a round serves the same mix
    whatever the seed."""

    def __init__(self, lengths: List[int], seed: int):
        self.lengths = sorted(lengths)
        self._rng = rng(seed, 1)
        self._queue: List[int] = []
        n = (len(self.lengths) + 1) // 2
        width = max(1, (n - 1).bit_length())
        self._order = sorted(range(n), key=lambda i: int(f"{i:0{width}b}"[::-1], 2))

    def _round(self) -> List[int]:
        pairs = [self.lengths[2 * i:2 * i + 2] for i in range(len(self._order))]
        flips = self._rng.integers(0, 2, size=len(pairs))
        first, second = [], []
        for i in self._order:
            pair = pairs[i][::-1] if flips[i] else pairs[i]
            first.append(pair[0])
            second.extend(pair[1:])
        return first + second

    def take(self, n: int) -> List[int]:
        out = []
        while len(out) < n:
            if not self._queue:
                self._queue = self._round()[::-1]
            out.append(self._queue.pop())
        return out


def prompts(lengths: List[int], vocab: int, gen: np.random.Generator) -> List[np.ndarray]:
    return [gen.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]
