"""Statistics over every sample of a run, and a seeded reservoir sample."""

from __future__ import annotations

import math
import random
from typing import List, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all samples, linear between order
    statistics (rank ``q / 100 * (n - 1)``). A sample of +inf (a failed
    request) sorts last and is returned where the rank reaches it."""
    if not xs:
        raise ValueError("percentile of no samples")
    s = sorted(xs)
    r = q / 100.0 * (len(s) - 1)
    lo, hi = math.floor(r), math.ceil(r)
    if s[hi] == math.inf:
        return math.inf if r > lo or s[lo] == math.inf else s[lo]
    return s[lo] + (s[hi] - s[lo]) * (r - lo)


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from ``seed`` (Algorithm R): the n-th item (0-based) replaces a
    kept one with probability k / (n + 1)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.n = 0
        self.items: List = []

    def offer(self, item):
        """Consider ``item``: the slot it now holds, or None."""
        n, self.n = self.n, self.n + 1
        if n < self.k:
            self.items.append(item)
            return n
        j = self.rng.randrange(n + 1)
        if j < self.k:
            self.items[j] = item
            return j
        return None
