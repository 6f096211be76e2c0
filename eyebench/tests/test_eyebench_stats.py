"""Percentiles over every sample and the reservoir sample."""

import math
import random

import numpy as np
import pytest

from eyebench.harness.stats import Reservoir, percentile


@pytest.mark.parametrize("n", [1, 2, 9, 10, 11, 150])
@pytest.mark.parametrize("q", [50, 90, 95])
def test_percentile_matches_numpy(n, q):
    xs = [random.Random(n).expovariate(1.0) for _ in range(n)]
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_counts_failures_as_inf():
    xs = [1.0] * 89 + [math.inf] * 11
    assert percentile(xs, 90) == math.inf
    assert percentile([1.0] * 95 + [math.inf] * 5, 90) == 1.0


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return r.items

    assert draw(7) == draw(7) and draw(7) != draw(8)
    counts = [0] * 20
    for s in range(3000):
        r = Reservoir(2, s)
        for i in range(20):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert max(counts) / min(counts) < 1.35

