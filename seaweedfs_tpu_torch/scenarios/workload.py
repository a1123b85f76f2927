"""Workload samplers: Zipfian popularity, size mix, op mix.

The port's copy of seaweedfs_tpu/scenarios/workload.py.  Pure, seeded,
stdlib-only: the engine composes them into client loops, and one
``random.Random(seed)`` draws the same sequence in both packages.
"""

from __future__ import annotations

import random
from bisect import bisect_left


class ZipfSampler:
    """Zipf(s) over ranks 0..n-1: P(rank r) proportional to
    1/(r+1)^s.  Rank 0 is the hottest object.  Sampling is one
    random() + one bisect over the precomputed CDF."""

    def __init__(self, n: int, s: float = 1.1):
        self.n = max(1, int(n))
        self.s = float(s)
        weights = [1.0 / ((r + 1) ** self.s) for r in range(self.n)]
        total = sum(weights)
        cdf = []
        acc = 0.0
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0  # float-sum slack must not strand random()==1.0
        self._cdf = cdf

    def sample(self, rng: random.Random) -> int:
        return bisect_left(self._cdf, rng.random())

    def pmf(self, rank: int) -> float:
        lo = self._cdf[rank - 1] if rank else 0.0
        return self._cdf[rank] - lo


class SizeSampler:
    """Weighted size mix: ((bytes, weight), ...) -> one size per
    sample.  Weights need not sum to 1."""

    def __init__(self, sizes):
        pairs = [(int(b), float(w)) for b, w in sizes] or [(4096, 1.0)]
        total = sum(w for _b, w in pairs)
        cdf = []
        acc = 0.0
        for b, w in pairs:
            acc += w / total
            cdf.append((acc, b))
        cdf[-1] = (1.0, cdf[-1][1])
        self._cdf = cdf

    def sample(self, rng: random.Random) -> int:
        x = rng.random()
        for acc, b in self._cdf:
            if x <= acc:
                return b
        return self._cdf[-1][1]


def percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted list — the one
    quantile convention the engine's route stats and the capacity
    probe share (a fix to the index rule must change both at once)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def pick_op(rng: random.Random, read_fraction: float,
            churn_fraction: float) -> str:
    """'read' | 'write' | 'delete' per the spec's mix: churn_fraction
    carves deletes out of the WRITE share (a delete is churn on data
    the run itself wrote)."""
    if rng.random() < read_fraction:
        return "read"
    return "delete" if rng.random() < churn_fraction else "write"


def payload_for(size: int, seed_byte: int) -> bytes:
    """Deterministic compressible-ish payload: one distinct byte
    repeated — cheap to build per op at MB sizes, still distinct per
    object so reads can sanity-check what came back."""
    return bytes((seed_byte & 0xFF,)) * size
