"""Balanced multi-source sampling (port of peclr_tpu/data/sampler.py, the
same numpy streams).

Each source is drawn with equal probability and samples are uniform with
replacement within a source (the reference's WeightedRandomSampler with
weight 1/len(source)); a single source is a shuffled epoch.
`BalancedSampler.draw` is stateful: it continues one stream across calls
and epochs, so multi-source batches do not replay after a resume.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class BalancedSampler:
    """One stream of (source_index, sample_index) draws."""

    def __init__(self, source_sizes: Sequence[int], seed: int = 0):
        if not all(s > 0 for s in source_sizes):
            raise ValueError(f"empty source among sizes {list(source_sizes)}")
        self.sizes = list(source_sizes)
        self.rng = np.random.default_rng(seed)

    def draw(self, n: int) -> List[Tuple[int, int]]:
        src = self.rng.integers(0, len(self.sizes), size=n)
        return [(int(s), int(self.rng.integers(0, self.sizes[s]))) for s in src]


class EpochSampler:
    """Shuffled single-source epoch order, keyed by (seed, epoch); the
    identity order when shuffle is off (validation)."""

    def __init__(self, size: int, seed: int = 0, shuffle: bool = True):
        self.size = size
        self.seed = seed
        self.shuffle = shuffle

    def epoch(self, epoch_idx: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.size)
        rng = np.random.default_rng((self.seed, epoch_idx))
        return rng.permutation(self.size)
