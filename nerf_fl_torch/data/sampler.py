"""Shuffled-epoch ray batches over flat host buffers.

The port's own copy of ``nerf_fl_tpu/data/sampler.py``: the same
``np.random.default_rng([seed, epoch])`` permutation, so for a given seed
the port and the JAX package train on identical batches, and the device
pool (``training/system.py:epoch_perm``) draws the same order.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def host_rows(batch_size: int, host_index: int, host_count: int,
              microbatch: int = 1) -> np.ndarray:
    """The rows of a global batch that host ``host_index`` of
    ``host_count`` holds: its contiguous batch_size / host_count slice, or
    with ``microbatch`` M its contiguous share of each of the M equal
    slices, in slice order (the train step slices the global batch into
    microbatches first and then shards each slice, as the JAX package's
    step does)."""
    M = max(1, microbatch)
    if batch_size % (M * host_count):
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"microbatch {M} x host_count {host_count}")
    per, share = batch_size // M, batch_size // (M * host_count)
    return np.concatenate([np.arange(j * per + host_index * share,
                                     j * per + (host_index + 1) * share)
                           for j in range(M)])


class RayBatcher:
    """Shuffled-epoch batch iterator over flat (rays, ts, rgbs) buffers."""

    def __init__(self, rays: np.ndarray, ts: np.ndarray, rgbs: np.ndarray,
                 batch_size: int, seed: int = 0, drop_last: bool = True,
                 host_index: int = 0, host_count: int = 1,
                 microbatch: int = 1):
        """``batch_size`` is the global batch; with ``host_count`` > 1 every
        process draws the same permutation and keeps its rows of each
        batch (``host_rows``: the contiguous batch_size / host_count slice,
        or its share of each of ``microbatch`` slices)."""
        if not len(rays) == len(ts) == len(rgbs):
            raise ValueError("rays, ts and rgbs differ in length")
        if batch_size % host_count:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"host_count {host_count}")
        if host_count > 1 and not drop_last:
            raise ValueError("drop_last=False is not supported with "
                             "host-sharded batching")
        self.rays, self.ts, self.rgbs = rays, ts, rgbs
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.host_index = host_index
        self.host_count = host_count
        self.rows = host_rows(batch_size, host_index, host_count, microbatch)
        self.n = len(rays)

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Deterministic shuffle per epoch, seeded by the pair [seed,
        epoch] (not their sum, which collides across runs)."""
        perm = np.random.default_rng([self.seed, epoch_idx]).permutation(
            self.n)
        B = self.batch_size
        stop = self.n - (self.n % B) if self.drop_last else self.n
        for i in range(0, stop, B):
            idx = perm[i:i + B]
            if self.host_count > 1:
                idx = idx[self.rows]
            yield {"rays": self.rays[idx], "ts": self.ts[idx],
                   "rgbs": self.rgbs[idx]}

    def sample(self, rng: np.random.Generator,
               batch_size: Optional[int] = None) -> Dict[str, np.ndarray]:
        """IID random batch."""
        B = batch_size or self.batch_size
        idx = rng.integers(0, self.n, size=B)
        return {"rays": self.rays[idx], "ts": self.ts[idx],
                "rgbs": self.rgbs[idx]}
