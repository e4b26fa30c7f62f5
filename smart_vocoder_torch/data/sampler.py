"""Length-bucketed, rank-striped batch sampler (reference data_utils.py:130-226);
counterpart of ``smart_vocoder_tpu/data/sampler.py``, batch for batch.

  - samples are bucketed by spec length between consecutive boundaries;
    those out of range are dropped (data_utils.py:134-137), and so are empty
    buckets with their upper boundary;
  - each bucket is padded by repeating its ids to a multiple of
    ``num_replicas * batch_size`` (data_utils.py:162-168, :190-192);
  - each replica takes ``ids[rank::num_replicas]`` (data_utils.py:195);
  - the order within buckets and of the batches is shuffled by the epoch's
    seed (data_utils.py:170-205), the same on every replica, so batch ``j``
    of every rank comes from the same bucket and has the same padded shape.

A replica is one process: one card under ``torch.distributed``.
"""

from __future__ import annotations

import bisect
from typing import Iterator, List, Sequence

import numpy as np


class BucketSampler:
    def __init__(self, lengths: Sequence[int], batch_size: int, boundaries: Sequence[int],
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} is outside [0, {num_replicas})")
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0

        self.buckets, self.num_samples_per_bucket = self._create_buckets()
        self.total_size = sum(self.num_samples_per_bucket)
        self.num_samples = self.total_size // num_replicas

    def _bucket_of(self, length: int) -> int:
        """Index i with boundaries[i] < length <= boundaries[i+1], else -1."""
        i = bisect.bisect_left(self.boundaries, length)
        if 0 < i < len(self.boundaries):
            return i - 1
        return -1

    def _create_buckets(self):
        buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(self.lengths):
            idx = self._bucket_of(length)
            if idx != -1:
                buckets[idx].append(i)
        for i in range(len(buckets) - 1, 0, -1):  # data_utils.py:157-160
            if len(buckets[i]) == 0:
                buckets.pop(i)
                self.boundaries.pop(i + 1)
        total_batch = self.num_replicas * self.batch_size
        num_samples_per_bucket = [
            len(b) + (total_batch - (len(b) % total_batch)) % total_batch for b in buckets]
        return buckets, num_samples_per_bucket

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def bucket_boundary(self, batch: Sequence[int]) -> int:
        """A batch's padded frame count: its bucket's upper boundary."""
        longest = max(self.lengths[i] for i in batch)
        return self.boundaries[self._bucket_of(longest) + 1]

    def __iter__(self) -> Iterator[List[int]]:
        g = np.random.default_rng(self.epoch)
        if self.shuffle:
            orders = [g.permutation(len(b)).tolist() for b in self.buckets]
        else:
            orders = [list(range(len(b))) for b in self.buckets]

        batches: List[List[int]] = []
        for bucket, ids, n_target in zip(self.buckets, orders, self.num_samples_per_bucket):
            rem = n_target - len(bucket)
            if len(bucket):
                ids = ids + ids * (rem // len(bucket)) + ids[: rem % len(bucket)]
            ids = ids[self.rank:: self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                batches.append([bucket[k] for k in
                                ids[j * self.batch_size: (j + 1) * self.batch_size]])
        if self.shuffle:
            batches = [batches[i] for i in g.permutation(len(batches))]
        if len(batches) * self.batch_size != self.num_samples:
            raise RuntimeError("BucketSampler: batches do not cover num_samples")
        return iter(batches)

    def __len__(self) -> int:
        return self.num_samples // self.batch_size
