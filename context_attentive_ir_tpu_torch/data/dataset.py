"""Batch iterators over vectorized examples.

Parity target: the reference's ``torch.utils.data.Dataset`` +
``DataLoader(--data_workers, shuffle)`` per task family (SURVEY.md SS2.1
'Datasets', marker ``exp:``).

TPU-first redesign: instead of worker processes producing variable-shape
batches, each epoch is a deterministic, seedable permutation of examples cut
into *fixed-size* batches (the final short batch is padded and flagged via
``row_mask``), so every step presents identical shapes to the compiled step
function.  Determinism makes exact checkpoint resume possible
(SURVEY.md SS5.3): the iterator state is (epoch_seed, position).

A copy of ``context_attentive_ir_tpu/data/dataset.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Generic, Iterator, Sequence, TypeVar

import numpy as np

T = TypeVar("T")
B = TypeVar("B")


class BatchIterator(Generic[T, B]):
    """Deterministic fixed-shape batch stream.

    ``collate(examples, batch_size) -> Batch`` must pad short batches and set
    ``row_mask`` accordingly (the ``build_*_batch`` functions in
    ``vectorize.py`` do).
    """

    def __init__(
        self,
        examples: Sequence[T],
        collate: Callable[[list[T]], B],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.examples = list(examples)
        self.collate = collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.examples)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch_idx: int, start_batch: int = 0) -> Iterator[B]:
        """Iterate batches of one epoch; resumable from ``start_batch``."""
        order = np.arange(len(self.examples))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch_idx)
            rng.shuffle(order)
        n_batches = len(self)
        for b in range(start_batch, n_batches):
            idx = order[b * self.batch_size: (b + 1) * self.batch_size]
            yield self.collate([self.examples[i] for i in idx])

    def __iter__(self) -> Iterator[B]:
        return self.epoch(0)


class BucketedIterator(Generic[T, B]):
    """Length-bucketed batches: each example is assigned the smallest
    bucket >= its length, and each bucket pads to its own static shape.

    TPU rationale (SURVEY.md SS7 hard part (a)): most AOL sessions have
    2-3 turns; padding everything to max_session_len wastes a multiple of
    the FLOPs.  One compiled program per bucket (a handful of compiles)
    instead of per-batch dynamic shapes (a recompile per shape).

    ``collate(examples, bucket_key) -> Batch`` receives the bucket key so
    it can pick the per-bucket ShapeConfig.  Determinism/resume contract
    matches BatchIterator: (epoch seed, global batch index).
    """

    def __init__(
        self,
        examples: Sequence[T],
        length_of: Callable[[T], int],
        collate: Callable[[list[T], int], B],
        batch_size: int,
        buckets: Sequence[int],
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.examples = list(examples)
        self.collate = collate
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self._assign = []
        for ex in self.examples:
            n = length_of(ex)
            key = next((b for b in self.buckets if n <= b),
                       self.buckets[-1])
            self._assign.append(key)

    def __len__(self) -> int:
        total = 0
        for b in self.buckets:
            n = sum(1 for k in self._assign if k == b)
            total += (n + self.batch_size - 1) // self.batch_size
        return total

    def epoch(self, epoch_idx: int, start_batch: int = 0) -> Iterator[B]:
        rng = np.random.RandomState(self.seed + epoch_idx)
        plan: list[tuple[int, list[int]]] = []
        for b in self.buckets:
            idx = np.asarray([i for i, k in enumerate(self._assign)
                              if k == b])
            if self.shuffle and len(idx):
                rng.shuffle(idx)
            for s in range(0, len(idx), self.batch_size):
                plan.append((b, idx[s:s + self.batch_size].tolist()))
        if self.shuffle:
            rng.shuffle(plan)
        for bucket, idx in plan[start_batch:]:
            yield self.collate([self.examples[i] for i in idx], bucket)
