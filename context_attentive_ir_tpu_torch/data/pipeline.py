"""Host input pipeline: packed vectorization cache + prefetch overlap.

The port of ``context_attentive_ir_tpu/data/pipeline.py`` (which imports
``jax`` only for ``jax.tree.map`` over a batch; here the map runs over the
batch dataclass's fields).  Two independent pieces, both deterministic and
both keeping the (epoch_seed, position) resume contract of
``BatchIterator``:

- ``PackedIterator``: vectorize the whole example list once (examples are
  immutable across epochs -- only the shuffle order changes), keeping the
  collated arrays as one contiguous numpy "superbatch"; each batch is then
  a fancy-index row gather, far cheaper than re-tokenizing.
  ``PackedBucketedIterator`` does the same with one superbatch per bucket.
- ``prefetch``: a single daemon thread + bounded queue that runs the host
  collate for batch t+1..t+depth while the card executes batch t.

Batches stay numpy on the host; the consumer moves them to its device
(``batch.to(device)``).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Generic, Iterable, Iterator, Sequence, TypeVar

import dataclasses

import numpy as np

T = TypeVar("T")
B = TypeVar("B")

logger = logging.getLogger(__name__)

_SENTINEL = object()


def _map_fields(fn, batch):
    """``fn`` over every array of a batch dataclass, as a new batch; a
    ``None`` field (a ``RankBatch`` without character ids) stays ``None``,
    as ``jax.tree.map`` skips it."""
    def apply(a):
        return None if a is None else fn(a)

    return type(batch)(**{f.name: apply(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


def _nbytes(batch) -> int:
    return sum(a.nbytes for a in (getattr(batch, f.name)
                                  for f in dataclasses.fields(batch))
               if a is not None)


def prefetch(batches: Iterable[B], depth: int = 2) -> Iterator[B]:
    """Yield from ``batches`` with a background thread running ``depth``
    items ahead.

    Order-preserving and exception-transparent: an exception raised by the
    producer is re-raised at the consumer's next ``next()``.  Closing the
    returned generator (break / GC) stops the producer promptly -- it
    blocks on a bounded queue, which the closer drains.
    """
    if depth <= 0:
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """Blocking put that stays responsive to the stop flag; returns
        False if stopped first."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in batches:
                if not put_or_stop(item):
                    return
            put_or_stop(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            # must not be dropped on a full queue (the consumer may sit
            # in a minutes-long device step before its next get(); a
            # swallowed error would leave it blocked forever once the
            # buffered items drain) -- retry under the stop flag exactly
            # like the item path
            put_or_stop(e)

    t = threading.Thread(target=producer, daemon=True,
                         name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer blocked on put() can observe the stop flag
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def _take_rows(packed: B, idx: np.ndarray, batch_size: int) -> B:
    """Gather rows ``idx`` from a packed superbatch, padding a short
    batch with zero rows (PAD ids / False masks / 0.0 labels --
    bit-identical to the collate functions' pre-filled short-batch
    padding; PAD == 0, constants.py)."""
    k = len(idx)
    if k < batch_size:
        idx = np.concatenate([idx, np.zeros(batch_size - k, np.int64)])

        def gather(a):
            out = a[idx]
            out[k:] = 0
            return out

        return _map_fields(gather, packed)
    return _map_fields(lambda a: a[idx], packed)


class PackedIterator(Generic[T, B]):
    """Pack-once batch stream: drop-in for ``BatchIterator`` when the
    collate output for an example does not depend on which batch it lands
    in (true for every ``build_*_batch``: rows are per-example, padding is
    static).

    ``collate(examples, batch_size) -> Batch`` is called ONCE over the
    full example list (batch_size=len(examples)); per-batch assembly is a
    row gather over the packed arrays.  Bit-identical to BatchIterator
    output by construction (same collate, same per-epoch permutation --
    asserted in tests).  The final short batch pads with zero rows
    (``_take_rows``) -- bit-identical to the collate functions'
    pre-filled short-batch padding (PAD == 0, masks False, labels 0.0).
    """

    def __init__(
        self,
        examples: Sequence[T],
        collate: Callable[..., B],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.n = len(examples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        packed = collate(list(examples), batch_size=self.n)
        if not hasattr(packed, "row_mask"):
            raise TypeError("PackedIterator needs a *Batch with row_mask")
        self._packed = packed
        self.nbytes = _nbytes(packed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def take(self, idx: np.ndarray) -> B:
        """Assemble one batch from packed rows (`idx` may be short)."""
        return _take_rows(self._packed, idx, self.batch_size)

    def epoch(self, epoch_idx: int, start_batch: int = 0) -> Iterator[B]:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch_idx)
            rng.shuffle(order)
        for b in range(start_batch, len(self)):
            yield self.take(order[b * self.batch_size:
                                  (b + 1) * self.batch_size])

    def __iter__(self) -> Iterator[B]:
        return self.epoch(0)


class PackedBucketedIterator(Generic[T, B]):
    """Pack-once variant of ``dataset.BucketedIterator``: one packed
    superbatch PER BUCKET (each bucket has its own static shape), the
    same (epoch seed, global batch index) plan, bit-identical batches.

    ``collate(examples, bucket_key, batch_size) -> Batch`` -- the extra
    ``batch_size`` kwarg (vs BucketedIterator's 2-arg collate) lets the
    pack step collate a whole bucket at once.
    """

    def __init__(
        self,
        examples: Sequence[T],
        length_of: Callable[[T], int],
        collate: Callable[..., B],
        batch_size: int,
        buckets: Sequence[int],
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.shuffle = shuffle
        self.seed = seed
        n = len(examples)
        self._assign = []
        for ex in examples:
            ln = length_of(ex)
            key = next((b for b in self.buckets if ln <= b),
                       self.buckets[-1])
            self._assign.append(key)
        # pack each bucket; map global example index -> row in its pack
        self._packs: dict[int, B] = {}
        self._local = np.zeros(n, np.int64)
        self.nbytes = 0
        for b in self.buckets:
            idx = [i for i, k in enumerate(self._assign) if k == b]
            if not idx:
                continue
            self._local[idx] = np.arange(len(idx))
            pack = collate([examples[i] for i in idx], b,
                           batch_size=len(idx))
            self._packs[b] = pack
            self.nbytes += _nbytes(pack)

    def __len__(self) -> int:
        total = 0
        for b in self.buckets:
            nb = sum(1 for k in self._assign if k == b)
            total += (nb + self.batch_size - 1) // self.batch_size
        return total

    def epoch(self, epoch_idx: int, start_batch: int = 0) -> Iterator[B]:
        # plan construction mirrors BucketedIterator.epoch EXACTLY (same
        # RandomState consumption order) so the two are interchangeable
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
            yield _take_rows(self._packs[bucket], self._local[idx],
                             self.batch_size)

    def __iter__(self) -> Iterator[B]:
        return self.epoch(0)
