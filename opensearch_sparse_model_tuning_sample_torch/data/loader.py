"""DataLoader: host-side batching with background prefetch.

The PyTorch port's copy of the JAX package's `data/loader.py` (the
reference's torch DataLoader + CombinedRandomSampler wiring,
trainer.py:180-218): plain-Python iteration, numpy shuffling seeded with
`seed + epoch` (so both packages give the same order), homogeneous batches
for a CombinedDataset, and a thread prefetcher that overlaps tokenization
with the device step. Worker exceptions reach the consumer. Each batch's
collation is the span `data.collate` (`utils/tracing.py`), which a
profiler sees where it records: on the thread that collates.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from ..utils import tracing
from .datasets import CombinedDataset, CombinedRandomSampler


class DataLoader:
    """Iterate `dataset` in shuffled batches of `batch_size`, collated by
    `collate_fn`. Re-iterable; each pass reshuffles (seed + epoch)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        self._skip_next = 0  # batches to skip on the next pass (exact resume)
        self._sampler = (
            CombinedRandomSampler(dataset.datasets, batch_size, seed=seed, drop_last=drop_last)
            if isinstance(dataset, CombinedDataset)
            else None
        )

    def __len__(self) -> int:
        if self._sampler is not None:
            return len(self._sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _row_batches(self) -> Iterator[list]:
        # exact-resume fast-forward: skip the first `_skip_next` batches of
        # this pass without fetching rows or collating; the epoch's batch
        # order is a function of (seed, epoch) alone
        skip, self._skip_next = self._skip_next, 0
        if self._sampler is not None:
            self._sampler.set_epoch(self._epoch)
            for j, pairs in enumerate(self._sampler):
                if j < skip:
                    continue
                yield [self.dataset[p] for p in pairs]
        else:
            rng = np.random.default_rng(self.seed + self._epoch)
            perm = rng.permutation(len(self.dataset))
            stop = len(perm) - len(perm) % self.batch_size if self.drop_last else len(perm)
            for start in range(skip * self.batch_size, stop, self.batch_size):
                yield [self.dataset[int(i)] for i in perm[start: start + self.batch_size]]

    def _produce(self) -> Iterator:
        for rows in self._row_batches():
            with tracing.span("data.collate"):
                batch = self.collate_fn(rows)
            yield batch

    def __iter__(self) -> Iterator:
        self._epoch += 1  # each full pass reshuffles
        if self.prefetch <= 0:
            yield from self._produce()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END, _ERR = object(), object()
        stop = threading.Event()  # set when the consumer abandons mid-epoch

        def worker():
            try:
                for batch in self._produce():
                    # a bounded put that honours abandonment: a consumer that
                    # drops the iterator mid-epoch (epochs() at max_steps)
                    # would otherwise leave this thread blocked forever
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(_END)
            except BaseException as e:  # hand it to the consumer
                if not stop.is_set():
                    q.put((_ERR, e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                    raise item[1]
                yield item
            t.join()
        finally:
            stop.set()
            # drain so a put-blocked worker can see `stop` and exit
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def epochs(loader: DataLoader, max_steps: int, start: int = 0) -> Iterator:
    """Cycle the loader across epochs, yielding exactly `max_steps - start`
    batches (the HF-Trainer epoch loop flattened into one stream).

    `start` > 0 is exact resume: the stream fast-forwards to global batch
    index `start` (completed epochs set the epoch counter, so the reshuffle
    seeds match, and the in-epoch remainder is skipped by index), so the
    resumed sequence is the uninterrupted run's."""
    produced = start
    if start:
        per_epoch = len(loader)
        if per_epoch <= 0:
            raise ValueError("cannot fast-forward an empty loader")
        loader._epoch = start // per_epoch  # completed epochs
        loader._skip_next = start % per_epoch
    while produced < max_steps:
        empty = True
        for batch in loader:
            empty = False
            yield batch
            produced += 1
            if produced >= max_steps:
                return
        if empty:
            raise ValueError("loader produced no batches (dataset too small?)")
