"""Bucketed sequence iteration for variable-length RNN training
(counterpart of ``dt_tpu/data/bucket_io.py``).

Reference: ``mx.rnn.BucketSentenceIter`` + ``BucketingModule``
(``python/mxnet/module/bucketing_module.py:1``; ``example/rnn/bucketing/``).
The reference re-binds a shared-parameter executor per bucket; an eager
PyTorch model takes every bucket length with the same weights.  What
remains is the data side: assign sequences to buckets, pad to the bucket
length, emit fixed-shape batches tagged with their bucket.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from dt_tpu_torch.data.io import DataBatch, DataIter


class BucketSentenceIter(DataIter):
    """Group token sequences into length buckets; yield (T_bucket, B)
    batches padded with ``invalid_label``.

    Batches carry ``bucket_key`` (the bucket length), the
    BucketingModule's key.
    """

    def __init__(self, sentences: Sequence[Sequence[int]],
                 batch_size: int, buckets: Optional[List[int]] = None,
                 invalid_label: int = -1, shuffle: bool = True,
                 seed: int = 0, layout: str = "TN"):
        super().__init__(batch_size)
        if buckets is None:
            lens = sorted({len(s) for s in sentences})
            buckets = lens or [1]
        self.buckets = sorted(buckets)
        self.invalid_label = invalid_label
        self.shuffle = shuffle
        self.layout = layout
        self._seed = seed
        self._epoch = 0

        # assign each sentence to the smallest bucket that fits; longer
        # sentences are DISCARDED (reference BucketSentenceIter behavior)
        self._data: List[np.ndarray] = []
        for bkt in self.buckets:
            self._data.append([])
        for s in sentences:
            for bi, bkt in enumerate(self.buckets):
                if len(s) <= bkt:
                    padded = np.full(bkt, invalid_label, np.int32)
                    padded[:len(s)] = s
                    self._data[bi].append(padded)
                    break
        self._data = [np.asarray(b, np.int32).reshape(-1, bkt)
                      for b, bkt in zip(self._data, self.buckets)]
        self._plan()

    def _plan(self):
        rng = np.random.RandomState(self._seed + self._epoch)
        self._batches = []  # (bucket_idx, row indices)
        for bi, arr in enumerate(self._data):
            idx = np.arange(len(arr))
            if self.shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx) - self.batch_size + 1,
                           self.batch_size):
                self._batches.append((bi, idx[i:i + self.batch_size]))
        if self.shuffle:
            rng.shuffle(self._batches)
        self._cursor = 0

    def reset(self):
        self._epoch += 1
        self._plan()

    @property
    def steps_per_epoch(self) -> int:
        return len(self._batches)

    def next(self) -> DataBatch:
        if self._cursor >= len(self._batches):
            raise StopIteration
        bi, rows = self._batches[self._cursor]
        self._cursor += 1
        arr = self._data[bi][rows]  # (B, T)
        if self.layout == "TN":
            arr = arr.T  # (T, B)
        return DataBatch(arr, None, 0, bucket_key=self.buckets[bi])
