"""Gluon-style Dataset / DataLoader (counterpart of
``dt_tpu/data/dataset.py``; host code in numpy, the same samplers, batches
and order).

Reference: ``python/mxnet/gluon/data/`` — ``Dataset`` (random access),
``ArrayDataset``, transforms, ``Sampler`` zoo, ``DataLoader`` (batchify +
shuffle + multi-worker prefetch).  ``num_workers > 0`` forks a real
N-process worker pool exactly like the reference's
``dataloader.py:26-75`` (fork start method: the dataset is inherited by
the workers, one BATCH per task, ``2 * num_workers`` batches in flight,
results reordered to the sampler order); transform code that holds the
GIL (pure-Python augmenters) therefore scales with processes, not
threads."""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from dt_tpu_torch.data.io import DataBatch, DataIter


class Dataset:
    """Random-access dataset (reference ``gluon.data.Dataset``)."""

    def __getitem__(self, idx: int):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        """``lazy=True`` applies ``fn`` per access; ``lazy=False`` applies
        it once now (gluon parity — errors surface immediately, cost paid
        once)."""
        out = _TransformedDataset(self, fn)
        if lazy:
            return out
        return _ListDataset([out[i] for i in range(len(out))])

    def transform_first(self, fn: Callable) -> "Dataset":
        return self.transform(lambda *items: (fn(items[0]),) + items[1:])


class _ListDataset(Dataset):
    def __init__(self, items: List):
        self._items = items

    def __getitem__(self, idx):
        return self._items[idx]

    def __len__(self):
        return len(self._items)


class _TransformedDataset(Dataset):
    def __init__(self, base: Dataset, fn: Callable):
        self._base = base
        self._fn = fn

    def __getitem__(self, idx):
        item = self._base[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)

    def __len__(self):
        return len(self._base)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (reference ``gluon.data.ArrayDataset``)."""

    def __init__(self, *arrays):
        assert arrays and all(len(a) == len(arrays[0]) for a in arrays)
        self._arrays = arrays

    def __getitem__(self, idx):
        out = tuple(a[idx] for a in self._arrays)
        return out if len(out) > 1 else out[0]

    def __len__(self):
        return len(self._arrays[0])


class Sampler:
    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int):
        self._n = length

    def __iter__(self):
        return iter(range(self._n))

    def __len__(self):
        return self._n


class RandomSampler(Sampler):
    def __init__(self, length: int, seed: int = 0):
        self._n = length
        self._seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(self._seed + self._epoch)
        self._epoch += 1
        return iter(rng.permutation(self._n).tolist())

    def __len__(self):
        return self._n


def default_batchify(items: List) -> DataBatch:
    """Stack tuple items column-wise (reference ``default_batchify_fn``).

    1 column -> ``DataBatch(data)``; 2 -> ``(data, label)``; 3+ ->
    ``label`` is the tuple of all remaining stacked columns (nothing is
    dropped; supply a custom ``batchify_fn`` for other layouts)."""
    if isinstance(items[0], tuple):
        cols = list(zip(*items))
        arrs = [np.stack([np.asarray(x) for x in col]) for col in cols]
        if len(arrs) == 1:
            return DataBatch(arrs[0], None, 0)
        if len(arrs) == 2:
            return DataBatch(arrs[0], arrs[1], 0)
        return DataBatch(arrs[0], tuple(arrs[1:]), 0)
    return DataBatch(np.stack([np.asarray(x) for x in items]), None, 0)


class DataLoader(DataIter):
    """Reference ``gluon.data.DataLoader``: dataset + sampler -> batches;
    ``num_workers > 0`` runs ``__getitem__`` + ``batchify_fn`` in that
    many forked worker processes (the reference's multiprocessing pool,
    ``gluon/data/dataloader.py:26-75``); ``last_batch`` in
    {'keep','discard'}.  ``prefetch`` (default ``2 * num_workers``) is the
    number of batches kept in flight.

    Fork-safety: workers are forked at *construction* time, also after
    the parent has made its CUDA context.  A worker touches no CUDA: the
    dataset's ``__getitem__`` and ``batchify_fn`` run on the host (numpy,
    as :func:`default_batchify`; a torch call on the card in a forked
    child raises).  Threads of the parent do not follow it into the
    child, and a lock one of them held at the fork stays held there, so
    build the loader where no other thread is inside the dataset.  Call
    :meth:`close` (or use the loader as a context manager) when done: it
    terminates and joins the workers; ``__del__`` is only a best-effort
    fallback."""

    def __init__(self, dataset: Dataset, batch_size: int,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: str = "keep",
                 batchify_fn: Callable = default_batchify,
                 num_workers: int = 0, seed: int = 0,
                 prefetch: Optional[int] = None):
        super().__init__(batch_size)
        self.dataset = dataset
        if sampler is None:
            sampler = RandomSampler(len(dataset), seed) if shuffle \
                else SequentialSampler(len(dataset))
        self.sampler = sampler
        if last_batch not in ("keep", "discard"):
            raise ValueError(last_batch)
        self.last_batch = last_batch
        self.batchify_fn = batchify_fn
        if num_workers > 0:
            self._it: DataIter = _MPLoaderIter(
                self, num_workers,
                2 * num_workers if prefetch is None else max(prefetch, 1))
        else:
            self._it = _LoaderIter(self)

    def reset(self):
        self._it.reset()

    @property
    def steps_per_epoch(self):
        n = len(self.dataset)
        return n // self.batch_size if self.last_batch == "discard" \
            else -(-n // self.batch_size)

    def next(self) -> DataBatch:
        return self._it.next()

    def close(self):
        """Shut down worker processes (no-op for the in-process path)."""
        if hasattr(self._it, "close"):
            self._it.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _LoaderIter(DataIter):
    def __init__(self, loader: DataLoader):
        super().__init__(loader.batch_size)
        self._loader = loader
        self._order: List[int] = []
        self._cursor = 0
        self.reset()

    def reset(self):
        # Regenerate the order only if the current one was (partly)
        # consumed: construction followed by a for-loop's reset() must not
        # burn a RandomSampler epoch (reproducibility of seed -> order).
        if self._cursor > 0 or not self._order:
            self._order = list(iter(self._loader.sampler))
        self._cursor = 0

    def next(self) -> DataBatch:
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        if end > n and self._loader.last_batch == "discard":
            self._cursor = n
            raise StopIteration
        idx = self._order[self._cursor:end]
        self._cursor = end
        return self._loader.batchify_fn([self._loader.dataset[i]
                                         for i in idx])


# worker-side state for _MPLoaderIter: installed by the pool initializer
# (fork start method — inherited, never pickled, so unpicklable datasets
# and closures work, matching the reference's worker_loop globals)
_worker_dataset = None
_worker_batchify = None


def _mp_worker_init(dataset, batchify_fn):
    global _worker_dataset, _worker_batchify
    _worker_dataset = dataset
    _worker_batchify = batchify_fn


def _mp_worker_batch(indices):
    return _worker_batchify([_worker_dataset[i] for i in indices])


class _MPLoaderIter(DataIter):
    """N-process batch evaluation (reference ``gluon/data/dataloader.py``
    ``DataLoader.__iter__`` multi-worker path): the fork pool inherits the
    dataset, the master streams index lists, each task returns one
    batchified batch, and ``prefetch`` tasks ride in flight.  Results pop
    in submission order so the sampler order is preserved regardless of
    worker timing."""

    def __init__(self, loader: DataLoader, num_workers: int,
                 prefetch: int):
        super().__init__(loader.batch_size)
        import multiprocessing as mp
        self._loader = loader
        self._prefetch = prefetch
        self._pool = mp.get_context("fork").Pool(
            num_workers, initializer=_mp_worker_init,
            initargs=(loader.dataset, loader.batchify_fn))
        self._order: List[int] = []
        self._cursor = 0
        self._consumed = 0  # next() calls since the order was generated
        self._pending: List = []
        self.reset()

    def reset(self):
        # prefetch advances _cursor ahead of consumption, so the
        # regenerate-only-if-used check (same contract as _LoaderIter:
        # construction + a for-loop's reset() must not burn a
        # RandomSampler epoch) keys off batches actually handed out.
        # When nothing was consumed the in-flight work IS the epoch
        # prefix from cursor 0 — keep it rather than recompute it.
        if self._consumed == 0 and self._order:
            return
        self._order = list(iter(self._loader.sampler))
        self._consumed = 0
        self._cursor = 0
        # drain stale in-flight results (cheap: at most `prefetch`)
        for r in self._pending:
            try:
                r.get()
            except Exception:
                pass
        self._pending = []
        self._fill()

    def _fill(self):
        while len(self._pending) < self._prefetch:
            n = len(self._order)
            if self._cursor >= n:
                break
            end = self._cursor + self.batch_size
            if end > n and self._loader.last_batch == "discard":
                self._cursor = n
                break
            idx = self._order[self._cursor:end]
            self._cursor = end
            self._pending.append(
                self._pool.apply_async(_mp_worker_batch, (idx,)))

    def next(self) -> DataBatch:
        if not self._pending:
            raise StopIteration
        batch = self._pending.pop(0).get()
        self._consumed += 1
        self._fill()
        return batch

    def close(self):
        self._pool.terminate()
        self._pool.join()

    def __del__(self):
        try:
            self._pool.terminate()
        except Exception:
            pass
