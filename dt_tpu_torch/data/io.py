"""Data iterators of the port (counterpart of ``dt_tpu/data/io.py``).

Copied, not imported, since the port imports nothing of ``dt_tpu``: the
iterators yield numpy host batches, images NHWC as in the JAX package, and
``Module`` places them on the device (NCHW in ``torch.channels_last``
memory format, which is NHWC in memory).  ``DevicePrefetchIter`` places
them one batch ahead on a side CUDA stream instead.  The batch order, pads
and leftovers are the JAX package's, bit for bit
(``tests/test_torch_io.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.policy import rescale


def _is_bf16(dtype) -> bool:
    return dtype is torch.bfloat16 or str(dtype) == "bfloat16"


def _f32_tensor(arr) -> torch.Tensor:
    a = np.ascontiguousarray(arr, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def host_values(arr, dtype) -> np.ndarray:
    """``arr`` cast to ``dtype`` as a numpy array.  numpy has no bfloat16
    of its own (the JAX package gets one from ``ml_dtypes``, which the
    port does not use), so ``"bfloat16"`` gives float32 holding the
    bfloat16 values: rounded to nearest even through float32, as
    ``ml_dtypes`` casts."""
    if _is_bf16(dtype):
        return _f32_tensor(arr).to(torch.bfloat16).float().numpy()
    return np.asarray(arr).astype(dtype)


def host_batch(arr, dtype):
    """A batch's array in ``dtype``: numpy, but a CPU ``torch.bfloat16``
    tensor for ``"bfloat16"`` (the same values as ``ml_dtypes``' cast;
    ``Module`` and :class:`DevicePrefetchIter` place either)."""
    if _is_bf16(dtype):
        return _f32_tensor(arr).to(torch.bfloat16)
    return np.asarray(arr).astype(dtype)


class DataBatch:
    """One batch.  Reference: ``mx.io.DataBatch`` — ``pad`` counts the fake
    trailing examples appended to fill the batch (last_batch_handle='pad')."""

    __slots__ = ("data", "label", "pad", "bucket_key")

    def __init__(self, data: np.ndarray, label: Optional[np.ndarray] = None,
                 pad: int = 0, bucket_key=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.bucket_key = bucket_key  # set by bucketing iterators


class DataDesc:
    """Shape/dtype/layout descriptor for one iterator stream (reference
    ``mx.io.DataDesc``, ``python/mxnet/io/io.py:39-90``): what
    ``provide_data``/``provide_label`` advertise so a consumer can bind
    buffers before the first batch."""

    __slots__ = ("name", "shape", "dtype", "layout")

    def __init__(self, name: str, shape: tuple, dtype=np.float32,
                 layout: str = "NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.layout = layout

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},"
                f"{self.dtype},{self.layout}]")

    def __eq__(self, other):
        return (isinstance(other, DataDesc)
                and (self.name, self.shape, self.dtype, self.layout)
                == (other.name, other.shape, other.dtype, other.layout))

    def __hash__(self):
        # hashable like the reference namedtuple (descs key buffer maps)
        return hash((self.name, self.shape, self.dtype, self.layout))

    def __iter__(self):
        # reference parity: DataDesc unpacks like the (name, shape) tuple
        # it replaced (io.py:83 "DataDesc is a namedtuple")
        return iter((self.name, self.shape))


class DataIter:
    """Iterator base.  Reference: ``mx.io.DataIter`` (reset/next/iter).

    ``num_parts``/``part_index`` sharding is part of the base contract here
    (in the reference it is per-iterator param plumbing,
    ``src/io/image_iter_common.h:127-162``).
    """

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def reset(self) -> None:
        raise NotImplementedError

    def next(self) -> DataBatch:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataBatch]:
        self.reset()
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    @property
    def steps_per_epoch(self) -> Optional[int]:
        return None


def _init_streams(arrays, default_name: str):
    """Normalize NDArrayIter's data/label argument to [(name, array)]
    (reference ``io.py:_init_data``): a bare array gets ``default_name``,
    dicts keep insertion order, lists get ``name_i`` suffixes."""
    if arrays is None:
        return []
    if isinstance(arrays, dict):
        return list(arrays.items())
    if isinstance(arrays, (list, tuple)):
        return [(f"{default_name}_{i}", a) for i, a in enumerate(arrays)]
    return [(default_name, arrays)]


def _take(arr, sel: np.ndarray) -> np.ndarray:
    """Gather rows ``sel`` as a dense numpy array.

    - numpy: fancy index.
    - scipy CSR: row-slice then densify (the reference keeps CSR for its
      sparse-PS pull path, ``io.py:682``; here, as in the JAX package,
      the host boundary is where sparse densifies).
    - h5py.Dataset: h5py fancy indexing requires strictly increasing
      unique indices (its ``io.py:700`` pain point too), so gather via
      argsort + inverse permutation; duplicates (wrap-pad) via unique.
    """
    if isinstance(arr, np.ndarray):
        return arr[sel]
    mod = type(arr).__module__
    if mod.startswith("scipy.sparse"):
        return np.asarray(arr[sel].todense())
    if mod.startswith("h5py"):
        uniq, inverse = np.unique(sel, return_inverse=True)
        return np.asarray(arr[uniq.tolist()])[inverse]
    return np.asarray(arr)[sel]


class NDArrayIter(DataIter):
    """In-memory iterator with sharding + shuffle + pad semantics.

    Reference: ``mx.io.NDArrayIter`` (``python/mxnet/io/io.py:489-530``);
    ``last_batch_handle`` in {'pad','discard','roll_over'} with reference
    behavior.  ``data``/``label`` accept numpy arrays, ``h5py.Dataset``
    objects (kept on disk; batches gathered per access) and
    ``scipy.sparse.csr_matrix`` (densified per batch at the host
    boundary).  ``provide_data``/``provide_label`` advertise
    :class:`DataDesc` rows like the reference.  Sharding: this part sees
    ``data[part_index::num_parts]`` (the reference's RecordIO sharding is
    also strided by part).
    """

    def __init__(self, data, label=None,
                 batch_size: int = 32, shuffle: bool = False,
                 last_batch_handle: str = "pad", num_parts: int = 1,
                 part_index: int = 0, seed: int = 0,
                 data_name: str = "data", label_name: str = "softmax_label",
                 part_weights: Optional[Sequence[float]] = None):
        """``part_weights`` (``dt_tpu/policy``): per-part relative
        weights — the shard split becomes contiguous largest-remainder
        ranges proportional to the weights instead of the equal strided
        split, so a worker whose policy batch share shrank also reads
        proportionally fewer examples (weighted re-sharding per Lin et
        al. dynamic mini-batch; equal weights reproduce near-equal
        contiguous parts)."""
        super().__init__(batch_size)
        if not 0 <= part_index < num_parts:
            raise ValueError(f"part_index {part_index} not in [0, {num_parts})")
        if part_weights is not None and len(part_weights) != num_parts:
            raise ValueError(
                f"part_weights has {len(part_weights)} entries for "
                f"{num_parts} parts")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(last_batch_handle)
        # data/label: array | dict {name: array} | list of arrays
        # (reference io.py:564 "multiple input and labels"); each array a
        # numpy ndarray, h5py.Dataset, or scipy CSR — all consumed
        # through _take/shape[0].  Multi-stream batches come out as
        # tuples in stream order.
        self._data_streams = _init_streams(data, data_name)
        self._label_streams = _init_streams(label, label_name)
        if not self._data_streams:
            raise ValueError("data must contain at least one stream "
                             "(got an empty dict/list)")
        lens = {a.shape[0] for _, a in
                self._data_streams + self._label_streams}
        if len(lens) > 1:
            raise ValueError(
                f"all data/label streams must share the leading dim; got "
                f"{sorted(lens)}")
        self.data_name = self._data_streams[0][0]
        self.label_name = self._label_streams[0][0] if self._label_streams \
            else label_name
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_parts = num_parts
        self.part_index = part_index
        self.part_weights = list(part_weights) if part_weights is not None \
            else None
        self._epoch = 0
        self._seed = seed
        self._leftover: Optional[np.ndarray] = None
        self._setup_epoch()

    def _setup_epoch(self):
        # len() is a TypeError on scipy CSR -> shape[0]
        n = self._data_streams[0][1].shape[0]
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(idx)
        if self.part_weights is not None:
            # weighted shard (r14 policy re-sharding): contiguous
            # largest-remainder ranges of the (shuffled) index — every
            # part derives the same bounds from the same weights, the
            # ranges are disjoint, and their union is the whole epoch
            counts = rescale.apportion(self.part_weights, n, min_each=0)
            start = int(sum(counts[:self.part_index]))
            idx = idx[start:start + counts[self.part_index]]
        else:
            # strided shard: every part gets ceil/floor(n/num_parts)
            # examples
            idx = idx[self.part_index::self.num_parts]
        if self._leftover is not None:
            idx = np.concatenate([self._leftover, idx])
            self._leftover = None
        self._order = idx
        self._cursor = 0

    def reset(self):
        self._epoch += 1
        self._setup_epoch()

    @property
    def num_examples(self) -> int:
        return len(self._order)

    @property
    def steps_per_epoch(self) -> int:
        n = len(self._order)
        if self.last_batch_handle == "discard":
            return n // self.batch_size
        return -(-n // self.batch_size)

    def next(self) -> DataBatch:
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        sel = self._order[self._cursor:end]
        pad = 0
        if end > n:
            if self.last_batch_handle == "discard":
                self._cursor = n
                raise StopIteration
            if self.last_batch_handle == "roll_over":
                self._leftover = sel
                self._cursor = n
                raise StopIteration
            pad = end - n
            sel = np.concatenate([sel, self._order[:pad]])  # wrap like reference
        self._cursor = end
        datas = tuple(_take(a, sel) for _, a in self._data_streams)
        labels = tuple(_take(a, sel) for _, a in self._label_streams)
        data = datas[0] if len(datas) == 1 else datas
        label = (labels[0] if len(labels) == 1
                 else labels if labels else None)
        return DataBatch(data, label, pad)

    def _descs(self, streams) -> List[DataDesc]:
        return [DataDesc(name, (self.batch_size,) + tuple(a.shape[1:]),
                         getattr(a, "dtype", np.float32))
                for name, a in streams]

    @property
    def provide_data(self) -> List[DataDesc]:
        """[DataDesc] per data stream (reference ``provide_data``);
        shapes lead with batch_size like the reference's."""
        return self._descs(self._data_streams)

    @property
    def provide_label(self) -> List[DataDesc]:
        return self._descs(self._label_streams)


class CSVIter(NDArrayIter):
    """CSV-backed iterator.  Reference: ``src/io/iter_csv.cc`` — here a thin
    numpy.loadtxt front-end over NDArrayIter (same batch semantics)."""

    def __init__(self, data_csv: str, data_shape: Sequence[int],
                 label_csv: Optional[str] = None, batch_size: int = 32, **kw):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
        super().__init__(data, label, batch_size, **kw)


class LibSVMIter(NDArrayIter):
    """LibSVM-format sparse data, densified.

    Reference: ``src/io/iter_libsvm.cc`` — the reference keeps CSR end to
    end for the sparse-PS path; here, as in the JAX package, sparse inputs
    densify at the host boundary.
    Line format: ``label idx:val idx:val ...``.  ``indexing``: 'one' (the
    LibSVM standard, DEFAULT — zero-based files fail loudly on index 0),
    'zero', or 'auto' (zero-based iff an index 0 appears; note auto cannot
    distinguish a zero-based file that never uses feature 0).  Out-of-range
    indices raise.
    """

    def __init__(self, data_libsvm: str, data_shape: Sequence[int],
                 batch_size: int = 32, indexing: str = "one", **kw):
        if indexing not in ("auto", "zero", "one"):
            raise ValueError(f"indexing {indexing!r}")
        num_features = int(np.prod(data_shape))
        entries, labels = [], []
        min_idx = None
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                pairs = []
                for tok in parts[1:]:
                    idx, val = tok.split(":")
                    idx = int(idx)
                    min_idx = idx if min_idx is None else min(min_idx, idx)
                    pairs.append((idx, float(val)))
                entries.append(pairs)
        if indexing == "auto":
            indexing = "zero" if min_idx == 0 else "one"
        offset = 1 if indexing == "one" else 0
        rows = []
        for pairs in entries:
            row = np.zeros(num_features, np.float32)
            for idx, val in pairs:
                j = idx - offset
                if not 0 <= j < num_features:
                    raise ValueError(
                        f"LibSVM index {idx} out of range for "
                        f"{num_features} features ({indexing}-based)")
                row[j] = val
            rows.append(row)
        data = np.asarray(rows, np.float32).reshape(
            (-1,) + tuple(data_shape))
        super().__init__(data, np.asarray(labels, np.float32), batch_size,
                         **kw)


class ResizeIter(DataIter):
    """Clamp an underlying iterator to exactly ``size`` batches per epoch,
    refilling from a fresh pass when the inner iterator is exhausted.

    Reference: ``mx.io.ResizeIter`` — the elastic fit loop wraps every
    worker's iterator in this so all workers run the SAME number of batches
    (``example/image-classification/common/fit.py:38-43``): unequal counts
    would hang the synchronous allreduce exactly like they hang the
    reference's synchronous push/pull.
    """

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch: Optional[DataBatch] = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    @property
    def steps_per_epoch(self) -> int:
        return self.size

    def next(self) -> DataBatch:
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """Background-thread double buffering.

    Reference: ``mx.io.PrefetchingIter`` / the C++ ``PrefetcherIter``
    (``src/io/iter_prefetcher.h``, dmlc ThreadedIter) — overlaps host batch
    prep with device compute, which hides input time behind the
    asynchronously launched train step.
    """

    def __init__(self, data_iter: DataIter, prefetch_depth: int = 2):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.depth = prefetch_depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._exhausted = False

    def _worker(self, q: "queue.Queue", stop: threading.Event):
        # q/stop are captured per-generation: a straggler worker from a
        # previous epoch can only ever touch its own (discarded) queue,
        # never the queue a later reset() created.
        try:
            while not stop.is_set():
                try:
                    batch = self.data_iter.next()
                except StopIteration:
                    q.put(None)
                    return
                q.put(batch)
        except Exception as e:  # propagate errors to consumer
            q.put(e)

    def reset(self):
        self._shutdown()
        self.data_iter.reset()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.depth)
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop), daemon=True)
        self._thread.start()

    def _shutdown(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def steps_per_epoch(self):
        return self.data_iter.steps_per_epoch

    def next(self) -> DataBatch:
        if self._thread is None:
            if getattr(self, "_exhausted", False):
                # keep raising after exhaustion like every other DataIter
                raise StopIteration
            self.reset()
        item = self._queue.get()
        if item is None:
            self._thread = None
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            self._thread = None
            self._exhausted = True
            raise item
        return item


class DevicePrefetchIter(DataIter):
    """Double-buffered host-to-device transfer: the NEXT batch is copied to
    the card on a side CUDA stream while the trainer computes on the
    current one (``dt_tpu/data/io.py:465``, where ``jax.device_put``
    dispatches the copy asynchronously).

    Each numpy array of a batch (or CPU tensor: a bfloat16 batch) is
    copied into pinned host memory and then to the device with
    ``non_blocking=True`` on the side stream, so the copy never waits for
    the compute in flight; an event recorded after the copies is what the
    consumer's stream waits on when the batch is handed over
    (``wait_event``), and ``record_stream`` tells the caching allocator
    that the consumer's stream uses the tensors.  Placed batches
    keep the iterator's layout (images NHWC) as torch tensors; ``Module``
    turns them into NCHW channels-last views.  On the CPU (``device=
    "cpu"``) batches pass through as they are.
    """

    def __init__(self, data_iter: DataIter,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.device = resolve_device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._ahead = None  # (DataBatch, event) or None
        self._exhausted = False

    def _put(self, batch: DataBatch):
        if self.device.type != "cuda":
            return batch, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def place(x):
            if isinstance(x, tuple):
                return tuple(place(a) for a in x)
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            elif not (isinstance(x, torch.Tensor) and x.device.type == "cpu"):
                return x
            return x.pin_memory().to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            placed = DataBatch(place(batch.data), place(batch.label),
                               batch.pad, bucket_key=batch.bucket_key)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _hand_over(self, batch: DataBatch, event) -> DataBatch:
        if event is None:
            return batch
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for x in (batch.data, batch.label):
            for t in (x if isinstance(x, tuple) else (x,)):
                if isinstance(t, torch.Tensor):
                    t.record_stream(cur)
        return batch

    def reset(self):
        self.data_iter.reset()
        self._ahead = None
        self._exhausted = False

    @property
    def steps_per_epoch(self):
        return self.data_iter.steps_per_epoch

    def next(self) -> DataBatch:
        if self._ahead is None:
            if self._exhausted:  # keep raising until reset(), like every
                raise StopIteration  # other DataIter
            try:
                self._ahead = self._put(self.data_iter.next())
            except StopIteration:
                self._exhausted = True
                raise
        current = self._ahead
        try:
            # the NEXT batch's copy is queued before this one is returned
            self._ahead = self._put(self.data_iter.next())
        except StopIteration:
            self._ahead = None
            self._exhausted = True  # raise at the NEXT call, not now
        return self._hand_over(*current)


class SyntheticImageIter(DataIter):
    """Deterministic synthetic image batches (benchmark-mode input).

    Reference: the ``--benchmark 1`` path in
    ``example/image-classification/common/fit.py`` (random synthetic data so
    input IO can't mask compute throughput)."""

    def __init__(self, image_shape: Sequence[int], num_classes: int,
                 batch_size: int, num_batches: int = 100, seed: int = 0,
                 dtype: str = "float32"):
        super().__init__(batch_size)
        rng = np.random.RandomState(seed)
        self._data = host_batch(
            rng.uniform(-1, 1, (batch_size,) + tuple(image_shape)), dtype)
        self._label = rng.randint(0, num_classes, (batch_size,)) \
            .astype("int32")
        self.num_batches = num_batches
        self._cur = 0

    def reset(self):
        self._cur = 0

    @property
    def steps_per_epoch(self) -> int:
        return self.num_batches

    def next(self) -> DataBatch:
        if self._cur >= self.num_batches:
            raise StopIteration
        self._cur += 1
        return DataBatch(self._data, self._label, 0)


class ElasticDataIterator:
    """The elastic re-sharding contract.

    Reference: ``BaseDataIterator`` (``python/mxnet/module/
    base_data_iterator.py``) + its implementation in
    ``example/dynamic-training/train_resnet.py:353-377``: after a membership
    change the fit loop calls ``get_data_iterator(kv)`` and the user rebuilds
    iterators with ``num_parts=kv.num_workers``, ``part_index=kv.rank``,
    wrapped in ResizeIter to equalize batch counts.

    ``factory(num_parts, part_index, batch_size)`` must return
    ``(train_iter, eval_iter_or_None)``.  ``global_batch_size`` fixed =>
    per-worker batch rescales (Lin et al. policy, ``train_resnet.py:315-317``);
    set ``fixed_per_worker_batch=True`` for the alternative policy shipped in
    ``fit.py:28-44``.

    The share-aware path (``dt_tpu/data/io.py:575-646``): when the
    kvstore's elastic controller carries policy shares (from the
    membership barrier's reply), the per-worker batch comes from
    ``policy.rescale.batch_map`` (summing exactly to
    ``global_batch_size`` fleet-wide), and a factory with an explicit
    ``weights`` parameter gets the rank-ordered batches as weights for a
    weighted shard (``NDArrayIter(part_weights=...)``).  A three-argument
    factory keeps the weighted batch over an equal shard.
    ``fixed_per_worker_batch`` ignores the shares.
    """

    def __init__(self, factory: Callable[..., tuple],
                 global_batch_size: int,
                 fixed_per_worker_batch: bool = False):
        self.factory = factory
        self.global_batch_size = global_batch_size
        self.fixed_per_worker_batch = fixed_per_worker_batch
        self._takes_weights: Optional[bool] = None

    def _factory_takes_weights(self) -> bool:
        """Whether the factory opts into weighted sharding (accepts a
        4th positional/keyword ``weights`` parameter)."""
        if self._takes_weights is None:
            import inspect
            try:
                params = inspect.signature(self.factory).parameters
                # only an EXPLICIT `weights` parameter opts in — a
                # legacy `*args` factory must keep its 3-arg contract
                self._takes_weights = "weights" in params
            except (TypeError, ValueError):
                self._takes_weights = False
        return self._takes_weights

    def per_worker_batch(self, num_workers: int) -> int:
        if self.fixed_per_worker_batch:
            return self.global_batch_size
        # Floor division like the reference (train_resnet.py:315-317
        # ``batch_size // kv.num_workers``): an indivisible global batch
        # shrinks slightly rather than erroring.
        per = self.global_batch_size // num_workers
        if per == 0:
            raise ValueError(
                f"global batch {self.global_batch_size} < {num_workers} "
                f"workers")
        return per

    def get_data_iterator(self, kv) -> tuple:
        """``kv`` exposes ``num_workers`` and ``rank`` (KVStore facade):
        ``factory(num_workers, rank, batch[, weights])`` with the batch
        from the controller's policy shares, else ``global_batch //
        num_workers`` (the global batch under
        ``fixed_per_worker_batch``)."""
        ctrl = getattr(kv, "_controller", None)
        shares = getattr(ctrl, "policy_shares", None)
        workers = list(getattr(ctrl, "workers", None) or [])
        if shares and workers and not self.fixed_per_worker_batch:
            from dt_tpu_torch.policy import rescale
            bmap = rescale.batch_map(shares, workers,
                                     self.global_batch_size)
            bs = bmap.get(getattr(ctrl, "host", None))
            if bs is not None:
                weights = [float(bmap[h]) for h in workers]
                if self._factory_takes_weights():
                    return self.factory(kv.num_workers, kv.rank, bs,
                                        weights)
                return self.factory(kv.num_workers, kv.rank, bs)
        bs = self.per_worker_batch(kv.num_workers)
        return self.factory(kv.num_workers, kv.rank, bs)
