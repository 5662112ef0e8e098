"""The port's data iterators against the JAX package's, on the CPU.

The same numpy arrays go through ``dt_tpu.data.io`` and
``dt_tpu_torch.data.io``; every batch (data, labels, pad), the batch order
under shuffle, the leftovers of ``roll_over`` and the shard of each part
must agree bit for bit, epoch after epoch.
"""

import numpy as np
import pytest
import torch

from dt_tpu.data import io as jio
from dt_tpu_torch.data import io as tio
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _arrays(seed, n=53):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 4, 3, 2)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    return x, y


def _epochs(it, epochs):
    """Each epoch's batches as (data, label, pad) tuples of numpy."""
    out = []
    for _ in range(epochs):
        it.reset()
        batches = []
        while True:
            try:
                b = it.next()
            except StopIteration:
                break
            data = b.data if isinstance(b.data, tuple) else (b.data,)
            label = b.label if isinstance(b.label, tuple) else (b.label,)
            batches.append(([np.asarray(d) for d in data],
                            [np.asarray(lb) for lb in label], b.pad))
        out.append(batches)
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for u, v in zip(da + la, db + lb):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_bit_for_bit(seed, handle, shuffle):
    """Batch order, pads and leftovers over four epochs, batch 8 over 53
    rows (a ragged last batch every epoch)."""
    x, y = _arrays(seed)
    kw = dict(batch_size=8, shuffle=shuffle, last_batch_handle=handle,
              seed=seed)
    a = _epochs(jio.NDArrayIter(x, y, **kw), 4)
    b = _epochs(tio.NDArrayIter(x, y, **kw), 4)
    _assert_same(a, b)
    it = tio.NDArrayIter(x, y, **kw)
    assert it.steps_per_epoch == jio.NDArrayIter(x, y, **kw).steps_per_epoch


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("parts", [
    dict(num_parts=3, part_index=1),
    dict(num_parts=3, part_index=2, part_weights=[1.0, 2.0, 3.5]),
    dict(num_parts=2, part_index=0, part_weights=[0.2, 0.8])])
def test_ndarray_iter_parts_match(seed, parts):
    """Strided and weighted shards, shuffled, padded and rolled over."""
    x, y = _arrays(seed, 61)
    for handle in ("pad", "roll_over"):
        kw = dict(batch_size=5, shuffle=True, last_batch_handle=handle,
                  seed=seed, **parts)
        _assert_same(_epochs(jio.NDArrayIter(x, y, **kw), 3),
                     _epochs(tio.NDArrayIter(x, y, **kw), 3))


def test_ndarray_iter_multi_stream_and_descs():
    """Dict and list streams batch as tuples in stream order; the
    ``provide_data``/``provide_label`` descriptors agree."""
    x, y = _arrays(4, 20)
    z = np.arange(20, dtype=np.int64)
    for data, label in (({"a": x, "b": x * 2}, {"y": y, "z": z}),
                        ([x, x + 1], [y])):
        kw = dict(batch_size=6, shuffle=True, seed=1)
        ja, ta = jio.NDArrayIter(data, label, **kw), \
            tio.NDArrayIter(data, label, **kw)
        _assert_same(_epochs(ja, 2), _epochs(ta, 2))
        assert [repr(d) for d in ja.provide_data] == \
            [repr(d) for d in ta.provide_data]
        assert [repr(d) for d in ja.provide_label] == \
            [repr(d) for d in ta.provide_label]
    with pytest.raises(ValueError):
        tio.NDArrayIter(x, y[:5])
    with pytest.raises(ValueError):
        tio.NDArrayIter(x, y, last_batch_handle="wrap")


@pytest.mark.parametrize("size", [2, 7, 11])
def test_resize_iter_matches(size):
    """ResizeIter clamps to ``size`` batches an epoch, refilling from a new
    pass of the (shuffled, padded) inner iterator."""
    x, y = _arrays(5, 29)
    kw = dict(batch_size=8, shuffle=True, seed=2)
    a = _epochs(jio.ResizeIter(jio.NDArrayIter(x, y, **kw), size), 3)
    b = _epochs(tio.ResizeIter(tio.NDArrayIter(x, y, **kw), size), 3)
    _assert_same(a, b)
    assert all(len(e) == size for e in b)


def test_prefetching_and_synthetic_iters_match():
    x, y = _arrays(6, 30)
    kw = dict(batch_size=7, shuffle=True, seed=4)
    _assert_same(_epochs(jio.PrefetchingIter(jio.NDArrayIter(x, y, **kw)), 2),
                 _epochs(tio.PrefetchingIter(tio.NDArrayIter(x, y, **kw)), 2))
    skw = dict(image_shape=(4, 4, 3), num_classes=5, batch_size=3,
               num_batches=4, seed=9)
    _assert_same(_epochs(jio.SyntheticImageIter(**skw), 2),
                 _epochs(tio.SyntheticImageIter(**skw), 2))


def test_csv_and_libsvm_iters_match(tmp_path):
    rng = np.random.RandomState(7)
    data = rng.uniform(-1, 1, (10, 6)).astype(np.float32)
    label = rng.randint(0, 3, 10).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4)
    _assert_same(_epochs(jio.CSVIter(**kw), 2), _epochs(tio.CSVIter(**kw), 2))
    with open(tmp_path / "s.libsvm", "w") as f:
        f.write("1 1:0.5 3:2\n0 2:1\n2 4:-1 1:3\n")
    kw = dict(data_libsvm=str(tmp_path / "s.libsvm"), data_shape=(4,),
              batch_size=2)
    _assert_same(_epochs(jio.LibSVMIter(**kw), 2),
                 _epochs(tio.LibSVMIter(**kw), 2))


class _StubKV:
    """A kvstore as ``get_data_iterator`` sees it: identity, no
    controller."""

    def __init__(self, num_workers, rank, controller=None):
        self.num_workers = num_workers
        self.rank = rank
        self._controller = controller


@pytest.mark.parametrize("workers,rank", [(1, 0), (3, 1), (4, 3)])
@pytest.mark.parametrize("fixed", [False, True])
def test_elastic_data_iterator_matches(workers, rank, fixed):
    """The factory gets ``(num_parts, part_index, batch)`` from the stub
    kvstore as the JAX package computes them, and the iterators it builds
    give the same batches."""
    x, y = _arrays(8, 97)
    calls = {}

    def factory(io):
        def make(num_parts, part_index, batch_size):
            calls.setdefault(io.__name__, []).append(
                (num_parts, part_index, batch_size))
            it = io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                                num_parts=num_parts, part_index=part_index)
            return io.ResizeIter(it, 3), None
        return make

    kv = _StubKV(workers, rank)
    a, _ = jio.ElasticDataIterator(factory(jio), 24, fixed) \
        .get_data_iterator(kv)
    b, _ = tio.ElasticDataIterator(factory(tio), 24, fixed) \
        .get_data_iterator(kv)
    assert calls[jio.__name__] == calls[tio.__name__]
    _assert_same(_epochs(a, 2), _epochs(b, 2))
    assert tio.ElasticDataIterator(factory(tio), 24, fixed) \
        .per_worker_batch(workers) == jio.ElasticDataIterator(
            factory(jio), 24, fixed).per_worker_batch(workers)


def test_elastic_data_iterator_refuses_policy_shares():
    """Policy shares on the controller no longer raise (the policy engine
    is ported): the factory gets the JAX package's share-weighted batch,
    and an equal batch too few for the workers still raises."""

    class Ctrl:
        policy_shares = {"w0": 6000, "w1": 4000}
        workers = ["w0", "w1"]
        host = "w0"

    got = {}
    for mod in (jio, tio):
        it = mod.ElasticDataIterator(
            lambda p, i, b, mod=mod: (got.setdefault(mod.__name__,
                                                     (p, i, b)), None), 16)
        it.get_data_iterator(_StubKV(2, 0, Ctrl()))
    assert got[tio.__name__] == got[jio.__name__] == (2, 0, 10)
    with pytest.raises(ValueError, match="workers"):
        it.per_worker_batch(32)


def test_device_prefetch_iter_passes_through_on_cpu():
    """On the CPU the prefetcher hands the inner batches over unchanged
    (numpy, NHWC); ``Module`` places them."""
    x, y = _arrays(9, 21)
    kw = dict(batch_size=8, shuffle=True, seed=5)
    got = _epochs(tio.DevicePrefetchIter(tio.NDArrayIter(x, y, **kw),
                                         device="cpu"), 2)
    _assert_same(got, _epochs(jio.NDArrayIter(x, y, **kw), 2))
    it = tio.DevicePrefetchIter(tio.NDArrayIter(x, y, **kw), device="cpu")
    assert isinstance(it.next().data, np.ndarray)
    assert it.steps_per_epoch == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tio.DevicePrefetchIter(tio.NDArrayIter(x, y, **kw))
