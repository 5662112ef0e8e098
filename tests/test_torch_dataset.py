"""The port's ``Dataset``/``DataLoader``, ``MNISTIter`` and
``BucketSentenceIter`` against the JAX package's, on the CPU.

The same arrays, idx files and sentences go through ``dt_tpu.data`` and
``dt_tpu_torch.data``; every batch must be equal bit for bit, epoch after
epoch, with the forked worker pool (2 workers) and in process.
"""

import gzip
import struct

import numpy as np
import pytest

from dt_tpu import data as jdata
from dt_tpu_torch import data as tdata
from dt_tpu_torch.data import dataset as tdataset
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _epochs(it, epochs):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        while True:
            try:
                b = it.next()
            except StopIteration:
                break
            label = b.label if isinstance(b.label, tuple) else (b.label,)
            out.append((np.asarray(b.data),
                        [None if x is None else np.asarray(x)
                         for x in label], b.pad, b.bucket_key))
    return out


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (da, la, pa, ka), (db, lb, pb, kb) in zip(a, b):
        assert (pa, ka) == (pb, kb)
        assert da.dtype == db.dtype
        np.testing.assert_array_equal(da, db)
        assert len(la) == len(lb)
        for u, v in zip(la, lb):
            if u is None:
                assert v is None
            else:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def _scale(x):
    return (x * 2.0 - 1.0).astype(np.float32)


def _dataset(mod, columns, transform):
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 1, (29, 4, 3)).astype(np.float32)
    y = rng.randint(0, 7, 29).astype(np.int32)
    z = rng.uniform(0, 1, 29).astype(np.float32)
    ds = mod.ArrayDataset(*(x, y, z)[:columns])
    if transform == "first":
        ds = ds.transform_first(_scale)
    elif transform == "eager":
        ds = ds.transform(lambda *items: tuple(_scale(i) for i in items)
                          if columns > 1 else _scale(items[0]), lazy=False)
    return ds


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last_batch", ["keep", "discard"])
@pytest.mark.parametrize("columns,transform", [(1, "eager"), (2, "first"),
                                               (3, None)])
def test_data_loader_matches(workers, shuffle, last_batch, columns,
                             transform):
    """Three epochs of batch 6 over 29 items: order, ragged or dropped last
    batch, transforms, 1/2/3 columns."""
    kw = dict(batch_size=6, shuffle=shuffle, last_batch=last_batch, seed=4,
              num_workers=workers)
    with jdata.DataLoader(_dataset(jdata, columns, transform), **kw) as j, \
            tdata.DataLoader(_dataset(tdata, columns, transform),
                             **kw) as t:
        assert t.steps_per_epoch == j.steps_per_epoch
        _same(_epochs(t, 3), _epochs(j, 3))


def test_data_loader_workers_exit_on_close():
    loader = tdata.DataLoader(_dataset(tdata, 2, None), batch_size=5,
                              num_workers=2)
    procs = list(loader._it._pool._pool)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    loader.next()
    loader.close()
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()


def test_samplers_match():
    for n, seed in ((0, 0), (1, 3), (17, 5)):
        js, ts = jdata.RandomSampler(n, seed), tdata.RandomSampler(n, seed)
        for _ in range(3):
            assert list(ts) == list(js)
        assert list(tdata.SequentialSampler(n)) == \
            list(jdata.SequentialSampler(n))
    b = tdataset.default_batchify([np.ones(2), np.zeros(2)])
    assert b.label is None and b.data.shape == (2, 2)


def _idx_files(tmp_path, gz, n=37):
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    ib = struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes()
    lb = struct.pack(">II", 2049, n) + lab.tobytes()
    ip, lp = tmp_path / "img-idx3-ubyte", tmp_path / "lab-idx1-ubyte"
    if gz:
        (tmp_path / (ip.name + ".gz")).write_bytes(gzip.compress(ib))
        (tmp_path / (lp.name + ".gz")).write_bytes(gzip.compress(lb))
    else:
        ip.write_bytes(ib)
        lp.write_bytes(lb)
    return str(ip), str(lp)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat,shuffle,parts", [(False, False, (1, 0)),
                                                (True, True, (1, 0)),
                                                (False, True, (3, 2))])
def test_mnist_iter_matches(tmp_path, gz, flat, shuffle, parts):
    """Raw and gzip idx files (the ``.gz`` found beside a bare name too)."""
    ip, lp = _idx_files(tmp_path, gz)
    kw = dict(batch_size=8, flat=flat, shuffle=shuffle, num_parts=parts[0],
              part_index=parts[1], seed=2)
    _same(_epochs(tdata.MNISTIter(ip, lp, **kw), 2),
          _epochs(jdata.MNISTIter(ip, lp, **kw), 2))
    if gz:  # the explicit .gz path reads the same arrays
        np.testing.assert_array_equal(
            tdata.mnist.read_idx_images(ip + ".gz"),
            jdata.mnist.read_idx_images(ip + ".gz"))
        np.testing.assert_array_equal(
            tdata.mnist.read_idx_labels(lp + ".gz"),
            jdata.mnist.read_idx_labels(lp + ".gz"))


def test_mnist_bad_magic_raises(tmp_path):
    p = tmp_path / "bad"
    p.write_bytes(struct.pack(">IIII", 2049, 1, 1, 1) + b"\x00")
    with pytest.raises(IOError, match="idx3 magic"):
        tdata.mnist.read_idx_images(str(p))
    p.write_bytes(struct.pack(">II", 2051, 1) + b"\x00")
    with pytest.raises(IOError, match="idx1 magic"):
        tdata.mnist.read_idx_labels(str(p))


def _sentences(seed=6, n=83):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 50, rng.randint(1, 15)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("buckets", [None, [4, 8, 12]])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("layout", ["TN", "NT"])
def test_bucket_sentence_iter_matches(buckets, shuffle, layout):
    """Batches, ``bucket_key`` and ``invalid_label`` padding over three
    epochs (sentences longer than the last bucket are dropped)."""
    kw = dict(batch_size=5, buckets=buckets, invalid_label=-7,
              shuffle=shuffle, seed=3, layout=layout)
    t = tdata.BucketSentenceIter(_sentences(), **kw)
    j = jdata.BucketSentenceIter(_sentences(), **kw)
    assert t.buckets == j.buckets
    assert t.steps_per_epoch == j.steps_per_epoch
    got = _epochs(t, 3)
    _same(got, _epochs(j, 3))
    assert {k for *_, k in got} <= set(t.buckets)
    # exact-length buckets pad nothing; [4, 8, 12] pads most sentences
    assert any((d == -7).any() for d, *_ in got) == (buckets is not None)
