"""The port's RecordIO files and image-record iterators against the JAX
package's, on the CPU.

The same payloads go through ``dt_tpu.data.recordio`` and
``dt_tpu_torch.data.recordio``: the files' bytes (``.rec`` and ``.idx``)
must be equal, each package must read the other's, and ``ImageRecordIter``
batches must equal the JAX package's bit for bit across shards, epochs,
shuffles and decode-thread counts for raw u8, raw f32 and PNG records.  The
JAX package decodes JPEGs with its native libjpeg where that is built and
the port with PIL: held here to :data:`TOL_JPEG` (0 levels of 255 measured
on 4:4:4, 4:2:2, 4:2:0, progressive and grayscale JPEGs).  A bf16 batch is
made in a child process that imports neither JAX nor ``ml_dtypes``.
"""

import io
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dt_tpu import data as jdata
from dt_tpu.data import augment as jaug
from dt_tpu_torch import data as tdata
from dt_tpu_torch.data import augment as taug
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
MAGIC = struct.pack("<I", 0xCED7230A)
#: u8 levels between the JAX package's libjpeg decode and the port's PIL one
TOL_JPEG = 0


def _payloads(case):
    rng = np.random.RandomState(7)
    if case == "plain":
        return [b"hello", b"a" * 7, b"", b"\x00" * 12]
    if case == "empty":
        return [b"", b"", b"x", b""]
    if case == "magic":
        return [MAGIC, b"abcd" + MAGIC + b"efgh", b"ab" + MAGIC + b"cd",
                MAGIC * 3, b"x" * 8 + MAGIC, b"plain old data!"]
    out = []  # "fuzz": assorted lengths, magic words sprinkled at random
    for _ in range(25):
        n = int(rng.choice([0, 1, 3, 4, 7, 8, 64, rng.randint(0, 3000)]))
        buf = bytearray(rng.randint(0, 256, n, dtype=np.uint8).tobytes())
        for _ in range(rng.randint(0, 3)):
            if len(buf) >= 4:
                at = rng.randint(0, len(buf) - 3)
                buf[at:at + 4] = MAGIC
        out.append(bytes(buf))
    return out


def _write(mod, path, payloads, index=True, keys=None):
    with mod.RecordIOWriter(str(path) + ".rec",
                            str(path) + ".idx" if index else None) as w:
        for i, p in enumerate(payloads):
            w.write(p, None if keys is None else keys[i])


@pytest.mark.parametrize("case", ["plain", "empty", "magic", "fuzz"])
@pytest.mark.parametrize("index", [False, True])
def test_writer_bytes_equal_and_files_cross(tmp_path, case, index):
    payloads = _payloads(case)
    keys = [10 * i + 3 for i in range(len(payloads))] if index else None
    _write(jdata, tmp_path / "j", payloads, index, keys)
    _write(tdata, tmp_path / "t", payloads, index, keys)
    for ext in (".rec",) + ((".idx",) if index else ()):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    # each package reads the other's file (the JAX package's read_all takes
    # its native scanner where built, which hands escaped files to Python)
    with tdata.RecordIOReader(j + ".rec") as r:
        assert r.read_all() == payloads
    with jdata.RecordIOReader(t + ".rec") as r:
        assert r.read_all() == payloads
    if index:
        jr = jdata.RecordIOReader(t + ".rec", t + ".idx")
        tr = tdata.RecordIOReader(j + ".rec", j + ".idx")
        assert tr.index == jr.index
        for k, p in zip(keys[::-1], payloads[::-1]):
            tr.seek_record(k)
            jr.seek_record(k)
            assert tr.read_record() == jr.read_record() == p
        jr.close()
        tr.close()


def test_reader_raises_on_bad_frames(tmp_path):
    p = tmp_path / "bad.rec"
    p.write_bytes(struct.pack("<II", 0x12345678, 4) + b"abcd")
    with tdata.RecordIOReader(str(p)) as r, pytest.raises(IOError,
                                                           match="magic"):
        r.read_all()
    p.write_bytes(struct.pack("<II", 0xCED7230A, (2 << 29) | 4) + b"abcd")
    with tdata.RecordIOReader(str(p)) as r, pytest.raises(IOError,
                                                           match="orphan"):
        r.read_all()
    p.write_bytes(struct.pack("<II", 0xCED7230A, (1 << 29) | 4) + b"abcd")
    with tdata.RecordIOReader(str(p)) as r, pytest.raises(IOError,
                                                           match="truncated"):
        r.read_all()


@pytest.mark.parametrize("label", [3.0, [1.5, -2.0, 7.25], np.arange(10.0)])
def test_pack_unpack_label(label):
    rec = tdata.pack_label(b"payload", label, rec_id=42)
    assert rec == jdata.pack_label(b"payload", label, rec_id=42)
    a, b = tdata.unpack_label(rec), jdata.unpack_label(rec)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == b[0].dtype == np.float32
    assert a[1:] == b[1:] == (42, b"payload")


def _image_payload(kind, img):
    if kind == "u8":
        return img.tobytes()
    if kind == "f32":
        return (img.astype(np.float32) / 7.0).tobytes()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _image_rec(tmp_path, kind, n=23, shape=(10, 12, 3), seed=0,
               vector_labels=False):
    rng = np.random.RandomState(seed)
    path = str(tmp_path / f"{kind}.rec")
    with tdata.RecordIOWriter(path) as w:
        for i in range(n):
            img = rng.randint(0, 256, shape).astype(np.uint8)
            label = rng.uniform(0, 5, 3) if vector_labels else i % 10
            w.write(tdata.pack_label(_image_payload(kind, img), label,
                                     rec_id=i))
    return path


def _batches(it, epochs):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        while True:
            try:
                b = it.next()
            except StopIteration:
                break
            d = b.data
            if isinstance(d, torch.Tensor):
                d = d.float().numpy()
            out.append((np.asarray(d), np.asarray(b.label), b.pad))
    return out


def _assert_batches(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        assert da.shape == db.shape and da.dtype == db.dtype
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


def _aug(mod, name):
    if name is None:
        return None
    if name == "cifar":
        return mod.cifar_train_augmenter(seed=3)
    return mod.Compose(mod.RandomCrop((8, 8), pad=2, seed=1),
                       mod.RandomMirror(seed=2),
                       mod.ColorJitter(0.2, 0.2, 0.2, seed=4),
                       mod.Normalize([120.0, 110.0, 100.0], [60.0, 55, 50]))


@pytest.mark.parametrize("kind", ["u8", "f32", "png"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("parts", [1, 2, 3])
def test_image_record_iter_bit_for_bit(tmp_path, kind, shuffle, parts):
    """Two epochs of every shard, pooled (4 threads) and serial, with and
    without an augmenter (its draws come from the per-record streams)."""
    path = _image_rec(tmp_path, kind)
    for part in range(parts):
        for aug in (None, "chain"):
            for threads in (1, 4):
                kw = dict(batch_size=5, shuffle=shuffle, num_parts=parts,
                          part_index=part, seed=11,
                          num_decode_threads=threads)
                want = _batches(jdata.ImageRecordIter(
                    path, (10, 12, 3), augmenter=_aug(jaug, aug), **kw), 2)
                it = tdata.ImageRecordIter(path, (10, 12, 3),
                                           augmenter=_aug(taug, aug), **kw)
                assert it.steps_per_epoch == -(-len(range(
                    part, 23, parts)) // 5)
                _assert_batches(_batches(it, 2), want)
                it.close()


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_image_record_iter_dtypes_and_tiny_shard(tmp_path, dtype):
    """The batch dtype (a bf16 batch is a CPU ``torch.bfloat16`` tensor with
    the JAX package's ``ml_dtypes`` values), vector labels, the CIFAR
    recipe, and a shard smaller than the wrap-pad (tiled to a full
    batch)."""
    path = _image_rec(tmp_path, "f32" if dtype == "bfloat16" else "u8",
                      n=7, shape=(32, 32, 3), vector_labels=True)
    for aug in (None, "cifar"):
        kw = dict(batch_size=8, shuffle=True, num_parts=2, part_index=1,
                  seed=5, dtype=dtype, num_decode_threads=3)
        jit = jdata.ImageRecordIter(path, (32, 32, 3),
                                    augmenter=_aug(jaug, aug), **kw)
        tit = tdata.ImageRecordIter(path, (32, 32, 3),
                                    augmenter=_aug(taug, aug), **kw)
        jb, tb = jit.next(), tit.next()
        if dtype == "bfloat16":
            assert tb.data.dtype == torch.bfloat16
            np.testing.assert_array_equal(tb.data.float().numpy(),
                                          np.asarray(jb.data, np.float32))
        else:
            assert tb.data.dtype == jb.data.dtype
            np.testing.assert_array_equal(tb.data, jb.data)
        np.testing.assert_array_equal(tb.label, jb.label)
        assert tb.pad == jb.pad == 5
        tit.close()


def test_jpeg_records_within_bound(tmp_path):
    """JPEG payloads of several kinds: the port decodes with PIL, the JAX
    package with its native libjpeg where built (PIL otherwise)."""
    rng = np.random.RandomState(1)
    path = str(tmp_path / "jpeg.rec")
    kinds = [dict(subsampling=0), dict(subsampling=1), dict(subsampling=2),
             dict(subsampling=2, progressive=True), "gray"]
    with tdata.RecordIOWriter(path) as w:
        for i, kw in enumerate(kinds * 2):
            img = np.clip(np.cumsum(rng.randint(-20, 21, (24, 20, 3)),
                                    axis=1) + 128, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            if kw == "gray":
                Image.fromarray(img[..., 0]).save(buf, "JPEG", quality=90)
            else:
                Image.fromarray(img).save(buf, "JPEG", quality=90, **kw)
            w.write(tdata.pack_label(buf.getvalue(), i))
    kw = dict(batch_size=10, dtype="uint8", num_decode_threads=2)
    jb = jdata.ImageRecordIter(path, (24, 20, 3), **kw).next()
    tb = tdata.ImageRecordIter(path, (24, 20, 3), **kw).next()
    worst = int(np.abs(tb.data.astype(int) - jb.data.astype(int)).max())
    print(f"largest JPEG difference: {worst} levels of 255")
    assert worst <= TOL_JPEG
    np.testing.assert_array_equal(tb.label, jb.label)


def test_encoded_record_without_pil_names_pil(tmp_path, monkeypatch):
    path = _image_rec(tmp_path, "png", n=2, shape=(4, 4, 3))
    monkeypatch.setitem(sys.modules, "PIL", None)
    it = tdata.ImageRecordIter(path, (4, 4, 3), batch_size=2,
                               num_decode_threads=1)
    with pytest.raises(ImportError, match="PNG record needs PIL"):
        it.next()
    with pytest.raises(ImportError, match="PIL"):
        taug.Resize((2, 2))(np.zeros((4, 4, 3), np.uint8))
    # the native convention needs no PIL, and never switches to it
    out = taug.Resize((2, 2), backend="native")(np.zeros((4, 4, 3),
                                                         np.uint8))
    assert out.shape == (2, 2, 3)


def _det_rec(tmp_path):
    rng = np.random.RandomState(4)
    path = str(tmp_path / "det.rec")
    with tdata.RecordIOWriter(path) as w:
        for i in range(9):
            k = 1 + i % 3
            x0 = rng.uniform(0, 0.5, (k, 2))
            boxes = np.concatenate([rng.randint(0, 5, (k, 1)), x0,
                                    x0 + rng.uniform(0.1, 0.5, (k, 2))], 1)
            img = rng.randint(0, 256, (16, 20, 3)).astype(np.uint8)
            kind = "png" if i % 2 else "u8"
            payload = _image_payload(kind, img)
            if kind == "u8":  # a raw record must have data_shape's size
                payload = img[:12, :12].tobytes()
            w.write(tdata.pack_label(payload, boxes.astype(np.float32)
                                     .ravel(), rec_id=i))
    return path


@pytest.mark.parametrize("augmented", [False, True])
def test_image_det_record_iter_labels_match(tmp_path, augmented):
    path = _det_rec(tmp_path)
    for threads in (1, 3):
        kw = dict(batch_size=4, max_objs=5, shuffle=True, seed=2,
                  num_decode_threads=threads)
        want = _batches(jdata.ImageDetRecordIter(
            path, (12, 12, 3), det_augmenter=(
                jaug.ssd_train_augmenter(seed=1) if augmented else None),
            **kw), 2)
        got = _batches(tdata.ImageDetRecordIter(
            path, (12, 12, 3), det_augmenter=(
                taug.ssd_train_augmenter(seed=1) if augmented else None),
            **kw), 2)
        _assert_batches(got, want)
        assert got[0][1].shape == (4, 5, 5)
    with pytest.raises(ValueError, match="max_objs"):
        tdata.ImageDetRecordIter(path, (12, 12, 3), batch_size=4,
                                 max_objs=2, num_decode_threads=1).next()
    with pytest.raises(ValueError, match="det_augmenter"):
        tdata.ImageDetRecordIter(path, (12, 12, 3), batch_size=4,
                                 augmenter=taug.RandomMirror())


class _KV:
    def __init__(self, n, rank):
        self.num_workers, self.rank = n, rank


def test_elastic_reshards_record_iter_like_the_jax_package(tmp_path):
    """``ElasticDataIterator`` over an ``ImageRecordIter`` factory through
    memberships of 2, 3 and 2 workers: every rank's batches equal."""
    path = _image_rec(tmp_path, "u8", n=31)

    def factory(mod, aug):
        def make(num_parts, part_index, batch):
            it = mod.ImageRecordIter(
                path, (10, 12, 3), batch, shuffle=True, seed=9,
                num_parts=num_parts, part_index=part_index,
                augmenter=_aug(aug, "chain"), num_decode_threads=2)
            return mod.ResizeIter(it, 3), None
        return make

    jel = jdata.ElasticDataIterator(factory(jdata, jaug), 12)
    tel = tdata.ElasticDataIterator(factory(tdata, taug), 12)
    for n in (2, 3, 2):
        for rank in range(n):
            jit, _ = jel.get_data_iterator(_KV(n, rank))
            tit, _ = tel.get_data_iterator(_KV(n, rank))
            assert tit.batch_size == jit.batch_size == 12 // n
            _assert_batches(_batches(tit, 2), _batches(jit, 2))


_CHILD = r"""
import json, sys
import numpy as np
for name in ("jax", "jaxlib", "ml_dtypes", "dt_tpu"):
    sys.modules[name] = None  # an import of any of them now raises
from dt_tpu_torch.data import io, recordio
out = {}
b = io.SyntheticImageIter((8, 8, 3), 10, 4, dtype="bfloat16").next()
out["synthetic"] = [str(b.data.dtype), b.data.float().numpy().tolist()]
it = recordio.ImageRecordIter(sys.argv[1], (10, 12, 3), 5, dtype="bfloat16",
                              num_decode_threads=2)
b = it.next()
out["record"] = [str(b.data.dtype), b.data.float().numpy().tolist()]
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "ml_dtypes", "dt_tpu")
                       and sys.modules[m] is not None)
print(json.dumps(out))
"""


def test_bf16_batches_need_no_ml_dtypes(tmp_path):
    """A bf16 batch in a process that never imports JAX or ``ml_dtypes``
    holds the JAX package's values (round to nearest even; halfway cases
    are in the f32 records)."""
    path = _image_rec(tmp_path, "f32", n=5)
    # halfway cases between two bf16 values in the first record's pixels
    recs = tdata.RecordIOReader(path).read_all()
    lab, _, payload = tdata.unpack_label(recs[0])
    vals = np.frombuffer(payload, np.float32).copy()
    vals[:4] = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8),
                         3 * 2**-9], np.float32)
    recs[0] = tdata.pack_label(vals.tobytes(), lab)
    with tdata.RecordIOWriter(path) as w:
        for r in recs:
            w.write(r)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _CHILD, path], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    want = jdata.SyntheticImageIter((8, 8, 3), 10, 4,
                                    dtype="bfloat16").next().data
    assert got["synthetic"][0] == "torch.bfloat16"
    np.testing.assert_array_equal(np.asarray(got["synthetic"][1],
                                             np.float32),
                                  np.asarray(want, np.float32))
    want = jdata.ImageRecordIter(path, (10, 12, 3), 5, dtype="bfloat16",
                                 num_decode_threads=2).next().data
    rec = np.asarray(got["record"][1], np.float32)
    np.testing.assert_array_equal(rec, np.asarray(want, np.float32))
    np.testing.assert_array_equal(rec.reshape(-1)[:4],
                                  [1.0, 1 + 2**-6, -1.0, 3 * 2**-9])
