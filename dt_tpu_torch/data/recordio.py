"""RecordIO: dmlc-format record files and packed image records (counterpart
of ``dt_tpu/data/recordio.py``).

The file format is the reference's, byte for byte, so a ``.rec``/``.idx``
written by either package (or by the reference's ``tools/im2rec.py``) reads
in the other:

- record frame: ``uint32 magic=0xced7230a; uint32 lrec; payload; pad to 4B``
  where ``lrec`` = cflag(3 bits) << 29 | length(29 bits);
- image record payload: ``IRHeader{uint32 flag; float label; uint64 id;
  uint64 id2}`` + (flag extra float labels) + image bytes.

Host code in numpy, as in the JAX package; the reader is Python only (the
JAX package scans with a native index when its toolchain built one, and
reads the same records).  Encoded images (JPEG, PNG) decode through PIL,
imported where a record needs it: a host without PIL reads raw u8 and raw
f32 records and raises ``ImportError`` naming PIL for an encoded one.
"""

from __future__ import annotations

import io as _io
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.data.io import DataBatch, host_batch, host_values

_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_IRHEADER = struct.Struct("<IfQQ")  # flag, label, id, id2


class RecordIOWriter:
    """Sequential record writer (+ optional ``.idx`` index like
    MXIndexedRecordIO)."""

    def __init__(self, path: str, index_path: Optional[str] = None):
        self._f = open(path, "wb")
        self._idx = open(index_path, "w") if index_path else None
        self._key = 0

    def write(self, data: bytes, key: Optional[int] = None):
        if self._idx is not None:
            self._idx.write(f"{key if key is not None else self._key}\t"
                            f"{self._f.tell()}\n")
            self._key += 1
        assert len(data) < (1 << 29), "record too large"
        # dmlc WriteRecord escape: a payload holding the magic word at a
        # 4-byte-aligned offset is split there; the magic is dropped from
        # the data and the frame seam stands in for it (cflag 1 = first,
        # 2 = middle, 3 = last part; the reader puts the magic back)
        parts = []
        start = 0
        if _MAGIC_BYTES in data:
            words = np.frombuffer(data, np.uint8,
                                  len(data) // 4 * 4).view("<u4")
            for i in (np.nonzero(words == _MAGIC)[0] * 4).tolist():
                parts.append(data[start:i])
                start = i + 4
        parts.append(data[start:])
        for j, part in enumerate(parts):
            if len(parts) == 1:
                cflag = 0
            elif j == 0:
                cflag = 1
            elif j == len(parts) - 1:
                cflag = 3
            else:
                cflag = 2
            self._f.write(struct.pack("<II", _MAGIC,
                                      (cflag << 29) | len(part)))
            self._f.write(part)
            pad = (4 - len(part) % 4) % 4
            if pad:
                self._f.write(b"\x00" * pad)

    def close(self):
        self._f.close()
        if self._idx is not None:
            self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader:
    """Sequential and indexed record reader."""

    def __init__(self, path: str, index_path: Optional[str] = None):
        self._path = path
        self._f = open(path, "rb")
        self.index: Optional[dict] = None
        if index_path and os.path.exists(index_path):
            self.index = {}
            with open(index_path) as f:
                for line in f:
                    k, off = line.split("\t")
                    self.index[int(k)] = int(off)

    def seek_record(self, key: int):
        assert self.index is not None, "no index loaded"
        self._f.seek(self.index[key])

    def _read_frame(self) -> Optional[Tuple[int, bytes]]:
        hdr = self._f.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise IOError(f"bad RecordIO magic {magic:#x}")
        length = lrec & ((1 << 29) - 1)
        data = self._f.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._f.read(pad)
        return lrec >> 29, data

    def read_record(self) -> Optional[bytes]:
        frame = self._read_frame()
        if frame is None:
            return None
        cflag, data = frame
        if cflag == 0:
            return data
        # a multi-part record (the writer escaped an embedded magic word):
        # cflag 1 starts it, parts follow up to the cflag-3 tail, joined
        # with the magic put back at each seam (dmlc ReadRecord)
        if cflag != 1:
            raise IOError(f"orphan continuation frame (cflag={cflag})")
        parts = [data]
        while True:
            frame = self._read_frame()
            if frame is None:
                raise IOError("truncated multi-part record")
            cflag, data = frame
            if cflag not in (2, 3):
                raise IOError(f"bad continuation cflag={cflag}")
            parts.append(data)
            if cflag == 3:
                return _MAGIC_BYTES.join(parts)

    def read_all(self) -> List[bytes]:
        """Every record from the start of the file, in order."""
        self._f.seek(0)
        out = []
        while True:
            r = self.read_record()
            if r is None:
                return out
            out.append(r)

    def reset(self):
        self._f.seek(0)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def pack_label(payload: bytes, label, rec_id: int = 0) -> bytes:
    """Pack an IRHeader + payload (reference ``mx.recordio.pack``)."""
    label_arr = np.asarray(label, np.float32).ravel()
    if label_arr.size == 1:
        hdr = _IRHEADER.pack(0, float(label_arr[0]), rec_id, 0)
        return hdr + payload
    hdr = _IRHEADER.pack(label_arr.size, 0.0, rec_id, 0)
    return hdr + label_arr.tobytes() + payload


def unpack_label(record: bytes) -> Tuple[np.ndarray, int, bytes]:
    """Unpack -> (label array, id, payload) (reference
    ``mx.recordio.unpack``)."""
    flag, label, rec_id, _ = _IRHEADER.unpack_from(record)
    off = _IRHEADER.size
    if flag > 0:
        labels = np.frombuffer(record, np.float32, flag, off)
        off += 4 * flag
    else:
        labels = np.array([label], np.float32)
    return labels, rec_id, record[off:]


def _payload_kind(payload: bytes) -> str:
    if payload[:2] == b"\xff\xd8":
        return "JPEG"
    if payload[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    return "encoded image"


def _decode_image(payload: bytes) -> np.ndarray:
    """An encoded image record's payload -> (H, W, 3) uint8 RGB, through
    PIL (the JAX package decodes JPEGs with its native libjpeg where that
    is built and with PIL otherwise)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding a {_payload_kind(payload)} record needs PIL "
            "(Pillow), which this host lacks; pack raw uint8 or float32 "
            "records to read without it") from e
    img = Image.open(_io.BytesIO(payload)).convert("RGB")
    return np.asarray(img, np.uint8)


class ImageRecordIter:
    """Image iterator over a ``.rec`` file: decode -> augment -> batch ->
    shard (``dt_tpu/data/recordio.py:213-389``; the reference's
    ``src/io/iter_image_recordio_2.cc`` with ``num_parts``/``part_index``
    sharding, ``src/io/image_iter_common.h:127-162``).

    The whole file is read into host memory at construction
    (:meth:`RecordIOReader.read_all`), as the JAX package does.  Decode and
    augmentation run across the batch on a thread pool
    (``num_decode_threads``, default ``DT_DECODE_THREADS`` or
    ``min(cpus, 16)``); each record draws from its own stream, seeded by
    ``(seed, epoch, position in the epoch)``, so the pooled batches equal
    the serial ones byte for byte.  The next ``pipeline_batches`` batches
    are submitted before the current one is returned.  Records whose
    payload length is ``prod(data_shape)`` (raw uint8) or 4x that (raw
    float32) are raw arrays and need no codec; others decode through PIL.

    ``dtype`` is the batch's: numpy arrays, but ``"bfloat16"`` batches are
    CPU ``torch.bfloat16`` tensors (``data.io.host_batch``) with the values
    the JAX package's ``ml_dtypes`` batches hold; a decoded image is then
    float32 holding bfloat16 values until the batch is stacked.
    """

    def __init__(self, path_imgrec: str, data_shape: Sequence[int],
                 batch_size: int, path_imgidx: Optional[str] = None,
                 shuffle: bool = False, num_parts: int = 1, part_index: int = 0,
                 augmenter=None, seed: int = 0, dtype: str = "float32",
                 num_decode_threads: Optional[int] = None,
                 pipeline_batches: int = 2):
        self.data_shape = tuple(data_shape)  # (H, W, C)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_parts = num_parts
        self.part_index = part_index
        self.augmenter = augmenter
        self.dtype = dtype
        self._seed = seed
        self._epoch = 0
        if num_decode_threads is None:
            num_decode_threads = int(config.env("DT_DECODE_THREADS")
                                     or min(os.cpu_count() or 1, 16))
        self._pool = None
        if num_decode_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=num_decode_threads,
                thread_name_prefix="dt_decode")
        self._pipeline_batches = max(pipeline_batches, 1)
        self._inflight: list = []  # [(pad, [futures | (i, pos) pairs])]
        reader = RecordIOReader(path_imgrec, path_imgidx)
        self._records = reader.read_all()
        reader.close()
        self._setup_epoch()

    def _setup_epoch(self):
        idx = np.arange(len(self._records))
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(idx)
        self._order = idx[self.part_index::self.num_parts]
        self._cursor = 0
        self._inflight = []

    def reset(self):
        self._epoch += 1
        self._setup_epoch()

    @property
    def steps_per_epoch(self) -> int:
        return -(-len(self._order) // self.batch_size)

    def _decode(self, payload: bytes) -> np.ndarray:
        n = int(np.prod(self.data_shape))
        if len(payload) == n:  # raw uint8 array record
            arr = np.frombuffer(payload, np.uint8)
        elif len(payload) == 4 * n:  # raw float32 array record
            arr = np.frombuffer(payload, np.float32)
        else:
            return host_values(_decode_image(payload), self.dtype)
        return host_values(arr.reshape(self.data_shape), self.dtype)

    def _record_rng(self, pos: int) -> np.random.RandomState:
        """The draw stream of the record at epoch position ``pos``,
        whatever thread decodes it."""
        ss = np.random.SeedSequence([self._seed, self._epoch, int(pos)])
        return np.random.RandomState(ss.generate_state(1)[0])

    def _decode_one(self, i: int, pos: int):
        lab, _, payload = unpack_label(self._records[i])
        img = self._decode(payload)
        if self.augmenter is not None:
            img = self.augmenter(img, rng=self._record_rng(pos))
        return img, (lab[0] if lab.size == 1 else lab)

    def _next_selection(self):
        """(sel, positions, pad) for the batch at the cursor, advancing
        it.  Positions count on through the wrap-pad, so every sample of
        the epoch has its own stream."""
        n = len(self._order)
        if self._cursor >= n:
            return None
        end = min(self._cursor + self.batch_size, n)
        sel = self._order[self._cursor:end]
        pad = self._cursor + self.batch_size - end
        if pad:  # wrap-pad like the reference's round_batch, tiled for a
            # shard smaller than the pad so the batch is always full
            reps = -(-pad // n)
            sel = np.concatenate([sel] + [self._order] * reps)[
                :self.batch_size]
        positions = range(self._cursor, self._cursor + len(sel))
        self._cursor += self.batch_size
        return sel, positions, pad

    def _submit(self, sel, positions):
        if self._pool is None:
            return list(zip(sel, positions))  # decoded when collected
        return [self._pool.submit(self._decode_one, i, p)
                for i, p in zip(sel, positions)]

    def next(self) -> DataBatch:
        while len(self._inflight) < self._pipeline_batches:
            nxt = self._next_selection()
            if nxt is None:
                break
            self._inflight.append((nxt[2], self._submit(nxt[0], nxt[1])))
        if not self._inflight:
            raise StopIteration
        pad, work = self._inflight.pop(0)
        if self._pool is None:
            results = [self._decode_one(i, p) for i, p in work]
        else:
            results = [f.result() for f in work]
        results = self._collect(results)
        imgs = [r[0] for r in results]
        labels = [r[1] for r in results]
        return DataBatch(host_batch(np.stack(imgs), self.dtype),
                         np.asarray(labels), pad)

    def _collect(self, results):
        """Hook between the pooled decode + augment and the stacking, for
        post-processing that needs the whole batch (none here; a subclass
        extension point)."""
        return results

    def close(self):
        """Stop the decode pool's threads (the iterator reads no more)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self):
        self.reset()
        while True:
            try:
                yield self.next()
            except StopIteration:
                return


class ImageDetRecordIter(ImageRecordIter):
    """Detection records: images with a variable number of box labels each
    (``dt_tpu/data/recordio.py:392-470``; the reference's
    ``src/io/iter_image_det_recordio.cc``).

    The label tensor has a fixed capacity ``(max_objs, obj_width)``;
    records are padded with ``pad_value`` rows (-1, the multibox ignore
    class) and an over-full record raises rather than dropping boxes.
    Labels may be packed flat (``k * obj_width`` floats) or as ``(k,
    obj_width)`` arrays, typically ``[class_id, xmin, ymin, xmax, ymax]``.
    An image whose size differs from ``data_shape`` after the detection
    augmenter is resized through ``augment.Resize`` (PIL).
    """

    def __init__(self, path_imgrec: str, data_shape: Sequence[int],
                 batch_size: int, max_objs: int = 16, obj_width: int = 5,
                 pad_value: float = -1.0, det_augmenter=None, **kwargs):
        if kwargs.get("augmenter") is not None:
            # a classification augmenter moves the image only: a flip or a
            # crop would leave the boxes behind
            raise ValueError(
                "ImageDetRecordIter does not take the classification "
                "augmenter (it would corrupt box labels); pass "
                "det_augmenter=DetCompose(...) instead")
        self.max_objs = int(max_objs)
        self.obj_width = int(obj_width)
        self.pad_value = float(pad_value)
        self.det_augmenter = det_augmenter
        super().__init__(path_imgrec, data_shape, batch_size, **kwargs)
        from dt_tpu_torch.data.augment import Resize
        self._resize = Resize((self.data_shape[0], self.data_shape[1]))

    def _decode_one(self, i: int, pos: int):
        """Decode, detection-augment and resize to ``data_shape``, in the
        pool (box coordinates are normalized: only the image resizes)."""
        lab, _, payload = unpack_label(self._records[i])
        img = self._decode(payload)
        flat = np.asarray(lab, np.float32).ravel()
        if flat.size % self.obj_width:
            raise ValueError(
                f"record {i}: label size {flat.size} is not a multiple of "
                f"obj_width={self.obj_width}")
        k = flat.size // self.obj_width
        if k > self.max_objs:
            raise ValueError(
                f"record {i}: {k} objects exceed max_objs={self.max_objs}; "
                "raise max_objs (a fixed label capacity keeps every "
                "batch one shape)")
        lab = np.full((self.max_objs, self.obj_width), self.pad_value,
                      np.float32)
        lab[:k] = flat.reshape(k, self.obj_width)
        if self.det_augmenter is not None:
            real = lab[:, 0] != self.pad_value
            img, boxes = self.det_augmenter(img, lab[real],
                                            rng=self._record_rng(pos))
            if len(boxes) > self.max_objs:
                raise ValueError(
                    f"det_augmenter produced {len(boxes)} boxes, over "
                    f"max_objs={self.max_objs}")
            lab = np.full((self.max_objs, self.obj_width),
                          self.pad_value, np.float32)
            if len(boxes):
                lab[:len(boxes)] = boxes
        th, tw = self.data_shape[0], self.data_shape[1]
        if img.shape[:2] != (th, tw):
            img = self._resize(img)
        return img, lab
