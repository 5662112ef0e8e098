"""MNIST idx-ubyte iterator (counterpart of ``dt_tpu/data/mnist.py``).

Reference: ``src/io/iter_mnist.cc:1`` — reads the original idx format
(``train-images-idx3-ubyte`` + ``train-labels-idx1-ubyte``, optionally
.gz), yields flat or (28, 28, 1) batches, shardable like every iterator.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from dt_tpu_torch.data.io import NDArrayIter


def _open(path: str):
    if path.endswith(".gz") or not os.path.exists(path) and \
            os.path.exists(path + ".gz"):
        return gzip.open(path if path.endswith(".gz") else path + ".gz", "rb")
    return open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise IOError(f"bad idx3 magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise IOError(f"bad idx1 magic {magic} in {path}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int32)


class MNISTIter(NDArrayIter):
    """Reference ``mx.io.MNISTIter`` surface: image/label paths, ``flat``
    attr, /255 scaling, shuffle + sharding."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 flat: bool = False, shuffle: bool = False,
                 num_parts: int = 1, part_index: int = 0, seed: int = 0,
                 **kw):
        x = read_idx_images(image).astype(np.float32) / 255.0
        y = read_idx_labels(label)
        if flat:
            x = x.reshape(len(x), -1)
        super().__init__(x, y, batch_size, shuffle=shuffle,
                         num_parts=num_parts, part_index=part_index,
                         seed=seed, **kw)
