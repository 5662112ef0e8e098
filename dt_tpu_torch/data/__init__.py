"""Data pipeline of the port (counterpart of ``dt_tpu/data``): host code in
numpy, with every name the JAX package's ``data`` exports.

The iterators of ``io``; RecordIO files and the image-record iterators
(``recordio``); the augmenters (``augment``); gluon-style ``Dataset`` and
``DataLoader`` (``dataset``); ``MNISTIter`` (``mnist``); and
``BucketSentenceIter`` (``bucket_io``).  The sharding pair
``num_parts``/``part_index`` and ``ResizeIter``'s equal batch counts are
the elastic contract (``ElasticDataIterator`` re-shards after a membership
change).
"""

from dt_tpu_torch.data.io import (
    DataBatch as DataBatch,
    DataDesc as DataDesc,
    DataIter as DataIter,
    NDArrayIter as NDArrayIter,
    CSVIter as CSVIter,
    LibSVMIter as LibSVMIter,
    ResizeIter as ResizeIter,
    PrefetchingIter as PrefetchingIter,
    DevicePrefetchIter as DevicePrefetchIter,
    SyntheticImageIter as SyntheticImageIter,
    ElasticDataIterator as ElasticDataIterator,
)
from dt_tpu_torch.data import augment as augment
from dt_tpu_torch.data.mnist import MNISTIter as MNISTIter
from dt_tpu_torch.data.dataset import (
    Dataset as Dataset,
    ArrayDataset as ArrayDataset,
    DataLoader as DataLoader,
    RandomSampler as RandomSampler,
    SequentialSampler as SequentialSampler,
)
from dt_tpu_torch.data.bucket_io import (
    BucketSentenceIter as BucketSentenceIter)
from dt_tpu_torch.data.recordio import (
    RecordIOReader as RecordIOReader,
    RecordIOWriter as RecordIOWriter,
    pack_label as pack_label,
    unpack_label as unpack_label,
    ImageDetRecordIter as ImageDetRecordIter,
    ImageRecordIter as ImageRecordIter,
)
