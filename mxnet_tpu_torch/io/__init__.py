"""Data iterators, as ``mxnet_tpu/io/`` exports them: ``io.py`` (with
``LibSVMIter``'s ``csr`` batches) and ``ImageRecordIter``
(``image_iter.py``, the pure-Python pipeline).  The native ``libmxio``
pipeline (``mxnet_tpu/io/native.py``) is not ported."""
from .io import (DataIter, DataBatch, DataDesc, NDArrayIter, ResizeIter,
                 CSVIter, LibSVMIter, PrefetchingIter, DevicePrefetchIter,
                 stage_batches)
from .image_iter import ImageRecordIter
