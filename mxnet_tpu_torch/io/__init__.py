"""Data iterators, as ``mxnet_tpu/io/`` exports them: ``io.py`` and
``ImageRecordIter`` (``image_iter.py``, the pure-Python pipeline).  The
native ``libmxio`` pipeline (``mxnet_tpu/io/native.py``) is not ported,
nor ``LibSVMIter`` (its batches are ``csr``: ROADMAP A.7)."""
from .io import (DataIter, DataBatch, DataDesc, NDArrayIter, ResizeIter,
                 CSVIter, PrefetchingIter, DevicePrefetchIter, stage_batches)
from .image_iter import ImageRecordIter
