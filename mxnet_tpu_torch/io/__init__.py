"""Data iterators, as ``mxnet_tpu/io/`` exports them (``io.py``).
``ImageRecordIter`` and the native ``libmxio`` pipeline are not ported
(ROADMAP A.13), nor ``LibSVMIter`` (its batches are ``csr``)."""
from .io import (DataIter, DataBatch, DataDesc, NDArrayIter, ResizeIter,
                 CSVIter, PrefetchingIter, DevicePrefetchIter, stage_batches)
