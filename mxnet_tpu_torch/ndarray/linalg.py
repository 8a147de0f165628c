"""The ``nd.linalg`` namespace: the short spellings of the ``linalg_*``
ops (``nd.linalg.gemm2`` is ``nd.linalg_gemm2``), the same stubs as the
flat names, filled in by ``ndarray/__init__.py`` as in
``mxnet_tpu/ndarray/linalg.py``."""
from __future__ import annotations

__all__ = []
