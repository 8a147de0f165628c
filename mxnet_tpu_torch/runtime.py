"""Run-time feature detection, the counterpart of the JAX
package's ``runtime.py``
(reference: python/mxnet/runtime.py ``Features()`` over
src/libinfo.cc's compile-time flags).

The key set is the JAX package's; the values say what this build
provides: ``CUDA``, ``CUDNN`` and ``NCCL`` from torch, ``OPENCV`` from
``cv2``; ``TPU``, ``XLA`` and ``PALLAS`` are False (the kernels are CUDA
C++); ``DIST_KVSTORE`` is whether ``torch.distributed`` is there (the
``dist_sync`` stores run on it) and ``ICI_COLLECTIVES`` is False (the
TPU's interconnect).
"""
from __future__ import annotations

from collections import namedtuple

import torch

__all__ = ["Feature", "Features", "feature_list"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _nccl() -> bool:
    try:
        import torch.distributed as dist

        return bool(dist.is_available() and dist.is_nccl_available())
    except (ImportError, AttributeError):
        return False


def _dist() -> bool:
    import torch.distributed as dist

    return bool(dist.is_available())


def _detect():
    feats = {
        "TPU": False,
        "XLA": False,
        "PALLAS": False,
        "CUDA": bool(torch.cuda.is_available()),
        "CUDNN": bool(torch.backends.cudnn.is_available()),
        "MIOPEN": False,
        "NCCL": _nccl(),
        "ICI_COLLECTIVES": False,
        "DIST_KVSTORE": _dist(),
        "OPENCV": False,
        "BLAS_OPEN": True,
        "F16C": True,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
    }
    try:
        import cv2  # noqa: F401

        feats["OPENCV"] = True
    except ImportError:
        pass
    return feats


class Features(dict):
    def __init__(self):
        super().__init__(
            (name, Feature(name, enabled))
            for name, enabled in _detect().items())

    def __repr__(self):
        return f"[{', '.join(f'{v.name}' + (' ✔' if v.enabled else ' ✖') for v in self.values())}]"

    def is_enabled(self, feature_name: str) -> bool:
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown")
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
