"""``mx.rtc``, the counterpart of the JAX package's
``rtc.py`` (reference:
src/common/rtc.cc, where ``mx.rtc.CudaModule`` compiles CUDA source with
NVRTC at run time).  The JAX package descopes it; so does the port, which
has the same surface: both entry points raise and name the port's own
route for hand-written kernels instead."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["CudaModule", "CudaKernel"]

_MSG = ("mx.rtc (run-time compilation of CUDA source) is not provided. "
        "The port's kernels are CUDA C++ sources under "
        "mxnet_tpu_torch/csrc/*.cu, built with nvcc for sm_90a by "
        "mxnet_tpu_torch/ops/kernels/_build.py (add a source to its SOURCES "
        "and a ctypes wrapper beside the others in ops/kernels/).")


class CudaModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)


class CudaKernel:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)
