"""Contributed modules of the port: ``amp`` (mixed precision for Gluon
training scripts), ``quantization`` (int8 post-training quantization) and
``onnx`` (ONNX export and import), counterparts of the JAX package's
``contrib/amp``, ``contrib/quantization.py`` and ``contrib/onnx``."""
from . import amp
from . import quantization
from . import onnx

__all__ = ["amp", "quantization", "onnx"]
