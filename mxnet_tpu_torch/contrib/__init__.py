"""Contributed modules of the port: ``amp`` (mixed precision for Gluon
training scripts) and ``quantization`` (int8 post-training quantization),
counterparts of the JAX package's ``contrib/amp`` and
``contrib/quantization.py``."""
from . import amp
from . import quantization

__all__ = ["amp", "quantization"]
