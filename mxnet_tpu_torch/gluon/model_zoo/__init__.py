"""The model zoo, as ``mxnet_tpu/gluon/model_zoo/`` exports it: the vision
models (``vision``) and ``get_model``."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
