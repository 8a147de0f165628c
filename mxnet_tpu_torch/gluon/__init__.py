"""Gluon: ``Parameter`` / ``ParameterDict``, ``Block`` / ``HybridBlock``,
the layers (``nn``), the losses, ``Trainer`` and ``utils``, as in
``mxnet_tpu/gluon/``; blocks are ``torch.nn`` modules."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, CachedOp, HybridBlock
from . import nn
from . import loss
from . import utils
from .utils import split_and_load
from .trainer import Trainer

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "CachedOp", "nn", "loss", "utils", "split_and_load", "Trainer"]
