"""Gluon: ``Parameter`` / ``ParameterDict``, ``Block`` / ``HybridBlock``,
the layers (``nn``), the recurrent layers and cells (``rnn``), the
losses, ``Trainer``, ``utils``, ``data``, the vision ``model_zoo`` and
``contrib`` (the contrib layers and cells, the ``Estimator``), as in
``mxnet_tpu/gluon/``; blocks are ``torch.nn`` modules."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, CachedOp, HybridBlock, SymbolBlock
from . import nn
from . import rnn
from . import loss
from . import utils
from .utils import split_and_load
from .trainer import Trainer
from . import data
from . import model_zoo
from . import contrib

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "CachedOp", "SymbolBlock", "nn", "rnn", "loss", "utils",
           "split_and_load", "Trainer", "data", "model_zoo", "contrib"]
