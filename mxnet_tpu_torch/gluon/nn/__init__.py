"""Gluon's layers, as ``HybridBlock``s (``torch.nn`` modules):
``basic_layers`` and ``conv_layers``, as in ``mxnet_tpu/gluon/nn/``."""
from ..block import Block, HybridBlock
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridLambda, HybridSequential, Lambda,
                           LayerNorm, Sequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "BatchNorm", "Embedding", "LayerNorm",
           "Flatten", "Lambda", "HybridLambda", "Activation", "Conv2D",
           "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D", "GlobalMaxPool2D"]
