"""Gluon's layers, as ``HybridBlock``s (``torch.nn`` modules):
``basic_layers`` and ``conv_layers``, as in ``mxnet_tpu/gluon/nn/``."""
from ..block import Block, HybridBlock
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridLambda, HybridSequential, InstanceNorm,
                           Lambda, LayerNorm, LeakyReLU, PReLU, Sequential,
                           Swish)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "BatchNorm", "Embedding", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU",
           "Conv2D",
           "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D", "GlobalMaxPool2D"]
