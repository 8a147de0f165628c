"""Gluon's layers, as ``HybridBlock``s (``torch.nn`` modules):
``basic_layers`` and ``conv_layers``, as in ``mxnet_tpu/gluon/nn/``."""
from ..block import Block, HybridBlock, SymbolBlock
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridLambda, HybridSequential, InstanceNorm,
                           Lambda, LayerNorm, LeakyReLU, PReLU, Sequential,
                           Swish)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Sequential",
           "HybridSequential", "Dense", "Dropout", "BatchNorm", "Embedding", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU",
           "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]
