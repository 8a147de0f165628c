"""The Gluon layers the port's models use, as ``torch.nn`` modules:
``basic_layers`` and ``conv_layers``, as in ``mxnet_tpu/gluon/nn/``."""
from .basic_layers import (Activation, BatchNorm, Dense, Flatten,
                           HybridSequential, LayerNorm)
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["LayerNorm", "BatchNorm", "Dense", "Activation", "Flatten",
           "HybridSequential", "Conv2D", "MaxPool2D", "AvgPool2D",
           "GlobalAvgPool2D"]
