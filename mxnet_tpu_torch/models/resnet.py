"""ResNet V1 and V1b, as ``torch.nn`` modules.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``BasicBlockV1``, ``BottleneckV1`` (``stride_in_1x1``; False is GluonCV's
v1b, the stride on the 3x3), ``ResNetV1`` (with ``thumbnail``),
``get_resnet(1, depth)``, ``resnet18_v1`` ... ``resnet152_v1``,
``resnet50_v1b`` (BASELINE config 2) and ``resnet101_v1b``.  V2 is not
ported yet.

``layout`` is "NCHW" or "NHWC"; an NHWC net takes (N, H, W, C) images,
as the JAX one does, and every activation is a contiguous NHWC tensor:
the convolutions, pooling and BatchNorm see it through a channels-first
view that is ``torch.channels_last`` memory, so cuDNN's NHWC kernels run
with no transposes.  Convolutions and pooling go to cuDNN through torch
and BatchNorm to torch's fused kernel; the JAX model reaches no Pallas
kernel, so no kernel of the port runs here.

Parameter names: the JAX package names layers by counters within name
scopes (``resnetv10_conv2d0_weight``, ``resnetv10_stage1_conv2d3_weight``
for the first block's downsample conv, created after the body's three,
..., ``resnetv10_dense0_bias``), so the modules here are created in the
JAX package's order and each takes its Gluon prefix from a
:class:`_Scope`'s counters (``convert`` reads ``gluon_prefix``).
``resnet50_v1b`` has 267 arrays and 25,610,152 values in both layouts.

Weights are drawn on the CPU from ``generator`` by
``initializer.Xavier()`` (``bench.py``'s ``mx.init.Xavier()``), then the
net moves to ``device`` (default: :func:`context.default_device`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.nn import (Activation, BatchNorm, Conv2D, Dense,
                        GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ..initializer import Xavier, initialize

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet50_v1b", "resnet101_v1b"]


class _Scope:
    """Gluon's per-scope name counters: the n-th layer of a kind created
    in a scope is ``<scope><kind><n>_``."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._counts = {}

    def __call__(self, kind: str) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        return f"{self.prefix}{kind}{n}_"


def _bn_axis(layout: str) -> int:
    return -1 if layout == "NHWC" else 1


def _conv(names, channels, kernel, stride, pad, in_channels, layout):
    return Conv2D(channels, kernel, strides=stride, padding=pad,
                  use_bias=False, in_channels=in_channels, layout=layout,
                  prefix=names("conv2d"))


def _bn(names, channels, layout):
    return BatchNorm(channels, axis=_bn_axis(layout),
                     prefix=names("batchnorm"))


def _downsample(names, channels, stride, in_channels, layout):
    return HybridSequential(
        _conv(names, channels, 1, stride, 0, in_channels, layout),
        _bn(names, channels, layout))


class BasicBlockV1(nn.Module):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, layout: str = "NCHW",
                 names: Optional[_Scope] = None):
        super().__init__()
        names = names or _Scope()
        self.body = HybridSequential(
            _conv(names, channels, 3, stride, 1, in_channels, layout),
            _bn(names, channels, layout), Activation("relu"),
            _conv(names, channels, 3, 1, 1, channels, layout),
            _bn(names, channels, layout))
        self.downsample = (_downsample(names, channels, stride, in_channels,
                                       layout) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(residual + x)


class BottleneckV1(nn.Module):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, stride_in_1x1: bool = True,
                 layout: str = "NCHW", names: Optional[_Scope] = None):
        super().__init__()
        names = names or _Scope()
        mid = channels // 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.body = HybridSequential(
            _conv(names, mid, 1, s1, 0, in_channels, layout),
            _bn(names, mid, layout), Activation("relu"),
            _conv(names, mid, 3, s3, 1, mid, layout),
            _bn(names, mid, layout), Activation("relu"),
            _conv(names, channels, 1, 1, 0, mid, layout),
            _bn(names, channels, layout))
        self.downsample = (_downsample(names, channels, stride, in_channels,
                                       layout) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class ResNetV1(nn.Module):
    """forward(x) -> logits (N, classes); x is (N, C, H, W) or, with
    ``layout="NHWC"``, (N, H, W, C)."""

    def __init__(self, block, layers: Sequence[int],
                 channels: Sequence[int], classes: int = 1000,
                 thumbnail: bool = False, stride_in_1x1: bool = True,
                 layout: str = "NCHW", in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs len(layers) == len(channels) - 1")
        device = resolve_device(device)
        names = _Scope()
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv(names, channels[0], 3, 1, 1,
                                    in_channels, layout))
        else:
            self.features.add(
                _conv(names, channels[0], 7, 2, 3, in_channels, layout),
                _bn(names, channels[0], layout), Activation("relu"),
                MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stage = _Scope(f"stage{i + 1}_")
            stride = 1 if i == 0 else 2
            kw = ({"stride_in_1x1": stride_in_1x1}
                  if block is BottleneckV1 else {})
            layer = HybridSequential(block(
                channels[i + 1], stride, channels[i + 1] != channels[i],
                in_channels=channels[i], layout=layout, names=stage, **kw))
            for _ in range(num_layer - 1):
                layer.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], layout=layout,
                                names=stage, **kw))
            self.features.add(layer)
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, in_units=channels[-1],
                            prefix=names("dense"))
        initialize(self, Xavier(), generator)
        self.to(device)

    def forward(self, x):
        return self.output(self.features(x))


_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version: int, num_layers: int, **kwargs) -> ResNetV1:
    """ResNet ``version`` 1 of depth 18, 34, 50, 101 or 152."""
    if version != 1:
        raise MXNetError(f"ResNet V{version} is not ported yet (V1 only)")
    if num_layers not in _SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    block_type, layers, channels = _SPEC[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet50_v1b(**kwargs):
    """ResNet-50 v1b: the stride on the 3x3 conv (BASELINE config 2)."""
    return get_resnet(1, 50, stride_in_1x1=False, **kwargs)


def resnet101_v1b(**kwargs):
    return get_resnet(1, 101, stride_in_1x1=False, **kwargs)
