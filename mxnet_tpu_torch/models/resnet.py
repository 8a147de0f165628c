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
..., ``resnetv10_dense0_bias``), so the blocks here are created in the
JAX package's order in the same name scopes (the net's, and each stage's
``stage<i>_``; the containers and residual blocks have the empty prefix):
``collect_params()`` gives the JAX net's names, which ``convert`` maps.
``resnet50_v1b`` has 267 arrays and 25,610,152 values in both layouts.

Weights are drawn on the CPU from ``generator`` by
``initializer.Xavier()`` (``bench.py``'s ``mx.init.Xavier()``), then the
net moves to ``device`` (default: :func:`context.default_device`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import (Activation, BatchNorm, Conv2D, Dense,
                        GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ..initializer import Xavier, initialize

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet50_v1b", "resnet101_v1b"]


def _bn_axis(layout: str) -> int:
    return -1 if layout == "NHWC" else 1


def _conv(channels, kernel, stride, pad, in_channels, layout):
    return Conv2D(channels, kernel, strides=stride, padding=pad,
                  use_bias=False, in_channels=in_channels, layout=layout)


def _bn(channels, layout):
    return BatchNorm(channels, axis=_bn_axis(layout))


def _seq(*layers) -> HybridSequential:
    seq = HybridSequential(prefix="")
    seq.add(*layers)
    return seq


def _downsample(channels, stride, in_channels, layout):
    return _seq(_conv(channels, 1, stride, 0, in_channels, layout),
                _bn(channels, layout))


class BasicBlockV1(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, layout: str = "NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.body = _seq(
            _conv(channels, 3, stride, 1, in_channels, layout),
            _bn(channels, layout), Activation("relu"),
            _conv(channels, 3, 1, 1, channels, layout),
            _bn(channels, layout))
        self.downsample = (_downsample(channels, stride, in_channels,
                                       layout) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(residual + x)


class BottleneckV1(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, stride_in_1x1: bool = True,
                 layout: str = "NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        mid = channels // 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.body = _seq(
            _conv(mid, 1, s1, 0, in_channels, layout),
            _bn(mid, layout), Activation("relu"),
            _conv(mid, 3, s3, 1, mid, layout),
            _bn(mid, layout), Activation("relu"),
            _conv(channels, 1, 1, 0, mid, layout),
            _bn(channels, layout))
        self.downsample = (_downsample(channels, stride, in_channels,
                                       layout) if downsample else None)

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class ResNetV1(HybridBlock):
    """forward(x) -> logits (N, classes); x is (N, C, H, W) or, with
    ``layout="NHWC"``, (N, H, W, C).  With ``init_weights=False`` nothing
    is drawn or moved: the Gluon Parameters wait for
    ``initialize(init, ctx)``."""

    def __init__(self, block, layers: Sequence[int],
                 channels: Sequence[int], classes: int = 1000,
                 thumbnail: bool = False, stride_in_1x1: bool = True,
                 layout: str = "NCHW", in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs len(layers) == len(channels) - 1")
        kw = {"stride_in_1x1": stride_in_1x1} if block is BottleneckV1 else {}
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv(channels[0], 3, 1, 1, in_channels,
                                        layout))
            else:
                self.features.add(
                    _conv(channels[0], 7, 2, 3, in_channels, layout),
                    _bn(channels[0], layout), Activation("relu"),
                    MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                layer = HybridSequential(prefix=f"stage{i + 1}_")
                with layer.name_scope():
                    layer.add(block(channels[i + 1], 1 if i == 0 else 2,
                                    channels[i + 1] != channels[i],
                                    in_channels=channels[i], layout=layout,
                                    prefix="", **kw))
                    for _ in range(num_layer - 1):
                        layer.add(block(channels[i + 1], 1, False,
                                        in_channels=channels[i + 1],
                                        layout=layout, prefix="", **kw))
                self.features.add(layer)
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1])
        if init_weights:
            device = resolve_device(device)
            initialize(self, Xavier(), generator)
            self.to(device)
            self._mark_initialized()

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
