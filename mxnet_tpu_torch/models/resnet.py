"""ResNet V1, V1b and V2, as Gluon ``HybridBlock``s (``torch.nn``
modules).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``BasicBlockV1``, ``BottleneckV1`` (``stride_in_1x1``; False is GluonCV's
v1b, the stride on the 3x3), ``ResNetV1`` (with ``thumbnail``),
``BasicBlockV2`` / ``BottleneckV2`` (pre-activation: BatchNorm and ReLU
before each convolution, the downsample fed the activated input) and
``ResNetV2``, which starts with a ``BatchNorm(scale=False,
center=False)`` over the images (its gamma and beta ``grad_req="null"``:
no step moves them, weight decay included) and ends in BatchNorm, ReLU,
the pool and ``Flatten``; ``get_resnet(version, depth)``,
``resnet18_v1`` ... ``resnet152_v1``, ``resnet18_v2`` ...
``resnet152_v2``, ``resnet50_v1b`` (BASELINE config 2) and
``resnet101_v1b``.  ``gluon.model_zoo.vision`` re-exports them.

Every block's body is its ``hybrid_forward``, the JAX block's own over
``F.<op>``: on tensors ``F`` is the op registry (the same torch calls as
before), and on Symbols it writes the graph, so ``export`` of any ResNet
gives the JAX export node for node.

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
Every layer is given its input width, so the shapes are known at
construction.  ``resnet50_v1b`` has 267 arrays and 25,610,152 values in
both layouts.

Weights are drawn on the CPU from ``generator`` by
``initializer.Xavier()`` (``bench.py``'s ``mx.init.Xavier()``), then the
net moves to ``device`` (default: :func:`context.default_device`); with
``init_weights=False`` the Gluon Parameters wait for ``initialize(init,
ctx)``, as the JAX constructors leave them (``get_model`` builds so).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                        GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ..initializer import Xavier, initialize

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BottleneckV1",
           "BasicBlockV2", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "resnet50_v1b", "resnet101_v1b", "get_resnet"]


def _bn_axis(layout: str) -> int:
    return -1 if layout == "NHWC" else 1


def _conv(channels, kernel, stride, pad, in_channels, layout):
    return Conv2D(channels, kernel, strides=stride, padding=pad,
                  use_bias=False, in_channels=in_channels, layout=layout)


def _bn(channels, layout, **kwargs):
    return BatchNorm(channels, axis=_bn_axis(layout), **kwargs)


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

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


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

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, layout: str = "NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = _conv(channels, 3, stride, 1, in_channels, layout)
        self.bn2 = _bn(channels, layout)
        self.conv2 = _conv(channels, 3, 1, 1, channels, layout)
        self.downsample = (_conv(channels, 1, stride, 0, in_channels, layout)
                           if downsample else None)

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, layout: str = "NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        mid = channels // 4
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = _conv(mid, 1, 1, 0, in_channels, layout)
        self.bn2 = _bn(mid, layout)
        self.conv2 = _conv(mid, 3, stride, 1, mid, layout)
        self.bn3 = _bn(mid, layout)
        self.conv3 = _conv(channels, 1, 1, 0, mid, layout)
        self.downsample = (_conv(channels, 1, stride, 0, in_channels, layout)
                           if downsample else None)

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


class _ResNet(HybridBlock):
    """What V1 and V2 share: the stem, the stages in their name scopes,
    the weights' drawing and ``hybrid_forward``."""

    def _stem(self, thumbnail, channels, in_channels, layout):
        if thumbnail:
            self.features.add(_conv(channels, 3, 1, 1, in_channels, layout))
        else:
            self.features.add(
                _conv(channels, 7, 2, 3, in_channels, layout),
                _bn(channels, layout), Activation("relu"),
                MaxPool2D(3, 2, 1, layout=layout))

    def _stages(self, block, layers, channels, in_c, layout, **kw):
        for i, num_layer in enumerate(layers):
            layer = HybridSequential(prefix=f"stage{i + 1}_")
            with layer.name_scope():
                layer.add(block(channels[i + 1], 1 if i == 0 else 2,
                                channels[i + 1] != in_c, in_channels=in_c,
                                layout=layout, prefix="", **kw))
                for _ in range(num_layer - 1):
                    layer.add(block(channels[i + 1], 1, False,
                                    in_channels=channels[i + 1],
                                    layout=layout, prefix="", **kw))
            self.features.add(layer)
            in_c = channels[i + 1]

    def _draw(self, init_weights, device, generator):
        if init_weights:
            device = resolve_device(device)
            initialize(self, Xavier(), generator)
            self.to(device)
            self._mark_initialized()

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
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
            self._stem(thumbnail, channels[0], in_channels, layout)
            self._stages(block, layers, channels, channels[0], layout, **kw)
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1])
        self._draw(init_weights, device, generator)


class ResNetV2(_ResNet):
    """The pre-activation ResNet; arguments as :class:`ResNetV1`'s."""

    def __init__(self, block, layers: Sequence[int],
                 channels: Sequence[int], classes: int = 1000,
                 thumbnail: bool = False, layout: str = "NCHW",
                 in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2 needs len(layers) == len(channels) - 1")
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_bn(in_channels, layout, scale=False,
                                  center=False))
            self._stem(thumbnail, channels[0], in_channels, layout)
            self._stages(block, layers, channels, channels[0], layout)
            self.features.add(_bn(channels[-1], layout), Activation("relu"),
                              GlobalAvgPool2D(layout=layout), Flatten())
            self.output = Dense(classes, in_units=channels[-1])
        self._draw(init_weights, device, generator)


_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                             "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version: int, num_layers: int, pretrained: bool = False,
               ctx=None, root=None, **kwargs):
    """ResNet ``version`` 1 or 2 of depth 18, 34, 50, 101 or 152;
    ``ctx`` is the device, and ``pretrained`` raises: there are no
    weights to fetch (the JAX package's rule too)."""
    if version not in _VERSIONS:
        raise MXNetError(f"invalid resnet version {version}: 1 or 2")
    if num_layers not in _SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if pretrained:
        raise MXNetError(
            "pretrained weights are unavailable without a network; "
            "initialize() and train, or load_parameters() from a local file")
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net_class, blocks = _VERSIONS[version]
    block_type, layers, channels = _SPEC[num_layers]
    return net_class(blocks[block_type], layers, channels, **kwargs)


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


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)


def resnet50_v1b(**kwargs):
    """ResNet-50 v1b: the stride on the 3x3 conv (BASELINE config 2)."""
    return get_resnet(1, 50, stride_in_1x1=False, **kwargs)


def resnet101_v1b(**kwargs):
    return get_resnet(1, 101, stride_in_1x1=False, **kwargs)
