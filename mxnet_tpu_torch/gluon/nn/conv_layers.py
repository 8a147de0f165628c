"""The Gluon convolution and pooling layers of
``mxnet_tpu/gluon/nn/conv_layers.py`` the ResNet family and LeNet use, as
``HybridBlock``s (``torch.nn`` modules) over the ``Convolution`` and
``Pooling`` ops of
``ops/nn.py`` (cuDNN through torch on the card; the JAX package has no
Pallas kernel for either).

``layout`` is "NCHW" or "NHWC", and an NHWC layer takes (N, H, W, C)
data as the JAX one does.  ``Conv2D.weight`` is torch's (O, I/g, kh, kw)
in both layouts; in NHWC it is kept in ``torch.channels_last`` memory, so
that its Gluon view (O, kh, kw, I/g) (``mxnet_tpu/gluon/nn/
conv_layers.py:53``), which the op takes, is contiguous and the op's
channels-first view of it is the layout cuDNN's NHWC kernels read:
nothing is copied on a call.  ``from_gluon`` turns a Gluon-layout array
into the weight's layout (``convert``, the Gluon Parameter's
initialization, ``set_data`` and ``load_parameters``), ``to_gluon`` back
(``save_parameters``), and ``gluon_shape`` gives the shape initializers
draw in (their fans come from it).  ``in_channels`` 0 is inferred at the
first call; ``activation`` applies the ``Activation`` op after the bias.
``hybrid_forward`` is the JAX layers' body over ``F.<op>`` (the graph of
``export``; the weight in Gluon's layout).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...ops import nn as _ops
from ...precision import runtime as _prec
from ..block import HybridBlock
from .basic_layers import weight_tensor

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "GlobalMaxPool2D"]

IntPair = Union[int, Sequence[int]]


def _tup(v: IntPair, n: int = 2):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _check_layout(layout: str) -> bool:
    """True for NHWC, False for NCHW; raise on anything else."""
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout must be NCHW or NHWC, got {layout!r}")
    return layout == "NHWC"


class Conv2D(HybridBlock):
    """2-D convolution, y = act(conv(x, W) + b); ``in_channels`` 0 is
    inferred at the first call."""

    def __init__(self, channels: int, kernel_size: IntPair,
                 strides: IntPair = 1, padding: IntPair = 0,
                 dilation: IntPair = 1, groups: int = 1,
                 layout: str = "NCHW", activation: Optional[str] = None,
                 use_bias: bool = True, weight_initializer=None,
                 bias_initializer="zeros", in_channels: int = 0,
                 prefix: Optional[str] = None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.nhwc = _check_layout(layout)
        self.layout = layout
        self.act = activation
        self._channels = channels
        k = _tup(kernel_size)
        self.kwargs = {"kernel": k, "stride": _tup(strides),
                       "dilate": _tup(dilation), "pad": _tup(padding),
                       "num_filter": channels, "num_group": groups,
                       "no_bias": not use_bias, "layout": layout}
        ig = in_channels // groups
        self.weight = weight_tensor((channels, ig) + k)
        if self.nhwc and in_channels > 0:
            self.weight.data = self.weight.data.contiguous(
                memory_format=torch.channels_last)
        self._gluon_param("weight", shape=self._gluon_wshape(ig),
                          init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(channels))
            self._gluon_param("bias", shape=(channels,),
                              init=bias_initializer,
                              allow_deferred_init=True)
        else:
            self.bias = None

    def _gluon_wshape(self, ig: int):
        k = self.kwargs["kernel"]
        return ((self._channels,) + k + (ig,) if self.nhwc
                else (self._channels, ig) + k)

    def infer_shape(self, x, *args):
        in_c = int(x.shape[-1 if self.nhwc else 1])
        self._reg_params["weight"]._set_shape_if_deferred(
            self._gluon_wshape(in_c // self.kwargs["num_group"]))

    def _gluon_weight(self):
        """The weight in Gluon's layout, a view."""
        return self.weight.permute(0, 2, 3, 1) if self.nhwc else self.weight

    def gluon_shape(self, leaf: str):
        return tuple(self._gluon_weight().shape if leaf == "weight"
                     else getattr(self, leaf).shape)

    def from_gluon(self, leaf: str, value: torch.Tensor) -> torch.Tensor:
        """A Gluon-layout array of parameter ``leaf`` in this layer's
        layout: an NHWC weight (O, kh, kw, I) as (O, I, kh, kw)."""
        if leaf == "weight" and self.nhwc and value.dim() == 4:
            return value.permute(0, 3, 1, 2)
        return value

    def to_gluon(self, leaf: str, value: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`from_gluon`."""
        if leaf == "weight" and self.nhwc and value.dim() == 4:
            return value.permute(0, 2, 3, 1)
        return value

    def forward(self, x):
        self._finish_deferred(x)
        twin = _prec.quant_entry(self)
        if twin is not None:
            # a quantized serving adapter's scope: the layer's int8 or
            # int4 twin replaces it
            return twin(x, self.bias)
        args = (x, self._gluon_weight()) + (
            () if self.bias is None else (self.bias,))
        out = _ops.convolution(*args, **self.kwargs)
        return out if self.act is None else _ops.activation(out, self.act)

    def hybrid_forward(self, F, x, weight, bias=None):
        # ``weight`` in Gluon's layout, as the graph variable has it
        if bias is None:
            out = F.Convolution(x, weight, **self.kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self.kwargs)
        if self.act:
            out = F.Activation(out, act_type=self.act)
        return out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        _check_layout(layout)
        if strides is None:
            strides = pool_size
        self.kwargs = {"kernel": _tup(pool_size), "stride": _tup(strides),
                       "pad": _tup(padding), "pool_type": pool_type,
                       "global_pool": global_pool,
                       "pooling_convention": "full" if ceil_mode else "valid",
                       "layout": layout}
        if count_include_pad is not None:
            self.kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return _ops.pooling(x, **self.kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self.kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size: IntPair = 2, strides=None,
                 padding: IntPair = 0, layout: str = "NCHW",
                 ceil_mode: bool = False, prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size: IntPair = 2, strides=None,
                 padding: IntPair = 0, layout: str = "NCHW",
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 prefix=None, params=None):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, prefix=prefix,
                         params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout: str = "NCHW", prefix=None, params=None):
        super().__init__(1, 1, 0, False, True, "avg", layout, prefix=prefix,
                         params=params)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout: str = "NCHW", prefix=None, params=None):
        super().__init__(1, 1, 0, False, True, "max", layout, prefix=prefix,
                         params=params)
