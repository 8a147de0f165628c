"""The Gluon convolution and pooling layers of
``mxnet_tpu/gluon/nn/conv_layers.py``, as ``HybridBlock``s (``torch.nn``
modules) over the ``Convolution``, ``Deconvolution`` and ``Pooling`` ops
of ``ops/nn.py`` (cuDNN through torch on the card; the JAX package has no
Pallas kernel for any of them): ``Conv1D`` / ``2D`` / ``3D``, their
``Transpose`` twins, and the max, average and global pools of each rank.

``layout`` is channels first (NCW, NCHW, NCDHW) or last (NWC, NHWC,
NDHWC), and a channel-last layer takes (N, *spatial, C) data as the JAX
one does.  The weight is torch's (O, I/g, *k) ((I, O/g, *k) for a
transposed convolution) in both layouts; channel-last, its memory is
laid out as its Gluon view (O, *k, I/g) ((I, *k, O/g);
``mxnet_tpu/gluon/nn/conv_layers.py:49-57``), which the op takes: for
2-D that is ``torch.channels_last`` memory, so the op's channels-first
view of it is the layout cuDNN's NHWC kernels read and nothing is copied
on a call.  ``from_gluon`` turns a Gluon-layout array into the weight's
layout (``convert``, the Gluon Parameter's initialization, ``set_data``
and ``load_parameters``), ``to_gluon`` back (``save_parameters``), and
``gluon_shape`` gives the shape initializers draw in (their fans come
from it).  ``in_channels`` 0 is inferred at the first call;
``activation`` applies the ``Activation`` op after the bias.
``hybrid_forward`` is the JAX layers' body over ``F.<op>`` (the graph of
``export``; the weight in Gluon's layout).  A ``Conv2D`` that a quantized
serving adapter selected runs its int8 or int4 twin.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...ops import nn as _ops
from ...precision import runtime as _prec
from ..block import HybridBlock
from .basic_layers import weight_tensor

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]

IntTuple = Union[int, Sequence[int]]


def _tup(v: IntTuple, n: int):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """A convolution (``op_name`` "Convolution") or transposed convolution
    ("Deconvolution") of ``len(kernel_size)`` spatial axes."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        n = len(kernel_size)
        self.channel_last = _ops._channel_last(layout, n, type(self).__name__)
        self.layout = layout
        self.act = activation
        self._channels = channels
        self._op = (_ops.convolution if op_name == "Convolution"
                    else _ops.deconvolution)
        self._op_name = op_name
        self.kwargs = {"kernel": kernel_size, "stride": strides,
                       "dilate": dilation, "pad": padding,
                       "num_filter": channels, "num_group": groups,
                       "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self.kwargs["adj"] = adj
        self.weight = weight_tensor(self._torch_wshape(in_channels))
        if self.channel_last and in_channels > 0:
            self.weight.data = self.weight.data.movedim(1, -1).contiguous(
            ).movedim(-1, 1)
        self._gluon_param("weight", shape=self._gluon_wshape(in_channels),
                          init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(channels))
            self._gluon_param("bias", shape=(channels,),
                              init=bias_initializer,
                              allow_deferred_init=True)
        else:
            self.bias = None

    def _torch_wshape(self, in_c: int):
        """(O, I/g, *k) of a convolution, (I, O/g, *k) of a transposed
        one; 0 where ``in_c`` is not known yet."""
        g = self.kwargs["num_group"]
        pair = ((self._channels, in_c // g) if self._op_name == "Convolution"
                else (in_c, self._channels // g if in_c else 0))
        return pair + tuple(self.kwargs["kernel"])

    def _gluon_wshape(self, in_c: int):
        shape = self._torch_wshape(in_c)
        return (shape[:1] + shape[2:] + shape[1:2] if self.channel_last
                else shape)

    def infer_shape(self, x, *args):
        in_c = int(x.shape[-1 if self.channel_last else 1])
        self._reg_params["weight"]._set_shape_if_deferred(
            self._gluon_wshape(in_c))

    def _gluon_weight(self):
        """The weight in Gluon's layout, a view."""
        return self.weight.movedim(1, -1) if self.channel_last else self.weight

    def gluon_shape(self, leaf: str):
        return tuple(self._gluon_weight().shape if leaf == "weight"
                     else getattr(self, leaf).shape)

    def from_gluon(self, leaf: str, value: torch.Tensor) -> torch.Tensor:
        """A Gluon-layout array of parameter ``leaf`` in this layer's
        layout: a channel-last weight (O, *k, I) as (O, I, *k)."""
        if leaf == "weight" and self.channel_last and value.dim() > 2:
            return value.movedim(-1, 1)
        return value

    def to_gluon(self, leaf: str, value: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`from_gluon`."""
        if leaf == "weight" and self.channel_last and value.dim() > 2:
            return value.movedim(1, -1)
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
        out = self._op(*args, **self.kwargs)
        return out if self.act is None else _ops.activation(out, self.act)

    def hybrid_forward(self, F, x, weight, bias=None):
        # ``weight`` in Gluon's layout, as the graph variable has it
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self.kwargs)
        else:
            out = op(x, weight, bias, **self.kwargs)
        if self.act:
            out = F.Activation(out, act_type=self.act)
        return out


def _conv_args(n, kernel_size, strides, padding, dilation):
    return (_tup(kernel_size, n), _tup(strides, n), _tup(padding, n),
            _tup(dilation, n))


class Conv1D(_Conv):
    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 dilation: IntTuple = 1, groups: int = 1,
                 layout: str = "NCW", activation: Optional[str] = None,
                 use_bias: bool = True, weight_initializer=None,
                 bias_initializer="zeros", in_channels: int = 0,
                 prefix: Optional[str] = None, params=None):
        super().__init__(channels,
                         *_conv_args(1, kernel_size, strides, padding,
                                     dilation),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix,
                         params=params)


class Conv2D(_Conv):
    """2-D convolution, y = act(conv(x, W) + b); ``in_channels`` 0 is
    inferred at the first call."""

    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 dilation: IntTuple = 1, groups: int = 1,
                 layout: str = "NCHW", activation: Optional[str] = None,
                 use_bias: bool = True, weight_initializer=None,
                 bias_initializer="zeros", in_channels: int = 0,
                 prefix: Optional[str] = None, params=None):
        super().__init__(channels,
                         *_conv_args(2, kernel_size, strides, padding,
                                     dilation),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix,
                         params=params)


class Conv3D(_Conv):
    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 dilation: IntTuple = 1, groups: int = 1,
                 layout: str = "NCDHW", activation: Optional[str] = None,
                 use_bias: bool = True, weight_initializer=None,
                 bias_initializer="zeros", in_channels: int = 0,
                 prefix: Optional[str] = None, params=None):
        super().__init__(channels,
                         *_conv_args(3, kernel_size, strides, padding,
                                     dilation),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix,
                         params=params)


class _ConvTranspose(_Conv):
    """A transposed convolution of ``n`` spatial axes; ``output_padding``
    is the op's ``adj``."""

    def __init__(self, n, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 prefix, params):
        super().__init__(channels,
                         *_conv_args(n, kernel_size, strides, padding,
                                     dilation),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, n), prefix=prefix,
                         params=params)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 output_padding: IntTuple = 0, dilation: IntTuple = 1,
                 groups: int = 1, layout: str = "NCW",
                 activation: Optional[str] = None, use_bias: bool = True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels: int = 0, prefix: Optional[str] = None,
                 params=None):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, prefix, params)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 output_padding: IntTuple = 0, dilation: IntTuple = 1,
                 groups: int = 1, layout: str = "NCHW",
                 activation: Optional[str] = None, use_bias: bool = True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels: int = 0, prefix: Optional[str] = None,
                 params=None):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, prefix, params)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels: int, kernel_size: IntTuple,
                 strides: IntTuple = 1, padding: IntTuple = 0,
                 output_padding: IntTuple = 0, dilation: IntTuple = 1,
                 groups: int = 1, layout: str = "NCDHW",
                 activation: Optional[str] = None, use_bias: bool = True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels: int = 0, prefix: Optional[str] = None,
                 params=None):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, prefix, params)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        n = len(pool_size)
        _ops._channel_last(layout, n, type(self).__name__)
        self.kwargs = {"kernel": pool_size,
                       "stride": pool_size if strides is None
                       else _tup(strides, n),
                       "pad": _tup(padding, n), "pool_type": pool_type,
                       "global_pool": global_pool,
                       "pooling_convention": "full" if ceil_mode else "valid",
                       "layout": layout}
        if count_include_pad is not None:
            self.kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return _ops.pooling(x, **self.kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self.kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCW",
                 ceil_mode: bool = False, prefix=None, params=None):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout, prefix=prefix, params=params)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCHW",
                 ceil_mode: bool = False, prefix=None, params=None):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, prefix=prefix, params=params)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCDHW",
                 ceil_mode: bool = False, prefix=None, params=None):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout, prefix=prefix, params=params)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCW",
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 prefix=None, params=None):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCHW",
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 prefix=None, params=None):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad,
                         prefix=prefix, params=params)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size: IntTuple = 2, strides=None,
                 padding: IntTuple = 0, layout: str = "NCDHW",
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 prefix=None, params=None):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad,
                         prefix=prefix, params=params)


class _GlobalPool(_Pooling):
    def __init__(self, pool_type, n, layout, prefix=None, params=None):
        super().__init__((1,) * n, (1,) * n, 0, False, True, pool_type,
                         layout, prefix=prefix, params=params)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout: str = "NCW", prefix=None, params=None):
        super().__init__("max", 1, layout, prefix=prefix, params=params)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout: str = "NCHW", prefix=None, params=None):
        super().__init__("max", 2, layout, prefix=prefix, params=params)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout: str = "NCDHW", prefix=None, params=None):
        super().__init__("max", 3, layout, prefix=prefix, params=params)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout: str = "NCW", prefix=None, params=None):
        super().__init__("avg", 1, layout, prefix=prefix, params=params)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout: str = "NCHW", prefix=None, params=None):
        super().__init__("avg", 2, layout, prefix=prefix, params=params)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout: str = "NCDHW", prefix=None, params=None):
        super().__init__("avg", 3, layout, prefix=prefix, params=params)
