"""The contrib recurrent cells, from ``mxnet_tpu/gluon/contrib/rnn.py``:
the convolutional recurrences ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``,
``VariationalDropoutCell`` and ``LSTMPCell``.

Each is a ``HybridRecurrentCell`` (``gluon.rnn``) whose step is the JAX
cell's ``hybrid_forward`` over the port's ops: the conv cells'
i2h and h2h gates are N-d ``Convolution`` ops (cuDNN on the card),
``LSTMPCell``'s are ``FullyConnected``.  Weights carry the JAX cells'
Gluon names (``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``,
``h2r_weight``), so ``convert.py`` or ``save_parameters`` carries them.
``VariationalDropoutCell`` draws one mask for inputs, states and outputs
per ``unroll`` (``reset`` clears them) in training mode (the module's,
which follows ``autograd``'s under an NDArray call).  No kernel of the
port is on this path.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import nn as _ops
from ..rnn.rnn_cell import HybridRecurrentCell, _ModifierCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]


def _tuplify(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    """The convolutional recurrence: ``input_shape`` (C, *spatial) is
    given up front, since the state's spatial extent sizes the h2h
    weights and ``begin_state``; h2h kernels are odd and padded to keep
    the state's shape."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, activation, prefix=None, params=None, conv_dims=2,
                 num_gates=1):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._conv_dims = conv_dims
        self._num_gates = num_gates
        self._activation = activation
        self._i2h_kernel = _tuplify(i2h_kernel, conv_dims)
        self._h2h_kernel = _tuplify(h2h_kernel, conv_dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h_kernel dims must be odd to preserve "
                                 f"the state shape, got {self._h2h_kernel}")
        self._i2h_pad = _tuplify(i2h_pad, conv_dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        in_c, spatial = self._input_shape[0], self._input_shape[1:]
        self._state_shape = (hidden_channels,) + tuple(
            s + 2 * p - k + 1
            for s, p, k in zip(spatial, self._i2h_pad, self._i2h_kernel))
        n = num_gates * hidden_channels
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(n, in_c) + self._i2h_kernel)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(n, hidden_channels) + self._h2h_kernel)
            self.i2h_bias = self.params.get("i2h_bias", shape=(n,),
                                            init="zeros")
            self.h2h_bias = self.params.get("h2h_bias", shape=(n,),
                                            init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[-self._conv_dims:]}]

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        n = self._num_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=n)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=n)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, activation="tanh", prefix=None, params=None,
                 conv_dims=2):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix=prefix,
                         params=params, conv_dims=conv_dims, num_gates=1)

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, activation="tanh", prefix=None, params=None,
                 conv_dims=2):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix=prefix,
                         params=params, conv_dims=conv_dims, num_gates=4)

    def _alias(self):
        return "conv_lstm"

    def state_info(self, batch_size=0):
        info = super().state_info(batch_size)
        return info + [dict(info[0])]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i, f, c, o = F.split(i2h + h2h, num_outputs=4, axis=1)
        next_c = (F.Activation(f, act_type="sigmoid") * states[1]
                  + F.Activation(i, act_type="sigmoid")
                  * self._get_activation(F, c, self._activation))
        next_h = (F.Activation(o, act_type="sigmoid")
                  * self._get_activation(F, next_c, self._activation))
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, activation="tanh", prefix=None, params=None,
                 conv_dims=2):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix=prefix,
                         params=params, conv_dims=conv_dims, num_gates=3)

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i_r, i_z, i_n = F.split(i2h, num_outputs=3, axis=1)
        h_r, h_z, h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i_r + h_r, act_type="sigmoid")
        update = F.Activation(i_z + h_z, act_type="sigmoid")
        next_h_tmp = self._get_activation(F, i_n + reset * h_n,
                                          self._activation)
        next_h = (1.0 - update) * next_h_tmp + update * states[0]
        return next_h, [next_h]


def _make_conv_cell(base, dims, kind):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, activation="tanh",
                     prefix=None, params=None):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad=i2h_pad,
                             activation=activation, prefix=prefix,
                             params=params, conv_dims=dims)

    Cell.__name__ = Cell.__qualname__ = f"Conv{dims}D{kind}Cell"
    Cell.__doc__ = f"{dims}-D convolutional {kind} cell."
    return Cell


Conv1DRNNCell = _make_conv_cell(_ConvRNNCell, 1, "RNN")
Conv2DRNNCell = _make_conv_cell(_ConvRNNCell, 2, "RNN")
Conv3DRNNCell = _make_conv_cell(_ConvRNNCell, 3, "RNN")
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMCell, 1, "LSTM")
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMCell, 2, "LSTM")
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMCell, 3, "LSTM")
Conv1DGRUCell = _make_conv_cell(_ConvGRUCell, 1, "GRU")
Conv2DGRUCell = _make_conv_cell(_ConvGRUCell, 2, "GRU")
Conv3DGRUCell = _make_conv_cell(_ConvGRUCell, 3, "GRU")


class VariationalDropoutCell(_ModifierCell):
    """The same dropout mask at every step of an unroll, on the inputs,
    the first state and the outputs (Gal & Ghahramani); the masks are
    drawn at the first step in training mode and cleared by
    ``reset``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._masks = {}

    def _mask(self, p, like, kind):
        if kind not in self._masks:
            self._masks[kind] = _ops.dropout(like.new_ones(like.shape), p=p,
                                             training=True)
        return self._masks[kind]

    def forward(self, inputs, states):
        if self.training and self.drop_inputs:
            inputs = inputs * self._mask(self.drop_inputs, inputs, "inputs")
        if self.training and self.drop_states:
            mask = self._mask(self.drop_states, states[0], "states")
            states = [states[0] * mask] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.training and self.drop_outputs:
            output = output * self._mask(self.drop_outputs, output,
                                         "outputs")
        return output, states


class LSTMPCell(HybridRecurrentCell):
    """LSTM whose output and recurrent state are a learned projection of
    the hidden state: r = W_r (o * tanh(c)), states [r, c]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        n = 4 * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(n, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(n, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(n,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(n,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, x, *args):
        self._reg_params["i2h_weight"]._set_shape_if_deferred(
            (4 * self._hidden_size, int(x.shape[-1])))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        n = 4 * self._hidden_size
        gates = (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n)
                 + F.FullyConnected(states[0], h2h_weight, h2h_bias,
                                    num_hidden=n))
        i, f, c, o = F.split(gates, num_outputs=4, axis=1)
        next_c = (F.Activation(f, act_type="sigmoid") * states[1]
                  + F.Activation(i, act_type="sigmoid")
                  * F.Activation(c, act_type="tanh"))
        hidden = (F.Activation(o, act_type="sigmoid")
                  * F.Activation(next_c, act_type="tanh"))
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
