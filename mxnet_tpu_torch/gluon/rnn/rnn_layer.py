"""The fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``, from
``mxnet_tpu/gluon/rnn/rnn_layer.py``, over the ``_fused_rnn`` op
(``ops/rnn_ops.py``: torch's fused recurrence, cuDNN on the card).

Each layer holds its weights under Gluon's names, as torch attributes and
as Gluon Parameters alike: ``{l,r}{i}_{i2h,h2h}_{weight,bias}`` (``l``
the forward direction, ``r`` the reverse), so ``convert.py`` carries a
JAX layer's weights by name.  ``input_size`` 0 is inferred at the first
call.  ``layout`` is ``TNC`` (default) or ``NTC``.  Called without
states, a layer starts from zeros and returns the output alone; with
states (a list: [h] or, for LSTM, [h, c], each (layers * directions, N,
hidden)) it returns (output, new states).  Dropout ``dropout`` falls
between layers in training mode, drawn from the device's generator.
Neither package runs a layer on Symbols (the JAX layer reads its
input's shape and context), so both raise there.
"""
from __future__ import annotations

import torch

from ...ops.rnn_ops import _fused_rnn
from ..block import HybridBlock
from ..nn.basic_layers import weight_tensor

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC', 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        inits = {"i2h_weight": i2h_weight_initializer,
                 "h2h_weight": h2h_weight_initializer,
                 "i2h_bias": i2h_bias_initializer,
                 "h2h_bias": h2h_bias_initializer}
        for i in range(num_layers):
            for j in self._directions():
                shapes = {"i2h_weight": (ng * nh, ni),
                          "h2h_weight": (ng * nh, nh),
                          "i2h_bias": (ng * nh,), "h2h_bias": (ng * nh,)}
                for kind, shape in shapes.items():
                    name = f"{j}{i}_{kind}"
                    setattr(self, name, weight_tensor(shape))
                    self._gluon_param(name, shape=shape, init=inits[kind],
                                      allow_deferred_init=True)
            ni = nh * self._dir

    def _directions(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def _weights(self):
        """Per layer, per direction: i2h_w, h2h_w, i2h_b, h2h_b."""
        return [getattr(self, f"{j}{i}_{kind}")
                for i in range(self._num_layers) for j in self._directions()
                for kind in ("i2h_weight", "h2h_weight", "i2h_bias",
                             "h2h_bias")]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (NDArrays, ``nd.zeros`` unless ``func`` is given;
        pass ``ctx=``)."""
        from ... import ndarray as nd

        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **{**info, **kwargs}))
        return states

    def infer_shape(self, x, *args):
        ni = int(x.shape[-1])
        ng, nh = self._gates, self._hidden_size
        for j in self._directions():
            self._reg_params[f"{j}0_i2h_weight"]._set_shape_if_deferred(
                (ng * nh, ni))

    def forward(self, inputs, states=None):
        self._finish_deferred(inputs)
        skip_states = states is None
        if skip_states:
            n = inputs.shape[self._layout.find("N")]
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(n)]
        elif isinstance(states, torch.Tensor):
            states = [states]
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        state_c = (states[1] if self._mode == "lstm"
                   else torch.zeros_like(states[0]))
        outs = _fused_rnn(x.contiguous(), states[0], state_c,
                          *self._weights(), mode=self._mode,
                          state_size=self._hidden_size,
                          num_layers=self._num_layers,
                          bidirectional=self._dir == 2, p=self._dropout,
                          training=self.training)
        out = outs[0].transpose(0, 1) if self._layout == "NTC" else outs[0]
        return out if skip_states else (out, list(outs[1:]))

    def _call_symbol(self, *args, **kwargs):
        raise AttributeError(
            f"{type(self).__name__} runs on arrays only: a Symbol has no "
            "shape or context, which the layer reads (as the JAX layer "
            "does)")


class RNN(_RNNLayer):
    """Elman RNN layer, ``activation`` relu or tanh."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation,
                         prefix=prefix, params=params)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", prefix=prefix,
                         params=params)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", prefix=prefix,
                         params=params)
