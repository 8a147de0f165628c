"""Recurrent cells, from ``mxnet_tpu/gluon/rnn/rnn_cell.py``: one step
each (``RNNCell``, ``LSTMCell`` with gates [i, f, c, o], ``GRUCell``
with [r, z, n]), the containers and modifiers (``SequentialRNNCell``,
``DropoutCell``, ``ZoneoutCell``, ``ResidualCell``,
``BidirectionalCell``) and ``unroll`` over a sequence, with
``merge_outputs`` and ``valid_length`` (outputs past a sequence's length
zeroed, the states those of its last valid step).

A cell steps as ``cell(x, states) -> (output, new states)`` on tensors,
or on NDArrays by MXNet's call convention (``gluon.block``); ``unroll``
takes either too, an array in ``layout`` (``NTC`` or ``TNC``) or a list
of per-step arrays.  Weights are Gluon-named (``i2h_weight``,
``h2h_weight``, ``i2h_bias``, ``h2h_bias`` under the cell's prefix);
``input_size`` 0 is inferred at the first step.  ``DropoutCell`` and
``ZoneoutCell`` draw their masks in training mode (the module's, which
follows ``autograd``'s under an NDArray call).

Neither package steps a cell, a stack or an ``unroll`` on Symbols: the
JAX cell reads its input's context and ``unroll`` its shape, which a
Symbol lacks, so both raise there, and a cell's one body is its
``forward``.  ``unroll`` inside a hybridized block runs eagerly through
its ``CachedOp``.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import indexing as _indexing
from ...ops import nn as _ops
from ..block import Block, HybridBlock, _arrays_in
from ..nn.basic_layers import weight_tensor

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(inputs, layout):
    """(per-step list, time axis, batch size) of a merged tensor or a
    list of step tensors."""
    assert layout in ("NTC", "TNC")
    axis = layout.find("T")
    if isinstance(inputs, torch.Tensor):
        batch = inputs.shape[layout.find("N")]
        return list(inputs.unbind(axis)), axis, batch
    return list(inputs), axis, inputs[0].shape[0]


def _activation(x, activation):
    if isinstance(activation, str):
        return _ops.activation(x, activation)
    return activation(x)


class RecurrentCell(Block):
    """The base cell: ``state_info``, ``begin_state`` and ``unroll``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``nd.zeros`` unless ``func``; pass
        ``ctx=``)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        from ... import ndarray as nd

        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **{**info, **kwargs}))
        return states

    def _zero_states(self, batch, like):
        return [torch.zeros(info["shape"], dtype=like.dtype,
                            device=like.device)
                for info in self.state_info(batch)]

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step through ``length`` steps: (outputs, final states).  Outputs
        are a list of steps, or one array stacked on the time axis with
        ``merge_outputs`` (and whenever ``valid_length`` is given, unless
        ``merge_outputs`` is False)."""
        run = lambda x, s, v: self._unroll(length, x, s, layout,  # noqa
                                           merge_outputs, v)
        if _arrays_in([inputs, begin_state]):
            return self._call_nd((inputs, begin_state, valid_length), {},
                                 run=run)
        return run(inputs, begin_state, valid_length)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        steps, axis, batch = _format_sequence(inputs, layout)
        states = (list(begin_state) if begin_state is not None
                  else self._zero_states(batch, steps[0]))
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [_indexing.sequence_last(
                torch.stack(ele, 0), valid_length, use_sequence_length=True,
                axis=0) for ele in zip(*all_states)]
            outputs = _indexing.sequence_mask(
                torch.stack(outputs, axis), valid_length,
                use_sequence_length=True, axis=axis)
            if merge_outputs is False:
                outputs = list(outputs.unbind(axis))
        elif merge_outputs:
            outputs = torch.stack(outputs, axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is a ``forward(x, states)`` on tensors (or, for
    the contrib cells, ``hybrid_forward`` over the port's ``F`` ops).  A
    Symbol step has no graph: the JAX cell reads its input's context
    first, which a Symbol lacks, and so raises; this one raises the same
    error."""

    def __call__(self, inputs, states):
        self._counter += 1
        return HybridBlock.__call__(self, inputs, states)

    def _call_symbol(self, *args, **kwargs):
        raise AttributeError(
            f"{type(self).__name__} steps on arrays only: a Symbol has no "
            "context, which the cell reads (as the JAX cell does)")

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class _GatedCell(HybridRecurrentCell):
    """The i2h / h2h weights of ``gates`` x ``hidden_size`` rows."""

    def __init__(self, hidden_size, gates, input_size, inits, prefix,
                 params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = gates
        n = gates * hidden_size
        shapes = {"i2h_weight": (n, input_size),
                  "h2h_weight": (n, hidden_size), "i2h_bias": (n,),
                  "h2h_bias": (n,)}
        for (name, shape), init in zip(shapes.items(), inits):
            setattr(self, name, weight_tensor(shape))
            self._gluon_param(name, shape=shape, init=init,
                              allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self._reg_params["i2h_weight"]._set_shape_if_deferred(
            (self._gates * self._hidden_size, int(x.shape[-1])))

    def _projections(self, x, h):
        self._finish_deferred(x)
        i2h = _ops.fully_connected(x, self.i2h_weight, self.i2h_bias,
                                   num_hidden=self.i2h_weight.shape[0])
        h2h = _ops.fully_connected(h, self.h2h_weight, self.h2h_bias,
                                   num_hidden=self.h2h_weight.shape[0])
        return i2h, h2h


class RNNCell(_GatedCell):
    """Elman cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, 1, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = _activation(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates [i, f, c, o]."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(hidden_size, 4, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def _alias(self):
        return "lstm"

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        i, f, c, o = (i2h + h2h).chunk(4, dim=1)
        rec = self._recurrent_activation
        next_c = (_activation(f, rec) * states[1]
                  + _activation(i, rec) * _activation(c, self._activation))
        next_h = _activation(o, rec) * _activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates [r, z, n], r applied to h W_hn^T + b_hn."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, 3, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)

    def _alias(self):
        return "gru"

    def forward(self, inputs, states):
        h = states[0]
        i2h, h2h = self._projections(inputs, h)
        i_r, i_z, i_n = i2h.chunk(3, dim=1)
        h_r, h_z, h_n = h2h.chunk(3, dim=1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        next_h = (1.0 - z) * n + z * h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells applied in turn at each step; the states are theirs in
    order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(), **kwargs)

    def forward(self, inputs, states):
        next_states, p = [], 0
        for cell in self._modules.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step's input in training mode; no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = _ops.dropout(inputs, p=self._rate, axes=self._axes,
                                  training=self.training)
        return inputs, states


class _ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        assert not base_cell._modified, "Cell cannot be modified twice"
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(_ModifierCell):
    """In training, keep each unit's previous output (state) with
    probability ``zoneout_outputs`` (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not self.training:
            return next_output, next_states

        def mask(p, like):
            return _ops.dropout(torch.ones_like(like), p=p, training=True)

        prev = self._prev_output
        if prev is None:
            prev = torch.zeros_like(next_output)
        output = (torch.where(mask(self.zoneout_outputs, next_output) != 0,
                              next_output, prev)
                  if self.zoneout_outputs != 0.0 else next_output)
        new_states = ([torch.where(mask(self.zoneout_states, new) != 0, new,
                                   old)
                       for new, old in zip(next_states, states)]
                      if self.zoneout_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """A left-to-right and a right-to-left cell over one sequence, their
    outputs concatenated; it unrolls only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def _alias(self):
        return "bi"

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(), **kwargs)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        steps, axis, batch = _format_sequence(inputs, layout)
        states = (list(begin_state) if begin_state is not None
                  else self._zero_states(batch, steps[0]))
        l_cell, r_cell = self._modules.values()
        n_l = len(l_cell.state_info(batch))
        l_outputs, l_states = l_cell._unroll(
            length, steps, states[:n_l], layout, merge_outputs, valid_length)
        if valid_length is not None:
            rev = _indexing.sequence_reverse(
                torch.stack(steps, 0), valid_length,
                use_sequence_length=True, axis=0)
            r_inputs = list(rev.unbind(0))
        else:
            r_inputs = list(reversed(steps))
        r_outputs, r_states = r_cell._unroll(
            length, r_inputs, states[n_l:], layout, False, valid_length)
        if valid_length is not None:
            r_outputs = list(_indexing.sequence_reverse(
                torch.stack(r_outputs, 0), valid_length,
                use_sequence_length=True, axis=0).unbind(0))
        else:
            r_outputs = list(reversed(r_outputs))
        l_list = (list(l_outputs.unbind(axis))
                  if isinstance(l_outputs, torch.Tensor) else l_outputs)
        outputs = [torch.cat([lo, ro], 1)
                   for lo, ro in zip(l_list, r_outputs)]
        if merge_outputs:
            outputs = torch.stack(outputs, axis)
        return outputs, l_states + r_states
