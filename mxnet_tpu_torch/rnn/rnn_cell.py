"""Symbolic RNN cells (counterpart of ``mxnet_tpu/rnn/rnn_cell.py``).

Each cell is a small factory of registry ops; ``unroll`` builds the whole
sequence graph in python, which the symbolic executor runs node by node,
and ``FusedRNNCell`` maps onto the ``RNN`` op (cuDNN's fused recurrence on
the card, torch's on the CPU).  Gate orders are cuDNN's: LSTM [i, f, c, o],
GRU [r, z, o].  The flat parameter vector of ``FusedRNNCell`` is laid out by
``ops.rnn_ops.rnn_packed_layout``, which the ``RNN`` op and shape inference
share; ``unpack_weights`` / ``pack_weights`` convert it to per-gate arrays
named as the unfused cells' (``lstm_l0_i2h_i_weight``).
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError


def _np_prod(shape):
    return int(_np.prod(shape)) if shape else 1

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Container for hold-and-share cell parameters (reference ~L40)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        from .. import symbol

        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract RNN cell (reference BaseRNNCell ~L80)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states.  Default: free Variables named
        ``{prefix}begin_state_{i}`` (bind them, or let ``unroll`` derive
        zero states from the inputs — the common path)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        from .. import symbol

        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is None:
                state = symbol.Variable(
                    f"{self._prefix}begin_state_{self._init_counter}")
            else:
                state = func(
                    name=f"{self._prefix}begin_state_{self._init_counter}",
                    **{k: v for k, v in dict(info, **kwargs).items()
                       if k not in ("__layout__",)})
            states.append(state)
        return states

    def _zeros_states(self, first_input, batch_axis=0):
        """Zero initial states derived from an input symbol's batch dim
        (in place of the reference's shape-0 zeros)."""
        F = _infer_ns(first_input)
        states = []
        for info in self.state_info:
            num_hidden = info["shape"][-1]
            states.append(F._begin_state_zeros(first_input,
                                               num_hidden=num_hidden,
                                               batch_axis=batch_axis))
        return states

    def unpack_weights(self, args):
        """Unpack fused packed weights into per-gate arrays
        (reference ~L200)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ("i2h", "h2h"):
            weight = args.pop(f"{self._prefix}{group_name}_weight")
            bias = args.pop(f"{self._prefix}{group_name}_bias")
            for j, gate in enumerate(self._gate_names):
                wname = f"{self._prefix}{group_name}{gate}_weight"
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = f"{self._prefix}{group_name}{gate}_bias"
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference ~L230)."""
        from .. import ndarray as nd

        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ("i2h", "h2h"):
            weight = []
            bias = []
            for gate in self._gate_names:
                weight.append(args.pop(f"{self._prefix}{group_name}{gate}_weight"))
                bias.append(args.pop(f"{self._prefix}{group_name}{gate}_bias"))
            args[f"{self._prefix}{group_name}_weight"] = nd.Concat(
                *weight, dim=0)
            args[f"{self._prefix}{group_name}_bias"] = nd.Concat(
                *bias, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell over `length` steps (reference ~L260)."""
        self.reset()
        inputs, axis, F = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._zeros_states(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs is True:
            outputs, _, _ = _normalize_sequence(length, outputs, layout,
                                                True)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        F = _infer_ns(inputs)
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _infer_ns(x):
    """mx.sym or mx.nd, depending on the value flowing through the cell."""
    from .. import ndarray as nd
    from .. import symbol as sym
    from ..symbol.symbol import Symbol

    return sym if isinstance(x, Symbol) else nd


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """list <-> merged-tensor conversion for unroll IO (reference ~L700)."""
    assert layout in ("NTC", "TNC"), f"invalid layout {layout}"
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        F = _infer_ns(inputs[0])
        assert len(inputs) == length
        if merge is True:
            seq = [F.expand_dims(i, axis=axis) for i in inputs]
            return F.Concat(*seq, dim=axis), axis, F
        return list(inputs), axis, F
    F = _infer_ns(inputs)
    in_axis = in_layout.find("T") if in_layout else axis
    if merge is False:
        outs = F.SliceChannel(inputs, num_outputs=length, axis=in_axis,
                              squeeze_axis=True)
        # nd returns a list; sym returns a multi-output Symbol
        outs = list(outs) if length > 1 else [outs]
        return outs, axis, F
    # merge True, or None (no preference): keep the merged tensor
    if in_axis != axis:
        inputs = F.SwapAxis(inputs, dim1=0, dim2=1)
    return inputs, axis, F


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference ~L450)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        F = _infer_ns(inputs)
        name = f"{self._prefix}t{self._counter}_"
        i2h = F.FullyConnected(inputs, self._iW, self._iB,
                               num_hidden=self._num_hidden,
                               name=f"{name}i2h")
        h2h = F.FullyConnected(states[0], self._hW, self._hB,
                               num_hidden=self._num_hidden,
                               name=f"{name}h2h")
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, cuDNN gate order [i, f, g, o] (reference ~L500)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias

        self._iW = self.params.get("i2h_weight")
        # forget-gate bias starts at forget_bias (Module.init_params honors
        # the Variable's init attr; reference LSTMCell does the same)
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        F = _infer_ns(inputs)
        name = f"{self._prefix}t{self._counter}_"
        i2h = F.FullyConnected(inputs, self._iW, self._iB,
                               num_hidden=self._num_hidden * 4,
                               name=f"{name}i2h")
        h2h = F.FullyConnected(states[0], self._hW, self._hB,
                               num_hidden=self._num_hidden * 4,
                               name=f"{name}h2h")
        gates = i2h + h2h
        sliced = F.SliceChannel(gates, num_outputs=4, axis=-1,
                                name=f"{name}slice")
        in_gate = F.Activation(sliced[0], act_type="sigmoid")
        forget_gate = F.Activation(sliced[1], act_type="sigmoid")
        in_transform = F.Activation(sliced[2], act_type="tanh")
        out_gate = F.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order [r, z, n] (reference ~L600)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        F = _infer_ns(inputs)
        name = f"{self._prefix}t{self._counter}_"
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, self._iW, self._iB,
                               num_hidden=self._num_hidden * 3,
                               name=f"{name}i2h")
        h2h = F.FullyConnected(prev_h, self._hW, self._hB,
                               num_hidden=self._num_hidden * 3,
                               name=f"{name}h2h")
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN backed by the scan-based ``RNN`` op
    (reference FusedRNNCell ~L700: the cuDNN path)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._parameters = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _zeros_states(self, first_input, batch_axis=0):
        """batch_axis: 0 when given a per-step (B, C) slice (stacked
        inside SequentialRNNCell), 1 when given the merged TNC tensor."""
        F = _infer_ns(first_input)
        dirs = 2 if self._bidirectional else 1
        states = []
        for _ in range(2 if self._mode == "lstm" else 1):
            states.append(F._begin_state_zeros_layers(
                first_input, num_hidden=self._num_hidden,
                num_layers=self._num_layers * dirs,
                batch_axis=batch_axis))
        return states

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped; use unroll")

    def _slice_plan(self, input_size):
        """(name, offset, shape) for every per-gate array inside the flat
        vector, derived from the shared rnn_packed_layout (the single
        source of truth also used by the RNN op and shape inference)."""
        from ..ops.rnn_ops import rnn_packed_layout

        H = self._num_hidden
        dnames = ("l", "r")
        entries, total = rnn_packed_layout(
            self._mode, input_size, H, self._num_layers,
            self._bidirectional)
        plan = []
        for layer, d, group, kind, off, shape in entries:
            cols = shape[1] if kind == "weight" else None
            per_gate = H * cols if kind == "weight" else H
            for g, gate in enumerate(self._gate_names):
                gshape = (H, cols) if kind == "weight" else (H,)
                plan.append((f"{self._prefix}{dnames[d]}{layer}_{group}"
                             f"{gate}_{kind}", off + g * per_gate, gshape))
        return plan, total

    def _input_size_from(self, total):
        """Solve the layer-0 input size from the flat vector length: the
        total is affine in the input size."""
        from ..ops.rnn_ops import rnn_packed_layout

        _, t0 = rnn_packed_layout(self._mode, 0, self._num_hidden,
                                  self._num_layers, self._bidirectional)
        _, t1 = rnn_packed_layout(self._mode, 1, self._num_hidden,
                                  self._num_layers, self._bidirectional)
        slope = t1 - t0
        assert (total - t0) % slope == 0, \
            f"flat parameter size {total} inconsistent with cell config"
        return (total - t0) // slope

    def unpack_weights(self, args):
        args = dict(args)
        name = f"{self._prefix}parameters"
        if name not in args:
            return args
        arr = args.pop(name)
        plan, _ = self._slice_plan(self._input_size_from(arr.shape[0]))
        for pname, off, shape in plan:
            n = int(_np_prod(shape))
            args[pname] = arr[off:off + n].reshape(shape).copy()
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd

        args = dict(args)
        probe = f"{self._prefix}l0_i2h{self._gate_names[0]}_weight"
        if probe not in args:
            return args
        input_size = args[probe].shape[1]
        plan, total = self._slice_plan(input_size)
        flat = [args.pop(pname).reshape((-1,)) for pname, _, _ in plan]
        args[f"{self._prefix}parameters"] = nd.Concat(*flat, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if self._dropout > 0 and self._num_layers > 1:
            import warnings

            warnings.warn(
                "FusedRNNCell: inter-layer dropout is not applied on the "
                "symbolic fused path (the RNN op draws no mask); unfuse() "
                "for training-time dropout", stacklevel=2)
        inputs, _, F = _normalize_sequence(length, inputs, "TNC", True,
                                           in_layout=layout)
        if begin_state is None:
            begin_state = self._zeros_states(inputs, batch_axis=1)
        states = list(begin_state)
        outs = F.RNN(inputs, self._parameters, *states,
                     state_size=self._num_hidden,
                     num_layers=self._num_layers, mode=self._mode,
                     bidirectional=self._bidirectional, p=self._dropout,
                     state_outputs=True,
                     name=f"{self._prefix}rnn")
        outputs, hN = outs[0], outs[1]
        states = [hN, outs[2]] if self._mode == "lstm" else [hN]
        if layout == "NTC":
            outputs = F.SwapAxis(outputs, dim1=0, dim2=1)
        outputs, _, _ = _normalize_sequence(length, outputs, layout,
                                            merge_outputs)
        if self._get_next_state:
            return outputs, states
        return outputs, []

    def unfuse(self):
        """Equivalent stack of unfused cells (reference ~L880)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pre),
            "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pre),
            "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
            "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order (reference ~L950)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def _zeros_states(self, first_input, batch_axis=0):
        return sum((c._zeros_states(first_input, batch_axis)
                    for c in self._cells), [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            first, _, _ = _normalize_sequence(length, inputs, layout, False)
            begin_state = self._zeros_states(first[0])
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cell over the sequence (reference ~L1050)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def _zeros_states(self, first_input, batch_axis=0):
        return sum((c._zeros_states(first_input, batch_axis)
                    for c in self._cells), [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis, F = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._zeros_states(inputs[0])
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        outputs = [F.Concat(l_o, r_o, dim=1,
                            name=f"{self._output_prefix}t{i}")
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        outputs, _, _ = _normalize_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference ~L1150)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def _zeros_states(self, first_input, batch_axis=0):
        self.base_cell._modified = False
        states = self.base_cell._zeros_states(first_input, batch_axis)
        self.base_cell._modified = True
        return states

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on the outputs (reference ~L1120)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            F = _infer_ns(inputs)
            inputs = F.Dropout(inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization on states (reference ~L1200)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        F = _infer_ns(inputs)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([F.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the output (reference ~L1260)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states
