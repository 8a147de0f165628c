"""The fused multi-layer RNN, from ``mxnet_tpu/ops/rnn_ops.py``:
``_fused_rnn``, ``_begin_state_zeros``, ``_begin_state_zeros_layers`` and
``rnn_packed_layout``.

The JAX op runs a ``lax.scan`` per layer and direction.  The port calls
torch's fused recurrence (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``) one layer at a time, both directions in one call; on the
card that is cuDNN's RNN, MXNet's own backend (``cudnn_rnn-inl.h``).
The gate orders agree with torch's: LSTM [i, f, g, o], GRU [r, z, n]
with ``r`` applied to ``h W_hn^T + b_hn``.  cuDNN wants the weights of a
call in one buffer; torch copies them into one on each call (the layer's
Parameters stay separate tensors, carried by Gluon name).

Between layers, in training with ``p`` > 0, the port applies its own
``Dropout`` op (inverted scaling, drawn from ``generator``, by default
the device's), where the JAX op applies its mask: after every layer but
the last.  cuDNN's internal dropout is never used: it would draw from
torch's global CUDA generator state instead.  The JAX op takes a key
input for that mask; the port's takes the ``generator`` attribute
instead (``random_ops``).
"""
from __future__ import annotations

import warnings

import torch

from .registry import register

_VF_RNN = {"lstm": "lstm", "gru": "gru", "rnn_tanh": "rnn_tanh",
           "rnn_relu": "rnn_relu"}


def _layer(mode, xs, h0, c0, params, bidirectional):
    """One layer (both directions when ``bidirectional``) through torch's
    fused recurrence: (ys, hT, cT) with hT / cT (dirs, B, H)."""
    fn = getattr(torch._VF, _VF_RNN[mode])
    train = torch.is_grad_enabled()  # cuDNN keeps its reserve for backward
    hx = (h0, c0) if mode == "lstm" else h0
    with warnings.catch_warnings():
        # the copy into one buffer is this module's documented cost
        warnings.filterwarnings("ignore", message="RNN module weights")
        out = fn(xs, hx, params, True, 1, 0.0, train, bidirectional, False)
    return out if mode == "lstm" else (*out, None)


@register("_fused_rnn")
def _fused_rnn(data, state_h, state_c, *weights, mode="lstm", state_size=0,
               num_layers=1, bidirectional=False, p=0.0, training=False,
               state_outputs=True, generator=None):
    """Multi-layer (bi)directional RNN over TNC ``data``.

    ``weights``: per layer, per direction, i2h_w, h2h_w, i2h_b, h2h_b.
    ``state_h`` / ``state_c``: (num_layers * dirs, B, H) (``state_c`` is
    ignored but for LSTM).  Returns (out, h_n, c_n) for LSTM, else
    (out, h_n)."""
    from .nn import dropout

    dirs = 2 if bidirectional else 1
    xs = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        s = slice(layer * dirs, (layer + 1) * dirs)
        params = list(weights[layer * dirs * 4:(layer + 1) * dirs * 4])
        ys, hT, cT = _layer(mode, xs, state_h[s],
                            state_c[s] if mode == "lstm" else None, params,
                            bidirectional)
        h_out.append(hT)
        if mode == "lstm":
            c_out.append(cT)
        xs = ys
        if training and p > 0.0 and layer < num_layers - 1:
            xs = dropout(xs, p=p, training=True, generator=generator)
    h_n = torch.cat(h_out, dim=0)
    if mode == "lstm":
        return xs, h_n, torch.cat(c_out, dim=0)
    return xs, h_n


@register("_begin_state_zeros", differentiable=False)
def _begin_state_zeros(data, num_hidden=0, batch_axis=0):
    """Zero initial state (B, H), B from ``data``'s batch axis."""
    return torch.zeros((data.shape[int(batch_axis)], int(num_hidden)),
                       dtype=data.dtype, device=data.device)


@register("_begin_state_zeros_layers", differentiable=False)
def _begin_state_zeros_layers(data, num_hidden=0, num_layers=1,
                              batch_axis=1):
    """Zero initial state (L, B, H)."""
    return torch.zeros((int(num_layers), data.shape[int(batch_axis)],
                        int(num_hidden)), dtype=data.dtype,
                       device=data.device)


def rnn_packed_layout(mode, input_size, state_size, num_layers,
                      bidirectional):
    """The packed flat RNN parameter vector's layout: every weight,
    layer- then direction-major, i2h then h2h, then every bias in the
    same order (MXNet's ``GetRnnParamSize``).  Returns (entries, total),
    entries (layer, direction, 'i2h' | 'h2h', 'weight' | 'bias', offset,
    shape)."""
    gates = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}[mode]
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    entries = []
    off = 0
    for layer in range(int(num_layers)):
        inp = int(input_size) if layer == 0 else H * dirs
        for d in range(dirs):
            entries.append((layer, d, "i2h", "weight", off, (gates * H, inp)))
            off += gates * H * inp
            entries.append((layer, d, "h2h", "weight", off, (gates * H, H)))
            off += gates * H * H
    for layer in range(int(num_layers)):
        for d in range(dirs):
            entries.append((layer, d, "i2h", "bias", off, (gates * H,)))
            off += gates * H
            entries.append((layer, d, "h2h", "bias", off, (gates * H,)))
            off += gates * H
    return entries, off
