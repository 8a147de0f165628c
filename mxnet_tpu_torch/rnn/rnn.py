"""RNN checkpoint helpers (counterpart of ``mxnet_tpu/rnn/rnn.py``): model
checkpoints with fused cell weights unpacked, so that the files are
interchangeable between fused and unfused cell stacks.
"""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _as_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save a checkpoint with cell weights unpacked (reference rnn.py
    save_rnn_checkpoint)."""
    args = dict(arg_params)
    for cell in _as_list(cells):
        args = cell.unpack_weights(args)
    save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint, re-packing weights for the given cells."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback that saves unpacked checkpoints (reference
    rnn.py do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
