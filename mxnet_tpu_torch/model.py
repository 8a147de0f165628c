"""Checkpoint helpers (counterpart of ``mxnet_tpu/model.py``):
``{prefix}-symbol.json`` plus ``{prefix}-{epoch:04d}.params`` with ``arg:`` /
``aux:`` keys, through ``nd.save`` / ``nd.load``, whose file format is the
JAX package's, so checkpoints cross between the packages both ways."""
from __future__ import annotations

import json
from collections import namedtuple

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params"]

# `loss` (default None) may carry a lazy loss handle (an unforced device
# array): callbacks force it only at their display cadence (Speedometer
# does), never every batch, since forcing is a host round trip.
BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals",
                            "loss"])
BatchEndParam.__new__.__defaults__ = (None,)


def save_checkpoint(prefix, epoch, symbol=None, arg_params=None,
                    aux_params=None, remove_amp_cast=True):
    """Write {prefix}-symbol.json + {prefix}-{epoch:04d}.params."""
    from . import ndarray as nd

    if symbol is not None:
        if hasattr(symbol, "save"):
            symbol.save(f"{prefix}-symbol.json")
        else:
            with open(f"{prefix}-symbol.json", "w") as f:
                json.dump({"format": "mxnet_tpu", "symbol": str(symbol)}, f)
    save_dict = {}
    for k, v in (arg_params or {}).items():
        save_dict[f"arg:{k}"] = v
    for k, v in (aux_params or {}).items():
        save_dict[f"aux:{k}"] = v
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch):
    from . import ndarray as nd

    save_dict = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Returns (symbol_or_None, arg_params, aux_params)."""
    symbol = None
    try:
        from . import symbol as sym_mod

        symbol = sym_mod.load(f"{prefix}-symbol.json")
    except Exception:
        symbol = None
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
