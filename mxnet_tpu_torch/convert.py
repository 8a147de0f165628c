"""Carry weights from the JAX package into the port, by Gluon name.

``from_mxnet_tpu_params(model, params, prefix)`` takes a dict of numpy
arrays keyed by Gluon parameter names — what
``{k: p.data().asnumpy() for k, p in net.collect_params().items()}``
gives for a ``mxnet_tpu`` net — and loads them into the port's
``state_dict``.  numpy is the only currency, so the port never imports
``mxnet_tpu``.

The port's models are Gluon blocks made in the JAX classes' name scopes,
so each tensor's Gluon name is the name of the Gluon ``Parameter`` that
wraps it (``gluon_name``, without the net's prefix):
``bert.encoder.layers.1.ln2.weight`` is ``<prefix>bert_encoder_layer1_ln2_gamma``,
``decoder.layers.0.self_attn.qkv.weight`` of the seq2seq ``Transformer``
``<prefix>dec_layer0_self_qkv_weight``.  A module with a
``from_gluon(leaf, tensor)`` hook turns the Gluon layout into its own (an
NHWC convolution's ``(O, kh, kw, I)`` weight into torch's OIHW).

``gluon_shape`` and ``from_gluon_layout`` give a parameter's Gluon shape
(where initializers take their fans) and turn a Gluon-layout array into
the port's layout; they, and ``gluon_name``, find the owning module in
one place, ``_owner``.  A numpy bfloat16 array loads bit for bit
(``base.tensor_from_numpy``).

For quantized serving, ``quant_thresholds_from_mxnet_tpu`` turns the JAX
package's calibrated activation thresholds, keyed by the layers' Gluon
names, into the port's ``{layer path: threshold}`` (what
``precision.QuantizedAdapter`` takes), and ``quant_buffers_from_mxnet_tpu``
loads a JAX adapter's quantized weight buffers (int8 weights, or int4
packed nibbles and f16 scales) into a port adapter's twins, so both int8
engines can be held to one calibration and one set of buffers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError, tensor_from_numpy

__all__ = ["gluon_name", "gluon_shape", "from_gluon_layout",
           "from_mxnet_tpu_params", "quant_thresholds_from_mxnet_tpu",
           "quant_buffers_from_mxnet_tpu"]


def _owner(model: torch.nn.Module, key: str):
    """(path, module, leaf) of ``state_dict`` key ``key``: the module
    that holds it and the tensor's own name."""
    *path, leaf = key.split(".")
    return path, model.get_submodule(".".join(path)), leaf


def gluon_name(model: torch.nn.Module, key: str) -> str:
    """The Gluon name (without ``model``'s prefix) of ``state_dict`` key
    ``key`` of ``model``: the name of the Gluon Parameter around it."""
    _, module, leaf = _owner(model, key)
    for param in getattr(module, "_reg_params", {}).values():
        if param._attr == leaf:
            prefix = getattr(model, "prefix", "")
            return (param.name[len(prefix):] if param.name.startswith(prefix)
                    else param.name)
    raise MXNetError(f"{key} is not wrapped by a Gluon Parameter")


def gluon_shape(model: torch.nn.Module, key: str, tensor: torch.Tensor):
    """The Gluon shape of ``state_dict`` key ``key`` (the owning module's
    ``gluon_shape`` hook; ``tensor``'s own shape without one)."""
    _, module, leaf = _owner(model, key)
    hook = getattr(module, "gluon_shape", None)
    return tuple(tensor.shape) if hook is None else hook(leaf)


def from_gluon_layout(model: torch.nn.Module, key: str,
                      value: torch.Tensor) -> torch.Tensor:
    """``value``, in the Gluon layout of ``state_dict`` key ``key``, in
    the port's layout (the owning module's ``from_gluon`` hook)."""
    _, module, leaf = _owner(model, key)
    hook = getattr(module, "from_gluon", None)
    return value if hook is None else hook(leaf, value)


def from_mxnet_tpu_params(model: torch.nn.Module,
                          params: Dict[str, np.ndarray], prefix: str) -> None:
    """Load Gluon-named numpy ``params`` into ``model`` in place.  Refuses
    missing or extra names and shape mismatches."""
    stripped = {}
    for name, value in params.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the net prefix "
                             f"{prefix!r}")
        stripped[name[len(prefix):]] = tensor_from_numpy(value)
    state = model.state_dict()
    by_gluon = {gluon_name(model, k): k for k in state}
    missing = sorted(set(by_gluon) - set(stripped))
    extra = sorted(set(stripped) - set(by_gluon))
    if missing or extra:
        raise MXNetError(f"parameter names disagree: missing {missing}, "
                         f"extra {extra}")
    new = {}
    for gname, key in by_gluon.items():
        value = from_gluon_layout(model, key, stripped[gname])
        if tuple(value.shape) != tuple(state[key].shape):
            raise MXNetError(f"{prefix}{gname}: shape "
                             f"{tuple(stripped[gname].shape)} does not fit "
                             f"{tuple(state[key].shape)} of {key}")
        new[key] = value.to(state[key].dtype)
    model.load_state_dict(new)


def _layers_by_name(model):
    """{Gluon name without ``model``'s prefix: (path, layer)} of the
    layers the serving rewrite quantizes."""
    from .precision.quantize import collect_quantizable

    prefix = getattr(model, "prefix", "")
    out = {}
    for path, layer in collect_quantizable(model):
        name = layer.name
        out[name[len(prefix):] if name.startswith(prefix) else name] = \
            (path, layer)
    return out


def _strip_prefix(names, prefix: str):
    out = {}
    for name, value in names.items():
        if not name.startswith(prefix):
            raise MXNetError(f"layer {name!r} lacks the net prefix "
                             f"{prefix!r}")
        out[name[len(prefix):]] = value
    return out


def quant_thresholds_from_mxnet_tpu(model: torch.nn.Module,
                                    thresholds: Dict[str, float],
                                    prefix: str) -> Dict[str, float]:
    """``{layer Gluon name: threshold}`` of the JAX package ->
    ``{layer path: threshold}`` of ``model``; ``prefix`` is the JAX net's.
    Refuses missing or extra layers."""
    by_name = _layers_by_name(model)
    got = _strip_prefix(thresholds, prefix)
    if set(got) != set(by_name):
        raise MXNetError(
            f"quantized layers disagree: missing "
            f"{sorted(set(by_name) - set(got))}, extra "
            f"{sorted(set(got) - set(by_name))}")
    return {by_name[n][0]: float(t) for n, t in got.items()}


def quant_buffers_from_mxnet_tpu(adapter, buffers: Dict[str, Dict],
                                 prefix: str) -> None:
    """Load ``{layer Gluon name: {buffer: numpy array}}`` -- the JAX
    twins' ``_qweight`` (int8), or ``_packed`` (uint8) and ``_scales``
    (f16) -- into the twins of the port adapter ``adapter`` in place,
    refusing a missing layer or a shape or dtype that differs."""
    by_name = _layers_by_name(adapter.model)
    for name, bufs in _strip_prefix(buffers, prefix).items():
        if name not in by_name:
            raise MXNetError(f"no quantized layer {prefix}{name}")
        impl = adapter._entries[id(by_name[name][1])]._impl
        for key, value in bufs.items():
            old = getattr(impl, key)
            new = torch.from_numpy(np.ascontiguousarray(value))
            if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
                raise MXNetError(
                    f"{prefix}{name}.{key}: {tuple(new.shape)} {new.dtype} "
                    f"does not fit {tuple(old.shape)} {old.dtype}")
            old.copy_(new)
