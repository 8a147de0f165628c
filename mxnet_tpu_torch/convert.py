"""Carry weights from the JAX package into the port, by Gluon name.

``from_mxnet_tpu_params(model, params, prefix)`` takes a dict of numpy
arrays keyed by Gluon parameter names — what
``{k: p.data().asnumpy() for k, p in net.collect_params().items()}``
gives for a ``mxnet_tpu`` net — and loads them into the port's
``state_dict``.  numpy is the only currency, so the port never imports
``mxnet_tpu``.

Names map segment by segment: the net's own ``prefix`` is stripped, each
module path step takes its Gluon prefix from the model family's segment
map (the top-level module's ``gluon_segments``; a segment the map does
not name is its own prefix), ``layers.3`` is ``layer3``, and a
LayerNorm's or BatchNorm's ``weight``/``bias`` are Gluon's
``gamma``/``beta``.  A module that carries a ``gluon_prefix`` (the layers
of ``models.resnet``, which reproduce Gluon's per-scope counters:
``stage1_conv2d3_``) is named by it instead of by its path, and a module
with a ``from_gluon(leaf, tensor)`` hook turns the Gluon layout into its
own (an NHWC convolution's ``(O, kh, kw, I)`` weight into torch's
OIHW).  For the seq2seq ``Transformer`` (``encoder`` -> ``enc``, ``self_attn`` ->
``self``, ``q_proj`` -> ``q``, ``ffn_1`` -> ``ffn1``, ...)
``decoder.layers.0.self_attn.qkv.weight`` is
``<prefix>dec_layer0_self_qkv_weight``; for BERT (``token_type_embed`` ->
``type_embed``, ``ffn_1`` -> ``ffn1``, ``ffn_2`` -> ``ffn2``)
``bert.encoder.layers.1.ln2.weight`` is
``<prefix>bert_encoder_layer1_ln2_gamma`` and ``decoder.weight`` is
``<prefix>decoder_weight``.

``gluon_shape`` and ``from_gluon_layout`` give a parameter's Gluon shape
(where initializers take their fans) and turn a Gluon-layout array into
the port's layout; they, and ``gluon_name``, find the owning module in
one place, ``_owner``.  A numpy bfloat16 array loads bit for bit
(``base.tensor_from_numpy``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError, tensor_from_numpy
from .gluon.nn import BatchNorm, LayerNorm

__all__ = ["gluon_name", "gluon_shape", "from_gluon_layout",
           "from_mxnet_tpu_params"]

_NORM_LEAF = {"weight": "gamma", "bias": "beta"}


def _owner(model: torch.nn.Module, key: str):
    """(path, module, leaf) of ``state_dict`` key ``key``: the module
    that holds it and the tensor's own name."""
    *path, leaf = key.split(".")
    return path, model.get_submodule(".".join(path)), leaf


def gluon_name(model: torch.nn.Module, key: str) -> str:
    """The Gluon name (without the net's prefix) of ``state_dict`` key
    ``key`` of ``model``."""
    path, module, leaf = _owner(model, key)
    if isinstance(module, (LayerNorm, BatchNorm)):
        leaf = _NORM_LEAF.get(leaf, leaf)
    prefix = getattr(module, "gluon_prefix", None)
    if prefix is not None:
        return prefix + leaf
    segments = getattr(model, "gluon_segments", {})
    parts = []
    for i, seg in enumerate(path):
        if seg.isdigit() and parts and path[i - 1] == "layers":
            parts[-1] = f"layer{seg}"
        else:
            parts.append(segments.get(seg, seg))
    return "_".join(parts + [leaf])


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
