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
LayerNorm's ``weight``/``bias`` are Gluon's ``gamma``/``beta``.  For the
seq2seq ``Transformer`` (``encoder`` -> ``enc``, ``self_attn`` ->
``self``, ``q_proj`` -> ``q``, ``ffn_1`` -> ``ffn1``, ...)
``decoder.layers.0.self_attn.qkv.weight`` is
``<prefix>dec_layer0_self_qkv_weight``; for BERT (``token_type_embed`` ->
``type_embed``, ``ffn_1`` -> ``ffn1``, ``ffn_2`` -> ``ffn2``)
``bert.encoder.layers.1.ln2.weight`` is
``<prefix>bert_encoder_layer1_ln2_gamma`` and ``decoder.weight`` is
``<prefix>decoder_weight``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .gluon.nn import LayerNorm

__all__ = ["gluon_name", "from_mxnet_tpu_params"]

_LN_LEAF = {"weight": "gamma", "bias": "beta"}


def gluon_name(model: torch.nn.Module, key: str) -> str:
    """The Gluon name (without the net's prefix) of ``state_dict`` key
    ``key`` of ``model``."""
    segments = getattr(model, "gluon_segments", {})
    *path, leaf = key.split(".")
    parts = []
    for i, seg in enumerate(path):
        if seg.isdigit() and parts and path[i - 1] == "layers":
            parts[-1] = f"layer{seg}"
        else:
            parts.append(segments.get(seg, seg))
    if isinstance(model.get_submodule(".".join(path)), LayerNorm):
        leaf = _LN_LEAF[leaf]
    return "_".join(parts + [leaf])


def from_mxnet_tpu_params(model: torch.nn.Module,
                          params: Dict[str, np.ndarray], prefix: str) -> None:
    """Load Gluon-named numpy ``params`` into ``model`` in place.  Refuses
    missing or extra names and shape mismatches."""
    stripped = {}
    for name, value in params.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the net prefix "
                             f"{prefix!r}")
        stripped[name[len(prefix):]] = np.asarray(value)
    state = model.state_dict()
    by_gluon = {gluon_name(model, k): k for k in state}
    missing = sorted(set(by_gluon) - set(stripped))
    extra = sorted(set(stripped) - set(by_gluon))
    if missing or extra:
        raise MXNetError(f"parameter names disagree: missing {missing}, "
                         f"extra {extra}")
    new = {}
    for gname, key in by_gluon.items():
        value = stripped[gname]
        if tuple(value.shape) != tuple(state[key].shape):
            raise MXNetError(f"{prefix}{gname}: shape {value.shape} != "
                             f"{tuple(state[key].shape)} of {key}")
        new[key] = torch.tensor(value, dtype=state[key].dtype)
    model.load_state_dict(new)
