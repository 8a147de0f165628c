"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``):
``print_summary`` walks the symbol graph and prints a layer table with
output shapes and parameter counts (the JAX package's text);
``plot_network`` returns a graphviz ``Digraph`` when the optional
``graphviz`` package is installed, and raises otherwise.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def _param_count(node, shapes: Dict[str, tuple], input_names) -> int:
    """Trainable-parameter count: variable inputs that are neither
    network INPUTS (anything the user listed in `shape` — data, rois,
    im_info, ...) nor aux/label state."""
    total = 0
    for parent, _ in node.inputs:
        if parent.is_variable() and not parent.name.endswith(
                ("_moving_mean", "_moving_var", "label")):
            shp = shapes.get(parent.name)
            if shp and parent.name not in input_names:
                total += int(np.prod(shp))
    return total


def print_summary(symbol, shape: Optional[dict] = None, line_length: int = 98,
                  positions=(0.44, 0.64, 0.74, 1.0)) -> None:
    """Print a Keras-style layer summary (reference: print_summary ~L50).

    shape: dict of input name -> shape (e.g. {'data': (1, 3, 224, 224)}).
    """
    from .symbol.symbol import _topo_order

    shapes: Dict[str, tuple] = {}
    out_shapes: Dict[int, tuple] = {}
    input_names = set(shape) if shape is not None else {"data"}
    if shape is not None:
        arg_shapes, out_s, aux_shapes = symbol.infer_shape(**shape)
        for name, s in zip(symbol.list_arguments(), arg_shapes):
            shapes[name] = s
        internals = symbol.get_internals()
        # per-node output shapes via get_internals inference
        try:
            _, int_shapes, _ = internals.infer_shape(**shape)
            for entry, s in zip(internals._entries, int_shapes):
                out_shapes[id(entry[0])] = s
        except MXNetError:
            pass

    order = _topo_order(symbol._entries)
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]
    positions = [int(line_length * p) for p in positions]

    def print_row(values):
        line = ""
        for v, pos in zip(values, positions):
            line = (line + str(v))[: pos - 1]
            line += " " * (pos - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total_params = 0
    for node in order:
        if node.is_variable():
            continue
        params = _param_count(node, shapes, input_names)
        total_params += params
        prev = ",".join(p.name for p, _ in node.inputs
                        if not p.is_variable())[:30]
        oshape = out_shapes.get(id(node), "")
        print_row([f"{node.name} ({node.op})", oshape, params, prev])
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Return a graphviz.Digraph of the network (reference: plot_network).

    Requires the optional `graphviz` python package.
    """
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError(
            "plot_network requires the 'graphviz' package, which is not "
            "installed in this environment; use print_summary for a text "
            "rendering") from None
    from .symbol.symbol import _topo_order

    node_attrs = node_attrs or {}
    dot = Digraph(name=title, format=save_format)
    base_attr = {"shape": "box", "fixedsize": "false", "style": "filled"}
    base_attr.update(node_attrs)
    palette = {"Convolution": "#fb8072", "FullyConnected": "#fb8072",
               "BatchNorm": "#bebada", "Activation": "#ffffb3",
               "Pooling": "#80b1d3", "Concat": "#fdb462",
               "softmax": "#fccde5", "SoftmaxOutput": "#fccde5"}
    order = _topo_order(symbol._entries)
    drawn = set()
    for node in order:
        if node.is_variable():
            if hide_weights and node.name != "data":
                continue
            dot.node(node.name, node.name,
                     dict(base_attr, fillcolor="#8dd3c7"))
            drawn.add(id(node))
            continue
        color = palette.get(node.op, "#d9d9d9")
        label = f"{node.name}\n{node.op}"
        k = node.attrs.get("kernel")
        if k:
            label += f" {tuple(k)}"
        dot.node(node.name, label, dict(base_attr, fillcolor=color))
        drawn.add(id(node))
        for parent, _ in node.inputs:
            if id(parent) in drawn:
                dot.edge(parent.name, node.name)
    return dot
