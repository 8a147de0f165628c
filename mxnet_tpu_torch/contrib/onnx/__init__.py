"""ONNX interop, the port's counterpart of the JAX package's
``contrib/onnx`` (reference: python/mxnet/contrib/onnx/, mx2onnx
export_model and onnx2mx import_model / get_model_metadata).

No ``onnx`` package is needed: ``proto.py`` is a self-contained codec of
the ONNX wire format, so files written here load in onnxruntime or
netron, and opset-11 inference models import back to a Symbol and
params.  The exporter reads the graph ``HybridBlock.export`` writes (the
JAX package's graph, before any fused-kernel pass), and exports
``_contrib_flash_attention`` as its dense decomposition and ``LayerNorm``
as its formula; the imported graphs therefore launch none of the port's
kernels.  Params come in as NDArrays on the requested context, the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...base import MXNetError
from . import proto
from .mx2onnx import export_symbol
from .onnx2mx import import_onnx_model
from .quant_export import export_quantized_net

__all__ = ["export_model", "import_model", "import_to_gluon",
           "get_model_metadata", "export_quantized_net"]


def _load_symbol(sym):
    from ... import symbol as S

    if isinstance(sym, str):
        return S.load(sym)
    return sym


def _load_params(params):
    from ...ndarray import utils

    if isinstance(params, str):
        loaded = utils.load(params)
        if isinstance(loaded, dict):
            return loaded
        raise MXNetError(f"params file {params!r} did not hold a dict")
    return dict(params)


def export_model(sym, params, input_shape: Sequence[Tuple[int, ...]],
                 input_type=np.float32,
                 onnx_file_path: str = "model.onnx",
                 verbose: bool = False) -> str:
    """Export a symbol + params to an ONNX file (opset 11).

    Reference: python/mxnet/contrib/onnx/mx2onnx/export_model.py ~L1-100
    (same signature: `sym`/`params` may be objects or file paths;
    `input_shape` is a list of tuples, one per data input, in the graph's
    list_arguments order, or, unambiguously for multi-input graphs, a
    dict {input_name: shape}).
    """
    sym = _load_symbol(sym)
    params = _load_params(params)
    shapes = (dict(input_shape) if isinstance(input_shape, dict)
              else list(input_shape))
    model_bytes = export_symbol(sym, params, shapes,
                                input_dtype=input_type)
    with open(onnx_file_path, "wb") as f:
        f.write(model_bytes)
    if verbose:
        meta = get_model_metadata(onnx_file_path)
        print(f"exported {onnx_file_path}: {meta}")
    return onnx_file_path


def import_model(model_file: str, ctx=None):
    """ONNX file -> (sym, arg_params, aux_params), the params as NDArrays
    on ``ctx`` (default: the card).

    Reference: python/mxnet/contrib/onnx/onnx2mx/import_model.py ~L1-60.
    """
    with open(model_file, "rb") as f:
        return import_onnx_model(f.read(), ctx)


def import_to_gluon(model_file: str, ctx=None):
    """ONNX file -> gluon.SymbolBlock with its parameters on ``ctx``
    (default: the card).

    Reference: python/mxnet/contrib/onnx/onnx2mx/import_to_gluon.py.
    """
    from ... import gluon
    from ... import symbol as S

    sym, arg_params, aux_params = import_model(model_file, ctx)
    data_names = [n for n in sym.list_arguments()
                  if n not in arg_params]
    net = gluon.SymbolBlock(sym, [S.Variable(n) for n in data_names])
    net_params = net.collect_params()
    for name, arr in {**arg_params, **aux_params}.items():
        if name in net_params:
            net_params[name]._load_init(arr, ctx)
    return net


def get_model_metadata(model_file: str) -> Dict[str, List]:
    """{'input_tensor_data': [(name, shape)...], 'output_tensor_data': ...}
    for an ONNX file's data inputs (initializers excluded).

    Reference: python/mxnet/contrib/onnx/onnx2mx/import_model.py
    get_model_metadata ~L60-100.
    """
    with open(model_file, "rb") as f:
        model = proto.parse_model(f.read())
    graph = model["graph"]
    if graph is None:
        raise MXNetError(f"{model_file!r}: no graph")
    init_names = {t["name"] for t in graph["initializer"]}
    meta = {
        "input_tensor_data": [
            (i["name"], tuple(i["shape"] or ()))
            for i in graph["input"] if i["name"] not in init_names],
        "output_tensor_data": [
            (o["name"], tuple(o["shape"] or ())) for o in graph["output"]],
    }
    return meta
