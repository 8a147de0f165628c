"""ONNX export of int8-quantized graphs, the port's copy of the JAX
package's ``contrib/onnx/quant_export.py`` (docs/PRECISION.md §ONNX), over
the port's ``contrib.quantization`` twins (``QuantizedDense``,
``QuantizedConv2D``; their int8 weights are torch tensors).

Two forms, per the deployment scenario ROADMAP item 5 names:

``mode="qdq"`` (default) — the standard ONNX *QDQ* representation:
every quantized layer exports as ``QuantizeLinear -> DequantizeLinear``
around the activation (calibrated scale, int8 zero-point 0) plus an int8
weight initializer behind its own ``DequantizeLinear``.  Backends that
understand QDQ (onnxruntime, TensorRT) fuse these into real int8
kernels; numerically the graph computes what the port's
``ops/quantization.py`` primitives compute (symmetric 127-level scheme;
the only divergence is QuantizeLinear's -128 saturation point vs our
-127 clip, and the bias fold — our kernels round the bias into int32
accumulator units, QDQ adds it in f32).  Requires calibrated activation
thresholds (``calib_mode`` naive/entropy): dynamic per-batch ranges are
not expressible as static ``QuantizeLinear`` scales.

``mode="dequant"`` — the documented dequantize-fallback: weights are
dequantized at export time (``int8 -> f32`` with the quantization error
baked in) and the graph is plain opset-11 f32 ops.  Loses the int8
size/speed story but round-trips through ANY opset-11 importer —
including this package's own ``import_model``/``import_to_gluon`` — so
it is the interop-maximal form.

Both forms accept the product of ``contrib.quantization.quantize_net``
(the ``_QuantizedNet`` mirror over a (Hybrid)Sequential).  Supported
parts: quantized Dense/Conv2D twins, plain Dense/Activation/Flatten
(Dropout is dropped — inference identity); anything else raises,
loudly — exporting a layer this module cannot faithfully express would
produce a silently-wrong model file.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...base import MXNetError
from . import proto

__all__ = ["export_quantized_net"]

_ACT_MAP = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
            "softsign": "Softsign", "softrelu": "Softplus"}


class _Builder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0

    def tmp(self, base: str) -> str:
        self._n += 1
        return f"{base}_{self._n}"

    def init(self, name: str, arr: np.ndarray) -> str:
        self.initializers.append(proto.make_tensor(name, arr))
        return name

    def node(self, op_type: str, inputs, outputs, **attrs):
        self.nodes.append(proto.make_node(op_type, inputs, outputs,
                                          name=outputs[0], **attrs))
        return outputs[0]


def _np(t) -> np.ndarray:
    """A torch tensor as a host numpy array (floats as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _flatten_parts(qnet) -> List:
    out = []
    for part in getattr(qnet, "_parts", ()):
        if hasattr(part, "_parts"):       # nested _QuantizedNet mirror
            out.extend(_flatten_parts(part))
        else:
            out.append(part)
    return out


def _qdq_input(b: _Builder, x: str, thresh: Optional[float], where: str,
               mode: str) -> str:
    """QuantizeLinear+DequantizeLinear around an activation edge (qdq
    mode), identity in dequant mode."""
    if mode != "qdq":
        return x
    if thresh is None:
        raise MXNetError(
            f"export_quantized_net(mode='qdq'): layer {where!r} has no "
            f"calibrated activation threshold (quantize_net ran with "
            f"calib_mode='none') — QuantizeLinear needs a static scale; "
            f"re-quantize with calib_mode naive/entropy, or export with "
            f"mode='dequant'")
    scale = b.init(b.tmp(f"{where}_xscale"),
                   np.asarray(float(thresh) / 127.0, np.float32))
    zp = b.init(b.tmp(f"{where}_xzp"), np.asarray(0, np.int8))
    q = b.node("QuantizeLinear", [x, scale, zp], [b.tmp(f"{where}_xq")])
    return b.node("DequantizeLinear", [q, scale, zp],
                  [b.tmp(f"{where}_xdq")])


def _weight_input(b: _Builder, qweight, w_thresh: float, where: str,
                  mode: str, transpose_to=None) -> str:
    """The weight edge: int8 initializer + DequantizeLinear (qdq), or a
    dequantized f32 initializer (dequant fallback)."""
    qw = np.asarray(_np(qweight), np.int8)
    if transpose_to is not None:
        qw = qw.transpose(transpose_to)
    scale = float(w_thresh) / 127.0
    if mode == "qdq":
        wq = b.init(b.tmp(f"{where}_wq"), qw)
        ws = b.init(b.tmp(f"{where}_wscale"),
                    np.asarray(scale, np.float32))
        wzp = b.init(b.tmp(f"{where}_wzp"), np.asarray(0, np.int8))
        return b.node("DequantizeLinear", [wq, ws, wzp],
                      [b.tmp(f"{where}_wdq")])
    return b.init(b.tmp(f"{where}_w"),
                  (qw.astype(np.float32) * scale).astype(np.float32))


def _export_qdense(b: _Builder, qd, x: str, rank: int, idx: int,
                   mode: str):
    where = f"qdense{idx}"
    if qd._flatten and rank > 2:
        x = b.node("Flatten", [x], [b.tmp(f"{where}_flat")], axis=1)
        rank = 2
    xin = _qdq_input(b, x, qd._calib_thresh, where, mode)
    w_thresh = float(qd._w_thresh)
    bias = b.init(b.tmp(f"{where}_b"), np.asarray(_np(qd._bias), np.float32))
    if rank == 2:
        w = _weight_input(b, qd._qweight, w_thresh, where, mode)
        out = b.node("Gemm", [xin, w, bias], [b.tmp(f"{where}_out")],
                     transB=1)
    else:
        # per-position projection (flatten=False, rank>2): MatMul over
        # the pre-transposed (in, units) weight + bias Add
        w = _weight_input(b, qd._qweight, w_thresh, where, mode,
                          transpose_to=(1, 0))
        mm = b.node("MatMul", [xin, w], [b.tmp(f"{where}_mm")])
        out = b.node("Add", [mm, bias], [b.tmp(f"{where}_out")])
    if qd._act_type:
        out = b.node(_ACT_MAP[qd._act_type], [out],
                     [b.tmp(f"{where}_act")])
    return out, rank


def _export_qconv(b: _Builder, qc, x: str, rank: int, idx: int, mode: str):
    where = f"qconv{idx}"
    k = qc._kwargs
    if (k.get("layout") or "NCHW") != "NCHW":
        raise MXNetError(
            f"export_quantized_net: quantized conv {where!r} uses layout "
            f"{k.get('layout')!r}; only NCHW exports (ONNX Conv is "
            f"channel-first)")
    xin = _qdq_input(b, x, qc._calib_thresh, where, mode)
    w_thresh = float(qc._w_thresh)
    w = _weight_input(b, qc._qweight, w_thresh, where, mode)
    bias = b.init(b.tmp(f"{where}_b"), np.asarray(_np(qc._bias), np.float32))
    kernel = tuple(k["kernel"])
    n = len(kernel)
    stride = tuple(k.get("stride") or (1,) * n)
    pad = tuple(k.get("pad") or (0,) * n)
    dilate = tuple(k.get("dilate") or (1,) * n)
    out = b.node("Conv", [xin, w, bias], [b.tmp(f"{where}_out")],
                 kernel_shape=list(kernel), strides=list(stride),
                 pads=list(pad) + list(pad), dilations=list(dilate),
                 group=int(k.get("num_group", 1)))
    if qc._act_type:
        out = b.node(_ACT_MAP[qc._act_type], [out],
                     [b.tmp(f"{where}_act")])
    return out, rank


def _export_plain_dense(b: _Builder, layer, x: str, rank: int, idx: int):
    where = f"dense{idx}"
    if layer.flatten and rank > 2:
        x = b.node("Flatten", [x], [b.tmp(f"{where}_flat")], axis=1)
        rank = 2
    weight = np.asarray(_np(layer.weight), np.float32)  # (units, in)
    w = b.init(b.tmp(f"{where}_w"), weight)
    units = layer._units
    bias = b.init(
        b.tmp(f"{where}_b"),
        np.asarray(_np(layer.bias), np.float32)
        if layer.bias is not None else np.zeros((units,), np.float32))
    if rank == 2:
        out = b.node("Gemm", [x, w, bias], [b.tmp(f"{where}_out")],
                     transB=1)
    else:
        wt = b.init(b.tmp(f"{where}_wt"), np.ascontiguousarray(weight.T))
        mm = b.node("MatMul", [x, wt], [b.tmp(f"{where}_mm")])
        out = b.node("Add", [mm, bias], [b.tmp(f"{where}_out")])
    if layer.act:
        out = b.node(_ACT_MAP[layer.act], [out],
                     [b.tmp(f"{where}_act")])
    return out, rank


def export_quantized_net(qnet, input_shape, onnx_file_path: str,
                         mode: str = "qdq") -> str:
    """Export a ``quantize_net`` product to an ONNX file (module
    docstring has the two modes).  ``input_shape`` is the fixed data
    shape (batch included)."""
    from ...contrib.quantization import QuantizedConv2D, QuantizedDense
    from ...gluon import nn as gnn

    if mode not in ("qdq", "dequant"):
        raise MXNetError(f"export_quantized_net: mode must be 'qdq' or "
                         f"'dequant', got {mode!r}")
    parts = _flatten_parts(qnet)
    if not parts:
        raise MXNetError("export_quantized_net: empty quantized net")
    b = _Builder()
    x = "data"
    rank = len(tuple(input_shape))
    qidx = 0
    for part in parts:
        if isinstance(part, QuantizedDense):
            qidx += 1
            x, rank = _export_qdense(b, part, x, rank, qidx, mode)
        elif isinstance(part, QuantizedConv2D):
            qidx += 1
            x, rank = _export_qconv(b, part, x, rank, qidx, mode)
        elif isinstance(part, gnn.Dense):
            qidx += 1
            x, rank = _export_plain_dense(b, part, x, rank, qidx)
        elif isinstance(part, gnn.Activation):
            x = b.node(_ACT_MAP[part.act], [x], [b.tmp("act")])
        elif isinstance(part, gnn.Flatten):
            x = b.node("Flatten", [x], [b.tmp("flat")], axis=1)
            rank = 2
        elif isinstance(part, gnn.Dropout):
            continue  # inference identity
        else:
            raise MXNetError(
                f"export_quantized_net: unsupported part "
                f"{type(part).__name__} — only quantized Dense/Conv2D "
                f"twins and plain Dense/Activation/Flatten/Dropout "
                f"export faithfully")
    graph = proto.make_graph(
        b.nodes, "mxnet_tpu_torch_int8",
        inputs=[proto.make_tensor_value_info(
            "data", proto.FLOAT, list(input_shape))],
        outputs=[proto.make_tensor_value_info(x, proto.FLOAT, None)],
        initializers=b.initializers)
    # QDQ ops (QuantizeLinear/DequantizeLinear) entered ONNX at opset 10;
    # the rest of the emitted surface is opset-11 stable
    model = proto.make_model(graph, opset=11)
    with open(onnx_file_path, "wb") as f:
        f.write(model)
    return onnx_file_path
