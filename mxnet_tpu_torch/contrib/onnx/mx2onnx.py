"""Symbol-graph -> ONNX ModelProto exporter, the port's copy of the JAX
package's ``contrib/onnx/mx2onnx.py``.

Reference parity: python/mxnet/contrib/onnx/mx2onnx/ (~L1-2500, per-op
`convert_*` translators registered by op name).  Same architecture here:
a translator registry keyed by the symbol op name, emitting wire format
through ``proto.py`` instead of the onnx package's generated classes (no
onnx package is needed).  The graph is the port's ``symbol`` graph (the
file ``HybridBlock.export`` writes, as the JAX package writes it), walked
in ``_topo_order``; per-node shapes and dtypes come from the port's shape
inference (meta tensors), held here as ``_Struct(shape, dtype)`` with
numpy dtypes, ``"bfloat16"`` naming the one type numpy lacks.

Where the JAX exporter is wrong, the port raises instead: BatchNorm
exports only its first output, so a graph in which another node (or a
head) reads BatchNorm's output 1 or 2 (the batch mean or variance) is
refused with ``MXNetError`` rather than written with a dangling name.

Supported surface: the inference graph of every model-zoo family in this
tree (Convolution/BatchNorm/Pooling/FullyConnected/Activation chains,
residual adds, concat, dropout, flatten/reshape/transpose, softmax,
reductions, Split) at opset 11.  Unsupported ops raise with the op name
so the gap is explicit, mirroring the reference's
AttributeError("No conversion function registered for op type ...").
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...base import MXNetError
from . import proto as P

OPSET = 11

# a node output's static shape and dtype (a numpy dtype, or "bfloat16")
_Struct = namedtuple("_Struct", ["shape", "dtype"])


def _dt(dtype):
    """A numpy dtype, or the name "bfloat16", for any dtype spelling."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype)


def _kind(dtype) -> str:
    return "f" if dtype == "bfloat16" else np.dtype(dtype).kind


def _itemsize(dtype) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _const(value, dtype):
    """``value`` as an array of ``dtype`` (a bfloat16 torch tensor for
    "bfloat16", numpy otherwise)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(value, np.float32)).to(
            torch.bfloat16)
    return np.asarray(value, dtype=dtype)


def _host(v):
    """A param value (NDArray, tensor or array-like) as a host array:
    numpy, except bfloat16, which stays a CPU torch tensor."""
    t = getattr(v, "data", v) if hasattr(v, "asnumpy") else v
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t)


def _to_dtype(arr, dtype):
    if _dt(arr.dtype) == dtype:
        return arr
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return _const(arr, dtype)


def _structs(lst):
    return None if lst is None else [
        None if t is None else _Struct(tuple(int(d) for d in t.shape),
                                       _dt(t.dtype)) for t in lst]


class _Ctx:
    """Per-export state shared by translators."""

    def __init__(self, dtype):
        self.dtype = _dt(dtype)
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.init_names: set = set()
        self.structs: Dict[int, list] = {}  # id(node) -> ShapeDtypeStructs
        self._uid = 0

    def in_struct(self, node, i):
        """ShapeDtypeStruct of node's i-th input (None when inference
        couldn't resolve it)."""
        parent, oidx = node.inputs[i]
        lst = self.structs.get(id(parent))
        if lst is None:
            return None
        return lst[oidx] if oidx < len(lst) else None

    def in_rank(self, node, i):
        s = self.in_struct(node, i)
        return None if s is None else len(s.shape)

    def add_node(self, op_type, inputs, outputs, name="", **attrs):
        self.nodes.append(P.make_node(op_type, inputs, outputs,
                                      name=name, **attrs))

    def add_initializer(self, name, array):
        if name in self.init_names:
            return name
        self.init_names.add(name)
        if not isinstance(array, torch.Tensor):
            array = np.asarray(array)
        self.initializers.append(P.make_tensor(name, array))
        return name

    def scalar(self, value, name_hint, dtype=None):
        if dtype is None:
            # float export dtype governs float constants (a float64 export
            # must emit DOUBLE clip bounds/eps); int input dtypes don't
            dtype = self.dtype if _kind(self.dtype) == "f" else np.float32
        self._uid += 1
        return self.add_initializer(f"{name_hint}_const{self._uid}",
                                    _const(value, dtype))

    def tmp(self, base):
        self._uid += 1
        return f"{base}_tmp{self._uid}"


def _pair(attrs, key, ndim, default):
    v = attrs.get(key) or ()
    v = list(v) if isinstance(v, (tuple, list)) else [v]
    return [int(x) for x in (v or [default] * ndim)]


def _pads(pad):  # MXNet symmetric pad -> ONNX begin+end
    return [int(p) for p in pad] * 2


_REGISTRY: Dict[str, callable] = {}


def _register(*op_names):
    def deco(fn):
        for n in op_names:
            _REGISTRY[n] = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# translators — signature: fn(ctx, node, ins, outs, attrs)
#   ins: ONNX names of the node's inputs, outs: names of its outputs
# --------------------------------------------------------------------------


def _conv_common(op, attrs):
    """Shared (De)Convolution attr extraction + channel-first guard."""
    if attrs.get("layout") not in (None, "NCHW", "NCW", "NCDHW"):
        raise MXNetError(f"ONNX export supports channel-first {op} only, "
                         f"got layout={attrs['layout']!r}")
    kernel = [int(k) for k in attrs.get("kernel", ())]
    ndim = len(kernel)
    return dict(kernel_shape=kernel,
                strides=_pair(attrs, "stride", ndim, 1),
                dilations=_pair(attrs, "dilate", ndim, 1),
                pads=_pads(_pair(attrs, "pad", ndim, 0)),
                group=int(attrs.get("num_group", 1)))


@_register("Convolution")
def _conv(ctx, node, ins, outs, attrs):
    ctx.add_node("Conv", ins, outs, name=node.name,
                 **_conv_common("Convolution", attrs))


@_register("Deconvolution")
def _deconv(ctx, node, ins, outs, attrs):
    # transposed conv: MXNet weight layout (C_in, C_out/group, *k) is
    # exactly ONNX ConvTranspose's W layout
    if attrs.get("target_shape"):
        raise MXNetError("ONNX export: Deconvolution target_shape "
                         "unsupported (use adj/output_padding)")
    kw = _conv_common("Deconvolution", attrs)
    ndim = len(kw["kernel_shape"])
    adj = _pair(attrs, "adj", ndim, 0)  # scalar adj broadcasts like the op
    if any(adj):
        kw["output_padding"] = adj
    ctx.add_node("ConvTranspose", ins, outs, name=node.name, **kw)


@_register("BatchNorm")
def _batchnorm(ctx, node, ins, outs, attrs):
    # ONNX BatchNormalization is fixed to channel axis 1
    if int(attrs.get("axis", 1)) != 1:
        raise MXNetError("ONNX export: BatchNorm axis="
                         f"{attrs['axis']} unsupported (ONNX "
                         "BatchNormalization normalizes axis 1 only)")
    # fix_gamma=True (the op default) means scale is semantically all-ones
    # regardless of the stored array — materialize that (reference
    # mx2onnx does the same)
    ctx.add_node(
        "BatchNormalization", ins, outs[:1], name=node.name,
        epsilon=float(attrs.get("eps", 1e-3)),
        momentum=float(attrs.get("momentum", 0.9)))


@_register("FullyConnected")
def _fc(ctx, node, ins, outs, attrs):
    data = ins[0]
    if attrs.get("flatten", True):
        flat = ctx.tmp(node.name)
        ctx.add_node("Flatten", [data], [flat], axis=1)
        ctx.add_node("Gemm", [flat] + list(ins[1:]), outs, name=node.name,
                     alpha=1.0, beta=1.0, transA=0, transB=1)
        return
    # flatten=False: per-position projection on rank>=2 input — Gemm is
    # 2D-only, so emit MatMul(x, W^T) (+ bias); runtimes constant-fold
    # the weight transpose
    wt = ctx.tmp(node.name)
    ctx.add_node("Transpose", [ins[1]], [wt], perm=[1, 0])
    if len(ins) > 2:
        mm = ctx.tmp(node.name)
        ctx.add_node("MatMul", [data, wt], [mm])
        ctx.add_node("Add", [mm, ins[2]], outs, name=node.name)
    else:
        ctx.add_node("MatMul", [data, wt], outs, name=node.name)


@_register("Activation")
def _activation(ctx, node, ins, outs, attrs):
    mapping = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
               "softrelu": "Softplus", "softsign": "Softsign"}
    act = attrs.get("act_type", "relu")
    if act not in mapping:
        raise MXNetError(f"ONNX export: Activation act_type={act!r}")
    ctx.add_node(mapping[act], ins, outs, name=node.name)


@_register("LeakyReLU")
def _leaky(ctx, node, ins, outs, attrs):
    act = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    if act == "leaky":
        ctx.add_node("LeakyRelu", ins, outs, name=node.name, alpha=slope)
    elif act == "elu":
        ctx.add_node("Elu", ins, outs, name=node.name, alpha=slope)
    elif act == "prelu":
        ctx.add_node("PRelu", ins, outs, name=node.name)
    elif act == "gelu":
        # exact gelu: 0.5 * x * (1 + erf(x / sqrt(2))) — no Gelu op in
        # opset 11
        s = ctx.in_struct(node, 0)
        dt = None if s is None else s.dtype
        t = lambda: ctx.tmp(node.name)  # noqa: E731
        div, erf, one, mul = t(), t(), t(), t()
        ctx.add_node("Div", [ins[0], ctx.scalar(np.sqrt(2.0), node.name,
                                                dtype=dt)], [div])
        ctx.add_node("Erf", [div], [erf])
        ctx.add_node("Add", [erf, ctx.scalar(1.0, node.name, dtype=dt)],
                     [one])
        ctx.add_node("Mul", [ins[0], one], [mul])
        ctx.add_node("Mul", [mul, ctx.scalar(0.5, node.name, dtype=dt)],
                     outs, name=node.name)
    else:
        raise MXNetError(f"ONNX export: LeakyReLU act_type={act!r}")


@_register("Pooling")
def _pooling(ctx, node, ins, outs, attrs):
    pool = attrs.get("pool_type", "max")
    if pool not in ("max", "avg"):
        raise MXNetError(f"ONNX export: pool_type={pool!r}")
    if attrs.get("global_pool", False):
        op = "GlobalMaxPool" if pool == "max" else "GlobalAveragePool"
        ctx.add_node(op, ins, outs, name=node.name)
        return
    kernel = [int(k) for k in attrs.get("kernel", ())]
    ndim = len(kernel)
    kw = dict(kernel_shape=kernel,
              strides=_pair(attrs, "stride", ndim, 1),
              pads=_pads(_pair(attrs, "pad", ndim, 0)),
              ceil_mode=int(attrs.get("pooling_convention",
                                      "valid") == "full"))
    if pool == "avg":
        kw["count_include_pad"] = int(attrs.get("count_include_pad", True))
        ctx.add_node("AveragePool", ins, outs, name=node.name, **kw)
    else:
        ctx.add_node("MaxPool", ins, outs, name=node.name, **kw)


@_register("Flatten")
def _flatten(ctx, node, ins, outs, attrs):
    ctx.add_node("Flatten", ins, outs, name=node.name, axis=1)


@_register("Dropout")
def _dropout(ctx, node, ins, outs, attrs):
    ctx.add_node("Dropout", ins, outs[:1], name=node.name,
                 ratio=float(attrs.get("p", 0.5)))


def _check_softmax_axis(node, attrs):
    # ONNX Softmax-11 has coerce-to-2D semantics: it flattens [d0..dk-1],
    # [dk..dn] and normalizes each row, which equals MXNet's single-axis
    # softmax ONLY when the axis is the last one.  axis=-1 is the op
    # default here and what every classifier head uses; other axes would
    # export a silently different model, so they raise.
    axis = int(attrs.get("axis", -1))
    if axis != -1:
        raise MXNetError(
            f"ONNX export: {node.op} axis={axis} differs from ONNX "
            "opset-11 flatten semantics (only axis=-1 is equivalent)")
    return axis


@_register("softmax")
def _softmax(ctx, node, ins, outs, attrs):
    ctx.add_node("Softmax", ins, outs, name=node.name,
                 axis=_check_softmax_axis(node, attrs))


@_register("SoftmaxActivation")
def _softmax_activation(ctx, node, ins, outs, attrs):
    # mode='instance' (the default) softmaxes over ALL non-batch dims —
    # exactly ONNX opset-11 Softmax(axis=1) flatten semantics.
    # mode='channel' (axis-1-only on rank>2) has no opset-11 equivalent.
    if attrs.get("mode", "instance") != "instance":
        raise MXNetError("ONNX export: SoftmaxActivation mode='channel' "
                         "has no opset-11 Softmax equivalent")
    ctx.add_node("Softmax", ins, outs, name=node.name, axis=1)


@_register("log_softmax")
def _log_softmax(ctx, node, ins, outs, attrs):
    ctx.add_node("LogSoftmax", ins, outs, name=node.name,
                 axis=_check_softmax_axis(node, attrs))


@_register("SoftmaxOutput")
def _softmax_output(ctx, node, ins, outs, attrs):
    # inference export: the label input and loss semantics drop away
    # (reference mx2onnx emits plain Softmax).  multi_output=True moves
    # the softmax to axis 1 of a rank-4 tensor (per-pixel heads), which
    # opset-11 flatten semantics cannot express.
    if attrs.get("multi_output", False):
        raise MXNetError("ONNX export: SoftmaxOutput multi_output=True "
                         "has no opset-11 Softmax equivalent")
    ctx.add_node("Softmax", ins[:1], outs, name=node.name, axis=-1)


_BINARY = {"elemwise_add": "Add", "broadcast_add": "Add", "_plus": "Add",
           "elemwise_sub": "Sub", "broadcast_sub": "Sub", "_minus": "Sub",
           "elemwise_mul": "Mul", "broadcast_mul": "Mul", "_mul": "Mul",
           "elemwise_div": "Div", "broadcast_div": "Div", "_div": "Div"}


@_register(*_BINARY)
def _binary(ctx, node, ins, outs, attrs):
    ctx.add_node(_BINARY[node.op], ins, outs, name=node.name)


_SCALAR = {"_plus_scalar": ("Add", False), "_minus_scalar": ("Sub", False),
           "_rminus_scalar": ("Sub", True), "_mul_scalar": ("Mul", False),
           "_div_scalar": ("Div", False), "_rdiv_scalar": ("Div", True)}


@_register(*_SCALAR)
def _scalar_op(ctx, node, ins, outs, attrs):
    op, reverse = _SCALAR[node.op]
    s = ctx.in_struct(node, 0)  # ONNX binaries need matching dtypes
    const = ctx.scalar(attrs.get("scalar", 0.0), node.name,
                       dtype=None if s is None else s.dtype)
    inputs = [const, ins[0]] if reverse else [ins[0], const]
    ctx.add_node(op, inputs, outs, name=node.name)


@_register("add_n", "ElementWiseSum")
def _add_n(ctx, node, ins, outs, attrs):
    ctx.add_node("Sum", ins, outs, name=node.name)


@_register("Concat", "concat")
def _concat(ctx, node, ins, outs, attrs):
    ctx.add_node("Concat", ins, outs, name=node.name,
                 axis=int(attrs.get("dim", 1)))


@_register("Reshape", "reshape")
def _reshape(ctx, node, ins, outs, attrs):
    shape = [int(s) for s in attrs.get("shape", ())]
    if any(s < -1 for s in shape):
        # MXNet's -2/-3/-4 split/merge codes have no ONNX encoding, but
        # under export the shapes are static — emit the node's inferred
        # output shape instead
        lst = ctx.structs.get(id(node))
        if not lst or lst[0] is None:
            raise MXNetError(
                "ONNX export: Reshape special codes -2/-3/-4 need shape "
                "inference (failed upstream); use explicit dims")
        shape = [int(d) for d in lst[0].shape]
    shp = ctx.add_initializer(f"{node.name}_shape",
                              np.asarray(shape, dtype=np.int64))
    ctx.add_node("Reshape", [ins[0], shp], outs, name=node.name)


@_register("transpose")
def _transpose(ctx, node, ins, outs, attrs):
    axes = attrs.get("axes", ())
    kw = {"perm": [int(a) for a in axes]} if axes else {}
    ctx.add_node("Transpose", ins, outs, name=node.name, **kw)


@_register("clip")
def _clip(ctx, node, ins, outs, attrs):
    lo = ctx.scalar(float(attrs["a_min"]), node.name)
    hi = ctx.scalar(float(attrs["a_max"]), node.name)
    ctx.add_node("Clip", [ins[0], lo, hi], outs, name=node.name)


_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
          "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
          "negative": "Neg", "erf": "Erf", "floor": "Floor",
          "ceil": "Ceil", "BlockGrad": "Identity", "identity": "Identity",
          "stop_gradient": "Identity"}


@_register(*_UNARY)
def _unary(ctx, node, ins, outs, attrs):
    ctx.add_node(_UNARY[node.op], ins, outs, name=node.name)


@_register("mean", "sum")
def _reduce(ctx, node, ins, outs, attrs):
    op = "ReduceMean" if node.op == "mean" else "ReduceSum"
    if attrs.get("exclude", False):
        raise MXNetError(
            f"ONNX export: {node.op} exclude=True has no ONNX axes "
            "equivalent without rank info; reduce over explicit axes")
    axis = attrs.get("axis", None)
    kw = {"keepdims": int(attrs.get("keepdims", False))}
    if axis is not None:
        kw["axes"] = ([int(axis)] if isinstance(axis, (int, np.integer))
                      else [int(a) for a in axis])
    ctx.add_node(op, ins, outs, name=node.name, **kw)


@_register("SliceChannel", "split")
def _split(ctx, node, ins, outs, attrs):
    axis = int(attrs.get("axis", 1))
    if attrs.get("squeeze_axis", False):
        # MXNet drops the split axis from each part; ONNX Split keeps it —
        # emit a Squeeze per output
        parts = [ctx.tmp(node.name) for _ in outs]
        ctx.add_node("Split", ins, parts, name=node.name, axis=axis)
        for part, out in zip(parts, outs):
            ctx.add_node("Squeeze", [part], [out], axes=[axis])
    else:
        ctx.add_node("Split", ins, outs, name=node.name, axis=axis)


@_register("Cast", "cast")
def _cast(ctx, node, ins, outs, attrs):
    ctx.add_node("Cast", ins, outs, name=node.name,
                 to=P.np_to_onnx_dtype(attrs["dtype"]))


# ---- transformer-family ops ----------------------------------------------


@_register("Embedding")
def _embedding(ctx, node, ins, outs, attrs):
    # table lookup = Gather(weight, indices) on axis 0; MXNet accepts
    # float indices, ONNX does not — cast when inference says float
    indices = ins[0]
    s = ctx.in_struct(node, 0)
    if s is None or _kind(s.dtype) == "f":
        cast = ctx.tmp(node.name)
        ctx.add_node("Cast", [indices], [cast], to=P.INT32)
        indices = cast
    ctx.add_node("Gather", [ins[1], indices], outs, name=node.name, axis=0)


@_register("LayerNorm")
def _layer_norm(ctx, node, ins, outs, attrs):
    if attrs.get("output_mean_var", False):
        raise MXNetError("ONNX export: LayerNorm output_mean_var=True")
    axis = int(attrs.get("axis", -1))
    rank = ctx.in_rank(node, 0)
    if axis != -1 and (rank is None or axis != rank - 1):
        # gamma/beta are (C,): only last-axis normalization broadcasts them
        # correctly in the decomposition below
        raise MXNetError(f"ONNX export: LayerNorm axis={axis} (only the "
                         "last axis is supported)")
    x, gamma, beta = ins
    t = lambda: ctx.tmp(node.name)  # noqa: E731
    mean, cent, sq, var, veps, std, norm, scaled = (
        t(), t(), t(), t(), t(), t(), t(), t())
    ctx.add_node("ReduceMean", [x], [mean], axes=[-1], keepdims=1)
    ctx.add_node("Sub", [x, mean], [cent])
    ctx.add_node("Mul", [cent, cent], [sq])
    ctx.add_node("ReduceMean", [sq], [var], axes=[-1], keepdims=1)
    ctx.add_node("Add", [var, ctx.scalar(float(attrs.get("eps", 1e-5)),
                                         node.name)], [veps])
    ctx.add_node("Sqrt", [veps], [std])
    ctx.add_node("Div", [cent, std], [norm])
    ctx.add_node("Mul", [norm, gamma], [scaled])
    ctx.add_node("Add", [scaled, beta], outs, name=node.name)


def _maybe_transpose_last2(ctx, node, idx, name_in, flag):
    if not flag:
        return name_in
    rank = ctx.in_rank(node, idx)
    if rank is None:
        raise MXNetError(f"ONNX export: {node.op} transpose flag needs "
                         "rank info (shape inference failed upstream)")
    perm = list(range(rank))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    tmp = ctx.tmp(node.name)
    ctx.add_node("Transpose", [name_in], [tmp], perm=perm)
    return tmp


@_register("batch_dot")
def _matmul(ctx, node, ins, outs, attrs):
    a = _maybe_transpose_last2(ctx, node, 0, ins[0],
                               attrs.get("transpose_a", False))
    b = _maybe_transpose_last2(ctx, node, 1, ins[1],
                               attrs.get("transpose_b", False))
    ctx.add_node("MatMul", [a, b], outs, name=node.name)


@_register("dot")
def _dot(ctx, node, ins, outs, attrs):
    # MXNet dot is TENSORDOT (contracts a's last axis with b's FIRST
    # axis, full cyclic transposes) — only the rank-2 case coincides
    # with ONNX MatMul semantics
    if ctx.in_rank(node, 0) != 2 or ctx.in_rank(node, 1) != 2:
        raise MXNetError("ONNX export: dot is only exportable for 2-D "
                         "operands (rank>2 dot is tensordot, not MatMul); "
                         "use batch_dot for batched matmul")
    _matmul(ctx, node, ins, outs, attrs)


@_register("expand_dims")
def _expand_dims(ctx, node, ins, outs, attrs):
    ctx.add_node("Unsqueeze", ins, outs, name=node.name,
                 axes=[int(attrs["axis"])])


@_register("squeeze")
def _squeeze(ctx, node, ins, outs, attrs):
    axis = attrs.get("axis", None)
    kw = {}
    if axis is not None:
        kw["axes"] = ([int(axis)] if isinstance(axis, (int, np.integer))
                      else [int(a) for a in axis])
    ctx.add_node("Squeeze", ins, outs, name=node.name, **kw)


@_register("broadcast_axis")
def _broadcast_axis(ctx, node, ins, outs, attrs):
    # Expand to the inferred output shape (size-1 dims tile per ONNX
    # broadcast rules, same as the op's semantics)
    lst = ctx.structs.get(id(node))
    if not lst or lst[0] is None:
        raise MXNetError("ONNX export: broadcast_axis needs shape "
                         "inference for its Expand target")
    shp = ctx.add_initializer(
        f"{node.name}_target",
        np.asarray(lst[0].shape, dtype=np.int64))
    ctx.add_node("Expand", [ins[0], shp], outs, name=node.name)


_CMP_SCALAR = {"_greater_scalar": ("Greater", False),
               "_lesser_scalar": ("Less", False),
               "_greater_equal_scalar": ("Less", True),
               "_lesser_equal_scalar": ("Greater", True),
               "_equal_scalar": ("Equal", False),
               "_not_equal_scalar": ("Equal", True)}


@_register(*_CMP_SCALAR)
def _cmp_scalar(ctx, node, ins, outs, attrs):
    # MXNet comparisons return float 0/1; ONNX Greater/Less/Equal return
    # bool — compare, optionally Not (for >= / <= via the negated op),
    # then Cast back to the input dtype to keep arithmetic consumers valid
    op, negate = _CMP_SCALAR[node.op]
    s = ctx.in_struct(node, 0)
    const = ctx.scalar(attrs.get("scalar", 0.0), node.name,
                       dtype=None if s is None else s.dtype)
    raw = ctx.tmp(node.name)
    ctx.add_node(op, [ins[0], const], [raw])
    if negate:
        inv = ctx.tmp(node.name)
        ctx.add_node("Not", [raw], [inv])
        raw = inv
    dtype = np.float32 if s is None else s.dtype
    ctx.add_node("Cast", [raw], outs, name=node.name,
                 to=P.np_to_onnx_dtype(dtype))


@_register("where")
def _where(ctx, node, ins, outs, attrs):
    cond = ctx.tmp(node.name)
    ctx.add_node("Cast", [ins[0]], [cond], to=P.BOOL)
    ctx.add_node("Where", [cond, ins[1], ins[2]], outs, name=node.name)


@_register("broadcast_like")
def _broadcast_like(ctx, node, ins, outs, attrs):
    # static export: Expand to the node's inferred output shape
    lst = ctx.structs.get(id(node))
    if not lst or lst[0] is None:
        raise MXNetError("ONNX export: broadcast_like needs shape "
                         "inference for its Expand target")
    shp = ctx.add_initializer(f"{node.name}_target",
                              np.asarray(lst[0].shape, dtype=np.int64))
    ctx.add_node("Expand", [ins[0], shp], outs, name=node.name)


@_register("ones_like", "zeros_like")
def _fill_like(ctx, node, ins, outs, attrs):
    # shape- and dtype-preserving without materializing a constant tensor:
    # zeros = x * 0, ones = x * 0 + 1
    s = ctx.in_struct(node, 0)
    if s is None:  # a dtype-blind constant would mismatch int inputs
        raise MXNetError(f"ONNX export: {node.op} needs dtype inference")
    dt = s.dtype
    zeros = ctx.tmp(node.name) if node.op == "ones_like" else outs[0]
    ctx.add_node("Mul", [ins[0], ctx.scalar(0.0, node.name, dtype=dt)],
                 [zeros], name=node.name if node.op == "zeros_like" else "")
    if node.op == "ones_like":
        ctx.add_node("Add", [zeros, ctx.scalar(1.0, node.name, dtype=dt)],
                     outs, name=node.name)


@_register("cumsum")
def _cumsum(ctx, node, ins, outs, attrs):
    axis = attrs.get("axis", None)
    if axis is None:
        raise MXNetError("ONNX export: cumsum over the flattened array "
                         "(axis=None) unsupported; pass an axis")
    ax = ctx.add_initializer(f"{node.name}_axis",
                             np.asarray(int(axis), dtype=np.int64))
    ctx.add_node("CumSum", [ins[0], ax], outs, name=node.name)


@_register("linalg_makediag")
def _makediag(ctx, node, ins, outs, attrs):
    # diag(v)[i, j] = v[i] * eye[i, j]; eye is a static initializer
    # (export shapes are fixed), so the translation is one Unsqueeze+Mul
    if int(attrs.get("offset", 0)) != 0:
        raise MXNetError("ONNX export: linalg_makediag offset != 0")
    s = ctx.in_struct(node, 0)
    if s is None or len(s.shape) != 1:
        raise MXNetError("ONNX export: linalg_makediag needs a known "
                         "1-D input shape")
    n = int(s.shape[0])
    eye = ctx.add_initializer(f"{node.name}_eye", _const(np.eye(n), s.dtype))
    col = ctx.tmp(node.name)
    ctx.add_node("Unsqueeze", [ins[0]], [col], axes=[1])
    ctx.add_node("Mul", [col, eye], outs, name=node.name)


@_register("slice_like")
def _slice_like(ctx, node, ins, outs, attrs):
    # static export: slice input 0 on `axes` down to input 1's inferred
    # dims (dynamic-shape slice_like would need Shape ops; export shapes
    # are fixed, so the static Slice is exact)
    like = ctx.in_struct(node, 1)
    src = ctx.in_struct(node, 0)
    if like is None or src is None:
        raise MXNetError("ONNX export: slice_like needs shape inference")
    axes = [int(a) for a in (attrs.get("axes") or
                             range(min(len(src.shape), len(like.shape))))]
    starts = [0] * len(axes)
    ends = [int(like.shape[a]) for a in axes]
    s = ctx.add_initializer(f"{node.name}_starts",
                            np.asarray(starts, np.int64))
    e = ctx.add_initializer(f"{node.name}_ends",
                            np.asarray(ends, np.int64))
    a = ctx.add_initializer(f"{node.name}_axes",
                            np.asarray(axes, np.int64))
    ctx.add_node("Slice", [ins[0], s, e, a], outs, name=node.name)


@_register("_contrib_flash_attention")
def _flash_attention(ctx, node, ins, outs, attrs):
    """Dense decomposition: softmax(q k^T * sm_scale [+ causal mask]) v,
    numerically the attention the fused kernels compute (K3,
    csrc/flash_attention.cu), expressed in plain ONNX ops."""
    q, k, v = ins
    qs = ctx.in_struct(node, 0)
    ks = ctx.in_struct(node, 1)
    if qs is None or ks is None:
        raise MXNetError("ONNX export: flash_attention needs shape "
                         "inference")
    rank = len(qs.shape)
    head_dim = int(qs.shape[-1])
    scale = attrs.get("sm_scale") or 1.0 / np.sqrt(head_dim)
    dt = qs.dtype
    t = lambda: ctx.tmp(node.name)  # noqa: E731
    perm = list(range(rank))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    kt, sc, scaled = t(), t(), t()
    ctx.add_node("Transpose", [k], [kt], perm=perm)
    ctx.add_node("MatMul", [q, kt], [sc])
    ctx.add_node("Mul", [sc, ctx.scalar(float(scale), node.name,
                                        dtype=dt)], [scaled])
    if attrs.get("causal", False):
        # (Lq, Lk) mask matching the kernel's qpos >= kpos rule — q and
        # k/v sequence lengths may differ (decode steps)
        lq, lk = int(qs.shape[-2]), int(ks.shape[-2])
        mask = ctx.add_initializer(
            f"{node.name}_causal",
            _const(np.triu(np.full((lq, lk), -1e9 if _itemsize(dt) > 2
                                   else -3e4), k=1), dt))
        masked = t()
        ctx.add_node("Add", [scaled, mask], [masked])
        scaled = masked
    att = t()
    ctx.add_node("Softmax", [scaled], [att], axis=-1)
    ctx.add_node("MatMul", [att, v], outs, name=node.name)


@_register("slice_axis")
def _slice_axis(ctx, node, ins, outs, attrs):
    axis = int(attrs["axis"])
    begin = int(attrs.get("begin", 0) or 0)
    end = attrs.get("end", None)
    end = (1 << 62) if end is None else int(end)
    starts = ctx.add_initializer(f"{node.name}_starts",
                                 np.asarray([begin], np.int64))
    ends = ctx.add_initializer(f"{node.name}_ends",
                               np.asarray([end], np.int64))
    axes = ctx.add_initializer(f"{node.name}_axes",
                               np.asarray([axis], np.int64))
    ctx.add_node("Slice", [ins[0], starts, ends, axes], outs,
                 name=node.name)


@_register("slice")
def _slice(ctx, node, ins, outs, attrs):
    begin = list(attrs.get("begin", ()))
    end = list(attrs.get("end", ()))
    step = attrs.get("step") or ()
    if any(s is not None and int(s) != 1 for s in step):
        raise MXNetError("ONNX export: strided slice unsupported")
    starts = [0 if b is None else int(b) for b in begin]
    ends = [(1 << 62) if e is None else int(e) for e in end]
    axes = list(range(len(begin)))

    s = ctx.add_initializer(f"{node.name}_starts",
                            np.asarray(starts, np.int64))
    e = ctx.add_initializer(f"{node.name}_ends",
                            np.asarray(ends, np.int64))
    a = ctx.add_initializer(f"{node.name}_axes",
                            np.asarray(axes, np.int64))
    ctx.add_node("Slice", [ins[0], s, e, a], outs, name=node.name)


# --------------------------------------------------------------------------
# graph walk
# --------------------------------------------------------------------------


def _out_names(node) -> List[str]:
    if node.num_outputs == 1:
        return [node.name]
    return [f"{node.name}_output{i}" for i in range(node.num_outputs)]


def _check_batchnorm_reads(sym, order):
    """Refuse a graph that reads BatchNorm's output 1 or 2: the exported
    BatchNormalization (inference form) has only output 0."""
    readers = [(node.name, node.inputs) for node in order
               if not node.is_variable()]
    readers.append(("the graph's outputs", sym._entries))
    for who, entries in readers:
        for parent, oidx in entries:
            if parent.op == "BatchNorm" and oidx > 0:
                raise MXNetError(
                    f"ONNX export: {who} reads output {oidx} of BatchNorm "
                    f"{parent.name!r} (its batch "
                    f"{'mean' if oidx == 1 else 'variance'}); the exported "
                    "BatchNormalization has only output 0")


def export_symbol(sym, params: Dict[str, np.ndarray],
                  input_shapes: Sequence[Tuple[int, ...]],
                  input_dtype=np.float32) -> bytes:
    """Serialize `sym` + `params` to ONNX ModelProto bytes (opset 11)."""
    from ...symbol.symbol import _topo_order

    ctx = _Ctx(input_dtype)
    params = {k.split(":", 1)[-1]: _host(v) for k, v in params.items()}

    order = _topo_order(sym._entries)
    _check_batchnorm_reads(sym, order)
    free_inputs = [n for n in order
                   if n.is_variable() and n.name not in params]
    if isinstance(input_shapes, dict):
        missing = [n.name for n in free_inputs if n.name not in input_shapes]
        if missing:
            raise MXNetError(
                f"export_model: input shapes missing for {missing}")
        shape_kwargs = {n.name: tuple(input_shapes[n.name])
                        for n in free_inputs}
    else:
        # positional list: graph (topo/list_arguments) order — for multi-
        # input graphs that order is traversal-dependent, so a dict
        # {input_name: shape} is the unambiguous spelling
        if len(free_inputs) != len(input_shapes):
            raise MXNetError(
                f"export_model: graph has {len(free_inputs)} data inputs "
                f"({[n.name for n in free_inputs]}) but {len(input_shapes)}"
                " input shapes were given")
        shape_kwargs = {n.name: tuple(s)
                        for n, s in zip(free_inputs, input_shapes)}

    # graph-wide shape/dtype inference: per-node structs let translators
    # that need rank/dtype (batch_dot transposes, Embedding index casts,
    # broadcast_axis target shapes) emit correct graphs, and give every
    # graph input/output its real elem_type
    try:
        structs = sym._infer_structs(
            shapes=shape_kwargs,
            dtypes={n.name: str(ctx.dtype) for n in free_inputs
                    if not n.vattrs.get("dtype")},
            partial=True)
        ctx.structs = {k: _structs(v) for k, v in structs["nodes"].items()}
        var_structs = {k: _structs([v])[0]
                       for k, v in structs["vars"].items()}
        out_structs = _structs(structs["outs"])
    except Exception as e:
        # degraded export: rank/dtype-dependent translators will raise if
        # reached — surface why instead of failing there mysteriously
        import warnings

        warnings.warn(f"ONNX export: graph shape inference failed ({e}); "
                      "exporting without per-node shape info")
        var_structs = {}
        out_structs = [None] * len(sym._entries)

    fix_gamma_inits = {}
    for node in order:
        if node.op == "BatchNorm" and node.attrs.get("fix_gamma", True):
            gamma = node.inputs[1][0]
            if gamma.is_variable() and gamma.name in params:
                fix_gamma_inits[gamma.name] = _const(
                    np.ones(tuple(params[gamma.name].shape)),
                    _dt(params[gamma.name].dtype))

    def _var_elem_type(name, default):
        s = var_structs.get(name)
        if s is None:
            return default
        try:
            return P.np_to_onnx_dtype(s.dtype)
        except ValueError:
            return default

    elem_type = P.np_to_onnx_dtype(input_dtype)
    graph_inputs = []
    for node in order:
        if not node.is_variable():
            continue
        if node.name in params:
            # a FLOAT export dtype casts float params with it (a float64
            # export must be type-consistent end to end); an int input
            # dtype (token models) must NOT touch float params
            arr = fix_gamma_inits.get(node.name, params[node.name])
            if _kind(ctx.dtype) == "f" and _kind(_dt(arr.dtype)) == "f":
                arr = _to_dtype(arr, ctx.dtype)
            ctx.add_initializer(node.name, arr)
        else:
            graph_inputs.append(P.make_tensor_value_info(
                node.name, _var_elem_type(node.name, elem_type),
                shape_kwargs[node.name]))

    for node in order:
        if node.is_variable():
            continue
        if node.op not in _REGISTRY:
            raise MXNetError(
                f"No ONNX conversion registered for op {node.op!r} "
                f"(node {node.name!r}) — supported: "
                f"{sorted(_REGISTRY)}")
        ins = []
        for parent, oidx in node.inputs:
            ins.append(parent.name if parent.num_outputs == 1
                       else _out_names(parent)[oidx])
        _REGISTRY[node.op](ctx, node, ins, _out_names(node), node.attrs)

    graph_outputs = []
    for (node, oidx), ostruct in zip(sym._entries, out_structs):
        oshape = None if ostruct is None else tuple(ostruct.shape)
        otype = elem_type
        if ostruct is not None:
            try:
                otype = P.np_to_onnx_dtype(ostruct.dtype)
            except ValueError:
                pass
        graph_outputs.append(P.make_tensor_value_info(
            _out_names(node)[oidx] if not node.is_variable() else node.name,
            otype, oshape))

    graph_name = getattr(sym, "name", None) or "mxnet_tpu_torch_graph"
    graph = P.make_graph(ctx.nodes, graph_name,
                         graph_inputs, graph_outputs, ctx.initializers)
    return P.make_model(graph, opset=OPSET)
