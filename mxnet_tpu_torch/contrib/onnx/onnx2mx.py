"""ONNX ModelProto -> Symbol graph importer, the port's copy of the JAX
package's ``contrib/onnx/onnx2mx.py``.

Reference parity: python/mxnet/contrib/onnx/onnx2mx/import_onnx.py
(GraphProto.from_onnx ~L1-250 + per-op `_convert_map`).  Same shape
here: decode the wire format with ``proto.py``, then map each ONNX node
to an op of the port's ``symbol``; initializers become arg_params
(BatchNormalization's running mean/var become aux_params, matching the
executor's aux-state convention), as NDArrays on the requested context.

Where the JAX importer is wrong, the port is held to the correct result:
an initializer that one node reads as a static value (a Reshape's shape,
a Clip bound) and another as a tensor stays a parameter.  The JAX
``const()`` drops it from the params whenever any node reads it
statically.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...base import MXNetError
from . import proto as P


class _Importer:
    def __init__(self, graph: Dict, ctx=None):
        self.graph = graph
        self.ctx = ctx
        # numpy arrays, bfloat16 initializers as torch tensors
        self.init: Dict[str, object] = {
            t["name"]: t["array"] for t in graph["initializer"]}
        self.tensors: Dict[str, object] = {}   # onnx name -> Symbol
        self.aux_names: set = set()
        self.used_params: set = set()
        # initializers some node reads as a tensor (not only statically)
        self.tensor_reads: set = set()
        self._static: set = set()
        self._uid = 0

    # -- helpers -----------------------------------------------------------

    def sym(self):
        from ... import symbol as S
        return S

    def get(self, name):
        """Symbol for an ONNX tensor name (variable for params/inputs).
        Param variables carry their initializer's shape so downstream
        infer_shape/simple_bind resolve without the caller re-supplying
        every constant's shape."""
        if name not in self.tensors:
            if name in self.init:
                self.tensors[name] = self.sym().Variable(
                    name, shape=tuple(self.init[name].shape))
                self.used_params.add(name)
            else:
                self.tensors[name] = self.sym().Variable(name)
        return self.tensors[name]

    def const(self, name) -> np.ndarray:
        """A tensor that must be compile-time static (shape vectors,
        clip bounds), i.e. present as an initializer.  This node reads it
        statically; it stays a param if another node reads it as a
        tensor."""
        if name not in self.init:
            raise MXNetError(
                f"ONNX import: input {name!r} must be an initializer")
        self._static.add(name)
        value = self.init[name]
        return value.float().numpy() if isinstance(value, torch.Tensor) \
            else value

    def set_out(self, node, outputs):
        names = node["output"]
        for name, out in zip(names, outputs):
            if name:
                self.tensors[name] = out

    # -- op converters -----------------------------------------------------

    def convert(self, node):
        op = node["op_type"]
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise MXNetError(
                f"No MXNet conversion registered for ONNX op {op!r} "
                f"(node {node['name']!r})")
        self._static = set()
        fn(node, node["attrs"], [self.get(i) for i in node["input"] if i])
        self.tensor_reads.update(i for i in node["input"]
                                 if i and i not in self._static)

    def op_Conv(self, node, attrs, ins):
        self._check_auto_pad(node, attrs)
        pads = attrs.get("pads")
        kernel = attrs["kernel_shape"]
        ndim = len(kernel)
        if pads and pads[:ndim] != pads[ndim:]:
            raise MXNetError("ONNX import: asymmetric Conv pads unsupported")
        w = self.const_shape(node["input"][1])
        out = self.sym().Convolution(
            *ins, kernel=tuple(kernel),
            stride=tuple(attrs.get("strides", [1] * ndim)),
            dilate=tuple(attrs.get("dilations", [1] * ndim)),
            pad=tuple((pads or [0] * 2 * ndim)[:ndim]),
            num_group=int(attrs.get("group", 1)),
            num_filter=int(w[0]), no_bias=len(ins) == 2,
            name=self._name(node))
        self.set_out(node, [out])

    def const_shape(self, name):
        if name in self.init:
            return self.init[name].shape
        raise MXNetError(f"ONNX import: weight {name!r} must be an "
                         "initializer to infer its layer config")

    @staticmethod
    def _check_auto_pad(node, attrs):
        # SAME_UPPER/SAME_LOWER carry no pads attr; importing them as
        # pad=0 would be silently wrong.  VALID *is* pads=0 — allowed.
        if attrs.get("auto_pad", "NOTSET") not in ("NOTSET", "", "VALID"):
            raise MXNetError(
                f"ONNX import: {node['op_type']} "
                f"auto_pad={attrs['auto_pad']!r} unsupported "
                "(explicit pads only)")

    def op_ConvTranspose(self, node, attrs, ins):
        self._check_auto_pad(node, attrs)
        kernel = attrs["kernel_shape"]
        ndim = len(kernel)
        pads = attrs.get("pads", [0] * 2 * ndim)
        if pads[:ndim] != pads[ndim:]:
            raise MXNetError(
                "ONNX import: asymmetric ConvTranspose pads unsupported")
        if attrs.get("output_shape"):
            raise MXNetError(
                "ONNX import: ConvTranspose output_shape unsupported")
        w = self.const_shape(node["input"][1])
        group = int(attrs.get("group", 1))
        out = self.sym().Deconvolution(
            *ins, kernel=tuple(kernel),
            stride=tuple(attrs.get("strides", [1] * ndim)),
            dilate=tuple(attrs.get("dilations", [1] * ndim)),
            pad=tuple(pads[:ndim]),
            adj=tuple(attrs.get("output_padding", [0] * ndim)),
            num_group=group, num_filter=int(w[1]) * group,
            no_bias=len(ins) == 2, name=self._name(node))
        self.set_out(node, [out])

    def op_BatchNormalization(self, node, attrs, ins):
        for aux in node["input"][3:5]:
            self.aux_names.add(aux)
        out = self.sym().BatchNorm(
            *ins, eps=float(attrs.get("epsilon", 1e-5)),
            momentum=float(attrs.get("momentum", 0.9)),
            fix_gamma=False, name=self._name(node))
        self.set_out(node, [out])

    def op_Gemm(self, node, attrs, ins):
        if (attrs.get("transA", 0) or not attrs.get("transB", 0)
                or attrs.get("alpha", 1.0) != 1.0
                or attrs.get("beta", 1.0) != 1.0):
            raise MXNetError("ONNX import: only Gemm(alpha=1, beta=1, "
                             "transB=1) maps to FullyConnected")
        w = self.const_shape(node["input"][1])
        out = self.sym().FullyConnected(
            *ins, num_hidden=int(w[0]), no_bias=len(ins) == 2,
            flatten=False, name=self._name(node))
        self.set_out(node, [out])

    def op_MatMul(self, node, attrs, ins):
        # ONNX MatMul is batched over leading dims; linalg_gemm2 has the
        # same contract (plain 2D included) — sym.dot would contract the
        # wrong axes for rank>2
        self.set_out(node, [self.sym().linalg.gemm2(
            *ins, name=self._name(node))])

    def op_Gather(self, node, attrs, ins):
        self.set_out(node, [self.sym().take(
            ins[0], ins[1], axis=int(attrs.get("axis", 0)),
            name=self._name(node))])

    def op_Expand(self, node, attrs, ins):
        shape = tuple(int(s) for s in self.const(node["input"][1]))
        self.set_out(node, [self.sym().broadcast_to(
            ins[0], shape=shape, name=self._name(node))])

    def op_Where(self, node, attrs, ins):
        self.set_out(node, [self.sym().where(
            *ins, name=self._name(node))])

    def op_Greater(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_greater")

    def op_Less(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_lesser")

    def op_Equal(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_equal")

    def op_Not(self, node, attrs, ins):
        self.set_out(node, [self.sym().logical_not(
            ins[0], name=self._name(node))])

    def op_CumSum(self, node, attrs, ins):
        if attrs.get("exclusive") or attrs.get("reverse"):
            raise MXNetError("ONNX import: CumSum exclusive/reverse "
                             "unsupported")
        axis = int(np.asarray(self.const(node["input"][1])).flat[0])
        self.set_out(node, [self.sym().cumsum(
            ins[0], axis=axis, name=self._name(node))])

    def op_Slice(self, node, attrs, ins):
        names = node["input"]
        if len(names) >= 3:  # opset 10+: starts/ends[/axes[/steps]] inputs
            starts = [int(v) for v in self.const(names[1])]
            ends = [int(v) for v in self.const(names[2])]
            # axes/steps are optional; "" is the empty-placeholder form
            if len(names) >= 4 and names[3]:
                axes = [int(v) for v in self.const(names[3])]
            else:
                axes = list(range(len(starts)))
            if len(names) >= 5 and names[4]:
                steps = [int(v) for v in self.const(names[4])]
                if any(s != 1 for s in steps):
                    raise MXNetError("ONNX import: strided Slice")
        else:  # opset <10: attributes
            starts = [int(v) for v in attrs["starts"]]
            ends = [int(v) for v in attrs["ends"]]
            axes = [int(v) for v in attrs.get("axes",
                                              range(len(starts)))]
        out = ins[0]
        S = self.sym()
        big = 1 << 60
        for ax, b, e in zip(axes, starts, ends):
            out = S.slice_axis(out, axis=ax, begin=b,
                               end=None if e >= big else e)
        self.set_out(node, [out])

    def _pool(self, node, attrs, ins, pool_type, global_pool=False):
        kw = dict(pool_type=pool_type, global_pool=global_pool,
                  name=self._name(node))
        if not global_pool:
            kernel = attrs["kernel_shape"]
            ndim = len(kernel)
            pads = attrs.get("pads", [0] * 2 * ndim)
            if pads[:ndim] != pads[ndim:]:
                raise MXNetError(
                    "ONNX import: asymmetric Pool pads unsupported")
            kw.update(kernel=tuple(kernel),
                      stride=tuple(attrs.get("strides", [1] * ndim)),
                      pad=tuple(pads[:ndim]),
                      pooling_convention=("full" if attrs.get("ceil_mode")
                                          else "valid"))
            if pool_type == "avg":
                kw["count_include_pad"] = bool(
                    attrs.get("count_include_pad", 0))
        self.set_out(node, [self.sym().Pooling(ins[0], **kw)])

    def op_MaxPool(self, node, attrs, ins):
        self._pool(node, attrs, ins, "max")

    def op_AveragePool(self, node, attrs, ins):
        self._pool(node, attrs, ins, "avg")

    def op_GlobalMaxPool(self, node, attrs, ins):
        self._pool(node, attrs, ins, "max", global_pool=True)

    def op_GlobalAveragePool(self, node, attrs, ins):
        self._pool(node, attrs, ins, "avg", global_pool=True)

    def op_Flatten(self, node, attrs, ins):
        if attrs.get("axis", 1) != 1:
            raise MXNetError("ONNX import: Flatten axis != 1 unsupported")
        self.set_out(node, [self.sym().Flatten(ins[0],
                                               name=self._name(node))])

    def _act(self, node, ins, act_type):
        self.set_out(node, [self.sym().Activation(
            ins[0], act_type=act_type, name=self._name(node))])

    def op_Relu(self, node, attrs, ins):
        self._act(node, ins, "relu")

    def op_Sigmoid(self, node, attrs, ins):
        self._act(node, ins, "sigmoid")

    def op_Tanh(self, node, attrs, ins):
        self._act(node, ins, "tanh")

    def op_Softplus(self, node, attrs, ins):
        self._act(node, ins, "softrelu")

    def op_Softsign(self, node, attrs, ins):
        self._act(node, ins, "softsign")

    def op_LeakyRelu(self, node, attrs, ins):
        self.set_out(node, [self.sym().LeakyReLU(
            ins[0], act_type="leaky",
            slope=float(attrs.get("alpha", 0.01)),
            name=self._name(node))])

    def op_Elu(self, node, attrs, ins):
        self.set_out(node, [self.sym().LeakyReLU(
            ins[0], act_type="elu", slope=float(attrs.get("alpha", 1.0)),
            name=self._name(node))])

    def op_PRelu(self, node, attrs, ins):
        self.set_out(node, [self.sym().LeakyReLU(
            *ins, act_type="prelu", name=self._name(node))])

    def _softmax(self, node, attrs, ins, op):
        # opset<13 Softmax flattens [d0..daxis-1], [daxis..dn] and
        # normalizes rows.  axis=-1 equals single-axis softmax on the last
        # dim; axis=1 (the ONNX default) is reproduced rank-generically by
        # collapsing trailing dims, applying softmax, and restoring the
        # shape; other axes need rank info we don't have — raise.
        S = self.sym()
        axis = int(attrs.get("axis", 1))
        fn = getattr(S, op)
        if axis == -1:
            out = fn(ins[0], axis=-1, name=self._name(node))
        elif axis == 1:
            flat = S.Reshape(ins[0], shape=(0, -1))
            out = S.reshape_like(fn(flat, axis=-1, name=self._name(node)),
                                 ins[0])
        else:
            raise MXNetError(
                f"ONNX import: {node['op_type']} axis={axis} flatten "
                "semantics unsupported (only axis in (1, -1))")
        self.set_out(node, [out])

    def op_Softmax(self, node, attrs, ins):
        self._softmax(node, attrs, ins, "softmax")

    def op_LogSoftmax(self, node, attrs, ins):
        self._softmax(node, attrs, ins, "log_softmax")

    def op_Dropout(self, node, attrs, ins):
        self.set_out(node, [self.sym().Dropout(
            ins[0], p=float(attrs.get("ratio", 0.5)),
            name=self._name(node))])

    def _binary(self, node, ins, op):
        self.set_out(node, [getattr(self.sym(), op)(
            ins[0], ins[1], name=self._name(node))])

    def op_Add(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_add")

    def op_Sub(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_sub")

    def op_Mul(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_mul")

    def op_Div(self, node, attrs, ins):
        self._binary(node, ins, "broadcast_div")

    def op_Sum(self, node, attrs, ins):
        self.set_out(node, [self.sym().add_n(*ins, name=self._name(node))])

    def op_Concat(self, node, attrs, ins):
        self.set_out(node, [self.sym().Concat(
            *ins, dim=int(attrs.get("axis", 1)), name=self._name(node))])

    def op_Reshape(self, node, attrs, ins):
        shape = tuple(int(s) for s in self.const(node["input"][1]))
        self.set_out(node, [self.sym().Reshape(
            ins[0], shape=shape, name=self._name(node))])

    def op_Transpose(self, node, attrs, ins):
        perm = attrs.get("perm")
        kw = {"axes": tuple(int(p) for p in perm)} if perm else {}
        self.set_out(node, [self.sym().transpose(
            ins[0], name=self._name(node), **kw)])

    def op_Clip(self, node, attrs, ins):
        def bound(idx, default):
            # opset 11: min/max are optional inputs; "" is the standard
            # empty-placeholder for an omitted one
            names = node["input"]
            if len(names) > idx and names[idx]:
                return float(np.asarray(self.const(names[idx])).flat[0])
            return default
        if len(node["input"]) >= 2:  # opset 11 form
            lo = bound(1, -np.inf)
            hi = bound(2, np.inf)
        else:  # opset <11: attributes
            lo = float(attrs.get("min", -np.inf))
            hi = float(attrs.get("max", np.inf))
        self.set_out(node, [self.sym().clip(
            ins[0], a_min=lo, a_max=hi, name=self._name(node))])

    def op_Identity(self, node, attrs, ins):
        self.set_out(node, [ins[0]])

    def op_Squeeze(self, node, attrs, ins):
        axes = attrs.get("axes")
        kw = {"axis": tuple(int(a) for a in axes)} if axes else {}
        self.set_out(node, [self.sym().squeeze(
            ins[0], name=self._name(node), **kw)])

    def op_Unsqueeze(self, node, attrs, ins):
        out = ins[0]
        S = self.sym()
        for a in sorted(int(x) for x in attrs["axes"]):
            out = S.expand_dims(out, axis=a)
        self.set_out(node, [out])

    def op_Split(self, node, attrs, ins):
        sizes = attrs.get("split")
        if sizes is None and len(node["input"]) >= 2 and node["input"][1] \
                and node["input"][1] in self.init:
            # opset 13+: split sizes arrive as a second input rather than
            # an attribute; validate when statically known (initializer or
            # Constant) — runtime-computed sizes keep the legacy
            # even-split import
            sizes = [int(s) for s in
                     np.asarray(self.const(node["input"][1])).flatten()]
        if sizes and len(set(int(s) for s in sizes)) > 1:
            # SliceChannel only emits equal parts; importing an uneven
            # split as an even one would silently produce wrong shapes
            raise MXNetError(
                f"ONNX Split node {self._name(node)!r}: uneven split "
                f"sizes {[int(s) for s in sizes]} are not supported "
                "(SliceChannel emits equal parts only); re-export the "
                "model with equal splits")
        out = self.sym().SliceChannel(
            ins[0], num_outputs=len(node["output"]),
            axis=int(attrs.get("axis", 0)), name=self._name(node))
        self.set_out(node, list(out))

    def op_Cast(self, node, attrs, ins):
        self.set_out(node, [self.sym().cast(
            ins[0], dtype=P.onnx_dtype_name(attrs["to"]),
            name=self._name(node))])

    def op_Constant(self, node, attrs, ins):
        name = node["output"][0]
        t = attrs.get("value")
        if t is None:
            # ONNX allows value_float/value_int/value_floats/... variants;
            # only the tensor form is supported — name the form found
            # instead of dying with a bare KeyError
            present = sorted(k for k in attrs if k.startswith("value")
                             or k == "sparse_value")
            raise MXNetError(
                f"ONNX Constant node {name!r}: only the tensor-valued "
                f"`value` attribute is supported, got "
                f"{present or sorted(attrs)}; re-export the constant as "
                "a tensor")
        self.init[name] = t["array"]
        # materialized lazily (as a param or via const()) on first use

    def _unary(self, node, ins, op):
        self.set_out(node, [getattr(self.sym(), op)(
            ins[0], name=self._name(node))])

    def op_Exp(self, node, attrs, ins):
        self._unary(node, ins, "exp")

    def op_Log(self, node, attrs, ins):
        self._unary(node, ins, "log")

    def op_Sqrt(self, node, attrs, ins):
        self._unary(node, ins, "sqrt")

    def op_Abs(self, node, attrs, ins):
        self._unary(node, ins, "abs")

    def op_Neg(self, node, attrs, ins):
        self._unary(node, ins, "negative")

    def op_Erf(self, node, attrs, ins):
        self._unary(node, ins, "erf")

    def op_Floor(self, node, attrs, ins):
        self._unary(node, ins, "floor")

    def op_Ceil(self, node, attrs, ins):
        self._unary(node, ins, "ceil")

    def _reduce(self, node, attrs, ins, op):
        axes = attrs.get("axes")
        kw = {"keepdims": bool(attrs.get("keepdims", 1))}
        if axes is not None:
            kw["axis"] = tuple(int(a) for a in axes)
        self.set_out(node, [getattr(self.sym(), op)(
            ins[0], name=self._name(node), **kw)])

    def op_ReduceMean(self, node, attrs, ins):
        self._reduce(node, attrs, ins, "mean")

    def op_ReduceSum(self, node, attrs, ins):
        self._reduce(node, attrs, ins, "sum")

    # -- driver ------------------------------------------------------------

    def _name(self, node):
        if node["name"]:
            return node["name"]
        self._uid += 1
        return f"onnx_{node['op_type'].lower()}{self._uid}"

    def _param(self, name):
        from ...context import resolve_device
        from ...ndarray import NDArray

        value = self.init[name]
        dev = resolve_device(self.ctx)
        if isinstance(value, torch.Tensor):  # bfloat16, bit for bit
            return NDArray(value.to(dev), ctx=dev)
        return NDArray(torch.from_numpy(np.ascontiguousarray(value).copy())
                       .to(dev), ctx=dev)

    def run(self):
        for node in self.graph["node"]:
            self.convert(node)
        outs = [self.tensors[o["name"]] for o in self.graph["output"]]
        # an initializer that is itself a graph output is read as a tensor
        self.tensor_reads.update(o["name"] for o in self.graph["output"])
        S = self.sym()
        sym = outs[0] if len(outs) == 1 else S.Group(outs)
        arg_params, aux_params = {}, {}
        for name in sorted(self.used_params & self.tensor_reads):
            arr = self._param(name)
            (aux_params if name in self.aux_names else arg_params)[name] = arr
        return sym, arg_params, aux_params


def import_onnx_model(model_bytes: bytes, ctx=None):
    """(sym, arg_params, aux_params) of an ONNX model's bytes; the params
    are NDArrays on ``ctx`` (default: the card)."""
    model = P.parse_model(model_bytes)
    if model["graph"] is None:
        raise MXNetError("ONNX import: no graph in model file")
    return _Importer(model["graph"], ctx).run()
