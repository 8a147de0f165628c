"""Symbol: the declarative graph-construction API.

Counterpart of ``mxnet_tpu/symbol/symbol.py``.  A Symbol is a small python
DAG over the op registry the imperative path uses (``ops/registry.py``), so
every registered op has a symbolic spelling.  The graph file is the JAX
package's (``tojson``: ``nodes`` / ``arg_nodes`` / ``heads``,
``mxnet_version`` 10500), so graphs cross between the packages both ways.

Departures from the JAX package, on purpose:

  * shape and type inference runs each node's registry op on ``meta``
    tensors (shapes and dtypes, no data) instead of ``jax.eval_shape``;
    an op that cannot run on meta tensors infers through its rule in
    ``_SHAPE_RULES`` (the recurrences ``RNN`` / ``_fused_rnn``, whose
    torch kernels have no meta implementation);
  * the graph runs eagerly (``build_graph_eval``): no jit, one registry op
    call per node, under torch's autograd where the executor records;
  * the port's random ops, ``Dropout`` and ``_fused_rnn`` take no PRNG key
    input (their draws come from the device's generator, ``random``).  A
    JAX graph file gives those nodes a ``*_key`` variable input; ``load``
    drops it (``_JAX_KEY_AT``).  Node inputs map onto the port op's
    arguments by name, so a dropped key shifts nothing else.
"""
from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

# ---------------------------------------------------------------------------
# graph nodes
# ---------------------------------------------------------------------------
_UID: Dict[str, int] = {}


def _auto_name(op_name: str) -> str:
    base = op_name.lstrip("_").lower()
    n = _UID.get(base, 0)
    _UID[base] = n + 1
    return f"{base}{n}"


class _Node:
    """One graph node: a variable (op is None) or an op application."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "vattrs")

    def __init__(self, op: Optional[str], name: str, attrs: dict,
                 inputs: List[Tuple["_Node", int]], num_outputs: int = 1,
                 vattrs: Optional[dict] = None):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = num_outputs
        self.vattrs = vattrs or {}   # variable decorations: shape/dtype/attr

    def is_variable(self) -> bool:
        return self.op is None


def _topo_order(entries: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    """DFS post-order over inputs: the order of ``list_arguments`` (data
    before its consumers' weights)."""
    seen: Dict[int, bool] = {}
    order: List[_Node] = []

    def visit(node: _Node):
        if id(node) in seen:
            return
        seen[id(node)] = True
        for parent, _ in node.inputs:
            visit(parent)
        order.append(node)

    for node, _ in entries:
        visit(node)
    return order


# ---------------------------------------------------------------------------
# per-op symbolic metadata
# ---------------------------------------------------------------------------
# auxiliary-state argument names per op (mutated inputs, e.g. BatchNorm's
# moving stats)
_AUX_ARGS = {"BatchNorm": ("moving_mean", "moving_var")}

# where a JAX graph's op node carries its PRNG key input (the JAX ops'
# signatures); the port's ops take none
_JAX_KEY_AT = {"Dropout": 1, "_fused_rnn": 1, "_shuffle": 0,
               "_sample_multinomial": 0, "sample_uniform": 0,
               "sample_normal": 0,
               **{f"_random_{k}": 0 for k in (
                   "uniform", "normal", "gamma", "exponential", "poisson",
                   "negative_binomial", "generalized_negative_binomial",
                   "randint")}}


def _op_arg_names(op_name: str) -> Tuple[List[str], Optional[str]]:
    """(required array-arg names, varargs name or None) from the
    registered fn's signature."""
    import inspect

    op = _reg.get_op(op_name)
    sig = inspect.signature(op.fn)
    req, var = [], None
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            var = p.name
        elif p.kind == p.POSITIONAL_OR_KEYWORD and p.default is p.empty:
            req.append(p.name)
    return req, var


def static_num_outputs(op_name: str, attrs: dict) -> int:
    """Build-time output count for ops whose count the attrs fix, so that
    ``sym.SliceChannel(x, num_outputs=3)[i]`` indexes before inference."""
    if op_name in ("SliceChannel", "split"):
        return int(attrs.get("num_outputs", 1))
    if op_name == "split_v2":
        sections = int(attrs.get("sections", 0) or 0)
        if sections > 0:
            return sections
        spec = attrs.get("indices_or_sections", 1)
        return int(spec) if isinstance(spec, int) else len(spec) + 1
    if op_name in ("moments", "linalg_slogdet", "linalg_gelqf"):
        return 2
    if op_name == "topk" and attrs.get("ret_typ") == "both":
        return 2
    if op_name in ("RNN", "_fused_rnn"):
        if op_name == "_fused_rnn" or attrs.get("state_outputs"):
            return 3 if attrs.get("mode", "lstm") == "lstm" else 2
    return 1


def _infer_param_shape(op_name: str, arg_name: str, data_shape, attrs):
    """Shape of an auto-created parameter variable from the op's data
    input shape (the symbolic twin of Gluon's deferred init)."""
    a = attrs
    if op_name == "FullyConnected":
        nh = int(a["num_hidden"])
        if arg_name == "weight":
            flat = a.get("flatten", True)
            in_units = (int(np.prod(data_shape[1:])) if flat
                        else int(data_shape[-1]))
            return (nh, in_units)
        if arg_name == "bias":
            return (nh,)
    elif op_name in ("Convolution", "Deconvolution"):
        nf = int(a["num_filter"])
        ng = int(a.get("num_group", 1))
        kernel = tuple(int(k) for k in a["kernel"])
        c = int(data_shape[1])
        if arg_name == "weight":
            if op_name == "Convolution":
                return (nf, c // ng) + kernel
            return (c, nf // ng) + kernel
        if arg_name == "bias":
            return (nf,)
    elif op_name == "BatchNorm":
        axis = int(a.get("axis", 1))
        return (int(data_shape[axis]),)
    elif op_name == "LayerNorm":
        axis = int(a.get("axis", -1))
        return (int(data_shape[axis]),)
    elif op_name == "Embedding":
        if arg_name == "weight":
            return (int(a["input_dim"]), int(a["output_dim"]))
    elif op_name == "SoftmaxOutput":
        if arg_name == "label":
            if a.get("multi_output", False):
                return (data_shape[0],) + tuple(data_shape[2:])
            return tuple(data_shape[:-1])
    elif op_name in ("LinearRegressionOutput", "MAERegressionOutput",
                     "LogisticRegressionOutput"):
        if arg_name == "label":
            return tuple(data_shape)
    elif op_name == "RNN":
        if arg_name == "parameters":
            from ..ops.rnn_ops import rnn_packed_layout

            _, total = rnn_packed_layout(
                a.get("mode", "lstm"), int(data_shape[2]),
                int(a["state_size"]), int(a.get("num_layers", 1)),
                a.get("bidirectional", False))
            return (total,)
        if arg_name in ("state", "state_cell"):
            H = int(a["state_size"])
            L = int(a.get("num_layers", 1))
            dirs = 2 if a.get("bidirectional", False) else 1
            return (L * dirs, int(data_shape[1]), H)
    return None


def _rnn_shapes(node, ins):
    """Output shapes of ``RNN`` / ``_fused_rnn`` (the recurrences have no
    meta kernel): out (T, N, dirs H), then h_n (and c_n) (L dirs, N, H)."""
    a = node.attrs
    data = ins[0]
    if node.op == "RNN" and a.get("mode", "lstm") == "lstm" and len(ins) < 4:
        raise MXNetError("RNN in lstm mode needs its state_cell input")
    H = int(a.get("state_size", 0))
    dirs = 2 if a.get("bidirectional", False) else 1
    L = int(a.get("num_layers", 1))
    T, N = int(data.shape[0]), int(data.shape[1])
    out = [(T, N, dirs * H)]
    if static_num_outputs(node.op, a) > 1:
        out += [(L * dirs, N, H)] * (static_num_outputs(node.op, a) - 1)
    return [torch.empty(s, dtype=data.dtype, device="meta") for s in out]


# ops inferred by rule instead of by running on meta tensors
_SHAPE_RULES = {"RNN": _rnn_shapes, "_fused_rnn": _rnn_shapes}


def _np_dtype(t: torch.dtype):
    from ..ndarray.ndarray import _NP_OF_TORCH

    np_t = _NP_OF_TORCH.get(t)
    return np.dtype(np_t) if np_t is not None else str(t).replace(
        "torch.", "")


def _meta(shape, dtype) -> torch.Tensor:
    from ..ndarray.ndarray import dtype_torch

    return torch.empty(tuple(int(s) for s in shape),
                       dtype=dtype_torch(dtype or "float32"), device="meta")


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------
class Symbol:
    """An immutable handle to one or more outputs of a graph node."""

    __slots__ = ("_entries",)

    def __init__(self, entries: Sequence[Tuple[_Node, int]]):
        self._entries = list(entries)

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def attr(self, key):
        node = self._entries[0][0]
        v = node.attrs.get(key, node.vattrs.get("attr", {}).get(key))
        return None if v is None else str(v)

    def list_attr(self):
        node = self._entries[0][0]
        out = {k: str(v) for k, v in node.attrs.items()}
        out.update({k: str(v) for k, v in node.vattrs.get("attr", {}).items()})
        return out

    def __repr__(self):
        names = ", ".join(n.name for n, _ in self._entries)
        return f"<Symbol {names}>"

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            for e in self._entries:
                if _entry_name(e) == index or e[0].name == index:
                    return Symbol([e])
            raise MXNetError(f"no output named {index!r}")
        return Symbol([self._entries[index]])

    # -- graph queries -----------------------------------------------------
    def list_arguments(self) -> List[str]:
        aux = set(self._aux_nodes())
        return [n.name for n in _topo_order(self._entries)
                if n.is_variable() and id(n) not in aux]

    def list_auxiliary_states(self) -> List[str]:
        order = {id(n): i for i, n in enumerate(_topo_order(self._entries))}
        nodes = self._aux_node_objs()
        nodes.sort(key=lambda n: order[id(n)])
        return [n.name for n in nodes]

    def list_outputs(self) -> List[str]:
        return [_entry_name(e) for e in self._entries]

    def list_inputs(self) -> List[str]:
        return self.list_arguments() + self.list_auxiliary_states()

    def _aux_node_objs(self) -> List[_Node]:
        out, seen = [], set()
        for node in _topo_order(self._entries):
            if node.op in _AUX_ARGS:
                req, _ = _op_arg_names(node.op)
                for aname in _AUX_ARGS[node.op]:
                    idx = req.index(aname)
                    parent = node.inputs[idx][0]
                    if parent.is_variable() and id(parent) not in seen:
                        seen.add(id(parent))
                        out.append(parent)
        return out

    def _aux_nodes(self):
        return [id(n) for n in self._aux_node_objs()]

    def get_internals(self) -> "Symbol":
        entries = []
        for node in _topo_order(self._entries):
            for i in range(node.num_outputs):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self) -> Optional["Symbol"]:
        node = self._entries[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # -- shape/type inference ---------------------------------------------
    def infer_shape(self, *args, **kwargs):
        arg_s, out_s, aux_s = self._infer(partial=False, shapes=kwargs,
                                          pos_shapes=args)
        return arg_s, out_s, aux_s

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer(partial=True, shapes=kwargs, pos_shapes=args)

    def infer_type(self, **kwargs):
        structs = self._infer_structs(shapes={}, dtypes=kwargs, partial=True)
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()

        def dt(name):
            s = structs["vars"].get(name)
            return None if s is None else _np_dtype(s.dtype)
        return ([dt(a) for a in args],
                [None if s is None else _np_dtype(s.dtype)
                 for s in structs["outs"]],
                [dt(a) for a in auxs])

    def _infer(self, partial, shapes, pos_shapes=()):
        args = self.list_arguments()
        if pos_shapes:
            shapes = dict(shapes)
            for name, shp in zip(args, pos_shapes):
                if shp is not None:
                    shapes[name] = shp
        structs = self._infer_structs(shapes=shapes, dtypes={},
                                      partial=partial)
        auxs = self.list_auxiliary_states()

        def shp(name):
            s = structs["vars"].get(name)
            return None if s is None else tuple(s.shape)
        arg_shapes = [shp(a) for a in args]
        aux_shapes = [shp(a) for a in auxs]
        out_shapes = [None if s is None else tuple(s.shape)
                      for s in structs["outs"]]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            missing = [a for a, s in zip(args, arg_shapes) if s is None]
            raise MXNetError(f"infer_shape incomplete; unknown args: {missing}"
                             f" (provide their shapes)")
        return arg_shapes, out_shapes, aux_shapes

    def _infer_structs(self, shapes: dict, dtypes: dict, partial: bool):
        """Topo walk computing a meta tensor per entry; unknown parameter
        variables get shapes from ``_infer_param_shape``."""
        order = _topo_order(self._entries)
        var_struct: Dict[str, Any] = {}
        node_out: Dict[int, list] = {}

        for node in order:
            if node.is_variable():
                shp = shapes.get(node.name, node.vattrs.get("shape"))
                dt = (dtypes.get(node.name, node.vattrs.get("dtype"))
                      or "float32")
                if shp is not None:
                    var_struct[node.name] = _meta(shp, dt)
                node_out[id(node)] = [var_struct.get(node.name)]
                continue

            req, _varargs = _op_arg_names(node.op) \
                if node.op != "_subgraph" else ([], None)

            def _aname(i):
                return req[i] if i < len(req) else (_varargs or f"arg{i}")
            in_structs = []
            data_struct = None
            for i, (parent, oidx) in enumerate(node.inputs):
                if parent.is_variable():
                    s = var_struct.get(parent.name)
                else:
                    lst = node_out.get(id(parent), [None])
                    s = lst[oidx] if oidx < len(lst) else None
                if s is None and parent.is_variable() and data_struct is not None:
                    shp = _infer_param_shape(node.op, _aname(i),
                                             data_struct.shape, node.attrs)
                    if shp is not None:
                        s = _meta(shp, "float32")
                        var_struct[parent.name] = s
                if i == 0:
                    data_struct = s
                in_structs.append(s)

            if any(s is None for s in in_structs):
                node_out[id(node)] = [None] * node.num_outputs
                continue
            try:
                rule = _SHAPE_RULES.get(node.op)
                with torch.no_grad():
                    outs = (rule(node, in_structs) if rule is not None
                            else _apply_node(node, in_structs, False))
            except Exception as e:  # noqa: BLE001
                if partial:
                    node_out[id(node)] = [None] * node.num_outputs
                    continue
                raise MXNetError(
                    f"shape inference failed at node {node.name} "
                    f"(op {node.op}): {e}") from e
            outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
            node_out[id(node)] = outs
            node.num_outputs = len(outs)

        out_structs = []
        for node, idx in self._entries:
            lst = node_out.get(id(node), [None])
            out_structs.append(lst[idx] if idx < len(lst) else None)
        # per-node output structs keyed by id(node): tools that need the
        # intermediate shapes (print_summary) read them
        return {"vars": var_struct, "outs": out_structs, "nodes": node_out}

    # -- graph passes ------------------------------------------------------
    def optimize_for(self, backend: str, args=None, aux=None, **kwargs):
        """Partition the graph for a subgraph backend (``subgraph``)."""
        from ..subgraph import partition

        return partition(self, backend)

    def get_backend_symbol(self, backend: str):
        """The 1.x spelling of ``optimize_for``."""
        return self.optimize_for(backend)

    # -- binding / evaluation ---------------------------------------------
    def _env_partitioned(self):
        """Apply the MXNET_SUBGRAPH_BACKEND hook before binding."""
        from ..subgraph import env_backend

        be = env_backend()
        return self.optimize_for(be) if be else self

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from .executor import Executor

        return Executor(self._env_partitioned(), ctx=ctx, args=args,
                        args_grad=args_grad, grad_req=grad_req,
                        aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        from .executor import Executor

        return Executor._simple_bind(self._env_partitioned(), ctx=ctx,
                                     grad_req=grad_req, type_dict=type_dict,
                                     shapes=shapes)

    def eval(self, ctx=None, **kwargs):
        from ..ndarray import NDArray

        arg_arrays = {k: v for k, v in kwargs.items()
                      if isinstance(v, NDArray)}
        exe = self.bind(ctx=ctx, args=arg_arrays, grad_req="null")
        return exe.forward(is_train=False)

    # -- serialization -----------------------------------------------------
    def tojson(self) -> str:
        order = _topo_order(self._entries)
        nid = {id(n): i for i, n in enumerate(order)}
        nodes, arg_nodes = [], []
        for i, n in enumerate(order):
            if n.is_variable():
                arg_nodes.append(i)
                entry = {"op": "null", "name": n.name, "inputs": []}
                vat = {}
                if n.vattrs.get("shape") is not None:
                    vat["__shape__"] = str(tuple(n.vattrs["shape"]))
                if n.vattrs.get("dtype") is not None:
                    vat["__dtype__"] = str(n.vattrs["dtype"])
                init = n.vattrs.get("init")
                if init is not None:
                    # the reference's '["name", {kwargs}]' (__init__ attr)
                    vat["__init__"] = (init if isinstance(init, str)
                                       else init.dumps())
                if vat:
                    entry["attrs"] = vat
            else:
                entry = {
                    "op": n.op, "name": n.name,
                    "attrs": {k: str(v) for k, v in n.attrs.items()},
                    "inputs": [[nid[id(p)], oi, 0] for p, oi in n.inputs],
                }
            nodes.append(entry)
        heads = [[nid[id(n)], oi, 0] for n, oi in self._entries]
        return json.dumps({
            "nodes": nodes, "arg_nodes": arg_nodes, "heads": heads,
            "attrs": {"mxnet_version": ["int", 10500]},
        }, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- composition sugar -------------------------------------------------
    def __call__(self, **kwargs):
        """Compose: replace named variable inputs with other symbols."""
        mapping = {}
        for name, s in kwargs.items():
            if not isinstance(s, Symbol):
                raise MXNetError("compose expects Symbol keyword arguments")
            mapping[name] = s._entries[0]
        memo: Dict[int, _Node] = {}  # shared across heads to keep the DAG
        return Symbol([_substitute(e, mapping, memo) for e in self._entries])

    # -- arithmetic sugar --------------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_sym(op, [a, b], {})
        return _apply_sym(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self.__add__(o)
    def __sub__(self, o): return self._binary(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "broadcast_sub", "_rminus_scalar", True)
    def __mul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self.__mul__(o)
    def __truediv__(self, o): return self._binary(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "broadcast_div", "_rdiv_scalar", True)
    def __pow__(self, o): return self._binary(o, "broadcast_power", "_power_scalar")
    def __neg__(self): return _apply_sym("_mul_scalar", [self], {"scalar": -1.0})

    # common method forms
    def reshape(self, *shape):
        # both spellings, as NDArray.reshape: s.reshape((a, b)) and
        # s.reshape(a, b)
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _apply_sym("Reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=()):
        return _apply_sym("transpose", [self], {"axes": tuple(axes)})

    def astype(self, dtype):
        return _apply_sym("Cast", [self], {"dtype": str(np.dtype(dtype))})

    def expand_dims(self, axis):
        return _apply_sym("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _apply_sym("squeeze", [self],
                          {} if axis is None else {"axis": axis})

    def flatten(self):
        return _apply_sym("Flatten", [self], {})

    def sum(self, axis=None, keepdims=False):
        return _apply_sym("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _apply_sym("mean", [self], {"axis": axis, "keepdims": keepdims})


def _entry_name(entry) -> str:
    node, idx = entry
    if node.is_variable():
        return node.name
    suffix = "_output" if node.num_outputs == 1 else f"_output{idx}"
    return node.name + suffix


def _substitute(entry, mapping, memo):
    node, idx = entry
    if id(node) in memo:
        return (memo[id(node)], idx)
    if node.is_variable():
        if node.name in mapping:
            return mapping[node.name]
        return entry
    new_inputs = [_substitute(e, mapping, memo) for e in node.inputs]
    new_node = _Node(node.op, node.name, node.attrs, new_inputs,
                     node.num_outputs)
    memo[id(node)] = new_node
    return (new_node, idx)


# ---------------------------------------------------------------------------
# node application / evaluation
# ---------------------------------------------------------------------------
def _apply_sym(op_name: str, inputs: List[Symbol], attrs: dict,
               name: Optional[str] = None) -> Symbol:
    _reg.get_op(op_name)  # validate
    name = name or _auto_name(op_name)
    entries = [s._entries[0] for s in inputs]
    node = _Node(op_name, name, attrs, entries)
    return Symbol([(node, 0)])


def _apply_node(node: _Node, in_vals: list, training: bool):
    """Run one graph node on torch tensors (meta tensors for inference).
    ``Dropout`` draws from the device's generator (``random``) in
    training; ``BatchNorm`` returns (out, mean, var)."""
    if node.op == "_subgraph":
        # a region claimed by a subgraph backend (``subgraph``), one
        # eager callable over the registry ops
        return node.attrs["fn"](*in_vals)
    op = _reg.get_op(node.op)
    attrs = dict(node.attrs)
    if node.op == "Dropout":
        attrs["training"] = training
        return op.fn(in_vals[0], **attrs)
    if node.op == "BatchNorm":
        attrs["training"] = training
        attrs["output_mean_var"] = True
        out, mean, var = op.fn(*in_vals, **attrs)
        return out, mean, var
    return op.fn(*in_vals, **attrs)


def build_graph_eval(entries: Sequence[Tuple[_Node, int]], training: bool):
    """fn(var_values: dict of tensors) -> outputs (list of tensors),
    evaluating the whole graph eagerly.  In training a BatchNorm that
    uses batch statistics moves its moving stats in place (no grad):
    ``moving = momentum * moving + (1 - momentum) * batch_stat``."""
    order = _topo_order(entries)
    bn_req = None

    def eval_fn(var_values: Dict[str, Any]):
        nonlocal bn_req
        vals: Dict[int, list] = {}
        for node in order:
            if node.is_variable():
                vals[id(node)] = [var_values[node.name]]
                continue
            ins = [vals[id(p)][oi] for p, oi in node.inputs]
            out = _apply_node(node, ins, training)
            if node.op == "BatchNorm":
                out, mean, var = out
                if training and not node.attrs.get("use_global_stats", False):
                    mom = float(node.attrs.get("momentum", 0.9))
                    if bn_req is None:
                        bn_req, _ = _op_arg_names("BatchNorm")
                    with torch.no_grad():
                        for stat, aname in ((mean, "moving_mean"),
                                            (var, "moving_var")):
                            parent = node.inputs[bn_req.index(aname)][0]
                            if parent.is_variable():
                                old = var_values[parent.name]
                                old.mul_(mom).add_(
                                    (1.0 - mom) * stat.detach().to(old.dtype))
                out = [out]
            elif not isinstance(out, (tuple, list)):
                out = [out]
            else:
                out = list(out)
            vals[id(node)] = out
            node.num_outputs = len(out)
        return [vals[id(n)][oi] for n, oi in entries]

    return eval_fn


# ---------------------------------------------------------------------------
# public constructors
# ---------------------------------------------------------------------------
def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    if not isinstance(name, str):
        raise MXNetError("Variable name must be a string")
    from .. import attribute as _attribute

    # AttrScope attrs apply to variables made in the scope; an explicit
    # attr wins, and scope __lr_mult__ / __wd_mult__ fill the typed fields
    attr = _attribute.current().get(attr)
    if lr_mult is None and "__lr_mult__" in attr:
        lr_mult = float(attr["__lr_mult__"])
    if wd_mult is None and "__wd_mult__" in attr:
        wd_mult = float(attr["__wd_mult__"])
    vattrs = {"shape": None if shape is None else tuple(shape),
              "dtype": dtype, "attr": dict(attr or {}), "init": init,
              "lr_mult": lr_mult, "wd_mult": wd_mult}
    node = _Node(None, name, {}, [], vattrs=vattrs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def _drop_key_input(op: str, inputs):
    """A JAX graph's PRNG key input of ``op`` (a ``*key`` variable at the
    JAX op's key position), dropped: the port's op takes none."""
    at = _JAX_KEY_AT.get(op)
    if at is None or at >= len(inputs):
        return inputs
    node = inputs[at][0]
    if node.is_variable() and node.name.endswith("key"):
        return inputs[:at] + inputs[at + 1:]
    return inputs


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes_data = data["nodes"]
    built: List[_Node] = []
    for nd_ in nodes_data:
        if nd_["op"] == "null":
            vattrs = {}
            raw = nd_.get("attrs", {})
            if "__shape__" in raw:
                vattrs["shape"] = tuple(ast.literal_eval(raw["__shape__"]))
            if "__dtype__" in raw:
                vattrs["dtype"] = raw["__dtype__"]
            if "__init__" in raw:
                from .. import initializer as _init

                vattrs["init"] = _init.create(raw["__init__"])
            built.append(_Node(None, nd_["name"], {}, [], vattrs=vattrs))
        else:
            attrs = {k: _parse_attr(v)
                     for k, v in nd_.get("attrs", {}).items()}
            inputs = [(built[i], oi) for i, oi, *_ in nd_["inputs"]]
            inputs = _drop_key_input(nd_["op"], inputs)
            node = _Node(nd_["op"], nd_["name"], attrs, inputs)
            node.num_outputs = static_num_outputs(nd_["op"], attrs)
            built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    return Symbol([(built[i], oi) for i, oi, *_ in heads])


def _parse_attr(v: str):
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
