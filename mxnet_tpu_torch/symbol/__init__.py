"""The ``mx.sym`` namespace.

Counterpart of ``mxnet_tpu/symbol/__init__.py``: as ``mx.nd``, the op
namespace is generated from the registry at import time, so every
registered op has a symbolic spelling, with the same auto-created
variables (``fc1_weight``, ``bn_moving_mean``) as the JAX package's, since
the ops' array arguments are named alike.  The random ops stay out, as in
the JAX package; the ufuncs (``add``, ..., ``power``) dispatch on scalars,
and ``sym.linalg`` / ``sym.contrib`` hold the short spellings.
"""
from __future__ import annotations

import inspect

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import MXNetError
from ..ops import registry as _reg
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     _auto_name, _Node, _op_arg_names, static_num_outputs)
from .executor import Executor

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor"]


def _make_sym_stub(op):
    req_names, varargs = _op_arg_names(op.name)
    sig = inspect.signature(op.fn)
    kw_order = [p.name for p in sig.parameters.values()
                if p.default is not p.empty]
    kw_ok = set(kw_order)
    no_bias_default = False
    if "no_bias" in sig.parameters:
        no_bias_default = bool(sig.parameters["no_bias"].default)

    def stub(*args, **kwargs):
        from .. import name as _nm

        explicit = kwargs.pop("name", None)
        name = (explicit if explicit is not None
                else _nm.current().get(None, _auto_name(op.name)))
        kwargs.pop("attr", None)
        sym_inputs = []
        # positional symbols fill the required slots, then the varargs
        pos = [a for a in args if isinstance(a, Symbol)]
        attrs_pos = [a for a in args if not isinstance(a, Symbol)]
        by_name = {}
        for k in list(kwargs):
            if isinstance(kwargs[k], Symbol):
                by_name[k] = kwargs.pop(k)
        if varargs and not req_names:
            # a fully variadic op (Concat, add_n): every positional
            # symbol is an input
            sym_inputs = pos
            pos = []
        else:
            for aname in req_names:
                if aname in by_name:
                    sym_inputs.append(by_name.pop(aname))
                elif pos:
                    sym_inputs.append(pos.pop(0))
                else:
                    # an auto-created variable, ``<node>_<argument>``
                    sym_inputs.append(Variable(f"{name}_{aname}"))
            if varargs and not kwargs.get("no_bias", no_bias_default):
                if by_name.get(varargs) is not None:
                    sym_inputs.append(by_name.pop(varargs))
                elif pos:
                    sym_inputs.extend(pos)
                    pos = []
                elif varargs == "bias":
                    sym_inputs.append(Variable(f"{name}_bias"))
        if pos:
            raise MXNetError(
                f"{op.name}: {len(pos)} unused positional symbol input(s)")
        if by_name:
            raise MXNetError(f"{op.name}: unknown symbol kwargs "
                             f"{sorted(by_name)}")
        # leftover positional scalars map onto keyword attrs in order
        if attrs_pos:
            free = [k for k in kw_order if k not in kwargs]
            for a, k in zip(attrs_pos, free):
                kwargs[k] = a
        bad = set(kwargs) - kw_ok
        if bad:
            raise MXNetError(f"{op.name}: unknown attrs {sorted(bad)}")
        entries = [s._entries[0] for s in sym_inputs]
        node = _Node(op.name, name, kwargs, entries)
        # AttrScope string attrs attach to op nodes too (introspection and
        # the file; the op's semantics come from kwargs)
        from .. import attribute as _attribute

        scoped = _attribute.current().get(None)
        if scoped:
            node.vattrs = {"attr": scoped}
        n_out = static_num_outputs(op.name, kwargs)
        node.num_outputs = n_out
        return Symbol([(node, i) for i in range(n_out)])

    stub.__name__ = op.name
    stub.__doc__ = op.__doc__
    return stub


_SKIP_PREFIXES = ("_random_", "_sample_", "sample_")


def _make_sym_ufunc(name, bop, np_fn, sop, rsop):
    """Symbol-side ufunc with scalar dispatch (the nd namespace's table)."""

    def f(lhs, rhs, **kw):
        g = globals()
        l, r = isinstance(lhs, Symbol), isinstance(rhs, Symbol)
        if l and r:
            return g[bop](lhs, rhs, **kw)
        if l:
            return g[sop](lhs, scalar=float(rhs), **kw)
        if r:
            return g[rsop](rhs, scalar=float(lhs), **kw)
        return np_fn(lhs, rhs)

    f.__name__ = name
    f.__doc__ = f"Element-wise {name} (maps to {bop} / {sop})."
    return f


def _populate():
    import sys
    import types

    import numpy as np

    from ..ndarray import _UFUNCS

    g = globals()
    for opname in _reg.list_ops():
        if opname.startswith(_SKIP_PREFIXES):
            continue
        g[opname] = _make_sym_stub(_reg.get_op(opname))
        __all__.append(opname)
    g["concat"] = g["Concat"]
    g["flatten"] = g["Flatten"]
    g["cast"] = g["Cast"]
    for name, (bop, sop, rsop) in _UFUNCS.items():
        np_fn = getattr(np, {"lesser": "less", "lesser_equal": "less_equal"}
                        .get(name, name))
        g[name] = _make_sym_ufunc(name, bop, np_fn, sop, rsop)
        __all__.append(name)

    # sym.linalg: the short spellings of the linalg_* stubs, also
    # importable as mxnet_tpu_torch.symbol.linalg
    lin = types.ModuleType(__name__ + ".linalg")
    lin.__doc__ = "The mx.sym.linalg namespace (linalg_* op spellings)."
    for opname in _reg.list_ops():
        if opname.startswith("linalg_"):
            setattr(lin, opname[len("linalg_"):], g[opname])
    g["linalg"] = lin
    sys.modules[lin.__name__] = lin


_populate()

from . import contrib  # noqa: E402,F401  (after the stubs)
