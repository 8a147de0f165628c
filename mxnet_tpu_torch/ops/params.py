"""Typed op-parameter descriptors, from ``mxnet_tpu/ops/params.py``
(dmlc::Parameter / DMLC_DECLARE_FIELD in MXNet: every operator's param
struct, its docstring table and the string-keyed attribute validation).

A descriptor per registered op, derived from the port op's signature
(name and default give the type), enriched with ranges, enums and docs
by ``declare`` (the JAX module's declarations).  ``describe`` renders
the parameter table; ``validate`` coerces and checks an attrs dict as
dmlc::Parameter::Init does (unknown key, type, range, enum), and
``validate_known`` range- and enum-checks the declared attrs of each
registry dispatch (``ops.registry.invoke``).  A port op's ``generator``
argument is the draw source that stands in for the JAX op's key input,
not an attribute, so it has no field: the fields of every op name the
two registries share are the JAX registry's.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence

from ..base import MXNetError

__all__ = ["ParamField", "declare", "fields_of", "describe", "validate"]


class ParamField:
    """One typed op parameter (MXNet's DMLC_DECLARE_FIELD chain)."""

    __slots__ = ("name", "type", "default", "doc", "lower", "upper", "enum")

    def __init__(self, name: str, type: str = "any", default: Any = None,
                 doc: str = "", lower=None, upper=None,
                 enum: Optional[Sequence] = None):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc
        self.lower = lower
        self.upper = upper
        self.enum = tuple(enum) if enum is not None else None

    def check(self, value):
        """Coerce + range/enum check; returns the coerced value."""
        v = value
        if v is None:
            return v  # None = unset/optional, always allowed
        try:
            if self.type == "int" and not isinstance(v, bool):
                v = int(v)
            elif self.type == "float":
                v = float(v)
            elif self.type == "bool":
                if isinstance(v, str):  # dmlc-style string parse
                    low = v.strip().lower()
                    if low in ("true", "1"):
                        v = True
                    elif low in ("false", "0"):
                        v = False
                    else:
                        raise ValueError(v)
                else:
                    v = bool(v)
            elif self.type == "str":
                v = str(v)
            elif self.type == "tuple" and not isinstance(v, (int, float)):
                if isinstance(v, str):  # "(2, 2)" — the C-ABI spelling
                    import ast

                    v = tuple(ast.literal_eval(v))
                else:
                    v = tuple(v)
        except (TypeError, ValueError, SyntaxError):
            raise MXNetError(
                f"parameter {self.name}={value!r} is not a valid "
                f"{self.type}")
        if self.lower is not None and v < self.lower:
            raise MXNetError(
                f"parameter {self.name}={v!r} below minimum {self.lower}")
        if self.upper is not None and v > self.upper:
            raise MXNetError(
                f"parameter {self.name}={v!r} above maximum {self.upper}")
        if self.enum is not None and v not in self.enum:
            raise MXNetError(
                f"parameter {self.name}={v!r} not in {self.enum}")
        return v

    def __repr__(self):
        extras = []
        if self.enum:
            extras.append(f"one of {self.enum}")
        if self.lower is not None or self.upper is not None:
            extras.append(f"range [{self.lower}, {self.upper}]")
        suffix = f" ({'; '.join(extras)})" if extras else ""
        return f"{self.type}, default={self.default!r}{suffix}"


# op name -> {param name -> ParamField}; populated lazily from signatures
# and eagerly by declare()
_DECLARED: Dict[str, Dict[str, ParamField]] = {}


def _infer_type(default) -> str:
    if isinstance(default, bool):
        return "bool"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, str):
        return "str"
    if isinstance(default, (tuple, list)):
        return "tuple"
    return "any"


def declare(op_name: str, *fields: ParamField):
    """Enrich (or add) typed fields for an op — the DMLC_DECLARE_FIELD
    analog for ranges, enums and docs the signature can't express."""
    slot = _DECLARED.setdefault(op_name, {})
    for f in fields:
        slot[f.name] = f


def fields_of(op_name: str) -> List[ParamField]:
    """All parameter fields of an op: signature-derived defaults merged
    with any declare()d enrichments."""
    from .registry import get_op

    op = get_op(op_name)
    sig = inspect.signature(op.fn)
    declared = _DECLARED.get(op_name, {})
    out = []
    for p in sig.parameters.values():
        if p.default is p.empty or p.name == "generator":
            continue  # array input (or the key's stand-in), not an attr
        if p.name in declared:
            out.append(declared[p.name])
        else:
            out.append(ParamField(p.name, _infer_type(p.default),
                                  default=p.default))
    # declared fields that aren't in the signature (e.g. **attrs ops)
    names = {f.name for f in out}
    out.extend(f for n, f in declared.items() if n not in names)
    return out


def describe(op_name: str) -> str:
    """Reference-style parameter table for an op's docstring."""
    fields = fields_of(op_name)
    if not fields:
        return f"{op_name}: no parameters"
    width = max(len(f.name) for f in fields) + 2
    lines = [f"Parameters of {op_name}:"]
    for f in fields:
        lines.append(f"  {f.name:<{width}}{f!r}"
                     + (f" — {f.doc}" if f.doc else ""))
    return "\n".join(lines)


def validate(op_name: str, attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce + check an attrs dict against the op's fields (MXNet's
    dmlc::Parameter::Init): unknown keys and out-of-range values raise."""
    fields = {f.name: f for f in fields_of(op_name)}
    out = {}
    for k, v in attrs.items():
        if k not in fields:
            raise MXNetError(
                f"{op_name}: unknown parameter {k!r} (valid: "
                f"{sorted(fields)})")
        out[k] = fields[k].check(v)
    return out


def validate_known(op_name: str, attrs: Dict[str, Any]) -> None:
    """Range/enum-check the attrs that have declared fields; tolerate
    unknown keys (ops with **attrs).  This is the hook on the registry's
    dispatch: it must never coerce, only reject bad values."""
    declared = _DECLARED.get(op_name)
    if not declared:
        return
    for k, v in attrs.items():
        f = declared.get(k)
        if f is not None:
            f.check(v)


# ---------------------------------------------------------------------------
# enriched declarations for the heavily-parameterized layer ops (the ones
# whose MXNet param structs carry ranges/enums)
# ---------------------------------------------------------------------------
declare("Pooling",
        ParamField("pool_type", "str", "max",
                   enum=("max", "avg", "sum", "lp"),
                   doc="pooling monoid"),
        ParamField("pooling_convention", "str", "valid",
                   enum=("valid", "full"), doc="output-shape rounding"),
        ParamField("p_value", "int", 2, lower=1,
                   doc="Lp-pooling exponent"))
declare("Activation",
        ParamField("act_type", "str", "relu",
                   enum=("relu", "sigmoid", "tanh", "softrelu",
                         "softsign")))
declare("Dropout",
        ParamField("p", "float", 0.5, lower=0.0, upper=1.0,
                   doc="fraction of units dropped"),
        ParamField("mode", "str", "training",
                   enum=("training", "always")))
declare("BatchNorm",
        ParamField("eps", "float", 1e-3, lower=0.0),
        ParamField("momentum", "float", 0.9, lower=0.0, upper=1.0))
declare("Convolution",
        ParamField("num_filter", "int", 1, lower=1),
        ParamField("num_group", "int", 1, lower=1))
declare("LeakyReLU",
        ParamField("act_type", "str", "leaky",
                   enum=("leaky", "prelu", "rrelu", "elu", "selu",
                         "gelu")))
declare("softmax", ParamField("axis", "int", -1))
declare("RNN",
        ParamField("mode", "str", "lstm",
                   enum=("lstm", "gru", "rnn_relu", "rnn_tanh")),
        ParamField("state_size", "int", 0, lower=0),
        ParamField("num_layers", "int", 1, lower=1),
        ParamField("p", "float", 0.0, lower=0.0, upper=1.0))
declare("Correlation",
        ParamField("kernel_size", "int", 1, lower=1),
        ParamField("max_displacement", "int", 1, lower=0),
        ParamField("stride1", "int", 1, lower=1),
        ParamField("stride2", "int", 1, lower=1),
        ParamField("pad_size", "int", 0, lower=0))
