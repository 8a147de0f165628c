"""The typed op-parameter descriptors (``ops/params.py``) against the JAX
registry's: for every op name the two registries share, ``fields_of``
gives the same names, types, defaults, docs, ranges and enums, and
``describe`` the same table; a default bound to a function (the
elementwise ops' ``_f``) is compared as "a function", since its repr is
each package's own.  ``validate`` coerces and rejects alike: each
field's default, the string spellings a Symbol attribute carries, an
unknown key, and every declared range and enum probed on both sides of
its bounds.  The port's registry dispatch rejects a declared attribute
outside its enum, as the JAX dispatch does.
"""
import re

import numpy as np
import pytest

import mxnet_tpu as jmx  # noqa: F401  (registers the JAX ops)
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import params as jp
from mxnet_tpu.ops import registry as jr
from mxnet_tpu_torch.ops import params as tp
from mxnet_tpu_torch.ops import registry as tr

SHARED = sorted(set(jr.list_ops()) & set(tr.list_ops()))


def _norm(text):
    return re.sub(r"default=<.*>(?=[ ,)\n]|$)", "default=<function>", text)


def _field(f):
    default = "<function>" if callable(f.default) else repr(f.default)
    return (f.name, f.type, default, f.doc, f.lower, f.upper, f.enum)


def test_every_op_name_is_shared():
    assert len(SHARED) == len(jr.list_ops()) == 301


@pytest.mark.parametrize("chunk", range(4))
def test_fields_and_describe_match_jax(chunk):
    for name in SHARED[chunk::4]:
        assert [_field(f) for f in tp.fields_of(name)] == \
            [_field(f) for f in jp.fields_of(name)], name
        assert _norm(tp.describe(name)) == _norm(jp.describe(name)), name


def _outcome(mod, name, attrs):
    try:
        out = mod.validate(name, attrs)
        return ("ok", {k: (type(v).__name__, repr(v)) for k, v in
                       out.items()})
    except Exception as e:
        return ("raise", type(e).__name__)


def _probes(fields):
    """Attr dicts for one op: every default, string spellings, an unknown
    key, and each declared bound's neighbours and a value off the enum."""
    plain = {f.name: f.default for f in fields if not callable(f.default)}
    yield plain
    yield {"no_such_attr": 1}
    for f in fields:
        if f.type in ("int", "float") and f.default is not None:
            yield {f.name: str(f.default)}
        if f.type == "bool":
            yield {f.name: "true"}
            yield {f.name: "maybe"}
        if f.type == "tuple" and f.default is not None:
            yield {f.name: str(tuple(f.default))}
        if f.type == "int":
            yield {f.name: "x1"}
        for bound in (f.lower, f.upper):
            if bound is not None:
                for d in (-1, 0, 1):
                    yield {f.name: bound + d * (1 if f.type == "int"
                                                else 0.25)}
        if f.enum is not None:
            yield {f.name: f.enum[0]}
            yield {f.name: "not_a_member"}


@pytest.mark.parametrize("chunk", range(4))
def test_validate_matches_jax(chunk):
    for name in SHARED[chunk::4]:
        for attrs in _probes(jp.fields_of(name)):
            assert _outcome(tp, name, attrs) == _outcome(jp, name, attrs), \
                (name, attrs)


def test_dispatch_rejects_a_declared_value_as_jax_does():
    x = np.ones((1, 2, 4, 4), np.float32)
    calls = (lambda nd, a: nd.Activation(a, act_type="swish"),
             lambda nd, a: nd.Pooling(a, kernel=(2, 2), pool_type="median"),
             lambda nd, a: nd.LeakyReLU(a, act_type="swish"),
             lambda nd, a: nd.Activation(a, act_type="relu"))
    for call in calls:
        outcome = []
        for nd, arr in ((jmx.nd, jmx.nd.array(x)),
                        (tmx.nd, tmx.nd.array(x, ctx=tmx.cpu()))):
            try:
                outcome.append(call(nd, arr).shape)
            except Exception as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1]
    with pytest.raises(tmx.base.MXNetError, match="not in"):
        calls[0](tmx.nd, tmx.nd.array(x, ctx=tmx.cpu()))


def test_declare_enriches_a_field():
    tp.declare("_test_only_op",
               tp.ParamField("k", "int", 1, lower=1, doc="a count"))
    try:
        assert tp.validate_known("_test_only_op", {"k": 2}) is None
        with pytest.raises(tmx.base.MXNetError, match="below minimum"):
            tp.validate_known("_test_only_op", {"k": 0})
    finally:
        tp._DECLARED.pop("_test_only_op")


def test_dispatch_validates_each_attribute_combination_once(monkeypatch):
    """The registry validates a declared op's attributes on the first
    dispatch of each combination, as the JAX op does on a jit-cache
    miss; a rejected combination is rejected again at every call."""
    seen = []
    real = tp.validate_known

    def spy(name, attrs):
        seen.append((name, attrs.get("act_type")))
        return real(name, attrs)

    monkeypatch.setattr(tp, "validate_known", spy)
    monkeypatch.setattr(tr.get_op("Activation"), "checked", set())
    a = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu())
    for act in ("relu", "relu", "tanh", "relu", "tanh"):
        tmx.nd.Activation(a, act_type=act)
    for _ in range(2):
        with pytest.raises(tmx.base.MXNetError, match="not in"):
            tmx.nd.Activation(a, act_type="swish")
    assert [s for s in seen if s[0] == "Activation"] == [
        ("Activation", "relu"), ("Activation", "tanh"),
        ("Activation", "swish"), ("Activation", "swish")]
