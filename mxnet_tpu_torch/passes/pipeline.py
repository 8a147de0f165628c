"""Ordered, composable, fingerprinted graph passes.

The port's copy of ``mxnet_tpu/passes/pipeline.py``:

  * a :class:`GraphPass` is a named, individually-toggleable rewrite
    whose effect is a scope (``scope()``) plus a structural
    ``signature()``;
  * a :class:`PassPipeline` is an ordered list of passes with one shared
    ``signature()`` and its ``fingerprint()``: any pass config, toggle or
    order change gives a different fingerprint, and the same pipeline
    gives the same fingerprint in both packages;
  * a disabled pass is absent: it adds nothing to the signature, and
    ``scope``/``wrap_apply`` skip it.

Pass classes register by name (:func:`register_pass_type`); an unknown
name raises naming the registered set.  The pipeline serializes to JSON
(name, enabled and config per pass, order kept) in the JAX package's
format, so either package reads the other's.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Any, Dict, List, Tuple

from ..base import MXNetError

__all__ = ["GraphPass", "PassPipeline", "register_pass_type",
           "available_passes", "resolve_pass_type", "apply_env_toggles",
           "fingerprint"]

_PASS_TYPES: Dict[str, type] = {}


def fingerprint(parts: Any) -> str:
    """sha256 over the repr of structural identity, first 16 hex digits
    (the JAX package's ``memwatch.fingerprint``): no object ids, so the
    same parts give the same fingerprint in any process."""
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def register_pass_type(cls):
    """Class decorator: register ``cls`` under its ``name`` attribute so
    ``PassPipeline.from_json`` and MX_PASSES can resolve it."""
    name = getattr(cls, "name", None)
    if not name:
        raise MXNetError("register_pass_type: pass class needs a non-empty "
                         "'name' attribute")
    if name in _PASS_TYPES and _PASS_TYPES[name] is not cls:
        raise MXNetError(f"graph pass {name!r} registered twice")
    _PASS_TYPES[name] = cls
    return cls


def available_passes() -> List[str]:
    return sorted(_PASS_TYPES)


def resolve_pass_type(name: str) -> type:
    try:
        return _PASS_TYPES[name]
    except KeyError:
        raise MXNetError(
            f"unknown graph pass {name!r}: registered passes are "
            f"{available_passes()}") from None


class GraphPass:
    """One named graph rewrite.  Subclasses set ``name`` (the registry
    key) and override ``signature``/``scope`` (and optionally
    ``wrap_apply``, ``config_json``/``from_config``)."""

    name: str = ""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)

    def signature(self) -> Tuple:
        """Structural identity of this pass's config (hashable,
        restart-stable).  The pipeline prefixes the pass name."""
        return ()

    def scope(self):
        """Context manager activating the pass's effect on the ops
        dispatched inside it.  Default: no effect."""
        return contextlib.nullcontext()

    def wrap_apply(self, apply_fn):
        """Wrap ``fn(params, key, *inputs)`` so it runs under this pass."""
        scope = self.scope

        def passed_apply(params, key, *inputs):
            with scope():
                return apply_fn(params, key, *inputs)

        return passed_apply

    def config_json(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, rec: dict) -> "GraphPass":
        return cls()

    def __repr__(self):
        state = "on" if self.enabled else "off"
        return f"<GraphPass {self.name} {state}>"


class PassPipeline:
    """An ordered list of :class:`GraphPass` objects with one shared
    fingerprint, in application order."""

    def __init__(self, passes=()):
        self.passes: List[GraphPass] = list(passes)
        seen = set()
        for p in self.passes:
            if not isinstance(p, GraphPass):
                raise MXNetError(f"PassPipeline: {p!r} is not a GraphPass")
            if p.name in seen:
                raise MXNetError(
                    f"PassPipeline: duplicate pass {p.name!r}: a pipeline "
                    "holds each named pass at most once")
            seen.add(p.name)

    def enabled(self) -> List[GraphPass]:
        return [p for p in self.passes if p.enabled]

    def names(self) -> List[str]:
        return [p.name for p in self.passes]

    def get(self, name: str) -> GraphPass:
        for p in self.passes:
            if p.name == name:
                return p
        raise MXNetError(
            f"PassPipeline: no pass named {name!r} in this pipeline "
            f"(has {self.names()}); registered passes are "
            f"{available_passes()}")

    def set_enabled(self, name: str, enabled: bool) -> "PassPipeline":
        self.get(name).enabled = bool(enabled)
        return self

    def signature(self) -> Tuple:
        """(name, config) of every enabled pass, in order."""
        return ("passes",) + tuple(
            (p.name,) + tuple(p.signature()) for p in self.enabled())

    def fingerprint(self) -> str:
        return fingerprint(self.signature())

    @contextlib.contextmanager
    def scope(self):
        """Enter every enabled pass's scope, pipeline order outermost
        first; a no-op with nothing enabled."""
        with contextlib.ExitStack() as stack:
            for p in self.enabled():
                stack.enter_context(p.scope())
            yield

    def wrap_apply(self, apply_fn):
        """Wrap ``apply_fn`` under every enabled pass; the same function
        object when nothing is enabled."""
        for p in reversed(self.enabled()):
            apply_fn = p.wrap_apply(apply_fn)
        return apply_fn

    def to_json(self) -> list:
        return [{"pass": p.name, "enabled": bool(p.enabled),
                 "config": p.config_json()} for p in self.passes]

    @classmethod
    def from_json(cls, recs) -> "PassPipeline":
        passes = []
        for rec in recs or ():
            pcls = resolve_pass_type(rec["pass"])
            p = pcls.from_config(rec.get("config") or {})
            p.enabled = bool(rec.get("enabled", True))
            passes.append(p)
        return cls(passes)

    def __repr__(self):
        inner = ", ".join(
            p.name + ("" if p.enabled else "(off)") for p in self.passes)
        return f"<PassPipeline [{inner}]>"


def apply_env_toggles(pipeline: PassPipeline, environ=None) -> PassPipeline:
    """MX_PASSES: comma-separated toggles applied to ``pipeline``.
    ``-name`` disables the named pass (a no-op when the pipeline does not
    carry it); a bare ``name`` only checks that it is registered.  A token
    naming an unregistered pass raises naming the registered set."""
    environ = environ if environ is not None else os.environ
    raw = (environ.get("MX_PASSES") or "").strip()
    if not raw:
        return pipeline
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        disable = tok.startswith("-")
        name = tok[1:] if disable else tok
        resolve_pass_type(name)
        if disable:
            for p in pipeline.passes:
                if p.name == name:
                    p.enabled = False
    return pipeline
