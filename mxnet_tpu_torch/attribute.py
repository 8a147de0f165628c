"""Symbol attribute scopes (reference: python/mxnet/attribute.py —
AttrScope).  ``with mx.AttrScope(ctx_group='dev1', lr_mult='0.1'):``
attaches the given attributes to every symbol node created in the scope;
nested scopes merge with inner-wins semantics.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings "
                                 "(reference convention)")
        self._attr: Dict[str, str] = dict(kwargs)

    def get(self, attr: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """Scope attrs merged with (and overridden by) explicit `attr`."""
        if not self._attr:
            return dict(attr or {})
        out = dict(self._attr)
        out.update(attr or {})
        return out

    def __enter__(self):
        # stack, not a single slot: reusing one instance in nested/repeated
        # with-blocks must restore correctly
        if not hasattr(self, "_old_stack"):
            self._old_stack = []
        old = getattr(AttrScope._current, "value", None)
        self._old_stack.append(old)
        merged = AttrScope()
        merged._attr = dict((old or _DEFAULT)._attr)
        merged._attr.update(self._attr)
        AttrScope._current.value = merged
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old_stack.pop()
        return False


def current() -> AttrScope:
    cur = getattr(AttrScope._current, "value", None)
    return cur if cur is not None else _DEFAULT


_DEFAULT = AttrScope()
