"""Symbol auto-naming scopes (reference: python/mxnet/name.py —
NameManager and Prefix).  ``with mx.name.Prefix('stage1_'):`` prefixes
every auto-generated symbol name created in the scope.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Default manager: pass auto names through unchanged; usable as a
    context manager to scope a custom subclass (reference NameManager)."""

    _current = threading.local()

    def get(self, name, hint):
        """Final name for a node: explicit `name` wins; otherwise derive
        from the auto-generated `hint`."""
        return name if name is not None else hint

    def __enter__(self):
        # stack, not a single slot: reusing one instance in nested/repeated
        # with-blocks must restore correctly
        if not hasattr(self, "_old_stack"):
            self._old_stack = []
        self._old_stack.append(getattr(NameManager._current, "value", None))
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old_stack.pop()
        return False


class Prefix(NameManager):
    """Prepend a prefix to every auto-generated name (reference Prefix)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        if name is not None:
            return name
        return self._prefix + hint


def current() -> NameManager:
    mgr = getattr(NameManager._current, "value", None)
    return mgr if mgr is not None else _DEFAULT


_DEFAULT = NameManager()
