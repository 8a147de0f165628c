"""The one dispatch consultation point of the pass pipeline.

The port's copy of ``mxnet_tpu/passes/hooks.py``.  ``ops/registry.
_invoke_impl`` reads exactly one module global, ``_OP_HOOKS``, per op
call.  When no pass is active the tuple is empty and dispatch pays a
single falsy check.

Active passes appear as hook objects implementing the two rewrite verbs
the dispatch point offers:

  * ``rewrite_inputs(op_name, inputs) -> inputs``: edit one op call's
    NDArray inputs before dispatch;
  * ``substitute(op_name, attrs, platform) -> fn | None``: swap the op's
    implementation for a registered kernel.  ``platform`` is the device
    type of the op's inputs (``"cpu"``, ``"cuda"``).  The port runs
    eagerly, so it has no traced branch: while a pass is active, every
    dispatch asks.

Standard library only.
"""
from __future__ import annotations

import contextlib

__all__ = ["OpHook", "op_hook", "active"]

_OP_HOOKS = ()   # tuple of active OpHook objects, innermost scope LAST


class OpHook:
    """Protocol/default base for a dispatch hook: both verbs are no-ops
    so a pass overrides only the one it needs."""

    def rewrite_inputs(self, op_name, inputs):
        return inputs

    def substitute(self, op_name, attrs, platform=None):
        return None


def active() -> bool:
    return bool(_OP_HOOKS)


@contextlib.contextmanager
def op_hook(hook):
    """Push ``hook`` for the ops dispatched inside the block.  Hooks nest
    and restore; state set by one thread around its own calls."""
    global _OP_HOOKS
    prev = _OP_HOOKS
    _OP_HOOKS = prev + (hook,)
    try:
        yield
    finally:
        _OP_HOOKS = prev
