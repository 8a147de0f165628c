"""The ``nd.contrib`` namespace: every registered ``_contrib_<name>`` op as
``nd.contrib.<name>`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``'s
``_populate``).  ``foreach``, ``while_loop`` and ``cond`` are not ported."""
from __future__ import annotations

from ..ops import registry as _reg

__all__ = []


def _make(op):
    def stub(*args, **kwargs):
        from .ndarray import NDArray, array

        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = next((a.context for a in args if isinstance(a, NDArray)), None)
        inputs = [a if isinstance(a, NDArray) else array(a, ctx=ctx)
                  for a in args]
        return _reg.invoke(op, inputs, out=out, **kwargs)

    stub.__name__ = op.name
    stub.__doc__ = op.__doc__
    return stub


def _populate():
    from .. import ops  # noqa: F401  (registers the ops)

    g = globals()
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            g[short] = _make(_reg.get_op(name))
            __all__.append(short)


_populate()
