"""The ``mx.sym.contrib`` namespace: the short spellings of the
``_contrib_*`` ops (counterpart of ``mxnet_tpu/symbol/contrib.py``)."""
from __future__ import annotations

from ..ops import registry as _reg

__all__ = []


def _populate():
    from .. import symbol as _sym_mod  # its op stubs exist by import order

    g = globals()
    for name in _reg.list_ops():
        if name.startswith("_contrib_") and hasattr(_sym_mod, name):
            short = name[len("_contrib_"):]
            g[short] = getattr(_sym_mod, name)
            __all__.append(short)


_populate()
