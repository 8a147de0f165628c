"""Operator registry and implementations (torch-backed), the counterpart
of ``mxnet_tpu/ops/``.  Importing this package registers the ported ops;
``kernels`` holds the hand-written CUDA kernels and their plain
versions."""
from .registry import Operator, get_op, invoke, invoke_by_name, list_ops, \
    register
from . import elemwise  # noqa: F401
from . import reduce_ops  # noqa: F401
from . import matrix  # noqa: F401
from . import nn  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401

__all__ = ["Operator", "register", "get_op", "invoke", "invoke_by_name",
           "list_ops"]
