"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

Mirrors the JAX package's layout (``base``, ``context`` with ``Context``,
``current_context``, ``cpu_pinned`` and ``num_gpus``, ``engine`` and
``waitall``, ``nd`` / ``NDArray``, ``autograd``, ``passes``,
``precision``, ``contrib``, ``parallel``, ``lr_scheduler``, ``KVStore``, ``gluon``, ``init``, ``metric``, ``random``,
``kv``, ``models``, ``optimizer``, ``operator`` (``CustomOp``),
``parallel``, ``serving``,
``recordio``, ``image``, ``io``, the runtime services ``telemetry``,
``profiler``, ``memwatch``, ``metrics_server``, ``checkpoint``,
``fault``, and the symbolic API ``sym`` / ``symbol``, ``mod`` / ``module``, ``rnn``,
``model``, ``callback``, ``monitor`` / ``Monitor``, ``name``,
``attribute`` / ``AttrScope``, ``subgraph``, ``viz`` /
``visualization``) in plain
PyTorch idiom: Gluon blocks (and so the models) are ``torch.nn.Module``s,
state is tensors on an explicit ``torch.device``,
randomness comes from explicit ``torch.Generator``s.  The TPU's Pallas
kernels become hand-written CUDA C++ kernels for Hopper (``csrc/``), built
on first use by ``ops.kernels._build``.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(or ``ctx=mx.cpu()``, or runs inside ``with mx.cpu():``);
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
The package imports ``torch``, numpy and the standard library only.
With ``MX_TELEMETRY_DIR`` set the telemetry recorder writes there from
import on; with ``MX_METRICS_PORT`` set the metrics endpoint starts at
import, as in the JAX package.
"""
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context,
                      default_device, gpu, num_gpus)
from . import engine
from . import autograd
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import optimizer
from .optimizer import lr_scheduler
from . import random
from . import initializer
from . import initializer as init
from . import metric
from . import kvstore
from . import kvstore as kv
from .kvstore import KVStore
from . import gluon
from . import operator
from . import parallel
from . import precision
from . import passes
from . import contrib
from . import telemetry
from . import profiler
from . import memwatch
from . import metrics_server
from . import checkpoint
from . import fault
from . import recordio
from . import image
from . import io
from . import models
from . import name
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import subgraph
from . import model
from . import callback
from . import monitor
from .monitor import Monitor
from . import module
from . import module as mod
from . import rnn
from . import visualization
from . import visualization as viz

__all__ = ["MXNetError", "Context", "cpu", "cpu_pinned", "gpu",
           "current_context", "num_gpus", "default_device", "engine",
           "waitall", "ndarray", "nd", "NDArray", "autograd", "optimizer",
           "lr_scheduler", "random", "initializer", "init", "metric",
           "kvstore", "kv", "KVStore", "gluon", "parallel", "precision",
           "passes", "contrib", "telemetry", "profiler", "memwatch",
           "metrics_server",
           "checkpoint", "fault", "recordio", "image", "io", "models",
           "name", "attribute", "AttrScope", "symbol", "sym", "Symbol",
           "subgraph", "model", "callback", "monitor", "Monitor", "module",
           "mod", "rnn", "visualization", "viz"]

metrics_server.maybe_start()


def waitall():
    engine.wait_all()
