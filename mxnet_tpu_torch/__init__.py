"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

Mirrors the JAX package's layout (``base``, ``context``, ``nd``,
``autograd``, ``passes``, ``gluon``, ``init``, ``metric``, ``random``,
``kv``, ``models``, ``optimizer``, ``parallel``, ``serving``) in plain
PyTorch idiom: Gluon blocks (and so the models) are ``torch.nn.Module``s,
state is tensors on an explicit ``torch.device``,
randomness comes from explicit ``torch.Generator``s.  The TPU's Pallas
kernels become hand-written CUDA C++ kernels for Hopper (``csrc/``), built
on first use by ``ops.kernels._build``.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
The package imports ``torch``, numpy and the standard library only.
"""
from .base import MXNetError
from .context import cpu, default_device, gpu
from . import autograd
from . import ndarray as nd
from . import optimizer
from . import random
from . import initializer
from . import initializer as init
from . import metric
from . import kvstore
from . import kvstore as kv
from . import gluon

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "nd", "autograd",
           "optimizer", "random", "initializer", "init", "metric", "kvstore",
           "kv", "gluon"]
