"""The fused training step, on one device.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py::DataParallelStep``
for a mesh of one device: ``step(data, label)`` runs the block's forward
in training mode, takes the f32 mean of ``loss_fn(out, label)`` (as
``loss_of`` does), runs the backward, applies one optimizer update and
returns an :class:`AsyncLoss` without waiting for the device.

The updates are ``_sgd_tree_update`` and ``_adam_tree_update`` formula for
formula, with ``learning_rate``, ``wd``, ``momentum``, ``beta1``,
``beta2``, ``epsilon``, ``rescale_grad`` and ``clip_gradient`` as
``optimizer_params``:

    g = clip(grad * rescale_grad, +-clip_gradient) + wd * w
    sgd:  m = momentum * m - lr * g;  w += m
    adam: m = beta1 m + (1 - beta1) g;  v = beta2 v + (1 - beta2) g^2
          w -= lr * sqrt(1 - beta2^t) / (1 - beta1^t) * m / (sqrt(v) + eps)

(MXNet's Adam adds eps to sqrt(v) before the bias correction, unlike
``torch.optim.Adam``, which is not used.)  Every term is computed in f32
from ``grad.float()`` and ``w.float()`` with f32 optimizer state, and a
16-bit parameter is rounded to its dtype once per step, as the JAX
updates do; there is no f32 master copy.  They run as multi-tensor
``torch._foreach_*`` calls over the parameter list, in place on the f32
gradients (which the step owns and discards) and, for f32 parameters, on
the parameters themselves, to save memory.  A parameter the loss does not
reach (BERT's pooler) gets a zero gradient, as ``jax.grad`` gives it.
Parameters with ``requires_grad=False`` are frozen, as Gluon's
``grad_req='null'``; buffers (BatchNorm's running stats) are not
parameters: the block's forward moves them, in training mode, as
Gluon's aux states.  Inputs keep their dtype (a bf16 image batch stays
bf16; a numpy bfloat16 array comes in bit for bit).

Not ported: meshes and sharding, ``accum_steps``, remat, loss scaling, the
superstep, AOT executables, ``state_dict`` / checkpoints, telemetry, and
per-parameter lr/wd multipliers.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..base import MXNetError, tensor_from_numpy
from ..context import resolve_device
from .async_loss import AsyncLoss

__all__ = ["DataParallelStep"]


class DataParallelStep:
    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict] = None, device=None):
        if optimizer not in ("sgd", "adam"):
            raise MXNetError(f"fused step supports sgd/adam, got {optimizer}")
        opt = dict(optimizer_params or {})
        self.device = resolve_device(device)
        self.block = block.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.learning_rate = float(opt.get("learning_rate", 0.01))
        self._momentum = float(opt.get("momentum", 0.9))
        self._wd = float(opt.get("wd", 0.0))
        self._beta1 = float(opt.get("beta1", 0.9))
        self._beta2 = float(opt.get("beta2", 0.999))
        self._eps = float(opt.get("epsilon", 1e-8))
        self._rescale = float(opt.get("rescale_grad", 1.0))
        self._clip = opt.get("clip_gradient")
        self.params = [p for p in block.parameters() if p.requires_grad]
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in self.params]
        # sgd: momenta; adam: (means, variances)
        self.opt_state = (zeros(),) if optimizer == "sgd" else (zeros(),
                                                                zeros())
        self.num_update = 0

    def _put(self, x):
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        return x.to(self.device, non_blocking=True)

    def step(self, data, label) -> AsyncLoss:
        """One training step; ``data`` is a tensor (or numpy array) or a
        tuple of them for a block with several inputs."""
        datas = tuple(data) if isinstance(data, (tuple, list)) else (data,)
        datas = tuple(self._put(d) for d in datas)
        label = self._put(label)
        self.block.train()
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(self.block(*datas), label).float().mean()
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        with torch.no_grad():
            self._update(grads)
        for p in self.params:
            p.grad = None
        self.num_update += 1
        return AsyncLoss(loss)

    def _grad_terms(self, grads, w):
        """g = clip(grad * rescale) + wd * w, in place on the f32
        ``grads``; ``w`` the parameters in f32."""
        if self._rescale != 1.0:
            torch._foreach_mul_(grads, self._rescale)
        if self._clip is not None:
            torch._foreach_clamp_min_(grads, -float(self._clip))
            torch._foreach_clamp_max_(grads, float(self._clip))
        if self._wd:
            torch._foreach_add_(grads, w, alpha=self._wd)
        return grads

    def _update(self, grads) -> None:
        # f32 views: the tensors themselves where they are f32, copies of
        # 16-bit ones, which are rounded back once at the end
        w = [p.float() for p in self.params]
        g = self._grad_terms([x.float() for x in grads], w)
        lr = self.learning_rate
        if self.optimizer == "sgd":
            (mom,) = self.opt_state
            torch._foreach_mul_(mom, self._momentum)
            torch._foreach_add_(mom, g, alpha=-lr)
            torch._foreach_add_(w, mom)
        else:
            m, v = self.opt_state
            b1, b2 = self._beta1, self._beta2
            t = self.num_update + 1
            corr = math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self._eps)
            torch._foreach_addcdiv_(w, m, denom, value=-lr * corr)
        low = [(p, x) for p, x in zip(self.params, w) if x is not p]
        if low:
            torch._foreach_copy_([p for p, _ in low], [x for _, x in low])
