"""The fused training step, on one device.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py::DataParallelStep``
for a mesh of one device: ``step(data, label)`` runs the block's forward
in training mode, takes the f32 mean of ``loss_fn(out, label)`` (as
``loss_of`` does), runs the backward, applies one optimizer update and
returns an :class:`AsyncLoss` without waiting for the device.

The updates are ``_sgd_tree_update`` and ``_adam_tree_update`` formula for
formula, with ``learning_rate``, ``lr_scheduler``, ``wd``, ``momentum``,
``beta1``, ``beta2``, ``epsilon``, ``rescale_grad`` and ``clip_gradient``
as ``optimizer_params``, and each parameter's ``lr_mult`` and ``wd_mult``
attributes (1.0 where it has none):

    g = clip(grad * rescale, +-clip_gradient) + wd * wd_mult * w
    sgd:  m = momentum * m - lr * lr_mult * g;  w += m
    adam: m = beta1 m + (1 - beta1) g;  v = beta2 v + (1 - beta2) g^2
          w -= lr * lr_mult * sqrt(1 - beta2^t) / (1 - beta1^t)
               * m / (sqrt(v) + eps)

(MXNet's Adam adds eps to sqrt(v) before the bias correction, unlike
``torch.optim.Adam``, which is not used.)  With ``clip_global_norm=c``
the rescale takes the factor ``min(1, c / (norm + 1e-12))``, ``norm`` the
L2 norm of every trainable parameter's rescaled f32 gradient, before the
per-element clip (``_update_core``).  The lr is read on the host at each
step from the scheduler (its ``base_lr`` set from ``learning_rate``) at
the step's number, counted from 1, as ``_current_lr`` does;
``learning_rate`` is the lr of the next step.

``accum_steps=k`` splits every input and the label into the strided
microbatches ``a[i::k]``, runs the forward and backward of each in turn
and feeds the mean of their losses and gradients to one update; buffers
a forward moves (BatchNorm's running stats) take the mean of what each
microbatch's forward made of them, from the same starting value.
``remat=True`` runs the block under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward, with
the forward's RNG state, as ``jax.checkpoint`` over the block apply;
buffers keep the value of the forward, not of the recomputation.

Every term is computed in f32 from ``grad.float()`` and ``w.float()``
with f32 optimizer state, and a 16-bit parameter is rounded to its dtype
once per step, as the JAX updates do; there is no f32 master copy.  They
run as multi-tensor ``torch._foreach_*`` calls over the parameter list
(the helpers of ``optimizer/foreach.py``, which the fused updater runs
too; parameters whose multipliers differ cost one call per value),
in place on the f32 gradients (which the step owns and discards) and,
for f32 parameters, on the parameters themselves, to save memory.  A
parameter the loss does not reach (BERT's pooler) gets a zero gradient,
as ``jax.grad`` gives it.  Parameters with ``requires_grad=False`` are
frozen, as Gluon's ``grad_req='null'``.  Inputs keep their dtype (a bf16
image batch stays bf16; a numpy bfloat16 array comes in bit for bit).

Not ported: meshes and sharding, loss scaling, the superstep, AOT
executables, ``state_dict`` / checkpoints and telemetry.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError, tensor_from_numpy
from ..context import resolve_device
from ..optimizer.foreach import adam_, grad_terms_, sgd_
from .async_loss import AsyncLoss

__all__ = ["DataParallelStep"]


class DataParallelStep:
    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict] = None, device=None,
                 remat: bool = False, accum_steps: int = 1,
                 clip_global_norm: Optional[float] = None):
        if optimizer not in ("sgd", "adam"):
            raise MXNetError(f"fused step supports sgd/adam, got {optimizer}")
        if int(accum_steps) < 1:
            raise MXNetError(f"accum_steps must be >= 1, got {accum_steps}")
        opt = dict(optimizer_params or {})
        self.device = resolve_device(device)
        self.block = block.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat = bool(remat)
        self.accum_steps = int(accum_steps)
        self.clip_global_norm = clip_global_norm
        self._lr = float(opt.get("learning_rate", 0.01))
        self._lr_scheduler = opt.get("lr_scheduler")
        if self._lr_scheduler is not None:
            self._lr_scheduler.base_lr = self._lr
        self._momentum = float(opt.get("momentum", 0.9))
        self._wd = float(opt.get("wd", 0.0))
        self._beta1 = float(opt.get("beta1", 0.9))
        self._beta2 = float(opt.get("beta2", 0.999))
        self._eps = float(opt.get("epsilon", 1e-8))
        self._rescale = float(opt.get("rescale_grad", 1.0))
        self._clip = opt.get("clip_gradient")
        self.params = [p for p in block.parameters() if p.requires_grad]
        # the multipliers are read once, as the JAX step reads its mults
        self._lr_mults = [float(getattr(p, "lr_mult", 1.0))
                          for p in self.params]
        self._wd_mults = [float(getattr(p, "wd_mult", 1.0))
                          for p in self.params]
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in self.params]
        # sgd: momenta; adam: (means, variances)
        self.opt_state = (zeros(),) if optimizer == "sgd" else (zeros(),
                                                                zeros())
        self.num_update = 0

    # -- the learning rate ------------------------------------------------
    def _current_lr(self, num_update: int) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler(num_update))
        return self._lr

    @property
    def learning_rate(self) -> float:
        """The lr the next step will use."""
        return self._current_lr(self.num_update + 1)

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr: float) -> None:
        if self._lr_scheduler is not None:
            raise MXNetError(
                "set_learning_rate conflicts with an lr_scheduler "
                "(Trainer semantics: mutate the scheduler instead)")
        self._lr = float(lr)

    # -- the step ---------------------------------------------------------
    def _put(self, x):
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        return x.to(self.device, non_blocking=True)

    @staticmethod
    def _microbatch(a, i: int, k: int):
        """Microbatch ``i`` of ``k``: the strided rows ``a[i::k]`` (the
        JAX step's choice: each microbatch draws from every device's
        shard of the batch)."""
        return a[i::k] if k > 1 else a

    def _loss(self, datas, label):
        if self.remat:
            out = checkpoint(self.block, *datas, use_reentrant=False)
        else:
            out = self.block(*datas)
        return self.loss_fn(out, label).float().mean()

    def step(self, data, label) -> AsyncLoss:
        """One training step; ``data`` is a tensor (or numpy array) or a
        tuple of them for a block with several inputs."""
        datas = tuple(data) if isinstance(data, (tuple, list)) else (data,)
        datas = tuple(self._put(d) for d in datas)
        label = self._put(label)
        k = self.accum_steps
        if k > 1:
            for d in datas + (label,):
                if d.shape[0] % k:
                    raise MXNetError(f"batch {d.shape[0]} not divisible by "
                                     f"accum_steps={k}")
        self.block.train()
        for p in self.params:
            p.grad = None
        bufs = ([b for b in self.block.buffers() if b.is_floating_point()]
                if k > 1 or self.remat else [])
        start = [b.clone() for b in bufs] if k > 1 else []
        sums = None
        loss = None
        for i in range(k):
            if i and bufs:
                torch._foreach_copy_(bufs, start)
            loss_i = self._loss(
                tuple(self._microbatch(d, i, k) for d in datas),
                self._microbatch(label, i, k))
            made = [b.clone() for b in bufs]
            loss_i.backward()
            if bufs:  # what the forward made of them, not the recomputation
                sums = made if sums is None else torch._foreach_add(sums,
                                                                    made)
            loss_i = loss_i.detach() / k if k > 1 else loss_i
            loss = loss_i if loss is None else loss + loss_i
        if bufs:
            torch._foreach_copy_(bufs, torch._foreach_div(sums, k))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if k > 1:
            grads = torch._foreach_div(grads, k)
        with torch.no_grad():
            self._update(grads)
        for p in self.params:
            p.grad = None
        self.num_update += 1
        return AsyncLoss(loss)

    def _grad_terms(self, grads, w):
        """g = clip(grad * rescale [* global-norm factor]) + wd * wd_mult
        * w, in place on the f32 ``grads``; ``w`` the parameters in f32."""
        scale = self._rescale
        if self.clip_global_norm is not None and grads:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))) * abs(self._rescale)
            scale = torch.clamp(self.clip_global_norm / (norm + 1e-12),
                                max=1.0) * self._rescale
        return grad_terms_(grads, w, scale, self._clip,
                           [self._wd * m for m in self._wd_mults])

    def _update(self, grads) -> None:
        # f32 views: the tensors themselves where they are f32, copies of
        # 16-bit ones, which are rounded back once at the end
        w = [p.float() for p in self.params]
        g = self._grad_terms([x.float() for x in grads], w)
        lr = self._current_lr(self.num_update + 1)
        if self.optimizer == "sgd":
            sgd_(w, g, self.opt_state[0], self._momentum,
                 [lr * m for m in self._lr_mults])
        else:
            t = self.num_update + 1
            corr = math.sqrt(1 - self._beta2 ** t) / (1 - self._beta1 ** t)
            adam_(w, g, *self.opt_state, self._beta1, self._beta2, self._eps,
                  [lr * m * corr for m in self._lr_mults])
        low = [(p, x) for p, x in zip(self.params, w) if x is not p]
        if low:
            torch._foreach_copy_([p for p, _ in low], [x for _, x in low])
