"""Optimizers, and the updater that applies them to NDArrays.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference
``python/mxnet/optimizer/optimizer.py``): the ``Optimizer`` base (its
registry and ``create``, ``lr_mult`` / ``wd_mult`` by index or name,
``_update_count``, the lr scheduler, ``multi_precision``) and the 11
registered classes SGD, NAG, Adam, Adamax, Nadam, AdaGrad, AdaDelta,
RMSProp, Ftrl, Signum and LAMB, each dispatching to the update ops of
``ops/optimizer_ops.py`` through the op registry (Adamax and Nadam, which
have no op, and LAMB's norms are torch expressions here).  ``Updater``
and ``get_updater`` hold the per-index state, with ``get_states`` /
``set_states`` (numpy in a pickle, update counts included).

Multi-precision: a bf16 or f16 weight keeps an f32 master copy in its
state, updated by the ``mp_*`` ops (SGD) or by the class's own update on
the master (the others), and the weight is the master rounded once.

A row-sparse gradient (``Embedding(sparse_grad=True)``) takes the lazy
update of SGD (with or without momentum) and Adam, as the JAX ones do
(reference ``SGDUpdateRspImpl`` / ``AdamUpdateRspImpl``): the ids are
aggregated (``sparse.aggregate_rows``) and only those rows of the weight
and its state are read and written, in place, after ``rescale_grad``,
``clip_gradient`` and ``wd``; the other rows see no decay and no moment
update.  The other classes refuse it: the JAX ones hand its values to
their dense op, which fails on the shapes (or, for a one-row gradient,
broadcasts that row over every row).
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "Adamax", "Nadam", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "Signum", "LAMB", "Updater",
           "get_updater", "register", "create"]

_REGISTRY: Dict[str, type] = {}
_LOW = (torch.float16, torch.bfloat16)


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}") from None


def _dense(grad):
    """Refuse a gradient that is not a dense NDArray."""
    if getattr(grad, "stype", "default") != "default" or \
            grad._data.layout != torch.strided:
        raise MXNetError(
            f"a {getattr(grad, 'stype', 'sparse')} gradient takes the lazy "
            "update of SGD and Adam only (the JAX optimizers give its values "
            "to their dense op, which does not take them)")


def _row_sparse(grad) -> bool:
    return getattr(grad, "stype", "default") == "row_sparse"


def _rs_rows(grad, weight, kw):
    """(unique ids, the rows' f32 gradient after rescale, clip and wd, the
    ids' rows of the weight in f32) of a row_sparse gradient."""
    from ..ndarray.sparse import aggregate_rows

    uids, g = aggregate_rows(grad._aux["indices"], grad._data)
    g = g.to(torch.float32) * kw["rescale_grad"]
    if kw["clip_gradient"] > 0:
        g = torch.clamp(g, -kw["clip_gradient"], kw["clip_gradient"])
    rows_w = weight._data.detach()[uids].to(torch.float32)
    return uids, g + kw["wd"] * rows_w


@torch.no_grad()
def _rs_apply(weight, uids, delta, states=()) -> None:
    """Add ``delta`` to the weight's rows ``uids`` and write each (state,
    rows) pair's rows, in place: no other row is touched."""
    w = weight._data
    w.index_add_(0, uids, delta.to(w.dtype))
    weight._version += 1
    for st, rows in states:
        st._data.index_copy_(0, uids, rows)
        st._version += 1


def _zeros_like32(weight):
    return NDArray(torch.zeros(weight.shape, dtype=torch.float32,
                               device=weight.context), ctx=weight.context)


def _master(weight):
    return NDArray(weight._data.detach().to(torch.float32),
                   ctx=weight.context)


class Optimizer:
    """Base optimizer."""

    opt_registry = _REGISTRY

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    @staticmethod
    def register(cls):
        return register(cls)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    # -- bookkeeping --------------------------------------------------------
    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _mult(self, index, by_index, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in by_index:
            return by_index[index]
        if index in self.idx2name:
            return by_index.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError(
                "LRScheduler of the optimizer has already been defined.")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr: float):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult: Dict) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict) -> None:
        self.wd_mult = dict(args_wd_mult)

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight._data.dtype in _LOW:
            master = _master(weight)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and isinstance(state, tuple) \
                and len(state) == 2 \
                and getattr(state[0], "shape", None) == weight.shape:
            master, inner = state
            self.update(index, master, grad, inner)
            weight._set_data(master._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    def _common_kwargs(self, index) -> Dict[str, Any]:
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": (self.clip_gradient
                                  if self.clip_gradient is not None
                                  else -1.0)}

    def _grad32(self, grad, weight, wd):
        """clip(grad * rescale) + wd * w in f32 (Adamax, Nadam)."""
        g = grad._data.to(torch.float32) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + wd * weight._data.to(torch.float32)


def _swap(arrays, results) -> None:
    for a, r in zip(arrays, results):
        a._set_data(r._data if isinstance(r, NDArray) else r)


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros_like32(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        if _row_sparse(grad):
            return self._update_rows(index, weight, grad, state)
        _dense(grad)
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _reg.invoke_by_name("sgd_update", [weight, grad], out=weight, **kw)
        else:
            _swap((weight, state), _reg.invoke_by_name(
                "sgd_mom_update", [weight, grad, state],
                momentum=self.momentum, **kw))

    def _update_rows(self, index, weight, grad, state):
        """The lazy update: w[rows] -= lr * g, or with momentum m[rows] =
        momentum * m[rows] - lr * g and w[rows] += m[rows]."""
        self._update_count(index)
        kw = self._common_kwargs(index)
        uids, g = _rs_rows(grad, weight, kw)
        if state is None:
            _rs_apply(weight, uids, -kw["lr"] * g)
        else:
            new_m = self.momentum * state._data[uids] - kw["lr"] * g
            _rs_apply(weight, uids, new_m, [(state, new_m)])

    def update_multi_precision(self, index, weight, grad, state):
        if not (isinstance(state, tuple) and len(state) == 2
                and getattr(state[0], "shape", None) == weight.shape):
            return self.update(index, weight, grad, state)
        _dense(grad)
        master, mom = state
        self._update_count(index)
        kw = self._common_kwargs(index)
        if mom is None:
            _swap((weight, master), _reg.invoke_by_name(
                "mp_sgd_update", [weight, grad, master], **kw))
        else:
            _swap((weight, mom, master), _reg.invoke_by_name(
                "mp_sgd_mom_update", [weight, grad, mom, master],
                momentum=self.momentum, **kw))

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight._data.dtype in _LOW:
            mom = _zeros_like32(weight) if self.momentum != 0.0 else None
            return (_master(weight), mom)
        return self.create_state(index, weight)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like32(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _reg.invoke_by_name("sgd_update", [weight, grad], out=weight, **kw)
        else:
            _swap((weight, state), _reg.invoke_by_name(
                "nag_mom_update", [weight, grad, state],
                momentum=self.momentum, **kw))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    def update(self, index, weight, grad, state):
        sparse = _row_sparse(grad)
        if not sparse:
            _dense(grad)
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        # bias correction folded into lr, as the reference's Adam.update
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        if sparse:
            # the lazy update: the rows' moments and weight only
            uids, g = _rs_rows(grad, weight, kw)
            new_mean = (self.beta1 * mean._data[uids]
                        + (1 - self.beta1) * g)
            new_var = (self.beta2 * var._data[uids]
                       + (1 - self.beta2) * torch.square(g))
            step = kw["lr"] * new_mean / (torch.sqrt(new_var)
                                          + self.epsilon)
            _rs_apply(weight, uids, -step,
                      [(mean, new_mean), (var, new_var)])
            return
        _swap((weight, mean, var), _reg.invoke_by_name(
            "adam_update", [weight, grad, mean, var], beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, **kw))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        g = self._grad32(grad, weight, self._get_wd(index))
        mean, u = state
        new_m = self.beta1 * mean._data + (1 - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u._data, g.abs())
        new_w = weight._data.to(torch.float32) - lr * new_m / (new_u + 1e-8)
        _swap((weight, mean, u), (new_w.to(weight._data.dtype), new_m, new_u))


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        g = self._grad32(grad, weight, self._get_wd(index))
        b1, b2, sd = self.beta1, self.beta2, self.schedule_decay
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        momentum_t_1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        mean, var = state
        g_prime = g / (1.0 - self.m_schedule)
        new_m = b1 * mean._data + (1.0 - b1) * g
        m_prime = new_m / (1.0 - m_schedule_next)
        new_v = b2 * var._data + (1.0 - b2) * torch.square(g)
        v_prime = new_v / (1.0 - b2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        new_w = weight._data.to(torch.float32) - lr * m_bar / (
            torch.sqrt(v_prime) + self.epsilon)
        _swap((weight, mean, var), (new_w.to(weight._data.dtype), new_m,
                                    new_v))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like32(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        _swap((weight, state), _reg.invoke_by_name(
            "adagrad_update", [weight, grad, state],
            epsilon=self.float_stable_eps, **self._common_kwargs(index)))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        acc_g, acc_delta = state
        kw = self._common_kwargs(index)
        kw.pop("lr")
        _swap((weight, acc_g, acc_delta), _reg.invoke_by_name(
            "adadelta_update", [weight, grad, acc_g, acc_delta], rho=self.rho,
            epsilon=self.epsilon, **kw))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like32(weight), _zeros_like32(weight),
                    _zeros_like32(weight))
        return _zeros_like32(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        kw = self._common_kwargs(index)
        cw = self.clip_weights if self.clip_weights is not None else -1.0
        if self.centered:
            n, g_buf, delta = state
            _swap((weight, n, g_buf, delta), _reg.invoke_by_name(
                "rmspropalex_update", [weight, grad, n, g_buf, delta],
                gamma1=self.gamma1, gamma2=self.gamma2, epsilon=self.epsilon,
                clip_weights=cw, **kw))
        else:
            _swap((weight, state), _reg.invoke_by_name(
                "rmsprop_update", [weight, grad, state], gamma1=self.gamma1,
                epsilon=self.epsilon, clip_weights=cw, **kw))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        z, n = state
        _swap((weight, z, n), _reg.invoke_by_name(
            "ftrl_update", [weight, grad, z, n], lamda1=self.lamda1,
            beta=self.beta, **self._common_kwargs(index)))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like32(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _swap((weight,), (_reg.invoke_by_name(
                "signsgd_update", [weight, grad], **kw),))
        else:
            _swap((weight, state), _reg.invoke_by_name(
                "signum_update", [weight, grad, state],
                momentum=self.momentum, wd_lh=self.wd_lh, **kw))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer: the two phases are the
    ``lamb_update_phase1/2`` ops, with the weight's and the update's L2
    norms between them."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like32(weight), _zeros_like32(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        kw = self._common_kwargs(index)
        lr = kw.pop("lr")
        wd = kw.pop("wd")
        g_update, new_mean, new_var = _reg.invoke_by_name(
            "lamb_update_phase1", [weight, grad, mean, var], beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, t=t,
            bias_correction=self.bias_correction, wd=wd, **kw)
        with torch.no_grad():
            r1 = NDArray(torch.linalg.vector_norm(
                weight._data.to(torch.float32)).reshape(1), ctx=weight.context)
            r2 = NDArray(torch.linalg.vector_norm(g_update._data).reshape(1),
                         ctx=weight.context)
        new_w = _reg.invoke_by_name(
            "lamb_update_phase2", [weight, g_update, r1, r2], lr=lr,
            lower_bound=(self.lower_bound if self.lower_bound is not None
                         else -1.0),
            upper_bound=(self.upper_bound if self.upper_bound is not None
                         else -1.0))
        _swap((weight, mean, var), (new_w, new_mean, new_var))


class Updater:
    """The per-index updater: ``updater(index, grad, weight)`` creates the
    index's state on first use and applies the optimizer."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def _ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded by set_states before this index was ever updated:
            # make the device state and fill it from the numpy snapshot
            snapshot = self.states[index]
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            _numpy_to_states(self.states[index], snapshot)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        state = self._ensure_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad, state)

    def get_states(self, dump_optimizer=False):
        """The states as numpy in a pickle, with the update counts (Adam's
        and LAMB's bias correction depend on them)."""
        payload = {"__states__": {i: _states_to_numpy(s)
                                  for i, s in self.states.items()},
                   "__counts__": dict(self.optimizer._index_update_count),
                   "__num_update__": self.optimizer.num_update}
        return pickle.dumps((payload, self.optimizer) if dump_optimizer
                            else payload)

    def set_states(self, states):
        data = pickle.loads(states)
        if isinstance(data, tuple) and len(data) == 2 and isinstance(
                data[1], Optimizer):
            payload, self.optimizer = data
        else:
            payload = data
        if isinstance(payload, dict) and "__states__" in payload:
            state = payload["__states__"]
            self.optimizer._index_update_count.update(
                payload.get("__counts__", {}))
            self.optimizer.num_update = max(self.optimizer.num_update,
                                            payload.get("__num_update__", 0))
        else:  # a bare state dict
            state = payload
        for idx, snp in state.items():
            if idx in self.states:
                _numpy_to_states(self.states[idx], snp)
            else:
                self.states[idx] = snp
                self.states_synced[idx] = False


def _states_to_numpy(s):
    if isinstance(s, NDArray):
        return s.asnumpy()
    if isinstance(s, (list, tuple)):
        return tuple(_states_to_numpy(x) for x in s)
    return s


def _numpy_to_states(s, snp):
    if s is None or snp is None:
        return
    if isinstance(s, NDArray):
        s._set_data(torch.from_numpy(np.ascontiguousarray(snp)).to(
            device=s.context, dtype=s._data.dtype))
        return
    if isinstance(s, (list, tuple)):
        for x, xnp in zip(s, snp):
            _numpy_to_states(x, xnp)


def get_updater(optimizer: Optimizer) -> Updater:
    """The updater for ``optimizer``: the fused batch updater unless
    ``MX_FUSED_UPDATE=0`` pins the per-parameter one."""
    from .fused import FusedUpdater, fused_enabled

    if fused_enabled():
        return FusedUpdater(optimizer)
    return Updater(optimizer)
