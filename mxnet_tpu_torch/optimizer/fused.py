"""The fused optimizer apply: one pass of multi-tensor ``torch._foreach_*``
calls updates every dense parameter of a batch.

Counterpart of ``mxnet_tpu/optimizer/fused.py``.  The per-parameter
``Updater`` runs one update op per parameter, each a handful of kernel
launches; :meth:`FusedUpdater.apply` groups the batch by update variant
and runs each group's update as multi-tensor calls over the whole group,
the launches of one parameter for all of them.

Design rules, as in the JAX module:

  * the specs (SGD, Adam, RMSProp) compute the registered ops' formulas
    (``ops/optimizer_ops.py``) in their order, with the per-parameter
    scalars (lr after the schedule and ``lr_mult``, wd after ``wd_mult``,
    Adam's bias-corrected lr) as lists, so f32 results agree with the
    per-parameter path to rounding; SGD's and Adam's terms are the
    helpers of ``foreach.py``, which the training step
    (``parallel/data_parallel.py``) runs too;
  * the state layout is the per-parameter ``Updater``'s own ``states``
    dict (this class subclasses it), so ``get_states`` / ``set_states``
    and the ``MX_FUSED_UPDATE=0`` switch see one representation;
  * what a spec cannot express (another optimizer class, a weight and a
    gradient on different devices, a state of another layout, a sparse
    gradient) takes the per-parameter update, for just those parameters.

Multi-precision fuses too: the f32 master is updated and the 16-bit
weight is the master rounded once.  Weights are swapped for new tensors,
as the per-parameter ops do; the state tensors are updated in place.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

import torch

from ..ndarray.ndarray import NDArray
from .foreach import adam_, grad_terms_, sgd_
from .optimizer import Optimizer, Updater

__all__ = ["FusedUpdater", "fused_enabled"]

_F32 = torch.float32


def fused_enabled() -> bool:
    """The ``MX_FUSED_UPDATE`` switch (default: on)."""
    return os.environ.get("MX_FUSED_UPDATE", "1").lower() not in (
        "0", "false", "off")


def _is_nd(x) -> bool:
    """A dense NDArray: a sparse gradient (a ``RowSparseNDArray``) takes
    the per-parameter update, its lazy one, as in the JAX module."""
    return (isinstance(x, NDArray) and x.stype == "default"
            and x._data.layout == torch.strided)


def _clip(opt) -> Optional[float]:
    c = opt.clip_gradient
    return float(c) if c is not None and c >= 0 else None


def _grad_terms(opt, ws, gs, wds):
    """[clip(g * rescale) + wd_i * w_i] in f32, new tensors."""
    return grad_terms_([x.to(_F32, copy=True) for x in gs], ws,
                       float(opt.rescale_grad), _clip(opt), wds)


# ---------------------------------------------------------------------------
# per-optimizer specs: kind(opt, weight, state) -> the update variant or
# None; scalars(opt, index) -> (lr, wd); apply(opt, kind, ws32, gs, states,
# lrs, wds) updates the f32 weights ws32 and the states in place
# ---------------------------------------------------------------------------
_SPECS: Dict[str, type] = {}


def _register_spec(cls):
    _SPECS[cls.opt_name] = cls
    return cls


def _mp_pair(opt, weight, state):
    return (opt.multi_precision and isinstance(state, tuple)
            and len(state) == 2 and _is_nd(state[0])
            and state[0].shape == weight.shape)


@_register_spec
class _SGDSpec:
    opt_name = "SGD"

    @staticmethod
    def kind(opt, weight, state):
        if state is None:
            return "plain"
        if _is_nd(state):
            return "mom"
        if (isinstance(state, tuple) and len(state) == 2
                and _is_nd(state[0]) and state[0].shape == weight.shape):
            if state[1] is None:
                return "mp"
            if _is_nd(state[1]):
                return "mp_mom"
        return None

    @staticmethod
    def scalars(opt, index):
        return opt._get_lr(index), opt._get_wd(index)

    @staticmethod
    def apply(opt, kind, ws, gs, states, lrs, wds):
        g = _grad_terms(opt, ws, gs, wds)
        moms = None
        if kind in ("mom", "mp_mom"):
            moms = [(s[1] if kind == "mp_mom" else s)._data for s in states]
        sgd_(ws, g, moms, opt.momentum, lrs)


@_register_spec
class _AdamSpec:
    opt_name = "Adam"

    @staticmethod
    def kind(opt, weight, state):
        if not (isinstance(state, tuple) and len(state) == 2):
            return None
        if _mp_pair(opt, weight, state) and isinstance(state[1], tuple) \
                and len(state[1]) == 2 and all(_is_nd(x) for x in state[1]):
            return "mp"
        if opt.multi_precision and getattr(state[0], "shape", None) == \
                weight.shape:
            # the base class's multi-precision path would take (mean,
            # var) for (master, state): keep that per-parameter behaviour
            return None
        if all(_is_nd(x) for x in state):
            return "plain"
        return None

    @staticmethod
    def scalars(opt, index):
        t = opt._index_update_count[index]
        # bias correction folded into lr, exactly as Adam.update does
        lr = opt._get_lr(index) * math.sqrt(1.0 - opt.beta2 ** t) \
            / (1.0 - opt.beta1 ** t)
        return lr, opt._get_wd(index)

    @staticmethod
    def apply(opt, kind, ws, gs, states, lrs, wds):
        g = _grad_terms(opt, ws, gs, wds)
        pairs = [s[1] if kind == "mp" else s for s in states]
        adam_(ws, g, [m._data for m, _ in pairs], [v._data for _, v in pairs],
              float(opt.beta1), float(opt.beta2), float(opt.epsilon), lrs)


@_register_spec
class _RMSPropSpec:
    opt_name = "RMSProp"

    @staticmethod
    def kind(opt, weight, state):
        if _is_nd(state):
            return "plain"
        if isinstance(state, tuple) and len(state) == 3 \
                and all(_is_nd(x) for x in state):
            return "centered"
        if _mp_pair(opt, weight, state):
            if _is_nd(state[1]):
                return "mp_plain"
            if isinstance(state[1], tuple) and len(state[1]) == 3 \
                    and all(_is_nd(x) for x in state[1]):
                return "mp_centered"
        return None

    @staticmethod
    def scalars(opt, index):
        return opt._get_lr(index), opt._get_wd(index)

    @staticmethod
    def apply(opt, kind, ws, gs, states, lrs, wds):
        g = _grad_terms(opt, ws, gs, wds)
        inner = [s[1] if kind.startswith("mp") else s for s in states]
        g1, eps = float(opt.gamma1), float(opt.epsilon)
        sq = torch._foreach_mul(g, g)
        lr_g = torch._foreach_mul(g, lrs)
        if kind.endswith("plain"):
            ns = [s._data for s in inner]
            torch._foreach_mul_(ns, g1)
            torch._foreach_add_(ns, torch._foreach_mul(sq, 1 - g1))
            denom = torch._foreach_sqrt(torch._foreach_add(ns, eps))
            torch._foreach_sub_(ws, torch._foreach_div(lr_g, denom))
        else:
            ns = [s[0]._data for s in inner]
            gbs = [s[1]._data for s in inner]
            deltas = [s[2]._data for s in inner]
            torch._foreach_mul_(ns, g1)
            torch._foreach_add_(ns, torch._foreach_mul(sq, 1 - g1))
            torch._foreach_mul_(gbs, g1)
            torch._foreach_add_(gbs, torch._foreach_mul(g, 1 - g1))
            var = torch._foreach_sub(ns, torch._foreach_mul(gbs, gbs))
            denom = torch._foreach_sqrt(torch._foreach_add(var, eps))
            torch._foreach_mul_(deltas, float(opt.gamma2))
            torch._foreach_sub_(deltas, torch._foreach_div(lr_g, denom))
            torch._foreach_add_(ws, deltas)
        if opt.clip_weights is not None and opt.clip_weights > 0:
            cw = float(opt.clip_weights)
            torch._foreach_clamp_min_(ws, -cw)
            torch._foreach_clamp_max_(ws, cw)


class FusedUpdater(Updater):
    """Per-parameter-compatible updater with a fused ``apply([...])``.

    ``__call__`` is the inherited per-parameter update.  ``apply(entries)``
    (``(index, grad, weight)`` triples) sorts the batch into groups of one
    update variant on one device and the per-parameter rest, and updates
    each group with multi-tensor calls.  ``last_info`` records what the
    most recent ``apply`` did.  In the JAX package the Gluon ``Trainer``
    calls ``apply``; the port's Trainer is not ported yet (ROADMAP A.6),
    so ``apply`` is called directly."""

    def __init__(self, optimizer: Optimizer):
        super().__init__(optimizer)
        self.last_info: Optional[Dict[str, int]] = None

    def apply(self, entries) -> Dict[str, int]:
        opt = self.optimizer
        spec = _SPECS.get(type(opt).__name__)
        groups: Dict[Any, List] = {}
        fallback: List = []
        for index, grad, weight in entries:
            state = self._ensure_state(index, weight)
            kind = None
            if (spec is not None and _is_nd(grad) and _is_nd(weight)
                    and grad.context == weight.context):
                kind = spec.kind(opt, weight, state)
            if kind is None:
                fallback.append((index, grad, weight))
            else:
                groups.setdefault((weight.context, kind), []).append(
                    (index, grad, weight, state))
        info = {"n_params": len(entries), "n_fused": 0, "n_fallback": 0,
                "n_groups": len(groups)}
        for (_ctx, kind), group in groups.items():
            self._apply_group(spec, kind, group)
            info["n_fused"] += len(group)
        for index, grad, weight in fallback:
            opt.update_multi_precision(index, weight, grad,
                                       self.states[index])
            info["n_fallback"] += 1
        self.last_info = info
        return info

    @torch.no_grad()
    def _apply_group(self, spec, kind, group) -> None:
        opt = self.optimizer
        for index, _g, _w, _s in group:
            opt._update_count(index)
        lrs, wds = zip(*(spec.scalars(opt, index)
                         for index, _g, _w, _s in group))
        mp = kind.startswith("mp")
        # the f32 master in place, or a new f32 copy of the weight
        ws = [(s[0]._data if mp else w._data.to(_F32, copy=True))
              for _i, _g, w, s in group]
        spec.apply(opt, kind, ws, [g._data for _i, g, _w, _s in group],
                   [s for *_x, s in group], list(lrs), list(wds))
        for (_i, _g, w, _s), nw in zip(group, ws):
            w._set_data(nw.to(w._data.dtype))
