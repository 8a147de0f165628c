"""Autograd: MXNet's imperative differentiation on torch's autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``/``pause`` scopes,
``backward``, ``mark_variables``), without a tape of its own:

  * inside ``record()`` ops run with torch's grad mode on, so their
    outputs carry ``grad_fn``; outside it, ``ops.registry`` runs them
    under ``torch.no_grad()``;
  * ``attach_grad`` makes an array's tensor a leaf that requires grad and
    gives it a gradient buffer; arrays with a buffer that ops use while
    recording are remembered, as the JAX package remembers them by the
    identity of their data;
  * :func:`backward` calls ``torch.autograd.grad`` for those leaves and
    writes each buffer by its ``grad_req``: ``write`` replaces it on
    every call (torch itself would accumulate), ``add`` adds to it;
    ``null`` has no buffer.  A head with no gradient given is seeded with
    ones, whatever its shape (torch wants a scalar);
  * a Gluon ``Parameter`` takes part as its ``data()`` array, whose leaf
    is the module's ``nn.Parameter`` and whose buffer is that tensor's
    ``.grad`` (``gluon.parameter``): a block called with NDArrays under
    ``record()`` registers them (``register_leaves``), and the buffer is
    written in place by the Parameter's ``grad_req``, ``add``
    accumulating until ``zero_grad``.

``is_training()`` is this module's flag, set by ``record``/``train_mode``
and the ``train_mode`` arguments, not ``nn.Module.training``.
``autograd.grad`` and ``Function`` are not ported.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "register_leaves"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # id(leaf tensor) -> (tensor, weakref to the NDArray whose .grad
        # receives its gradient)
        self.leaves: Dict[int, Any] = {}


_state = _State()


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._prev = None

    def __enter__(self):
        self._prev = (_state.recording, _state.training)
        if self._rec is True and not _state.recording:
            # a fresh outermost record scope drops the leaves of a forward
            # that never ran backward, as MXNet drops its graph
            _state.leaves = {}
        if self._rec is not None:
            _state.recording = self._rec
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._prev
        return False


def record(train_mode: bool = True):
    """Scope in which executed ops are recorded for :func:`backward`."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(flag: bool) -> bool:
    prev = _state.recording
    _state.recording = bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev = _state.training
    _state.training = bool(flag)
    return prev


def register_leaves(nds) -> None:
    """Remember the arrays among ``nds`` that have a gradient buffer, under
    the tensor they entered the graph with."""
    for nd in nds:
        if getattr(nd, "_grad", None) is not None and nd._data.requires_grad:
            _state.leaves[id(nd._data)] = (nd._data, weakref.ref(nd))


def _make_leaf(nd) -> None:
    """Make ``nd``'s tensor a fresh leaf that requires grad."""
    if not (nd._data.is_floating_point() or nd._data.is_complex()):
        raise MXNetError(f"attach_grad: a {nd._data.dtype} array cannot "
                         "have a gradient")
    nd._data = nd._data.detach().requires_grad_(True)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Associate arrays with gradient buffers (``grad_req`` ``null``:
    none)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._grad = g if req != "null" else None
        var._grad_req = req
        if var._grad is not None:
            _make_leaf(var)
            register_leaves([var])


def backward(heads, head_grads=None, retain_graph=False,
             train_mode=True) -> None:
    """Gradients of ``heads`` with respect to every recorded array with a
    gradient buffer, written into the buffers by their ``grad_req``."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue  # not computed from a recorded leaf: no gradient
        outs.append(h._data)
        seeds.append(torch.ones_like(h._data) if hg is None
                     else hg._data.to(h._data.dtype))
    leaves = list(_state.leaves.values())
    if not retain_graph:
        _state.leaves = {}
    if not outs or not leaves:
        return
    grads = torch.autograd.grad(outs, [t for t, _ in leaves], seeds,
                                retain_graph=retain_graph, allow_unused=True)
    for (_, ref), g in zip(leaves, grads):
        nd = ref()
        if g is None or nd is None or nd._grad is None:
            continue
        buf = nd._grad
        g = g.to(buf._data.dtype)
        buf._set_data(buf._data + g if nd._grad_req == "add" else g)
