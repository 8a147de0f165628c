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

A gradient of a weight looked up by ``Embedding(sparse_grad=True)``
while recording (outside a hybridized block's call, :class:`traced`) is
torch's sparse one: a ``RowSparseNDArray`` buffer takes its rows summed
per id (``write`` replaces them, ``add`` merges), a dense buffer its
dense form, and :func:`grad` returns it as a ``RowSparseNDArray``; a
dense gradient into a row-sparse buffer fills every row.

``is_training()`` is this module's flag, set by ``record``/``train_mode``
and the ``train_mode`` arguments, not ``nn.Module.training``.

:func:`grad` returns the gradients instead of writing buffers
(``torch.autograd.grad``); with ``create_graph`` they carry a graph of
their own, so a gradient penalty built from them differentiates again.
:class:`Function` is MXNet's user-defined op, ``forward`` and
``backward`` over NDArrays, run inside a ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "register_leaves", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # > 0 inside a hybridized block's call (the JAX CachedOp's trace)
        self.traced = 0
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


class traced:
    """The scope of a hybridized block's call, which the JAX package runs
    as one traced program: an op's sparse-gradient pullback applies only
    outside it (``Embedding(sparse_grad=True)`` inside takes the dense
    gradient, every row, as the JAX ``CachedOp``'s ``vjp`` gives)."""

    def __enter__(self):
        _state.traced += 1
        return self

    def __exit__(self, *exc):
        _state.traced -= 1
        return False


def is_traced() -> bool:
    return _state.traced > 0


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
    from .ndarray.sparse import RowSparseNDArray

    for (_, ref), g in zip(leaves, grads):
        nd = ref()
        if g is None or nd is None or nd._grad is None:
            continue
        buf = nd._grad
        if isinstance(buf, RowSparseNDArray):
            buf._write_grad(g, add=nd._grad_req == "add")
            continue
        if g.layout != torch.strided:
            g = g.to_dense()  # a sparse gradient into a dense buffer
        g = g.to(buf._data.dtype)
        buf._set_data(buf._data + g if nd._grad_req == "add" else g)


def _heads_and_seeds(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    seeds = [torch.ones_like(h._data) if hg is None
             else hg._data.to(h._data.dtype)
             for h, hg in zip(heads, head_grads)]
    return [h._data for h in heads], seeds


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (arrays
    the recorded ops used), as new arrays; no buffer is written.  With
    ``create_graph`` the gradients are themselves recorded, for a
    second ``backward`` / ``grad``; ``retain_graph`` defaults to
    ``create_graph``."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, seeds = _heads_and_seeds(heads, head_grads)
    try:
        grads = torch.autograd.grad(
            outs, [v._data for v in variables], seeds,
            retain_graph=retain_graph, create_graph=create_graph)
    except RuntimeError as e:
        raise MXNetError("one of the variables is not part of the recorded "
                         f"graph ({e})") from None
    res = [_grad_array(g, v) for g, v in zip(grads, variables)]
    return res[0] if single else res


def _grad_array(g, v):
    """A gradient as the array :func:`grad` returns: a sparse one (an
    ``Embedding(sparse_grad=True)`` weight's) as a ``RowSparseNDArray`` of
    its summed rows."""
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import RowSparseNDArray, aggregate_rows

    if g.layout == torch.sparse_coo:
        uids, vals = aggregate_rows(g._indices()[0], g._values())
        return RowSparseNDArray(vals, {"indices": uids}, tuple(g.shape),
                                ctx=v.context)
    return NDArray(g, ctx=v.context)


class _FunctionNode(torch.autograd.Function):
    """The torch node of a :class:`Function` call: the user's forward
    and backward run over NDArrays, unrecorded."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray

        with pause(train_mode=is_training()):
            outs = func.forward(*[NDArray(t) for t in tensors])
        func._single = isinstance(outs, NDArray)
        ctx.func = func
        return tuple(o._data for o in ([outs] if func._single else outs))

    @staticmethod
    def backward(ctx, *cotangents):
        from .ndarray.ndarray import NDArray

        with pause(train_mode=is_training()):
            in_grads = ctx.func.backward(*[NDArray(c) for c in cotangents])
        if isinstance(in_grads, NDArray):
            in_grads = [in_grads]
        return (None,) + tuple(None if g is None else g._data
                               for g in in_grads)


class Function:
    """A user-defined differentiable function: subclass with
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` over
    NDArrays (``save_for_backward`` / ``saved_tensors`` keep arrays
    between them) and call the instance."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionNode.apply(self, *[x._data for x in inputs])
        register_leaves(inputs)
        ctx = inputs[0].context if inputs else None
        res = [NDArray(o, ctx=ctx) for o in outs]
        return res[0] if self._single else res
