"""Parallelism scopes, consulted by the ops a step runs.

Counterpart of ``mxnet_tpu/parallel/scope.py``, unchanged in meaning:
``DataParallelStep`` with a sequence-sharded input activates
``ring_attention_scope(mesh, batch_axes, mode)`` around its forward and
backward, and the fused-attention site (``ops.contrib_ops.
sp_attention``) reads ``ring_scope()`` to take the sequence-parallel
route.  The JAX package enters the scope only for ``ring`` and
``ulysses``, and lets GSPMD gather K/V otherwise; the port has no
compiler to insert that gather, so its step also enters the scope in the
``gspmd`` mode, which the attention site serves by an all-gather of K/V
over ``sp`` (:func:`~mxnet_tpu_torch.parallel.ring.gather_attention`).

``seq_offset()`` is the global position of this process's first
sequence element under the active scope (0 without one): the
positional embeddings read it, since a rank's model sees only its slice
of the sequence.

``tensor_parallel_scope(mesh)`` is active while a step whose parameters
are sharded over ``tp`` runs its forward and backward: a layer whose
parameters carry a placement (``tensor_parallel.shard_of``) reads
``tp_scope()`` for the mesh, whose ``tp`` slice its collectives run over.
``pipeline_parallel_scope(mesh, batch_axes, microbatches)`` is active
around a step over a mesh whose ``pp`` axis is more than one process: a
stacked encoder (``models.bert_pp``) then runs its layers through
``pipeline.pipeline_apply``.

``batch_reduction_scope(group, world)`` is active while a step of more
than one process runs its forward and loss: a loss that normalizes by a
count it computes itself (``label_smoothed_ce``'s non-pad tokens) reads
``batch_reduction()`` and divides by the count over the whole group, so
that the step's mean over the processes is the global loss.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from ..base import MXNetError

__all__ = ["ring_scope", "ring_scope_mesh", "ring_attention_scope",
           "pipeline_scope", "pipeline_parallel_scope", "tp_scope",
           "tensor_parallel_scope", "seq_offset",
           "batch_reduction", "batch_reduction_scope", "global_count"]

_state = threading.local()
_MODES = ("ring", "ulysses", "gspmd")


def ring_scope() -> Optional[Tuple]:
    """(mesh, batch_axes, mode) of the innermost active scope, or None."""
    return getattr(_state, "scope", None)


def ring_scope_mesh():
    s = ring_scope()
    return None if s is None else s[0]


def seq_offset(local_len: int) -> int:
    """The global index of this rank's first sequence position, for a local
    sequence of ``local_len`` under the active scope; 0 without one."""
    s = ring_scope()
    if s is None:
        return 0
    return s[0].axis_index("sp") * int(local_len)


def pipeline_scope() -> Optional[Tuple]:
    """(mesh, batch_axes, microbatches) of the active pp scope, or None."""
    return getattr(_state, "pp_scope", None)


@contextlib.contextmanager
def pipeline_parallel_scope(mesh, batch_axes: Tuple[str, ...] = (),
                            microbatches: int = 4):
    prev = getattr(_state, "pp_scope", None)
    _state.pp_scope = (mesh, tuple(batch_axes), int(microbatches))
    try:
        yield
    finally:
        _state.pp_scope = prev


def tp_scope():
    """The mesh of the active tensor-parallel scope, or None."""
    return getattr(_state, "tp_scope", None)


@contextlib.contextmanager
def tensor_parallel_scope(mesh):
    prev = getattr(_state, "tp_scope", None)
    _state.tp_scope = mesh
    try:
        yield
    finally:
        _state.tp_scope = prev


@contextlib.contextmanager
def ring_attention_scope(mesh, batch_axes: Tuple[str, ...] = (),
                         mode: str = "ring"):
    """mode: ``ring`` (K/V rotate over ``sp``), ``ulysses`` (all-to-all
    head resharding) or ``gspmd`` (K/V gathered over ``sp``)."""
    if mode not in _MODES:
        raise MXNetError(f"unknown SP attention mode {mode!r} "
                         "(expected 'ring' or 'ulysses')")
    prev = getattr(_state, "scope", None)
    _state.scope = (mesh, tuple(batch_axes), mode)
    try:
        yield
    finally:
        _state.scope = prev


def batch_reduction() -> Optional[Tuple]:
    """(group, world) of the active step's batch reduction, or None."""
    return getattr(_state, "batch", None)


@contextlib.contextmanager
def batch_reduction_scope(group, world: int):
    prev = getattr(_state, "batch", None)
    _state.batch = (group, int(world))
    try:
        yield
    finally:
        _state.batch = prev


def global_count(count):
    """(count summed over the active step's processes, the number of
    processes); ``(count, 1)`` without a step of more than one."""
    red = batch_reduction()
    if red is None:
        return count, 1
    import torch.distributed as dist

    group, world = red
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return total, world
