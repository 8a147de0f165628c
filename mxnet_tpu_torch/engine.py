"""Execution-engine facade.

Counterpart of ``mxnet_tpu/engine.py``.  torch queues each card's work
on its stream in order, so what is left of MXNet's dependency engine is:

  * ``MXNET_ENGINE_TYPE=NaiveEngine`` (read once, at import, as the JAX
    module reads it): every registry op synchronizes its device after
    dispatch (``ops/registry.py``), the serial oracle for race debugging;
  * :func:`wait_all` (``mx.waitall``, ``mx.nd.waitall``): synchronize
    every card in use, then wait on the arrays given to :func:`track`,
    and raise the first failure -- a CUDA error from work queued earlier
    surfaces here, at the barrier, not at the op that dispatched it.

The JAX package tracks every NDArray, since waiting on a jax array is
how its barrier reaches the device; synchronizing the cards reaches all
of the port's work at once, so the port's NDArrays are not tracked (it
would cost each array a weak reference) and ``track`` serves arrays whose
``wait_to_read`` does more than the card's synchronization.
"""
from __future__ import annotations

import os
import weakref

import torch

__all__ = ["is_naive", "set_engine_type", "track", "wait_all"]

_ENGINE_TYPE = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")

# arrays registered for wait_all (weak: a dropped array is not kept alive)
_live: "weakref.WeakSet" = weakref.WeakSet()


def is_naive() -> bool:
    return _ENGINE_TYPE == "NaiveEngine"


def set_engine_type(name: str) -> None:
    global _ENGINE_TYPE
    _ENGINE_TYPE = name


def track(nd) -> None:
    """Register an array for :func:`wait_all` to wait on."""
    _live.add(nd)


def wait_all() -> None:
    """Block until all outstanding device work is complete; every card
    and tracked array is waited on before the first failure is raised."""
    first_err = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            try:
                torch.cuda.synchronize(i)
            except Exception as e:  # noqa: BLE001 — wait on the rest first
                if first_err is None:
                    first_err = e
    for nd in list(_live):
        try:
            nd.wait_to_read()
        except Exception as e:  # noqa: BLE001 — drain the rest first
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
