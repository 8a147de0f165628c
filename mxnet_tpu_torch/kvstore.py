"""KVStore, in one process on one device.

Counterpart of ``mxnet_tpu/kvstore.py`` for the ``local`` and ``device``
stores: ``init``, ``push`` (a list of values for one key is summed,
sparse values in their dense form, as the JAX store reduces them),
``pull``, ``pushpull``, ``row_sparse_pull`` (dense, as the JAX one),
``set_updater`` / ``set_optimizer`` (the "server-side" optimizer runs on
each push, batched through ``FusedUpdater.apply`` when several keys
arrive at once, as the JAX ``_store_merged`` does),
``save_optimizer_states`` / ``load_optimizer_states``, ``type``, ``rank``
0 and ``num_workers`` 1.  The store keeps its own copy of each value;
``pull`` copies into the arrays it is given (a Parameter's NDArray writes
into the module's tensor in place).

``"nccl"`` and ``"dist_*"`` raise: the port has one device per process
until ROADMAP A.9.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _copy(nd: NDArray, device=None) -> NDArray:
    t = nd._data.detach().to(device or nd.context, copy=True)
    return NDArray(t, ctx=t.device)


class KVStore:
    """Key-value store for parameter synchronization."""

    def __init__(self, kv_type: str = "local"):
        self._type = kv_type
        self._store: Dict[Any, NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # ------------------------------------------------------------------
    def init(self, key, value) -> None:
        for k, v in zip(*self._key_value(key, value)):
            self._store[k] = _copy(_as_list(v)[0])

    def push(self, key, value, priority: int = 0) -> None:
        """Sum each key's values and store the sum, or hand it to the
        updater (all the keys of this call in one batch)."""
        merged = []
        for k, v in zip(*self._key_value(key, value)):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            # a sparse value reduces dense, as the JAX store's
            vals = [x.todense() if x.stype != "default" else x
                    for x in _as_list(v)]
            dev = self._store[k].context
            total = vals[0]._data.detach().to(dev, copy=True)
            for x in vals[1:]:
                total += x._data.detach().to(dev)
            merged.append((k, NDArray(total, ctx=dev)))
        self._store_merged(merged)

    def _store_merged(self, merged) -> None:
        if self._updater is None:
            for k, m in merged:
                self._store[k] = m
            return
        entries = [(self._updater_key(k), m, self._store[k])
                   for k, m in merged]
        from .optimizer.fused import FusedUpdater

        if len(entries) > 1 and isinstance(self._updater, FusedUpdater):
            self._updater.apply(entries)
        else:
            for uk, m, stored in entries:
                self._updater(uk, m, stored)

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True) -> None:
        for k, o in zip(*self._key_value(key, out)):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            src = self._store[k]._data
            for dst in _as_list(o):
                dst._set_data(src.detach().to(dst.context, copy=True))

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def broadcast(self, key, value, out, priority: int = 0) -> None:
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0,
                        row_ids=None) -> None:
        """Dense, as the JAX store's: the whole value."""
        self.pull(key, out, priority)

    # ------------------------------------------------------------------
    def set_updater(self, updater) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        """Install the optimizer that updates the stored values on push;
        it crosses a pickle, as the reference sends it to its servers."""
        from . import optimizer as opt_mod

        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = opt_mod.get_updater(self._optimizer)

    def set_gradient_compression(self, compression_params) -> None:
        self._compression_params = compression_params

    def barrier(self) -> None:
        pass

    def save_optimizer_states(self, fname: str,
                              dump_optimizer: bool = False) -> None:
        if self._updater is None:
            raise MXNetError("no updater installed")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str) -> None:
        if self._updater is None:
            raise MXNetError("no updater installed")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # ------------------------------------------------------------------
    @staticmethod
    def _key_value(key, value):
        if isinstance(key, (list, tuple)):
            if value is None:
                return list(key), [None] * len(key)
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _updater_key(k):
        return int(k) if isinstance(k, str) and k.isdigit() else k


def create(name: str = "local") -> KVStore:
    """A ``local`` or ``device`` store; ``nccl`` and ``dist_*`` raise."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    kv_type = name.lower()
    if kv_type in ("local", "local_allreduce_cpu", "local_allreduce_device",
                   "device"):
        return KVStore("device" if kv_type != "local" else "local")
    if kv_type == "nccl" or kv_type.startswith("dist"):
        raise MXNetError(
            f"KVStore {name!r} spans devices or processes; the port has one "
            "device per process until ROADMAP A.9 (use 'local' or "
            "'device')")
    raise MXNetError(f"unknown KVStore type {name!r}")
