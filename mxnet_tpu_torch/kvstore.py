"""KVStore: the data-parallel aggregation facade.

Counterpart of ``mxnet_tpu/kvstore.py``:

  * ``local``, ``device`` and ``nccl`` (``create`` maps ``nccl`` to
    ``device``, as the JAX one does) reduce over a device list in one
    process: ``push`` of a list of values for a key sums them, on cards
    through ``torch.cuda.comm.reduce_add`` (NCCL underneath) onto the first
    value's card, on the CPU as a plain sum; ``pull`` copies the stored
    value into each output, so every context of a device list gets it;
  * ``dist_sync``, ``dist_sync_device`` and ``dist_device_sync`` reduce
    over processes too: the constructor joins the launcher's process group
    (``parallel.dist.init_from_env``), ``rank`` and ``num_workers`` are the
    group's, ``init`` broadcasts rank 0's value, each push's device sum is
    then summed over the processes (one all-reduce), and the "server-side"
    optimizer (``set_optimizer``) runs the same update on every process,
    which the synchronous protocol makes equal to the reference's servers;
  * ``dist_async`` raises: asynchronous parameter serving has no SPMD
    analog (the JAX package's reason).

``push_bucketed`` coalesces many keys into flat buckets of
``parallel.dist.bucket_cap_bytes()`` (``MX_ALLREDUCE_BUCKET_MB``), one
reduction (and, for ``dist_*``, one all-reduce) a bucket, and returns the
number of buckets (0 when bucketing is off and every key was pushed on its
own); what the store holds afterwards is what per-key pushes would have
made.  Sparse values reduce in their dense form, and ``row_sparse_pull``
pulls the whole value, as in the JAX package.  The store keeps its own copy
of each value; ``pull`` copies into the arrays it is given (a Parameter's
NDArray writes into the module's tensor in place).
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List

import torch

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
        if self._dist:
            from .parallel import dist

            dist.init_from_env()

    @property
    def _dist(self) -> bool:
        return self._type.startswith("dist")

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        if self._dist:
            from .parallel import dist

            return dist.process_index()
        return 0

    @property
    def num_workers(self) -> int:
        if self._dist:
            from .parallel import dist

            return dist.process_count()
        return 1

    # ------------------------------------------------------------------
    def init(self, key, value) -> None:
        """Store a copy of each key's (first) value; a ``dist`` store over
        more than one process keeps rank 0's, so every process starts from
        the same value."""
        for k, v in zip(*self._key_value(key, value)):
            val = _copy(_as_list(v)[0])
            if self._dist and self.num_workers > 1:
                import torch.distributed as tdist

                tdist.broadcast(val._data, 0)
            self._store[k] = val

    def push(self, key, value, priority: int = 0) -> None:
        """Sum each key's values (over the device list, then over the
        processes of a ``dist`` store) and store the sum, or hand it to the
        updater (all the keys of this call in one batch)."""
        merged = []
        for k, v in zip(*self._key_value(key, value)):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            merged.append((k, self._global_sum(self._reduce(_as_list(v),
                                                            k))))
        self._store_merged(merged)

    def _reduce(self, vals, k=None) -> NDArray:
        """The sum of one key's values over its device list, on the stored
        value's device (the first value's without one); sparse values
        densify first."""
        vals = [x.todense() if x.stype != "default" else x for x in vals]
        dev = (self._store[k]._data.device if k in self._store
               else vals[0]._data.device)
        tensors = [x._data.detach() for x in vals]
        cards = [t.device for t in tensors]
        if (len(tensors) > 1 and all(d.type == "cuda" for d in cards)
                and len(set(cards)) == len(cards)):
            total = torch.cuda.comm.reduce_add(tensors, destination=dev)
        else:
            total = tensors[0].to(dev, copy=True)
            for t in tensors[1:]:
                total += t.to(dev)
        return NDArray(total, ctx=dev)

    def _global_sum(self, nd: NDArray) -> NDArray:
        """``nd`` summed over the processes of a ``dist`` store."""
        if self._dist and self.num_workers > 1:
            from .parallel import dist

            return NDArray(dist.allreduce_sum(nd._data), ctx=nd._ctx)
        return nd

    def push_bucketed(self, key, value, priority: int = 0) -> int:
        """Push many keys at once in flat buckets of at most
        ``bucket_cap_bytes`` (one dtype and device list each): one
        reduction and one all-reduce a bucket.  Returns the number of
        buckets; 0 when bucketing is off (each key pushed alone).  Sparse or
        ragged values take the per-key push."""
        from . import telemetry
        from .parallel import dist

        keys, values = self._key_value(key, value)
        cap = dist.bucket_cap_bytes()
        if cap <= 0:
            for k, v in zip(keys, values):
                self.push(k, v, priority)
            return 0
        with telemetry.span("push_bucketed", n_keys=len(keys)):
            groups: Dict[Any, List] = {}
            fallback = []
            for k, v in zip(keys, values):
                if k not in self._store:
                    raise MXNetError(f"key {k} not initialized")
                vals = _as_list(v)
                lead = vals[0]
                if (any(x.stype != "default" for x in vals)
                        or any(x._data.dtype != lead._data.dtype
                               or x.shape != lead.shape for x in vals[1:])):
                    fallback.append((k, vals))
                    continue
                gkey = (tuple(x._data.device for x in vals),
                        str(lead._data.dtype))
                groups.setdefault(gkey, []).append((k, vals))
            n_buckets = 0
            merged = []
            for items in groups.values():
                lead = [vals[0]._data for _k, vals in items]
                for idx in dist.buckets(lead, cap):
                    merged.extend(self._reduce_bucket([items[i]
                                                       for i in idx]))
                    n_buckets += 1
            self._store_merged(merged)
            for k, vals in fallback:
                self.push(k, vals, priority)
            return n_buckets

    def _reduce_bucket(self, bucket) -> List:
        """One flat bucket reduced over the device list (and processes) ->
        [(key, merged value)]."""
        from .parallel import dist

        if len(bucket) == 1:
            k, vals = bucket[0]
            return [(k, self._global_sum(self._reduce(vals, k)))]
        ndev = len(bucket[0][1])
        flats = [NDArray(dist.flatten_bucket([vals[d]._data.detach()
                                              for _k, vals in bucket]))
                 for d in range(ndev)]
        k0 = bucket[0][0]
        total = self._global_sum(self._reduce(flats, k0))
        shapes = [tuple(vals[0].shape) for _k, vals in bucket]
        return [(k, NDArray(seg, ctx=total._ctx)) for (k, _v), seg in
                zip(bucket, dist.unflatten_bucket(total._data, shapes))]

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
                dst._set_data(src.detach().to(dst._data.device, copy=True))

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
        if self._dist:
            from .parallel import dist

            dist.barrier()

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
    """A KVStore of type ``name`` (see the module's docstring)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    kv_type = name.lower()
    if kv_type in ("local", "local_allreduce_cpu", "local_allreduce_device",
                   "device", "nccl"):
        return KVStore("device" if kv_type != "local" else "local")
    if kv_type in ("dist_sync", "dist_sync_device", "dist_device_sync"):
        return KVStore(kv_type)
    if kv_type == "dist_async":
        raise MXNetError(
            "dist_async is not supported: asynchronous parameter serving "
            "has no SPMD analog; use dist_sync")
    raise MXNetError(f"unknown KVStore type {name!r}")
