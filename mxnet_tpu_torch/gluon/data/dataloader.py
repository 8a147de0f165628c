"""DataLoader, the port's counterpart of
``mxnet_tpu/gluon/data/dataloader.py`` (reference:
python/mxnet/gluon/data/dataloader.py).

Batches are built on the host and moved whole to the loader's device
(``ctx``, default the card): one copy per array, through pinned memory
and without blocking on a CUDA device.  Transports, as in the JAX
loader:

- ``num_workers>0`` (default): PROCESS workers started with ``spawn``.
  A worker never touches CUDA: it hides every card from itself
  (``CUDA_VISIBLE_DEVICES`` empty) before it unpickles the dataset, and
  builds each batch as host arrays, which cross back through
  ``multiprocessing.shared_memory`` (one copy into shm in the worker,
  one copy out of it in the parent, which then moves the batch to the
  device).  Dataset and batchify_fn must be picklable, and (the
  ``spawn`` rule) a script making a worker-backed DataLoader at module
  level needs an ``if __name__ == "__main__"`` guard.
- ``thread_pool=True``: a thread pool, no transport cost.

``default_batchify_fn`` stacks samples into host (CPU) NDArrays; a
``batchify_fn`` of the caller's may return NDArrays, tensors or numpy
arrays, and each is moved to the device.  ``pin_memory`` is accepted;
a CUDA target is always copied from pinned memory.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ...base import MXNetError
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

# arrays at/above this size ride shared memory; smaller ones pickle
_SHM_MIN_BYTES = 1 << 15

_worker_state = None  # (dataset, batchify_fn) inside a worker process


def _worker_init(payload: bytes):
    # FIRST: no card in a worker, before anything can initialize CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _worker_state
    _worker_state = pickle.loads(payload)


def _host(obj):
    """NDArray or tensor -> numpy (a host copy); anything else as is."""
    import torch

    from ...ndarray import NDArray

    if isinstance(obj, NDArray):
        return obj.asnumpy()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def _encode(obj, created=None):
    """Worker-side: batch pytree -> picklable tree with big ndarrays in
    POSIX shared memory.  `created` collects segment names so a mid-batch
    failure can unlink what the batch already allocated."""
    obj = _host(obj)
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_MIN_BYTES:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        if created is not None:
            created.append(shm.name)
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        name = shm.name
        shm.close()
        return ("shm", name, obj.shape, str(obj.dtype))
    if isinstance(obj, (list, tuple)):
        return ("seq", isinstance(obj, tuple),
                [_encode(o, created) for o in obj])
    return ("raw", obj)


def _decode(enc):
    """Parent-side: rebuild the batch as host arrays; shm segments are
    copied out and unlinked at once."""
    kind = enc[0]
    if kind == "shm":
        from multiprocessing import shared_memory

        _, name, shape, dtype = enc
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = np.ndarray(shape, dtype, buffer=shm.buf).copy()
        finally:
            shm.close()
            shm.unlink()
        return arr
    if kind == "seq":
        _, is_tuple, items = enc
        vals = [_decode(o) for o in items]
        return tuple(vals) if is_tuple else vals
    return enc[1]


def _free(enc):
    """Unlink an encoded batch's shm segments without decoding it."""
    if enc[0] == "shm":
        _unlink([enc[1]])
    elif enc[0] == "seq":
        for o in enc[2]:
            _free(o)


def _unlink(names):
    from multiprocessing import shared_memory

    for name in names:
        try:
            shm = shared_memory.SharedMemory(name=name)
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass


def _worker_fn(indices):
    dataset, batchify_fn = _worker_state
    created = []
    try:
        return _encode(batchify_fn([dataset[i] for i in indices]), created)
    except BaseException:
        _unlink(created)  # don't leak this batch's finished segments
        raise


def default_batchify_fn(data):
    """Stack samples into a batch of host (CPU) NDArrays (reference:
    dataloader.py ~L130)."""
    import torch

    from ... import ndarray as nd
    from ...context import cpu
    from ...ndarray import NDArray

    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data.cpu() for d in data]), ctx=cpu())
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    arr = np.asarray(data)
    return nd.array(arr, ctx=cpu(), dtype=arr.dtype)


def _to_device(obj, device):
    """Every array of a batch tree as an NDArray on ``device``."""
    import torch

    from ...context import to_device
    from ...ndarray import NDArray

    if isinstance(obj, NDArray):
        obj = obj.data
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.float64:
            obj = obj.astype(np.float32)
        return NDArray(to_device(obj, device), ctx=device)
    if isinstance(obj, torch.Tensor):
        if obj.device != device:
            obj = (obj.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" and obj.device.type == "cpu"
                   else obj.to(device))
        return NDArray(obj, ctx=device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device) for o in obj)
    return obj


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler=None, last_batch=None,
                 batch_sampler=None, batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 pin_device_id: int = 0, prefetch: Optional[int] = None,
                 thread_pool: bool = False, timeout: int = 120,
                 prefetch_to=None, ctx=None):
        from ...context import resolve_device

        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise MXNetError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self.ctx = resolve_device(ctx)
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        # a DataParallelStep here stages every yielded batch onto the
        # step's device in a background thread (io.stage_batches)
        self._prefetch_to = prefetch_to
        self._pool = None  # lazy persistent process pool

    def _load(self, indices) -> object:
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _get_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            payload = pickle.dumps((self._dataset, self._batchify_fn))
            self._pool = ctx.Pool(self._num_workers, initializer=_worker_init,
                                  initargs=(payload,))
        return self._pool

    def __iter__(self):
        batches = (_to_device(b, self.ctx) for b in self._iter_batches())
        if self._prefetch_to is None:
            return batches
        from ...io.io import stage_batches

        return stage_batches(batches, self._prefetch_to)

    def _iter_batches(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._load(batch)
            return
        if self._thread_pool:
            # thread pool with bounded prefetch (double buffering)
            with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
                batches = iter(self._batch_sampler)
                futures = []
                try:
                    for _ in range(self._prefetch or self._num_workers):
                        futures.append(pool.submit(self._load, next(batches)))
                except StopIteration:
                    pass
                while futures:
                    fut = futures.pop(0)
                    try:
                        futures.append(pool.submit(self._load, next(batches)))
                    except StopIteration:
                        pass
                    yield fut.result()
            return
        # process workers + shared-memory transport
        pool = self._get_pool()
        batches = iter(self._batch_sampler)
        pending = []
        try:
            try:
                for _ in range(self._prefetch or self._num_workers):
                    pending.append(
                        pool.apply_async(_worker_fn, (next(batches),)))
            except StopIteration:
                pass
            while pending:
                res = pending.pop(0)
                try:
                    pending.append(
                        pool.apply_async(_worker_fn, (next(batches),)))
                except StopIteration:
                    pass
                yield _decode(res.get(self._timeout))
        finally:
            # abandoned iteration (break/exception): prefetched batches
            # hold live /dev/shm segments — drain and unlink them
            for res in pending:
                for attempt in (1, 2):
                    try:
                        _free(res.get(self._timeout))
                        break
                    except multiprocessing.TimeoutError:
                        if attempt == 2:
                            import warnings

                            warnings.warn(
                                "DataLoader drain timed out; a prefetched "
                                "batch's shared-memory segments may leak "
                                "until process exit")
                    except Exception:
                        break  # worker raised: _worker_fn already unlinked

    def __del__(self):
        pool = getattr(self, "_pool", None)  # __init__ may have raised
        if pool is not None:
            pool.terminate()

    def __len__(self):
        return len(self._batch_sampler)
