"""Core data-iterator API, the port's copy of ``mxnet_tpu/io/io.py``:
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter``,
``ResizeIter``, ``CSVIter``, ``PrefetchingIter``, ``DevicePrefetchIter``
and ``stage_batches``.

Arrays an iterator makes live on its ``ctx`` (default the card): each
batch is sliced on the host and copied once, through pinned memory
without blocking on a CUDA device.  ``DevicePrefetchIter`` and
``stage_batches`` stage batches onto a ``DataParallelStep``'s device
through its ``stage`` from a background thread, and call its ``drain``
at the end, as the JAX ones stage onto the step's shardings.
``LibSVMIter`` gives ``csr`` batches built straight from the parsed
rows (the JAX iterator densifies each batch first, which at a million
features is 32 GB a batch of 8,192): the same ``indptr``, ``indices``
and values, copied to ``ctx``.
"""
from __future__ import annotations

from collections import namedtuple
from typing import List, Optional

import numpy as np

from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "CSVIter", "LibSVMIter", "PrefetchingIter", "DevicePrefetchIter",
           "stage_batches"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise MXNetError("data must be a list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise MXNetError("label must be a list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return (f"{type(self).__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (reference ~L200)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    from ..ndarray import NDArray

    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError(
            f"Input must be NDArray, numpy.ndarray, list or dict; got "
            f"{type(data)}")
    return list(data.items())


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays (reference ~L600).

    TPU-native extensions over the reference iterator
    (docs/FAULT_TOLERANCE.md §Elastic resize):

    * ``seed`` — a per-iterator RNG.  The reference shuffled through the
      *global* ``np.random`` state, so two interleaved iterators
      perturbed each other and a restarted run could never reproduce an
      epoch's order.  Here each epoch's permutation is derived from
      ``(seed, epoch)`` alone, so the order is reproducible across
      process restarts (the prerequisite for the checkpointable cursor).
      ``seed=None`` draws one from the global stream at construction
      (legacy ``np.random.seed`` determinism preserved) and records it in
      :meth:`get_state` — even an unseeded iterator restores exactly.
    * ``num_parts`` / ``part_index`` — gang sharding over ONE global
      sample order (the ``ImageRecordIter`` contract): every rank holds
      the full arrays, each global batch is ``batch_size * num_parts``
      consecutive samples of the epoch permutation, and rank ``p`` takes
      its ``batch_size`` slice.  The cursor counts GLOBAL samples, so it
      is world-size independent: after an elastic resize the restored
      iterator continues at the same sample position under the new
      ``(num_parts, batch_size)`` — no sample skipped or consumed twice
      even though the per-rank shard boundaries moved.
    * :meth:`get_state` / :meth:`set_state` — the checkpointable position
      (epoch, seed, global sample cursor), saved alongside the model via
      ``AsyncCheckpointer.step(..., extra=...)``.

    Batches land on ``ctx`` (default the card).
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None,
                 num_parts=1, part_index=0, ctx=None):
        from ..context import resolve_device

        super().__init__(batch_size)
        self.ctx = resolve_device(ctx)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        if num_parts < 1 or not 0 <= part_index < num_parts:
            raise MXNetError(
                f"need 0 <= part_index < num_parts, got part_index="
                f"{part_index} num_parts={num_parts}")
        if num_parts > 1 and last_batch_handle == "roll_over":
            # a short final global batch would hand higher-index parts an
            # empty/shorter slice than their peers — divergent shapes into
            # a sync-SGD collective step; gang sharding supports pad (wrap)
            # and discard, whose per-part shapes stay uniform
            raise MXNetError(
                "num_parts > 1 does not support last_batch_handle="
                "'roll_over' (ragged per-rank final batches); use 'pad' "
                "or 'discard'")
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._stride = batch_size * self.num_parts
        self.shuffle = shuffle
        if seed is None:
            if shuffle and self.num_parts > 1:
                # each rank drawing its own seed would shard DIFFERENT
                # permutations — samples consumed twice/never with no
                # error; the gang contract requires one agreed seed
                raise MXNetError(
                    "num_parts > 1 with shuffle requires an explicit "
                    "seed: every rank must shard ONE global sample order")
            # drawn from the global stream so legacy global-seed setups
            # stay deterministic; recorded in get_state so restores
            # reproduce the order either way
            seed = int(np.random.randint(0, 2**31 - 1)) if shuffle else 0
        self._seed = int(seed)
        self._epoch = 0
        self.last_batch_handle = last_batch_handle
        self.idx = self._perm()
        self.cursor = -self._stride
        num = self._size()
        if last_batch_handle == "discard":
            self.num_data = (num // self._stride) * self._stride
        else:
            self.num_data = num

    def _size(self):
        k, v = self.data[0]
        return len(v)

    def _perm(self):
        """This epoch's sample order — a pure function of (seed, epoch),
        never of global RNG state or of how many batches were drawn."""
        n = self._size()
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self._seed, self._epoch)).permutation(n)

    # -- checkpointable position (docs/FAULT_TOLERANCE.md §Elastic resize) --
    def get_state(self) -> dict:
        """JSON-serializable iterator position: (epoch, seed, global
        sample cursor).  The cursor counts samples consumed by ALL parts
        jointly, so the state restores onto a different
        ``(num_parts, batch_size)`` split — the elastic-resize contract."""
        return {"epoch": int(self._epoch), "seed": int(self._seed),
                "sample_cursor": int(max(0, self.cursor + self._stride)),
                "shuffle": bool(self.shuffle),
                "num_data": int(self._size())}

    def set_state(self, state: dict) -> None:
        """Resume exactly where :meth:`get_state` left off — the next
        batch starts at the saved global sample position under THIS
        iterator's stride, on the same (seed, epoch) permutation."""
        if int(state.get("num_data", self._size())) != self._size():
            raise MXNetError(
                f"iterator state was saved over {state.get('num_data')} "
                f"samples but this iterator holds {self._size()} — "
                "restore requires the same dataset")
        self._seed = int(state["seed"])
        self.shuffle = bool(state.get("shuffle", self.shuffle))
        self._epoch = int(state["epoch"])
        self.idx = self._perm()
        self.cursor = int(state["sample_cursor"]) - self._stride

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(np.shape(v)[1:]),
                         getattr(v, "dtype", np.float32))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(np.shape(v)[1:]),
                         getattr(v, "dtype", np.float32))
                for k, v in self.label]

    def reset(self):
        self._epoch += 1  # a fresh (seed, epoch) permutation each epoch
        self.idx = self._perm()
        self.cursor = -self._stride

    def iter_next(self):
        self.cursor += self._stride
        if self.last_batch_handle == "discard":
            # the FULL global window must fit: a restored cursor may not
            # be aligned to THIS stride (set_state after a resize), and a
            # straddling window would hand ranks ragged/empty batches —
            # discard means fixed shapes, so the short tail is dropped
            return self.cursor + self._stride <= self._size()
        return self.cursor < self.num_data

    def _sel(self):
        """This part's sample ids for the current global batch: the
        ``batch_size`` slice at ``part_index`` inside the
        ``batch_size * num_parts`` global window at ``cursor``.  In pad
        mode a window reaching past the epoch wraps circularly over the
        permutation (the reference's wrap-from-the-head, generalized to
        parts)."""
        offset = self.cursor + self.part_index * self.batch_size
        end = offset + self.batch_size
        # discard windows are guaranteed by iter_next to fit the RAW
        # size (a restored cursor may be unaligned, so a full window can
        # legitimately reach past the stride-aligned num_data)
        limit = self._size() if self.last_batch_handle == "discard" \
            else self.num_data
        if end <= limit:
            return self.idx[offset:end]
        if self.last_batch_handle == "pad":
            return self.idx[np.arange(offset, end) % self.num_data]
        return self.idx[offset:limit]  # roll_over: short part

    def _take(self, arrays):
        from ..context import to_device
        from ..ndarray import NDArray

        sel = self._sel()
        out = []
        for _, v in arrays:
            vnp = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
            part = vnp[sel]
            if part.dtype == np.float64:
                part = part.astype(np.float32)
            out.append(NDArray(to_device(part, self.ctx), ctx=self.ctx))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getindex(self):
        """Sample ids of this part's current batch (the census surface:
        summing getindex over ranks and steps must cover an epoch exactly
        once — asserted across an elastic resize in tests/test_elastic.py)."""
        if self.cursor < 0:
            return None
        return self._sel().copy()

    def getpad(self):
        if self.last_batch_handle != "pad":
            return 0
        offset = self.cursor + self.part_index * self.batch_size
        pad = offset + self.batch_size - self.num_data
        return max(0, min(self.batch_size, pad))


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (reference ~L300)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class CSVIter(DataIter):
    """CSV file iterator (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, ctx=None, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard", ctx=ctx)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class LibSVMIter(DataIter):
    """A libsvm-format iterator giving ``csr`` batches (reference:
    ``src/io/iter_libsvm.cc``), with dense labels on ``ctx`` (default
    the card).

    ``one_based=True`` reads a 1-based file (liblinear / svmlight),
    ``False`` a 0-based one; ``None`` shifts only when the largest id
    equals the feature count, and warns that it did.  Within a row the
    ids are sorted, a repeated id keeps its last value and zero values
    are dropped: the rows a dense batch converted to ``csr`` would give,
    without the dense batch.  ``round_batch`` fills the last batch from
    the start of the file and reports the filled rows in ``pad``;
    otherwise the last partial batch is dropped."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, round_batch=True, one_based=None, ctx=None,
                 **kwargs):
        from ..context import resolve_device

        super().__init__(batch_size)
        self._n_feat = int(np.prod(data_shape))
        self.ctx = resolve_device(ctx)
        labels, counts, cols, vals = [], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                counts.append(len(parts) - 1)
                for p in parts[1:]:
                    k, v = p.split(":")
                    cols.append(int(k))
                    vals.append(float(v))
        if label_libsvm is not None:
            with open(label_libsvm) as f:
                labels = [float(line.split()[0]) for line in f
                          if line.strip()]
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if cols.size:
            lo, hi = int(cols.min()), int(cols.max())
            if one_based is True:
                if lo < 1:
                    raise MXNetError(
                        f"one_based=True but found feature index {lo}")
                cols -= 1
            elif one_based is None and lo >= 1 and hi == self._n_feat:
                import warnings

                warnings.warn(
                    "LibSVMIter: max feature index equals n_feat; assuming "
                    "a 1-based file and shifting indices.  Pass one_based="
                    "True/False to silence this heuristic.", stacklevel=2)
                cols -= 1
            if int(cols.max()) >= self._n_feat:
                raise MXNetError(
                    f"libsvm feature index {int(cols.max())} out of range "
                    f"for data_shape {data_shape}")
        rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        # sorted by (row, id), the last of a repeated id kept, zeros gone
        order = np.lexsort((np.arange(cols.size), cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        last = np.ones(cols.size, bool)
        last[:-1] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        keep = last & (vals != 0)
        rows, self._cols, self._vals = rows[keep], cols[keep], vals[keep]
        self._ptr = np.zeros(len(counts) + 1, np.int64)
        self._ptr[1:] = np.cumsum(np.bincount(rows, minlength=len(counts)))
        self._labels = np.asarray(labels, np.float32)
        self._round = round_batch
        self._pos = 0

    @property
    def provide_data(self):
        return [DataDesc(name="data",
                         shape=(self.batch_size, self._n_feat))]

    @property
    def provide_label(self):
        return [DataDesc(name="softmax_label", shape=(self.batch_size,))]

    def reset(self):
        self._pos = 0

    def _span(self, a, b):
        """(indptr from 0, ids, values) of rows [a, b)."""
        p = self._ptr
        return (p[a:b + 1] - p[a], self._cols[p[a]:p[b]],
                self._vals[p[a]:p[b]])

    def next(self):
        from ..context import to_device
        from ..ndarray import NDArray
        from ..ndarray.sparse import CSRNDArray

        n = len(self._ptr) - 1
        if self._pos >= n:
            raise StopIteration
        end = min(self._pos + self.batch_size, n)
        pad = self.batch_size - (end - self._pos)
        if pad and not self._round:
            raise StopIteration
        indptr, cols, vals = self._span(self._pos, end)
        label = self._labels[self._pos:end]
        if pad:  # wrap around to the first rows, as the reference does
            ptr2, cols2, vals2 = self._span(0, pad)
            indptr = np.concatenate([indptr, ptr2[1:] + indptr[-1]])
            cols = np.concatenate([cols, cols2])
            vals = np.concatenate([vals, vals2])
            label = np.concatenate([label, self._labels[:pad]])
        self._pos += self.batch_size
        dev = self.ctx
        csr = CSRNDArray(to_device(vals, dev),
                         {"indices": to_device(cols, dev),
                          "indptr": to_device(indptr, dev)},
                         (self.batch_size, self._n_feat), ctx=dev)
        return DataBatch([csr], [NDArray(to_device(label, dev), ctx=dev)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False


class _ThreadedIter(DataIter):
    """Shared background-production discipline for prefetching iterators
    (reference: io.py threadediter).  Guarantees the wrappers ride on:

    * a worker failure propagates to the consumer EXACTLY ONCE with the
      worker's original traceback (subsequent ``next()`` raise
      StopIteration until ``reset()``);
    * the worker catches BaseException — a dying worker always leaves a
      message in the queue, so the consumer can never block forever on a
      silently dead thread (the old ``except Exception`` swallowed e.g.
      KeyboardInterrupt and hung the consumer);
    * ``reset()`` restarts cleanly from ANY state — mid-epoch, after
      exhaustion, after a worker error — via a generation counter: the
      old worker is retired (it checks the generation around every
      blocking queue operation), joined, and only then is the wrapped
      iterator reset for the fresh worker.
    """

    _QUEUE_DEPTH = 2

    def __init__(self, inner, batch_size=0):
        super().__init__(batch_size)
        self._iter = inner
        self._gen = 0
        self._done = False
        import queue

        self._queue: "queue.Queue" = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._thread = None
        self._start()

    # -- hooks -------------------------------------------------------------
    def _produce(self):
        """Produce the next item (worker thread); raise StopIteration at
        epoch end."""
        raise NotImplementedError

    def _on_epoch_end(self):
        """Consumer-side hook when the epoch's 'done' marker is consumed."""

    # -- machinery ---------------------------------------------------------
    def _start(self):
        import threading

        gen, q = self._gen, self._queue

        def _put(kind, payload):
            # bounded put that never deadlocks against a consumer that
            # already reset(): a stale-generation worker just drops out
            import queue as _q

            while gen == self._gen:
                try:
                    q.put((gen, kind, payload), timeout=0.1)
                    return True
                except _q.Full:
                    continue
            return False

        def worker():
            while gen == self._gen:
                try:
                    item = self._produce()
                except StopIteration:
                    _put("done", None)
                    return
                except BaseException as exc:  # noqa: BLE001 — see class doc
                    _put("error", exc)
                    return
                if not _put("batch", item):
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        import queue

        self._gen += 1  # retire the current worker at its next gen check
        thread = self._thread
        while thread is not None and thread.is_alive():
            try:  # unblock a worker parked on a full queue
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        if thread is not None:
            thread.join()
        # only after the old worker is gone may the wrapped iterator be
        # touched — two workers interleaving .next() on one iter would
        # shuffle (or double-consume) batches
        self._iter.reset()
        self._done = False
        self._queue = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._start()

    def next(self):
        import queue as _q

        if self._done:
            raise StopIteration  # repeatable after exhaustion/error
        while True:
            try:
                gen, kind, payload = self._queue.get(timeout=0.1)
            except _q.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    # belt and braces: a worker can no longer die without
                    # queueing a marker, but never hang the consumer if
                    # one somehow does
                    self._done = True
                    raise MXNetError(
                        "prefetch worker died without producing a result")
                continue
            if gen != self._gen:
                continue  # stale item from a retired worker
            if kind == "done":
                self._done = True
                self._on_epoch_end()
                raise StopIteration
            if kind == "error":
                self._done = True  # exactly once; then StopIteration
                raise payload  # original worker traceback rides along
            return payload

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label


class PrefetchingIter(_ThreadedIter):
    """Background-thread prefetch wrapper (reference: io.py
    PrefetchingIter over threadediter) — overlaps host-side batch prep
    with device compute, the python analog of the C++ PrefetcherIter.

    rename_data/rename_label: list with one dict mapping original
    descriptor names to new names (reference semantics for binding under
    different arg names).
    """

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter here wraps exactly one iter; "
                             "compose multiple with a zip-style wrapper")
        self._rename_data = (rename_data[0] if rename_data else None)
        self._rename_label = (rename_label[0] if rename_label else None)
        super().__init__(iters[0],
                         batch_size=getattr(iters[0], "batch_size", 0))

    def _produce(self):
        return self._iter.next()

    def _renamed(self, descs, mapping):
        if not mapping:
            return descs
        return [DataDesc(name=mapping.get(d.name, d.name), shape=d.shape)
                for d in descs]

    @property
    def provide_data(self):
        return self._renamed(self._iter.provide_data, self._rename_data)

    @property
    def provide_label(self):
        return self._renamed(self._iter.provide_label, self._rename_label)


def _staged_batch_arrays(it):
    """memwatch provider: device arrays of batches parked in the prefetch
    queue (staged but not yet consumed by a step)."""
    out = []
    try:
        items = list(it._queue.queue)
    except Exception:
        return out
    for item in items:
        if not (isinstance(item, tuple) and len(item) == 3):
            continue
        _gen, kind, payload = item
        if kind != "batch" or payload is None:
            continue
        for nd in list(getattr(payload, "data", None) or ()) + \
                list(getattr(payload, "label", None) or ()):
            data = getattr(nd, "_data", None)
            if data is not None:
                out.append(data)
    return out


class DevicePrefetchIter(_ThreadedIter):
    """Device-side input prefetch: wraps any DataIter and stages the NEXT
    batch onto a ``DataParallelStep``'s device (via its ``stage()``) from
    a background thread while the current step computes — so the H2D
    transfer overlaps device compute instead of serializing in
    ``step()``.  The step finds the inputs already on its device and
    copies nothing.

    Epoch end drains the step's in-flight window: by the time
    StopIteration reaches the training loop every dispatched step has
    landed (and any deferred failure has surfaced).

    Only the FIRST label array is staged (the fused step consumes one
    label); extra label arrays pass through untouched.

    ``depth=None`` (default) is a staging queue of 1 (the port has no
    superstep, whose group size the JAX one takes).
    """

    def __init__(self, data_iter, step, depth=None):
        if depth is None:
            depth = 1
        self._step = step
        self._QUEUE_DEPTH = max(1, int(depth))
        super().__init__(data_iter,
                         batch_size=getattr(data_iter, "batch_size", 0))
        # live-array census: batches staged on device ahead of the step
        # are the "inflight" slice of the memory watchdog
        from .. import memwatch

        memwatch.register("inflight", self, _staged_batch_arrays)

    def _produce(self):
        batch = self._iter.next()
        data = list(batch.data or [])
        label = list(batch.label or [])
        staged_data, staged_label = self._step.stage(
            tuple(data), label[0] if label else None)
        return DataBatch(list(staged_data),
                         ([staged_label] + label[1:]) if label else None,
                         pad=batch.pad, index=batch.index,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)

    def _on_epoch_end(self):
        self._step.drain()


def stage_batches(iterable, step, depth=None):
    """Generator wrapper giving any (data, ..., label)-tuple iterable —
    e.g. a ``gluon.data.DataLoader`` — the same background device staging
    as :class:`DevicePrefetchIter`: each batch's arrays are pre-placed
    onto ``step``'s device in a worker thread while the previous step
    computes.  Batches that are a single array stage as data only;
    sequences stage all-but-last as data and the last element as label.
    The step's in-flight window is drained when the iterable ends.
    ``depth=None`` is a queue of 1, as :class:`DevicePrefetchIter`'s."""
    import queue as _q
    import threading

    if depth is None:
        depth = 1

    q: "_q.Queue" = _q.Queue(maxsize=max(1, int(depth)))
    _END, _ERR = object(), object()
    retired = threading.Event()

    def _put(item):
        # bounded put that never deadlocks against a consumer that
        # abandoned the generator early (same escape as _ThreadedIter's):
        # a retired worker drops out instead of pinning the staged device
        # arrays + this thread forever
        while not retired.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _q.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterable:
                if isinstance(batch, (list, tuple)) and len(batch) >= 2:
                    data, lab = tuple(batch[:-1]), batch[-1]
                    staged, slab = step.stage(data, lab)
                    out = list(staged) + [slab]
                    item = tuple(out) if isinstance(batch, tuple) else out
                else:
                    one = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    staged, _ = step.stage(one, None)
                    item = ([staged[0]] if isinstance(batch, list) else
                            (staged if isinstance(batch, tuple)
                             else staged[0]))
                if not _put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 — consumer re-raises
            _put((_ERR, exc))
            return
        _put((_END, None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            # control markers compare by IDENTITY: a real 2-tuple batch
            # holds NDArrays whose == is elementwise and must never be
            # invoked here
            if type(item) is tuple and len(item) == 2 and \
                    (item[0] is _END or item[0] is _ERR):
                if item[0] is _ERR:
                    raise item[1]
                return
            yield item
    finally:
        # runs on normal end, on the error re-raise, AND on generator
        # close/abandonment: retire the worker, then land every in-flight
        # step so nothing is left pending behind the caller's back
        retired.set()
        step.drain()
