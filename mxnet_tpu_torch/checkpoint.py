"""Step-granular asynchronous checkpointing with verified restore.

The counterpart of ``mxnet_tpu/checkpoint.py``, on the same directory
protocol, so a checkpoint written by either package loads in the other
with every array equal bit for bit (the arrays go through
``ndarray/utils.py``, whose file format is the JAX package's):

  * a background thread writes ``step-N/`` directories (the training loop
    never blocks on disk): staged in a ``.tmp-*`` directory, published by
    an atomic rename, rotated to ``keep`` scheduled steps, pointed at by
    ``latest``;
  * every payload file's SHA-256 digest is recorded in ``meta.json``;
    loads verify digests and fall back to the next-newest *valid* step
    when the newest is torn, truncated or missing.  The ``fault.py``
    hooks sit in the writer, so every failure shape is reproducible on
    demand (``MX_FAULT_SPEC``);
  * format 1 (gathered): ``params.nd`` (+ ``trainer.states``);
  * format 2 (``sharded=True`` or ``MX_CKPT_SHARDED``): per-rank
    ``params-shard-R.nd`` files with an atomic ``shard-R.json`` digest
    marker and a shard manifest in ``meta.json`` next to ``layout``.
    The port runs one process, so rank 0 owns every shard, each a whole
    parameter; a format-2 directory of the JAX package (any world size)
    loads through :class:`_LazyShardedArray`.

Parameters are keyed by structural names
(``encoder.layers.0.attn.qkv.weight``), in Gluon's layouts and dtypes,
which both packages' Blocks share.  The
optimizer states of a ``gluon.Trainer`` go through its ``save_states``
bytes (the JAX package's pickle of numpy states).  A target with
``state_dict``, ``load_state_dict`` and ``layout`` (a
``DataParallelStep``) is saved from its ``state_dict``: its optimizer
slots (``mom.*``, ``mean.*``, ``var.*``, ``t``, ``amp.*``) go to
``opt_state.nd`` and its ``layout()`` (with the optimizer's name) to
``meta.json`` in format 1, and through its ``shard_state_dict`` in format
2; ``restore`` hands the loaded state to its ``load_state_dict``.  Such
checkpoints cross packages both ways with their slots.  ``meta.json``'s
``rng`` (the JAX package's PRNG key) is left null by the port, which
records torch's generator states under ``torch_rng`` instead; seeds do
not carry across the packages.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import fault
from . import memwatch
from . import telemetry
from .base import MXNetError

__all__ = ["AsyncCheckpointer", "load_checkpoint_state", "restore",
           "latest_valid_step", "agree_resume_step"]

_LOG = logging.getLogger("mxnet_tpu_torch.checkpoint")


def _env_sharded_default() -> bool:
    """``MX_CKPT_SHARDED`` (off unless truthy): the constructor default
    for shard-granular (format 2) checkpoints."""
    return os.environ.get("MX_CKPT_SHARDED", "").lower() not in (
        "", "0", "false", "off")


def _shard_wait_s() -> float:
    """How long the leader rank waits for peer shard commit markers
    (``MX_CKPT_SHARD_WAIT_S``, seconds)."""
    try:
        return float(os.environ.get("MX_CKPT_SHARD_WAIT_S", "60"))
    except (TypeError, ValueError):
        return 60.0


def _is_step_target(obj) -> bool:
    """Whether ``obj`` is a step-like target (``DataParallelStep``): it
    owns its state (``state_dict`` / ``load_state_dict``) and describes
    its placement (``layout``)."""
    return (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")
            and hasattr(obj, "layout"))


def _params_of(net_or_params) -> dict:
    """Structural name -> Parameter of a Block, or the dict given."""
    if hasattr(net_or_params, "_collect_params_with_prefix"):
        return net_or_params._collect_params_with_prefix()
    return dict(net_or_params)


def _snapshot_params(net_or_params) -> Dict[str, torch.Tensor]:
    """Host copies (CPU tensors, Gluon layout and dtype) keyed by
    structural names.  The device-to-host copy happens here; the disk
    I/O is what the background thread takes off the critical path."""
    return {name: p._reduce().detach().to("cpu", copy=True)
            for name, p in _params_of(net_or_params).items()}


def _host_view(t) -> np.ndarray:
    """A numpy view of a CPU tensor's bytes (bfloat16 through int16), or
    the numpy array itself."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _block_shard_state(snapshot: Dict[str, torch.Tensor],
                       rank: int) -> dict:
    """The format-2 shard state of a one-process Block snapshot: each
    parameter one shard, owned by ``rank``, covering the whole array."""
    manifest = {"params": {}, "opt_state": {}}
    local = {}
    for name, t in snapshot.items():
        manifest["params"][name] = {
            "shape": [int(s) for s in t.shape],
            "dtype": str(t.dtype).replace("torch.", ""),
            "shards": [{"rank": rank, "j": 0,
                        "slice": [[0, int(s)] for s in t.shape]}]}
        local[name] = [(0, t)]
    return {"params": local, "opt_state": {}, "manifest": manifest,
            "optimizer": None, "rank": rank, "nprocs": 1}


def _block_layout(snapshot: Dict[str, torch.Tensor]) -> dict:
    """``meta.json``'s layout of a one-process Block: world size 1 and
    every parameter replicated (an empty spec)."""
    return {"world_size": 1, "specs": {name: [] for name in snapshot}}


class AsyncCheckpointer:
    """Write training state every ``save_every`` steps without blocking.

    Usage::

        ckpt = AsyncCheckpointer(dir, save_every=100, keep=2)
        start = checkpoint.restore(dir, net, trainer)  # 0 if none yet
        for batch in loader:
            ...train...
            ckpt.step(net, trainer=trainer)
        ckpt.close()

    ``params`` is a Gluon Block (structural names), a dict of
    Parameters, or a ``DataParallelStep`` (its parameters, optimizer slots
    and layout).  A new checkpointer on a non-empty directory continues
    the step numbering from the newest step on disk; ``initial_step``
    overrides it (and drops the step directories above it).
    ``writer=False`` makes this process a non-writing member of a group
    sharing one directory: it counts steps and runs the hooks, and in
    format 2 persists its own shards without publishing.  ``sharded``
    (default ``MX_CKPT_SHARDED``) selects format 2.
    """

    def __init__(self, directory: str, save_every: int = 100, keep: int = 2,
                 initial_step: Optional[int] = None, writer: bool = True,
                 sharded: Optional[bool] = None):
        if save_every < 1:
            raise MXNetError("save_every must be >= 1")
        self.dir = directory
        self.save_every = save_every
        self.keep = keep
        self.writer = bool(writer)
        self.sharded = (_env_sharded_default() if sharded is None
                        else bool(sharded))
        os.makedirs(directory, exist_ok=True)
        if initial_step is None:
            # continue numbering from the newest step on disk; a torn
            # `latest` must not reset numbering to 0
            candidates = _candidate_steps(directory)
            initial_step = candidates[0] if candidates else 0
        elif self.writer:
            # explicit resume step: step dirs ABOVE it are an abandoned
            # timeline that would poison rotation and resume
            for s in _candidate_steps(directory):
                if s > initial_step:
                    shutil.rmtree(os.path.join(directory, f"step-{s}"),
                                  ignore_errors=True)
            latest = os.path.join(directory, "latest")
            try:
                with open(latest) as f:
                    if int(f.read().strip()) > initial_step:
                        os.remove(latest)
            except (OSError, ValueError):
                pass
        self._step = int(initial_step)
        if self.writer:
            # garbage-collect staging leftovers a crashed writer left
            for d in os.listdir(directory):
                if d.startswith(".tmp-"):
                    shutil.rmtree(os.path.join(directory, d),
                                  ignore_errors=True)
                elif d.startswith(".latest.tmp"):
                    try:
                        os.remove(os.path.join(directory, d))
                    except OSError:
                        pass
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._closed = False
        # queued host snapshots are the "checkpoint" census category
        memwatch.register("checkpoint", self, _queued_snapshot_arrays)
        self._writer = None
        if self.writer or self.sharded:
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._writer.start()

    # ------------------------------------------------------------------
    def step(self, params, trainer=None, extra: Optional[dict] = None) -> bool:
        """Count one training step; snapshot and enqueue a write when
        due.  Returns True when a checkpoint was enqueued."""
        if self._error is not None:
            raise MXNetError(f"checkpoint writer failed: {self._error}")
        self._step += 1
        # chaos harness: `crash:step=N` dies HERE, before step N's
        # checkpoint can be enqueued
        fault.on_train_step(self._step)
        telemetry.heartbeat(self._step)
        memwatch.on_step(self._step)
        if self._step % self.save_every != 0:
            return False
        if not self.writer and not self.sharded:
            return False
        # bounded queue: blocks if two writes are already in flight
        self._queue.put(self._snap(params, trainer, extra))
        return True

    def wait(self) -> None:
        """Block until all enqueued checkpoints are on disk."""
        if self._writer is None:
            return
        self._queue.join()
        if self._error is not None:
            raise MXNetError(f"checkpoint writer failed: {self._error}")

    def close(self) -> None:
        """Flush pending writes and stop the writer thread (always joined;
        a writer error is re-raised after)."""
        if self._closed:
            if self._error is not None:
                raise MXNetError(f"checkpoint writer failed: {self._error}")
            return
        self._closed = True
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._queue.put(None)
                self._writer.join()

    def save_now(self, params, trainer=None, extra: Optional[dict] = None,
                 drain_timeout: float = 5.0) -> int:
        """Synchronously checkpoint the CURRENT step on the calling thread
        (the preemption path: ``fault.install_preemption_handler`` calls
        this from the SIGTERM handler, then exits).  Returns the step
        written, 0 when no step has been taken yet.

        It runs inside a signal handler, so it never takes the queue's
        lock: in-flight writes are drained by a bounded poll of
        ``unfinished_tasks``; the staging directories are thread-unique."""
        if self._step == 0:
            return 0
        if not self.writer and not self.sharded:
            return 0
        snap = self._snap(params, trainer, extra)
        if "sharded" in snap:
            # a SIGTERM handler cannot sit out the full peer-marker wait
            snap["wait_s"] = 2.0
        deadline = time.monotonic() + drain_timeout
        while self._queue.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        if self._queue.unfinished_tasks and self._step % self.save_every == 0:
            # the writer is still persisting THIS very step
            return 0
        self._write(snap)
        return self._step

    # ------------------------------------------------------------------
    def _snap(self, params, trainer, extra) -> dict:
        """The writer's work item: host params (format 1) or this rank's
        shard state (format 2), a step's optimizer slots and layout,
        trainer states, the RNG states."""
        snap = {
            "step": self._step,
            "trainer": (self._trainer_states(trainer)
                        if trainer is not None and self.writer else None),
            "rng": _rng_state(),
            "extra": extra or {},
        }
        if _is_step_target(params):
            layout = params.layout()
            if self.sharded:
                state = params.shard_state_dict()
                snap["sharded"] = state
            else:
                state = params.state_dict()
                snap["params"] = state["params"]
                snap["opt"] = state.get("opt_state")
            layout["optimizer"] = state.get("optimizer")
            snap["layout"] = layout
            return snap
        host = _snapshot_params(params)
        if self.sharded:
            snap["sharded"] = _block_shard_state(host, telemetry.rank())
            snap["layout"] = _block_layout(host)
        else:
            snap["params"] = host
        return snap

    @staticmethod
    def _trainer_states(trainer) -> bytes:
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        if trainer._update_on_kvstore:
            updater = trainer._kvstore._updater
        else:
            updater = trainer._updaters[0]
        return updater.get_states(dump_optimizer=False)

    def _writer_loop(self):
        while True:
            snap = self._queue.get()
            if snap is None:
                self._queue.task_done()
                return
            try:
                self._write(snap)
            except BaseException as e:  # surfaced on the next step()/wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, snap):
        # the span runs on the writer thread (its own trace track)
        with telemetry.span("checkpoint_save", paired=True,
                            step=snap["step"]):
            self._write_impl(snap)
        # sample while the snapshot buffers are still resident
        memwatch.on_checkpoint("save", snap["step"])

    def _write_impl(self, snap):
        if "sharded" in snap:
            return self._write_sharded_impl(snap)
        from .ndarray import utils as nd_utils

        step = snap["step"]
        t0 = time.perf_counter()
        fault.on_write_begin(step)
        # thread-unique staging dir: save_now (signal handler) may race
        # the writer thread on the SAME step
        tmp = os.path.join(self.dir,
                           f".tmp-{step}-{threading.get_ident()}")
        final = os.path.join(self.dir, f"step-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        digests = {}
        nd_utils.save(os.path.join(tmp, "params.nd"), snap["params"])
        digests["params.nd"] = _sha256_file(os.path.join(tmp, "params.nd"))
        if snap.get("opt") is not None:
            # a step target's optimizer slots, host copies like the params
            nd_utils.save(os.path.join(tmp, "opt_state.nd"), snap["opt"])
            digests["opt_state.nd"] = _sha256_file(
                os.path.join(tmp, "opt_state.nd"))
        if snap["trainer"] is not None:
            with open(os.path.join(tmp, "trainer.states"), "wb") as f:
                f.write(snap["trainer"])
            digests["trainer.states"] = _sha256_file(
                os.path.join(tmp, "trainer.states"))
        fault.on_write_mid(step)
        # meta.json is written LAST and carries the payload digests: a
        # parseable meta whose digests verify is a valid checkpoint
        meta = {"step": step, "rng": None, "torch_rng": snap["rng"],
                "extra": snap["extra"], "digests": digests}
        if snap.get("layout") is not None:
            meta["layout"] = snap["layout"]
            meta["world_size"] = snap["layout"].get("world_size")
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._publish(step, tmp, final)
        if telemetry.enabled():
            try:
                nbytes = sum(os.path.getsize(os.path.join(final, f))
                             for f in os.listdir(final))
            except OSError:
                nbytes = 0
            telemetry.record_checkpoint(
                "save", step=step, wall_s=time.perf_counter() - t0,
                nbytes=nbytes)
        fault.on_write_published(step, final)

    def _publish(self, step, tmp, final):
        """Atomically publish a complete staging dir and rotate."""
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        latest_tmp = os.path.join(
            self.dir, f".latest.tmp-{threading.get_ident()}")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(self.dir, "latest"))
        # rotate.  An off-cycle step (a save_now preemption checkpoint)
        # never evicts a scheduled save_every multiple, and is kept only
        # until the next scheduled checkpoint supersedes it.
        steps = sorted(
            int(d.split("-")[1]) for d in os.listdir(self.dir)
            if d.startswith("step-"))
        scheduled = [s for s in steps if s % self.save_every == 0]
        extra = [s for s in steps if s % self.save_every != 0]
        drop = scheduled[: -self.keep]
        drop += extra[:-1]
        if extra and scheduled and extra[-1] < scheduled[-1]:
            drop.append(extra[-1])
        for old in drop:
            shutil.rmtree(os.path.join(self.dir, f"step-{old}"),
                          ignore_errors=True)

    def _write_sharded_impl(self, snap):
        """Format-2 write: this rank persists the shards it owns into the
        group's fixed-name staging dir and commits them with an atomic
        ``shard-R.json`` digest marker; the leader (``writer=True``) waits
        for peer markers, writes ``meta.json`` (format, manifest, layout)
        and publishes."""
        from .ndarray import utils as nd_utils

        step = snap["step"]
        state = snap["sharded"]
        rank = int(state["rank"])
        t0 = time.perf_counter()
        fault.on_write_begin(step)
        tmp = os.path.join(self.dir, f".tmp-{step}-shard")
        final = os.path.join(self.dir, f"step-{step}")
        os.makedirs(tmp, exist_ok=True)
        digests = {}

        def dump(fname, section):
            arrs = {f"{sname}#{j}": a for sname, payloads in section.items()
                    for j, a in payloads}
            if not arrs:
                return
            path = os.path.join(tmp, fname)
            nd_utils.save(path, arrs)
            digests[fname] = _sha256_file(path)

        dump(f"params-shard-{rank}.nd", state["params"])
        dump(f"optstate-shard-{rank}.nd", state["opt_state"])
        nbytes_local = sum(
            os.path.getsize(os.path.join(tmp, f)) for f in digests)
        marker = {"rank": rank, "step": step, "digests": digests}
        mpath = os.path.join(tmp, f"shard-{rank}.json")
        mtmp = f"{mpath}.tmp-{threading.get_ident()}"
        with open(mtmp, "w") as f:
            json.dump(marker, f)
        os.replace(mtmp, mpath)
        if not self.writer:
            if telemetry.enabled():
                telemetry.record_checkpoint(
                    "save", step=step, wall_s=time.perf_counter() - t0,
                    nbytes=nbytes_local, sharded=True, rank=rank)
            return
        meta_digests = {}
        if snap["trainer"] is not None:
            with open(os.path.join(tmp, "trainer.states"), "wb") as f:
                f.write(snap["trainer"])
            meta_digests["trainer.states"] = _sha256_file(
                os.path.join(tmp, "trainer.states"))
        fault.on_write_mid(step)
        manifest = state["manifest"]
        peers = _manifest_ranks(manifest) - {rank}
        deadline = time.monotonic() + snap.get("wait_s", _shard_wait_s())
        missing = []
        while True:
            missing = [r for r in sorted(peers) if not os.path.exists(
                os.path.join(tmp, f"shard-{r}.json"))]
            if not missing or time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        if missing:
            _LOG.warning(
                "sharded checkpoint step %d: no commit marker from "
                "rank(s) %s within the wait window — publishing anyway "
                "(the step will fail validation and restore falls back)",
                step, missing)
        meta = {"step": step, "format": 2, "rng": None,
                "torch_rng": snap["rng"], "extra": snap["extra"],
                "digests": meta_digests, "manifest": manifest,
                "layout": snap["layout"],
                "world_size": snap["layout"].get("world_size")}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._publish(step, tmp, final)
        if telemetry.enabled():
            try:
                total = sum(os.path.getsize(os.path.join(final, f))
                            for f in os.listdir(final))
            except OSError:
                total = 0
            telemetry.record_checkpoint(
                "save", step=step, wall_s=time.perf_counter() - t0,
                nbytes=nbytes_local, sharded=True, rank=rank,
                total_nbytes=total)
        fault.on_write_published(step, final)


def _rng_state() -> dict:
    """torch's generator states as hex strings: the CPU's, and each
    card's once the card is in use."""
    out = {"cpu": torch.get_rng_state().numpy().tobytes().hex()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["cuda"] = [s.numpy().tobytes().hex()
                       for s in torch.cuda.get_rng_state_all()]
    return out


def _set_rng_state(state) -> None:
    def tensor(h):
        return torch.from_numpy(np.frombuffer(bytes.fromhex(h),
                                              np.uint8).copy())

    if not isinstance(state, dict) or "cpu" not in state:
        return
    torch.set_rng_state(tensor(state["cpu"]))
    cuda = state.get("cuda")
    if cuda and torch.cuda.is_available() \
            and len(cuda) == torch.cuda.device_count():
        torch.cuda.set_rng_state_all([tensor(h) for h in cuda])


def _queued_snapshot_arrays(ckpt):
    """memwatch provider: host param copies waiting on the writer queue
    (numpy views: the checkpoint category's host bytes)."""
    out = []
    try:
        items = list(ckpt._queue.queue)
    except Exception:
        return out
    for snap in items:
        if isinstance(snap, dict):
            out.extend(_host_view(t) for t in snap.get("params", {}).values())
            out.extend(_host_view(t)
                       for t in (snap.get("opt") or {}).values())
            sharded = snap.get("sharded")
            if sharded:
                for section in ("params", "opt_state"):
                    for payloads in sharded.get(section, {}).values():
                        out.extend(_host_view(a) for _, a in payloads)
    return out


def _manifest_ranks(manifest: dict) -> set:
    """Every rank the manifest says owns at least one shard."""
    ranks = set()
    for section in ("params", "opt_state"):
        for ent in (manifest.get(section) or {}).values():
            for sh in ent.get("shards", []):
                ranks.add(int(sh["rank"]))
    return ranks


class _ShardReader:
    """Per-rank shard-file cache over one format-2 checkpoint dir: loads
    each ``params-shard-R.nd`` / ``optstate-shard-R.nd`` at most once, and
    only when a :class:`_LazyShardedArray` reads a slice it covers."""

    _PREFIX = {"params": "params-shard", "opt_state": "optstate-shard"}

    def __init__(self, directory: str, meta: dict):
        self.dir = directory
        self.manifest = meta.get("manifest") or {}
        self._files: Dict[tuple, dict] = {}

    def rank_file(self, section: str, rank: int) -> dict:
        key = (section, rank)
        if key not in self._files:
            from .ndarray import utils as nd_utils

            self._files[key] = nd_utils.load(os.path.join(
                self.dir, f"{self._PREFIX[section]}-{rank}.nd"))
        return self._files[key]

    def section(self, section: str) -> dict:
        return {name: _LazyShardedArray(self, section, name, ent)
                for name, ent in (self.manifest.get(section) or {}).items()}


class _LazyShardedArray:
    """One logical array of a shard-granular checkpoint, readable by
    global slice without composing the full value (``read_slice`` copies
    only the manifest shards that intersect the request).  ``tensor()``
    composes the whole array as a CPU tensor in its own dtype;
    ``asnumpy()`` as an NDArray's ``asnumpy`` would give it."""

    def __init__(self, reader: _ShardReader, section: str, name: str,
                 ent: dict):
        from .ndarray.ndarray import dtype_torch

        self._reader = reader
        self._section = section
        self.name = name
        self.shape = tuple(int(s) for s in ent["shape"])
        self.dtype = dtype_torch(ent["dtype"])
        self._shards = ent["shards"]

    def read_slice(self, idx) -> torch.Tensor:
        want = []
        for dim, s in enumerate(idx):
            start = 0 if s.start is None else int(s.start)
            stop = (self.shape[dim] if s.stop is None else int(s.stop))
            want.append((start, stop))
        out = torch.empty(tuple(b - a for a, b in want), dtype=self.dtype)
        for sh in self._shards:
            src = [tuple(int(x) for x in p) for p in sh["slice"]]
            inter = [(max(a, c), min(b, d))
                     for (a, b), (c, d) in zip(want, src)]
            if any(a >= b for a, b in inter):
                continue
            data = self._reader.rank_file(self._section, int(sh["rank"]))[
                f"{self.name}#{int(sh['j'])}"]._data
            dst = tuple(slice(a - w, b - w)
                        for (a, b), (w, _) in zip(inter, want))
            sel = tuple(slice(a - s0, b - s0)
                        for (a, b), (s0, _) in zip(inter, src))
            out[dst] = data[sel]
        return out

    def tensor(self) -> torch.Tensor:
        return self.read_slice(tuple(slice(0, s) for s in self.shape))

    def asnumpy(self) -> np.ndarray:
        t = self.tensor()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensor_of(value) -> torch.Tensor:
    """The CPU tensor of a loaded array (an NDArray or a lazy shard view)."""
    if isinstance(value, _LazyShardedArray):
        return value.tensor()
    return value._data


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _candidate_steps(directory: str) -> List[int]:
    """Step numbers worth trying, newest first: the `latest` pointer
    (when readable) plus every step-* dir."""
    steps = set()
    try:
        with open(os.path.join(directory, "latest")) as f:
            steps.add(int(f.read().strip()))
    except (OSError, ValueError):
        pass
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for dname in names:
        if dname.startswith("step-"):
            try:
                steps.add(int(dname.split("-", 1)[1]))
            except ValueError:
                pass
    return sorted(steps, reverse=True)


def _read_meta_if_valid(d: str):
    """Parsed meta.json iff the checkpoint dir is complete and every
    recorded digest verifies; None for any torn/corrupt/missing shape."""
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict) or "step" not in meta:
        return None
    if int(meta.get("format", 1)) >= 2:
        return meta if _shard_files_valid(d, meta) else None
    digests = meta.get("digests")
    if digests is None:
        # pre-digest checkpoint (older layout): existence check only
        return meta if os.path.exists(os.path.join(d, "params.nd")) else None
    for fname, want in digests.items():
        try:
            if _sha256_file(os.path.join(d, fname)) != want:
                return None
        except OSError:
            return None
    return meta


def _shard_files_valid(d: str, meta: dict) -> bool:
    """Format-2 validity: every meta-level digest verifies, every
    shard-owning rank's marker parses and its digests verify, and each
    rank the manifest assigns shards to committed the shard file."""
    for fname, want in (meta.get("digests") or {}).items():
        try:
            if _sha256_file(os.path.join(d, fname)) != want:
                return False
        except OSError:
            return False
    manifest = meta.get("manifest") or {}
    for r in sorted(_manifest_ranks(manifest)):
        try:
            with open(os.path.join(d, f"shard-{r}.json")) as f:
                marker = json.load(f)
        except (OSError, ValueError):
            return False
        digests = marker.get("digests") or {}
        for section, prefix in (("params", "params-shard"),
                                ("opt_state", "optstate-shard")):
            owns = any(
                any(int(sh["rank"]) == r for sh in ent.get("shards", []))
                for ent in (manifest.get(section) or {}).values())
            if owns and f"{prefix}-{r}.nd" not in digests:
                return False
        for fname, want in digests.items():
            try:
                if _sha256_file(os.path.join(d, fname)) != want:
                    return False
            except OSError:
                return False
    return True


def latest_valid_step(directory: str,
                      multiple_of: Optional[int] = None) -> int:
    """Newest step whose checkpoint verifies; 0 when none does.  With
    ``multiple_of=save_every`` only scheduled steps count."""
    for s in _candidate_steps(directory):
        if multiple_of and s % multiple_of != 0:
            continue
        d = os.path.join(directory, f"step-{s}")
        if _read_meta_if_valid(d) is not None:
            return s
    return 0


def agree_resume_step(local_step: int, kv=None) -> int:
    """The group's common resume step: the minimum over the ranks' local
    steps.  The port's kvstore has one worker (ROADMAP A.9), so this is
    ``local_step``; a store of more workers raises."""
    if kv is not None and getattr(kv, "num_workers", 1) > 1:
        raise MXNetError("agree_resume_step over more than one worker "
                         "needs a distributed kvstore (ROADMAP A.9)")
    return int(local_step)


def load_checkpoint_state(directory: str, step: Optional[int] = None):
    """Load the newest VALID checkpoint: dict(step, params (name ->
    NDArray on the CPU, or a lazy shard view for format 2), opt_state
    (or None), trainer (bytes or None), extra, layout) — or None when no
    valid one exists.  Restores torch's generator states when the
    checkpoint recorded them.  A torn, mismatched or undecodable step is
    skipped (with a warning) for the next-newest; with ``step=N`` the
    exact step is demanded and an invalid one raises."""
    with telemetry.span("checkpoint_load", paired=True):
        state = _load_checkpoint_state(directory, step)
    memwatch.on_checkpoint("load", state["step"] if state else 0)
    return state


def _load_checkpoint_state(directory: str, step: Optional[int] = None):
    from .ndarray import utils as nd_utils

    explicit = step is not None
    t0 = time.perf_counter()
    candidates = [int(step)] if explicit else _candidate_steps(directory)
    for s in candidates:
        d = os.path.join(directory, f"step-{s}")
        meta = _read_meta_if_valid(d)
        if meta is None:
            if explicit:
                raise MXNetError(
                    f"checkpoint step {s} in {directory} is missing or "
                    "corrupt (demanded via step=)")
            _LOG.warning("checkpoint %s is torn/corrupt; falling back to "
                         "the next-newest step", d)
            telemetry.record_checkpoint("fallback", step=s,
                                        reason="digest-or-meta")
            continue
        trainer_states = None
        tpath = os.path.join(d, "trainer.states")
        sharded = int(meta.get("format", 1)) >= 2
        if sharded:
            reader = _ShardReader(d, meta)
            params = reader.section("params")
            opt_state = reader.section("opt_state") or None
        else:
            try:
                params = nd_utils.load(os.path.join(d, "params.nd"))
                opath = os.path.join(d, "opt_state.nd")
                opt_state = (nd_utils.load(opath) if os.path.exists(opath)
                             else None)
            except Exception as e:  # undecodable payload
                if explicit:
                    raise MXNetError(
                        f"checkpoint step {s} in {directory} failed to "
                        f"load: {e}") from e
                _LOG.warning("checkpoint %s failed to load (%s); falling "
                             "back", d, e)
                telemetry.record_checkpoint("fallback", step=s,
                                            reason="payload-decode")
                continue
        if os.path.exists(tpath):
            with open(tpath, "rb") as f:
                trainer_states = f.read()
        _set_rng_state(meta.get("torch_rng"))
        telemetry.record_checkpoint(
            "load", step=s, wall_s=time.perf_counter() - t0,
            **({"sharded": True} if sharded else {}))
        return {"step": s, "params": params, "opt_state": opt_state,
                "trainer": trainer_states, "extra": meta.get("extra", {}),
                "layout": meta.get("layout")}
    return None


def restore(directory: str, net, trainer=None,
            step: Optional[int] = None) -> int:
    """Apply the newest valid checkpoint (or exactly ``step=N``) to
    ``net`` (structural names) and ``trainer``.  Returns the restored
    step (0 when no valid checkpoint exists).  ``net`` may be a
    ``DataParallelStep``: its parameters and optimizer slots go through
    its ``load_state_dict`` with the saved layout."""
    state = load_checkpoint_state(directory, step=step)
    if state is None:
        return 0
    if _is_step_target(net):
        net.load_state_dict({"params": state["params"],
                             "opt_state": state["opt_state"] or {}},
                            saved_layout=state.get("layout"))
        return state["step"]
    for name, p in _params_of(net).items():
        if name not in state["params"]:
            raise MXNetError(f"checkpoint missing parameter {name}")
        p.set_data(_tensor_of(state["params"][name]))
    if trainer is not None and state["trainer"] is not None:
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        updaters = (trainer._updaters if not trainer._update_on_kvstore
                    else [trainer._kvstore._updater])
        for upd in updaters or []:
            upd.set_states(state["trainer"])
            upd.optimizer = trainer._optimizer
    return state["step"]
