"""Processes, the rendezvous and the flat-bucket all-reduce.

Counterpart of ``mxnet_tpu/parallel/dist.py``.  The port runs one process
per card through ``torch.distributed``: the rendezvous is
``init_process_group`` over a TCP store at the coordinator's address, and
the data plane is one collective of the process group per flat bucket.
The backend follows the device: ``nccl`` for a process on a card,
``gloo`` for one on the CPU, which only ``MX_FORCE_CPU=1`` (or
``force_cpu=True``) asks for.  There is no switch from one to the other:
a backend that fails to start raises.

Environment contract (both spellings are read, as in the JAX package, so
reference launch scripts work unchanged; ``tools/launch.py`` of this
package exports both):

  MX_COORDINATOR      / DMLC_PS_ROOT_URI + DMLC_PS_ROOT_PORT
  MX_NUM_PROCS        / DMLC_NUM_WORKER
  MX_PROC_ID          / DMLC_WORKER_ID
  MX_LOCAL_RANK       the card of this process (default: MX_PROC_ID)

The rendezvous retries with backoff (0.5 s doubling to 10 s) until
``MX_RENDEZVOUS_TIMEOUT`` seconds (default 300) have passed.
"""
from __future__ import annotations

import datetime
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["init_from_env", "init", "is_initialized", "allreduce_sum",
           "process_index", "process_count", "bucket_cap_bytes",
           "flatten_bucket", "unflatten_bucket", "device", "backend",
           "barrier", "shutdown", "local_rank"]

_LOG = logging.getLogger("mxnet_tpu_torch.dist")
_initialized = False
_device: Optional[torch.device] = None


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def _dist():
    import torch.distributed as dist

    return dist


def local_rank() -> int:
    """This process's card index on its host (``MX_LOCAL_RANK``, else the
    process id)."""
    return int(_env("MX_LOCAL_RANK", "MX_PROC_ID", "DMLC_WORKER_ID",
                    default="0"))


def init_from_env(force_cpu: Optional[bool] = None) -> bool:
    """Join the process group the launcher's environment describes.

    Returns True when more than one process runs after the call.
    Idempotent, and a group the caller already started counts as joined.
    Without the launcher's variables it does nothing and returns False."""
    global _initialized
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        _initialized = True
        return dist.get_world_size() > 1
    coord = _env("MX_COORDINATOR")
    if coord is None:
        uri = _env("DMLC_PS_ROOT_URI")
        port = _env("DMLC_PS_ROOT_PORT")
        coord = f"{uri}:{port}" if uri and port else None
    n = _env("MX_NUM_PROCS", "DMLC_NUM_WORKER")
    rank = _env("MX_PROC_ID", "DMLC_WORKER_ID")
    if coord is None or n is None or rank is None:
        return False  # one process
    if force_cpu is None:
        force_cpu = _env("MX_FORCE_CPU") == "1"
    init(coord, int(n), int(rank),
         device="cpu" if force_cpu else f"cuda:{local_rank()}")
    return dist.get_world_size() > 1


def init(coordinator: str, num_procs: int, proc_id: int,
         device=None) -> None:
    """Start this process's group: ``coordinator`` is ``host:port`` (rank
    0 serves the store there), ``device`` the process's device (a card by
    default, ``cuda:<local rank>``); the backend is ``nccl`` on a card and
    ``gloo`` on the CPU."""
    global _initialized, _device
    dist = _dist()
    dev = torch.device(device if device is not None
                       else f"cuda:{local_rank()}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"the process group wants {dev} but no CUDA device is "
                "available; set MX_FORCE_CPU=1 to run the group on the CPU "
                "(gloo)")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        backend_name = "nccl"
    elif dev.type == "cpu":
        backend_name = "gloo"
    else:
        raise MXNetError(f"no process-group backend for device {dev}")
    _initialize_with_retry(coordinator, int(num_procs), int(proc_id),
                           backend_name, dev)
    _device = dev
    _initialized = True


def _initialize_with_retry(coord: str, n: int, rank: int, backend_name: str,
                           dev: torch.device) -> None:
    """``init_process_group`` with exponential-backoff retries up to
    ``MX_RENDEZVOUS_TIMEOUT`` seconds: a rank may dial before rank 0's
    store listens, or find its port in TIME_WAIT after a restart."""
    from .. import fault, telemetry

    dist = _dist()
    timeout = float(_env("MX_RENDEZVOUS_TIMEOUT", default="300"))
    deadline = time.monotonic() + timeout
    delay = 0.5
    retries = 0
    kw = {"device_id": dev} if backend_name == "nccl" else {}
    while True:
        try:
            fault.on_rendezvous()
            dist.init_process_group(
                backend_name, init_method=f"tcp://{coord}", world_size=n,
                rank=rank, timeout=datetime.timedelta(
                    seconds=max(10.0, deadline - time.monotonic())), **kw)
            telemetry.record("rendezvous", coordinator=coord, nproc=n,
                             retries=retries, backend=backend_name)
            _record_resize(n)
            return
        except (TypeError, ValueError):
            raise  # misconfiguration: fail fast, no retry
        except Exception as e:
            if dist.is_initialized():
                dist.destroy_process_group()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise MXNetError(
                    f"rendezvous with coordinator {coord} (rank {rank}/{n}, "
                    f"{backend_name}) failed after {timeout:.0f}s — set "
                    f"MX_RENDEZVOUS_TIMEOUT to extend; last error: {e}") from e
            _LOG.warning("rendezvous with %s failed (%s); retrying for "
                         "another %.0fs", coord, e, remaining)
            retries += 1
            telemetry.record("rendezvous_retry", coordinator=coord,
                             retries=retries, error=str(e)[:200])
            time.sleep(min(delay, remaining))
            delay = min(delay * 2, 10.0)


def _record_resize(n: int) -> None:
    """A ``resize`` telemetry event when the launcher says the world size
    changed (``MX_PREV_NUM_PROCS``, exported by ``tools/launch.py
    --elastic`` to the first incarnation after a resize), as the JAX
    package records it; the restore that follows reshards the checkpoint
    (``DataParallelStep.load_state_dict``) and records none."""
    from .. import telemetry

    prev = _env("MX_PREV_NUM_PROCS")
    try:
        prev_n = int(prev) if prev else None
    except ValueError:
        return
    if prev_n is not None and prev_n != n:
        telemetry.record(
            "resize", old_world=prev_n, new_world=n,
            restart=int(_env("MX_RESTART_COUNT", default="0") or 0))


def is_initialized() -> bool:
    dist = _dist()
    return bool(dist.is_available() and dist.is_initialized())


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """``nccl``, ``gloo`` or None before the rendezvous."""
    return str(_dist().get_backend()) if is_initialized() else None


def device() -> torch.device:
    """This process's device: the card the rendezvous bound, the CPU for a
    gloo group, else the default device."""
    if _device is not None:
        return _device
    if is_initialized() and backend() == "gloo":
        return torch.device("cpu")
    from ..context import default_device

    return default_device()


def barrier(group=None) -> None:
    """Block until every process of ``group`` (default: all) is here."""
    if is_initialized() and process_count() > 1:
        _dist().barrier(group=group)


def shutdown() -> None:
    global _initialized, _device
    if is_initialized():
        _dist().destroy_process_group()
    _initialized = False
    _device = None


# ---------------------------------------------------------------------------
# gradient bucketing
# ---------------------------------------------------------------------------
_BUCKET_MB_DEFAULT = 32.0


def bucket_cap_bytes() -> int:
    """Gradient-allreduce bucket cap in bytes (``MX_ALLREDUCE_BUCKET_MB``,
    default 32 MB).  0 (or any non-positive or garbled value) disables
    bucketing: one collective a key."""
    raw = os.environ.get("MX_ALLREDUCE_BUCKET_MB")
    try:
        mb = float(raw) if raw is not None else _BUCKET_MB_DEFAULT
    except (TypeError, ValueError):
        return 0
    return int(mb * (1 << 20)) if mb > 0 else 0


def flatten_bucket(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Same-dtype tensors as one flat buffer (one ``cat``)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_bucket(flat: torch.Tensor,
                     shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """Views of ``flat`` in the given shapes, in order."""
    sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
    return [p.view(tuple(s)) for p, s in
            zip(torch.split(flat, sizes), shapes)]


def buckets(tensors: Sequence[torch.Tensor], cap: Optional[int] = None
            ) -> List[List[int]]:
    """Indices of ``tensors`` grouped into buckets of one dtype and at most
    ``cap`` bytes (a tensor larger than the cap is a bucket of its own);
    ``cap`` 0 puts each tensor in its own bucket."""
    cap = bucket_cap_bytes() if cap is None else cap
    out: List[List[int]] = []
    open_: dict = {}
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        cur = open_.get(t.dtype)
        if cur is None or cap <= 0 or (cur[1] and cur[1] + nbytes > cap):
            cur = open_[t.dtype] = [[], 0]
            out.append(cur[0])
        cur[0].append(i)
        cur[1] += nbytes
    return out


def allreduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``group`` (default: all), as
    a new tensor on ``t``'s device; ``t`` itself when one process runs."""
    from .. import telemetry

    if not is_initialized():
        return t
    out = t.detach().clone()
    t0 = time.perf_counter()
    _dist().all_reduce(out, group=group)
    if telemetry.enabled():
        telemetry.record_collective("global_allreduce",
                                    nbytes=out.numel() * out.element_size(),
                                    wall_s=time.perf_counter() - t0,
                                    nproc=_dist().get_world_size(group))
    return out
