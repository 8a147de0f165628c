"""Devices.

The counterpart of ``mxnet_tpu/context.py`` (``Context``, ``cpu``,
``cpu_pinned``, ``gpu``, ``num_gpus``, ``current_context``, the ``with``
scope).  ``cpu()`` and ``gpu(i)`` return a :class:`Context`, which
compares by ``(device_type, device_id)`` and prints as ``cpu(0)`` /
``gpu(0)``, as the JAX one does.

A ``Context`` is also a ``str`` whose characters are the torch device it
names (``"cpu"``, ``"cuda:0"``), so torch takes it wherever it takes a
device (``tensor.to(ctx)``, ``device=ctx``, ``torch.device(ctx)``); it
compares equal to that ``torch.device``, hashes as it does (so either
finds the other's dict entries) and has its ``type`` and ``index``.  The
port's own code resolves every device through :func:`resolve_device`,
which takes a ``Context``, a ``torch.device``, a string, or None.

``default_device()`` is the scope's device inside ``with ctx:``, else
``cuda:0``, and raises when CUDA is unavailable: the port never drops to
the CPU on its own -- a caller that wants the CPU says ``device="cpu"``,
``ctx=mx.cpu()`` or ``with mx.cpu():``.  Outside a scope
``current_context()`` is ``gpu(0)`` (the JAX package's is ``cpu(0)``,
its default device); a ``gpu`` Context that names no card raises when it
is resolved.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "num_gpus",
           "current_context", "default_device", "resolve_device",
           "to_device", "normalize_memory_stats"]

_HOST_TYPES = ("cpu", "cpu_pinned", "cpu_shared")
_scope = threading.local()
_OF_DEVICE: dict = {}  # torch.device -> Context (NDArray.context)


class Context(str):
    """A device context; compares by ``(device_type, device_id)``."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __new__(cls, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in cls.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        device_id = int(device_id)
        name = ("cpu" if device_type in _HOST_TYPES
                else f"cuda:{device_id}")
        self = super().__new__(cls, name)
        self.device_type = device_type
        self.device_id = device_id
        return self

    def __getnewargs__(self):
        return (self.device_type, self.device_id)

    # -- identity ----------------------------------------------------------
    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_type == other.device_type
                    and self.device_id == other.device_id)
        if isinstance(other, torch.device):
            return torch.device(str.__str__(self)) == other
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        # the hash of the torch.device it equals, so either finds the
        # other's dict entries
        return hash(torch.device(str.__str__(self)))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __format__(self, spec):
        return format(repr(self), spec)

    # -- the torch device ---------------------------------------------------
    @property
    def type(self) -> str:
        return "cpu" if self.device_type in _HOST_TYPES else "cuda"

    @property
    def index(self):
        return None if self.device_type in _HOST_TYPES else self.device_id

    @property
    def device(self) -> torch.device:
        """The ``torch.device``; raises for a card that is not there."""
        if self.device_type in _HOST_TYPES:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self!r} requested but no CUDA device is available; "
                "pass ctx=mx.cpu() (or device=\"cpu\") to run on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self!r} out of range: {n} device(s) visible")
        return torch.device("cuda", self.device_id)

    @classmethod
    def from_device(cls, device) -> "Context":
        """The Context of a ``torch.device`` (``cuda:i`` is ``gpu(i)``);
        a device of another type (``meta``) is returned as it is."""
        ctx = _OF_DEVICE.get(device)
        if ctx is None:
            dev = torch.device(device)
            if dev.type == "cuda":
                ctx = cls("gpu", 0 if dev.index is None else dev.index)
            elif dev.type == "cpu":
                ctx = cls("cpu", 0)
            else:
                return dev
            _OF_DEVICE[device] = ctx
        return ctx

    # -- scope -------------------------------------------------------------
    def __enter__(self):
        stack = getattr(_scope, "stack", None)
        if stack is None:
            stack = _scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()
        return False

    def empty_cache(self) -> None:
        """Release the card's cached blocks (``torch.cuda.empty_cache``);
        nothing to do on the CPU."""
        if self.type == "cuda" and torch.cuda.is_available():
            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()

    def memory_stats(self) -> dict:
        """The card's allocator counters in the schema of
        :func:`normalize_memory_stats`; the CPU has none
        (``available=False``)."""
        if self.type != "cuda" or not torch.cuda.is_available():
            return normalize_memory_stats(None)
        dev = self.device
        free, total = torch.cuda.mem_get_info(dev)
        return normalize_memory_stats({
            "bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": total})


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _scoped():
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


def current_context() -> Context:
    """The innermost ``with`` scope's Context, else ``gpu(0)``."""
    ctx = _scoped()
    return gpu(0) if ctx is None else ctx


def default_device() -> torch.device:
    """The ``with`` scope's device, else the current CUDA device (``cuda:0``
    unless the process selected another: a process of a group runs on
    ``cuda:<local rank>``); raises when CUDA is unavailable."""
    ctx = _scoped()
    if ctx is not None:
        return ctx.device
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device=\"cpu\" to run on "
            "the CPU with the kernels' plain PyTorch versions")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` (a Context, a ``torch.device``, a string, or None for
    :func:`default_device`) as a ``torch.device``."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.device
    return torch.device(device)


def to_device(arr, device) -> torch.Tensor:
    """One copy of host (numpy) array ``arr`` onto ``device``: through
    pinned memory and without blocking on a CUDA device."""
    import numpy as np

    device = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def normalize_memory_stats(raw) -> dict:
    """The port's copy of ``mxnet_tpu.context.normalize_memory_stats``:
    an allocator-stats dict as ``{"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit", "available"}``.  Anything without ``bytes_in_use``
    (the CPU has no allocator stats) is ``available=False`` with zeroed
    counters."""
    if not isinstance(raw, dict) or "bytes_in_use" not in raw:
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0, "available": False}

    def _int(key, default=0):
        try:
            return int(raw.get(key, default))
        except (TypeError, ValueError):
            return default

    in_use = _int("bytes_in_use")
    return {"bytes_in_use": in_use,
            "peak_bytes_in_use": _int("peak_bytes_in_use", in_use),
            "bytes_limit": _int("bytes_limit"),
            "available": True}
