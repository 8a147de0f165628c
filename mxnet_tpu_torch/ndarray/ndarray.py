"""NDArray: the imperative n-dimensional array, over a torch tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An NDArray owns a torch
tensor on one device (its ``context``, a ``Context`` equal to the tensor's
``torch.device``).  Mutation (``copyto`` into an array, ``out=``) swaps
the tensor in, as the JAX package swaps its immutable buffers, and bumps
``version``.  Arithmetic and methods go through the op registry, so they
are recorded by ``autograd`` and seen by the pass pipeline like any op.

``wait_to_read`` and ``asnumpy`` block on the device, like MXNet's
engine waits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "dtype_torch"]

_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.int8: np.int8,
                torch.uint8: np.uint8, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.bool: np.bool_}


def dtype_torch(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    np_dt = np.dtype(dtype).type
    for t, n in _NP_OF_TORCH.items():
        if n is np_dt:
            return t
    raise MXNetError(f"no torch dtype for {dtype!r}")


class NDArray:
    __slots__ = ("_data", "_ctx", "_version", "_grad", "_grad_req",
                 "_mxctx", "__weakref__")

    # numpy should defer to our reflected dunders
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor, ctx=None):
        self._data = data
        self._ctx = (data.device if ctx is None
                     else ctx if type(ctx) is torch.device
                     else resolve_device(ctx))
        # the Context it was placed on: cpu(1) and cpu(0) share the one
        # torch CPU device but stay distinct contexts (a device list)
        self._mxctx = ctx if isinstance(ctx, Context) else None
        self._version = 0
        self._grad = None
        self._grad_req = "write"

    # ------------------------------------------------------------------
    # core properties
    # ------------------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy scalar type (``np.float32``, ...), as MXNet's;
        ``"bfloat16"`` for bf16, which numpy lacks."""
        return _NP_OF_TORCH.get(self._data.dtype, str(self._data.dtype)
                                .replace("torch.", ""))

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        tagged = getattr(self, "_mxctx", None)
        if tagged is not None and tagged.device == self._data.device:
            return tagged
        return Context.from_device(self._ctx)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def version(self) -> int:
        """How many times the array's contents were swapped or written."""
        return self._version

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")

    def _set_data(self, new: torch.Tensor) -> None:
        """Swap in a new tensor; an array with a gradient buffer stays a
        leaf that requires grad."""
        if self._grad is not None:
            new = new.detach().requires_grad_(True)
        self._data = new
        self._version += 1

    # ------------------------------------------------------------------
    # host transfer / sync
    # ------------------------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """Blocking copy to host (a copy on the CPU too: the array's later
        updates do not show in it).  numpy has no bfloat16 (the JAX package
        returns ``ml_dtypes.bfloat16``, which the port does not import), so
        a bfloat16 array comes back as float32, every value exact."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy() if t.device.type == "cpu" else \
            t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def wait_to_read(self) -> None:
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def wait_to_write(self) -> None:
        self.wait_to_read()

    # ------------------------------------------------------------------
    # device movement
    # ------------------------------------------------------------------
    def copyto(self, other) -> "NDArray":
        """A copy on device ``other``, or into the NDArray ``other``."""
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._ctx, copy=True))
            return other
        dev = resolve_device(other)
        return NDArray(self._data.detach().to(dev, copy=True), ctx=dev)

    def as_in_context(self, ctx) -> "NDArray":
        dev = resolve_device(ctx)
        if dev == self._ctx and (not isinstance(ctx, Context)
                                 or ctx == self.context):
            return self
        return NDArray(self._data.detach().to(dev),
                       ctx=ctx if isinstance(ctx, Context) else dev)

    as_in_ctx = as_in_context

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write",
                    stype: Optional[str] = None) -> None:
        """Give this array a zero gradient buffer filled by
        ``autograd.backward``; ``grad_req`` is ``write``, ``add`` or
        ``null`` (no buffer)."""
        from .. import autograd

        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data), ctx=self._ctx)],
            grad_req)

    def detach(self) -> "NDArray":
        """The same data, outside gradient flow."""
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # arithmetic through the ops: an array operand goes to the
    # broadcast_* op, a Python scalar to the *_scalar op as an attribute
    # (the JAX package's NDArray keeps ``+`` and ``*`` on broadcast_*
    # with the scalar as a 0-d array; both round the same)
    # ------------------------------------------------------------------
    def _binary(self, other, opname):
        if isinstance(other, NDArray):
            return _reg.invoke_by_name(opname, [self, other])
        if isinstance(other, (int, float, bool, np.generic)):
            scalar = NDArray(torch.tensor(other, dtype=self._data.dtype,
                                          device=self._ctx), ctx=self._ctx)
            return _reg.invoke_by_name(opname, [self, scalar])
        return NotImplemented

    def _scalar_op(self, other, opname, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _reg.invoke_by_name(opname, [a, b])
        if isinstance(other, (int, float, bool, np.generic)):
            return _reg.invoke_by_name(scalar_op, [self],
                                       scalar=float(other))
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "broadcast_add")

    __radd__ = __add__

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul")

    __rmul__ = __mul__

    def __sub__(self, other):
        return self._scalar_op(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._scalar_op(other, "broadcast_sub", "_rminus_scalar",
                               reverse=True)

    def __truediv__(self, other):
        return self._scalar_op(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._scalar_op(other, "broadcast_div", "_rdiv_scalar",
                               reverse=True)

    def __mod__(self, other):
        return self._scalar_op(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._scalar_op(other, "broadcast_mod", "_rmod_scalar",
                               reverse=True)

    def __pow__(self, other):
        return self._scalar_op(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._scalar_op(other, "broadcast_power", "_rpower_scalar",
                               reverse=True)

    def __neg__(self):
        return _reg.invoke_by_name("negative", [self])

    def __abs__(self):
        return _reg.invoke_by_name("abs", [self])

    def __gt__(self, other):
        return self._scalar_op(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._scalar_op(other, "broadcast_greater_equal",
                               "_greater_equal_scalar")

    def __lt__(self, other):
        return self._scalar_op(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._scalar_op(other, "broadcast_lesser_equal",
                               "_lesser_equal_scalar")

    # ------------------------------------------------------------------
    # indexing: a key of ints, slices, None, Ellipsis, lists or arrays
    # ------------------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(key), device=self._ctx).long()
        if isinstance(key, tuple):
            return tuple(self._key(k) for k in key)
        return key

    def __getitem__(self, key) -> "NDArray":
        k = self._key(key)
        return _reg.invoke_fn(lambda x: x[k], [self])

    def __setitem__(self, key, value) -> None:
        k = self._key(key)
        v = value._data if isinstance(value, NDArray) else value
        new = self._data.detach().clone()
        new[k] = torch.as_tensor(v, dtype=new.dtype, device=new.device)
        self._set_data(new)

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        return _reg.invoke_by_name("Cast", [self], dtype=str(
            dtype_torch(dtype)).replace("torch.", ""))

    def copy(self) -> "NDArray":
        return self.copyto(self._ctx)

    def tostype(self, stype: str) -> "NDArray":
        """``"default"`` is this array; ``"row_sparse"`` and ``"csr"``
        compress it on its device (``nd.sparse``)."""
        if stype == "default":
            return self
        from . import sparse as _sparse

        if stype == "row_sparse":
            return _sparse.row_sparse_array(self)
        if stype == "csr":
            return _sparse.csr_matrix(self)
        raise MXNetError(f"unknown storage type {stype!r}")

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    # op methods: any registered op is a method with ``self`` as its first
    # input, through the nd namespace's stubs
    # ------------------------------------------------------------------
    def __getattr__(self, name):
        import sys

        stub = sys.modules[__package__].__dict__.get(name)
        if stub is None or not callable(stub) or name.startswith("_"):
            raise AttributeError(
                f"'NDArray' object has no attribute {name!r}")
        nd = self

        def method(*args, **kwargs):
            return stub(nd, *args, **kwargs)

        method.__name__ = name
        return method

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _reg.invoke_by_name("reshape", [self], shape=tuple(shape),
                                   reverse=kwargs.get("reverse", False))

    def sum(self, axis=None, keepdims=False, **kw):
        return _reg.invoke_by_name("sum", [self], axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return _reg.invoke_by_name("mean", [self], axis=axis,
                                   keepdims=keepdims)


def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray from array-like ``source`` on ``ctx`` (default: the
    card, ``cuda:0``, raising without one; pass ``ctx=mx.cpu()`` for the
    CPU).  float64 sources become float32, as in MXNet."""
    dev = resolve_device(ctx)
    if isinstance(source, NDArray):
        src = source.asnumpy()
    elif isinstance(source, torch.Tensor):
        src = source.detach().cpu().numpy()
    else:
        src = np.asarray(source)
    if dtype is None:
        dtype = np.float32 if src.dtype == np.float64 else src.dtype
    t = torch.from_numpy(np.ascontiguousarray(src)).to(dtype_torch(dtype))
    return NDArray(t.to(dev), ctx=dev)
