"""Sparse NDArray storage types: ``row_sparse`` and ``csr``.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference
``python/mxnet/ndarray/sparse.py``).  A sparse array is its component
tensors on the array's device: the values (``_data``) and ``indices``,
plus ``indptr`` for ``csr``.  Compute is gathers, ``index_add_``
segment sums and scatters on those components, never a dense product:

  * ``CSRNDArray.dot`` gathers the dense rows its column ids name, scales
    them by the values and sums them into their rows (``index_add_``);
    ``transpose_a`` sums them into the columns instead;
  * :func:`aggregate_rows` turns (ids, rows) pairs with repeats into
    sorted unique ids and summed rows (``torch.unique`` and
    ``index_add_``), with the true row count and no padding: it waits for
    that count, as the JAX one's ``np.unique`` does.  Autograd writes an
    ``Embedding(sparse_grad=True)`` gradient through it and the lazy
    optimizer updates read its rows;
  * ``row_sparse`` plus ``row_sparse`` (or minus) stays sparse; every
    other combination, and ``dot`` with a sparse right side, computes on
    the dense forms, as in the JAX package.

A dense array compresses on its own device (``tostype``); a scipy
matrix goes through ``array``.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .ndarray import NDArray, array as _dense_array, dtype_torch

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "array", "empty",
           "retain", "dot", "elemwise_add", "elemwise_sub", "elemwise_mul",
           "elemwise_div", "add", "subtract", "multiply", "divide",
           "zeros_like"]


class BaseSparseNDArray(NDArray):
    """What the compressed storage types share: the values are ``_data``,
    the index components ``_aux``, the logical shape ``_shape``."""

    __slots__ = ("_aux", "_shape")

    def __init__(self, data: torch.Tensor, aux: dict,
                 shape: Tuple[int, ...], ctx=None):
        super().__init__(data, ctx=ctx)
        self._aux = aux
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def size(self) -> int:
        return math.prod(self._shape)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def data(self) -> NDArray:
        """The values component."""
        return NDArray(self._data, ctx=self._ctx)

    def __repr__(self):
        return f"<{type(self).__name__} {self._shape} @{self._ctx}>"

    def asnumpy(self) -> np.ndarray:
        return self.todense().asnumpy()

    def astype(self, dtype, copy: bool = True) -> NDArray:
        return self.todense().astype(dtype)

    def todense(self) -> NDArray:
        raise NotImplementedError

    def tostype(self, stype: str):
        if stype == "default":
            return self.todense()
        if stype == self.stype:
            return self
        return self.todense().tostype(stype)

    def _moved(self, dev: torch.device):
        return type(self)(self._data.detach().to(dev, copy=True),
                          {k: v.to(dev, copy=True)
                           for k, v in self._aux.items()},
                          self._shape, ctx=dev)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self.todense()._data.to(other._ctx))
            return other
        return self._moved(resolve_device(other))

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        return self if dev == self._ctx else self._moved(dev)

    as_in_ctx = as_in_context

    def copy(self):
        return self._moved(self._ctx)

    def _set_data(self, new: torch.Tensor) -> None:
        """New values of the same shape (``clip_global_norm``'s scaling);
        a :class:`RowSparseNDArray` also takes a dense tensor of its
        logical shape, every row present."""
        if tuple(new.shape) != tuple(self._data.shape):
            raise MXNetError(f"{type(self).__name__}: values of shape "
                             f"{tuple(new.shape)} for components of "
                             f"{tuple(self._data.shape)}")
        self._data = new
        self._version += 1

    def __getitem__(self, key):
        return self.todense()[key]

    def __setitem__(self, key, value):
        raise MXNetError(f"{type(self).__name__} does not support item "
                         "assignment; convert with tostype('default')")


class RowSparseNDArray(BaseSparseNDArray):
    """Rows at ``indices`` hold the values; every other row is zero (the
    gradient type of a sparse ``Embedding``)."""

    __slots__ = ()

    @property
    def stype(self) -> str:
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"], ctx=self._ctx)

    def todense(self) -> NDArray:
        out = torch.zeros(self._shape, dtype=self._data.dtype,
                          device=self._data.device)
        out[self._aux["indices"]] = self._data
        return NDArray(out, ctx=self._ctx)

    def _set_data(self, new: torch.Tensor) -> None:
        if (tuple(new.shape) == self._shape
                and tuple(new.shape) != tuple(self._data.shape)):
            self._set_sparse_components(new, torch.arange(
                new.shape[0], device=new.device))
            return
        super()._set_data(new)

    def _set_sparse_components(self, values, indices) -> None:
        """Swap in (values, indices): autograd's write into a row-sparse
        gradient buffer."""
        self._data = values
        self._aux["indices"] = indices
        self._version += 1

    def _write_grad(self, g: torch.Tensor, add: bool) -> None:
        """Write a gradient into this buffer (``grad_req`` ``write``, or
        ``add`` merging with what it holds): a sparse COO gradient (torch's
        sparse ``embedding`` backward, uncoalesced) by its rows, summed
        per row; a dense one touches every row."""
        if g.layout == torch.sparse_coo:
            ids, vals = g._indices()[0], g._values()
            ids, vals = aggregate_rows(ids, vals)
        else:
            ids = torch.arange(g.shape[0], device=g.device)
            vals = g
        vals = vals.to(self._data.dtype)
        if add and self._data.shape[0]:
            ids, vals = aggregate_rows(
                torch.cat([self._aux["indices"], ids]),
                torch.cat([self._data, vals]))
        self._set_sparse_components(vals, ids)

    def zero(self) -> None:
        """No rows (``Parameter.zero_grad`` on a row-sparse buffer)."""
        self._set_sparse_components(
            self._data.new_zeros((0,) + self._shape[1:]),
            self._aux["indices"].new_zeros((0,)))

    def retain(self, indices) -> "RowSparseNDArray":
        """The rows ``indices``, in that order: a row this array lacks
        comes out zero."""
        mine = self._aux["indices"]
        keep = (indices._data if isinstance(indices, NDArray)
                else torch.as_tensor(np.asarray(indices)))
        keep = keep.to(device=mine.device).long()
        vals = self._data.new_zeros((keep.shape[0],) + self._shape[1:])
        if mine.shape[0]:
            order = torch.argsort(mine)
            srt = mine[order].long()
            pos = torch.searchsorted(srt, keep).clamp(max=srt.shape[0] - 1)
            present = srt[pos] == keep
            got = self._data[order[pos]]
            mask = present.reshape((-1,) + (1,) * (got.dim() - 1))
            vals = torch.where(mask, got, vals)
        return RowSparseNDArray(vals, {"indices": keep.to(mine.dtype)},
                                self._shape, ctx=self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix."""

    __slots__ = ()

    @property
    def stype(self) -> str:
        return "csr"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"], ctx=self._ctx)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._aux["indptr"], ctx=self._ctx)

    def _rows(self) -> torch.Tensor:
        """The row of each stored value (no wait: the count is the values'
        length)."""
        m = self._shape[0]
        indptr = self._aux["indptr"]
        return torch.repeat_interleave(
            torch.arange(m, device=indptr.device), indptr[1:] - indptr[:-1],
            output_size=self._data.shape[0])

    def todense(self) -> NDArray:
        out = torch.zeros(self._shape, dtype=self._data.dtype,
                          device=self._data.device)
        out[self._rows(), self._aux["indices"]] = self._data
        return NDArray(out, ctx=self._ctx)

    def dot(self, dense: NDArray, transpose_a: bool = False) -> NDArray:
        """``self @ dense`` (or ``self.T @ dense``): the dense rows the
        column ids name (or the rows' own), scaled by the values and summed
        into rows (or columns) with ``index_add_``."""
        m, n = self._shape
        d = dense._data
        cols = self._aux["indices"]
        rows = self._rows()
        vals = self._data[:, None]
        if transpose_a:
            part = d[rows] * vals
            out = part.new_zeros((n,) + tuple(d.shape[1:]))
            out.index_add_(0, cols, part)
        else:
            part = d[cols] * vals
            out = part.new_zeros((m,) + tuple(d.shape[1:]))
            out.index_add_(0, rows, part)
        return NDArray(out, ctx=self._ctx)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def _device_of(ctx, parts):
    if ctx is not None:
        return resolve_device(ctx)
    for p in parts:
        if isinstance(p, (NDArray, torch.Tensor)):
            return p._ctx if isinstance(p, NDArray) else p.device
    return resolve_device(None)


def _component(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        arr = np.asarray(x)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    return t.to(dev)


def _index(x, dev) -> torch.Tensor:
    return _component(x, None, dev).long()


def _dense_source(arg, ctx) -> NDArray:
    if isinstance(arg, NDArray):
        return arg if ctx is None else arg.as_in_context(ctx)
    return _dense_array(arg, ctx=ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from ``(values, indices)`` and ``shape``, or
    compressed from a dense array (its rows with a nonzero)."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array requires shape with "
                             "(data, indices)")
        dev = _device_of(ctx, arg1)
        return RowSparseNDArray(_component(data, dtype, dev),
                                {"indices": _index(indices, dev)},
                                tuple(shape), ctx=dev)
    dense = _dense_source(arg1, ctx)
    t = dense._data.detach()
    nz = (t != 0).reshape(t.shape[0], -1).any(dim=1).nonzero()[:, 0]
    vals = t[nz]
    if dtype is not None:
        vals = vals.to(dtype_torch(dtype))
    return RowSparseNDArray(vals, {"indices": nz}, tuple(t.shape),
                            ctx=dense._ctx)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from ``(values, indices, indptr)`` and ``shape``,
    or compressed from a 2-D dense array (row-major nonzeros)."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix requires shape with "
                             "(data, indices, indptr)")
        dev = _device_of(ctx, arg1)
        return CSRNDArray(_component(data, dtype, dev),
                          {"indices": _index(indices, dev),
                           "indptr": _index(indptr, dev)},
                          tuple(shape), ctx=dev)
    dense = _dense_source(arg1, ctx)
    t = dense._data.detach()
    if t.dim() != 2:
        raise MXNetError("csr_matrix requires a 2-D input")
    rows, cols = t.nonzero(as_tuple=True)
    indptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64, device=t.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=t.shape[0]), 0)
    vals = t[rows, cols]
    if dtype is not None:
        vals = vals.to(dtype_torch(dtype))
    return CSRNDArray(vals, {"indices": cols, "indptr": indptr},
                      tuple(t.shape), ctx=dense._ctx)


def zeros(stype, shape, ctx=None, dtype=None):
    dev = resolve_device(ctx)
    dt = dtype_torch(dtype or "float32")
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            {"indices": torch.zeros((0,), dtype=torch.int64, device=dev)},
            shape, ctx=dev)
    if stype == "csr":
        return CSRNDArray(
            torch.zeros((0,), dtype=dt, device=dev),
            {"indices": torch.zeros((0,), dtype=torch.int64, device=dev),
             "indptr": torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                   device=dev)}, shape, ctx=dev)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev), ctx=dev)
    raise MXNetError(f"unknown storage type {stype!r}")


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """A sparse array from a scipy.sparse matrix (as ``csr``) or a sparse
    NDArray (as it is); dense sources take ``nd.array``."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    try:
        import scipy.sparse as sp
    except ImportError:
        sp = None
    if sp is not None and sp.issparse(source_array):
        csr = source_array.tocsr()
        return csr_matrix((csr.data, csr.indices, csr.indptr),
                          shape=csr.shape, ctx=ctx, dtype=dtype)
    raise MXNetError("sparse.array expects a scipy.sparse matrix or sparse "
                     "NDArray; use nd.array for dense inputs")


def aggregate_rows(indices: torch.Tensor, values: torch.Tensor):
    """(sorted unique ids, the rows of each id summed) from ids with
    repeats and their rows: the true count of ids, no padding."""
    uids, inv = torch.unique(indices, sorted=True, return_inverse=True)
    out = values.new_zeros((uids.shape[0],) + tuple(values.shape[1:]))
    out.index_add_(0, inv.reshape(-1), values)
    return uids, out


# ---------------------------------------------------------------------------
# the functional namespace (mx.nd.sparse.*)
# ---------------------------------------------------------------------------
def retain(data, indices):
    """The rows ``indices`` of a row_sparse array."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    return data.retain(indices)


def _densified(x):
    return x.todense() if isinstance(x, BaseSparseNDArray) else x


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``csr`` times dense through the compressed rows; every other
    combination contracts the dense forms."""
    if (isinstance(lhs, CSRNDArray) and not transpose_b
            and not isinstance(rhs, BaseSparseNDArray)):
        return lhs.dot(rhs, transpose_a=transpose_a)
    from ..ops import registry as _reg

    return _reg.invoke_by_name("dot", [_densified(lhs), _densified(rhs)],
                               transpose_a=transpose_a,
                               transpose_b=transpose_b)


def _rs_binary(lhs, rhs, op):
    """row_sparse plus (minus) row_sparse of one shape stays sparse over
    the union of their rows; anything else is the dense op."""
    if (isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray)
            and lhs.shape == rhs.shape and op in ("add", "sub")):
        dt = lhs._data.dtype
        # negate in the values' own type (int8 for bool, which has none)
        work = torch.int8 if dt == torch.bool else dt
        lvals = lhs._data.to(work)
        rvals = rhs._data.to(work)
        if op == "sub":
            rvals = -rvals
        uids, summed = aggregate_rows(
            torch.cat([lhs._aux["indices"], rhs._aux["indices"]]),
            torch.cat([lvals, rvals]))
        return RowSparseNDArray(summed.to(dt), {"indices": uids}, lhs.shape,
                                ctx=lhs._ctx)
    from ..ops import registry as _reg

    return _reg.invoke_by_name(f"elemwise_{op}",
                               [_densified(lhs), _densified(rhs)])


def elemwise_add(lhs, rhs):
    return _rs_binary(lhs, rhs, "add")


def elemwise_sub(lhs, rhs):
    return _rs_binary(lhs, rhs, "sub")


def elemwise_mul(lhs, rhs):
    return _rs_binary(lhs, rhs, "mul")


def elemwise_div(lhs, rhs):
    return _rs_binary(lhs, rhs, "div")


add = elemwise_add
subtract = elemwise_sub
multiply = elemwise_mul
divide = elemwise_div


def zeros_like(data):
    """An empty array of ``data``'s storage type, shape and dtype."""
    if isinstance(data, RowSparseNDArray):
        return RowSparseNDArray(
            data._data.new_zeros((0,) + data.shape[1:]),
            {"indices": data._aux["indices"].new_zeros((0,))}, data.shape,
            ctx=data._ctx)
    if isinstance(data, CSRNDArray):
        return CSRNDArray(
            data._data.new_zeros((0,)),
            {"indices": data._aux["indices"].new_zeros((0,)),
             "indptr": data._aux["indptr"].new_zeros((data.shape[0] + 1,))},
            data.shape, ctx=data._ctx)
    return NDArray(torch.zeros_like(data._data), ctx=data._ctx)
