"""Shape manipulation and linear algebra, from ``mxnet_tpu/ops/matrix.py``,
under its names: ``reshape`` / ``Reshape`` with MXNet's special codes 0
(keep), -1 (infer), -2 (copy the rest), -3 (merge two) and -4 (split one
in two) and ``reverse``; ``Flatten``, ``transpose``, ``expand_dims``,
``squeeze``, ``swapaxes`` / ``SwapAxis``, ``flip`` / ``reverse``,
``tile``, ``repeat``, ``broadcast_to`` / ``_like`` / ``_axis``,
``Concat``, ``stack``, ``split`` / ``SliceChannel`` / ``split_v2``,
``slice`` (negative steps too) / ``slice_axis`` / ``slice_like``,
``pad``, ``dot`` and ``batch_dot`` with ``transpose_a/b``, ``where``,
``depth_to_space`` / ``space_to_depth``, ``diag``, ``shape_array`` /
``size_array``, ``batch_take``, ``khatri_rao``, ``reshape_like``,
``cumsum``, ``logsumexp``, the legacy ``onehot_encode`` /
``choose_element_0index`` / ``fill_element_0index`` /
``zeros_like_legacy``, and the 15 ``linalg_*`` ops on ``torch.linalg``.

The linear algebra keeps the JAX ops' conventions: ``linalg_trsm``
transposes the factor and flips ``lower`` for ``transpose``, and with
``rightside`` solves against ``b``'s transpose; ``linalg_gelqf`` is the
QR factorization of the transpose, ``(Q, L)`` with no sign fixed (both
packages take LAPACK's Householder signs on the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..precision import runtime as _amp
from .registry import register


@register("reshape")
def reshape(x, shape=None, reverse=False):
    if shape is None:
        return x
    src = list(x.shape)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    if out.count(-1) == 1:
        known = math.prod(d for d in out if d != -1) or 1
        out[out.index(-1)] = x.numel() // known
    return torch.reshape(x, tuple(out))


@register("Reshape")
def Reshape(x, shape=None, reverse=False):
    return reshape(x, shape=shape, reverse=reverse)


@register("Flatten")
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def transpose(x, axes=None):
    if axes is None or axes == ():
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(np.atleast_1d(axis).tolist()))


@register("swapaxes")
def swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


@register("SwapAxis")
def SwapAxis(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


def _flip(x, axis):
    return torch.flip(x, tuple(np.atleast_1d(axis).tolist()))


@register("flip")
def flip(x, axis=0):
    return _flip(x, axis)


@register("reverse")
def reverse(x, axis=0):
    return _flip(x, axis)


@register("tile")
def tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("broadcast_to")
def broadcast_to(x, shape=()):
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_like")
def broadcast_like(x, y, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(x, y.shape)
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = y.shape[ra]
    return torch.broadcast_to(x, tuple(tgt))


@register("broadcast_axis")
def broadcast_axis(x, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


@register("Concat")
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


def _split_out(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("split")
def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {x.shape[axis]} does "
                         f"not divide into {num_outputs} equal parts")
    return _split_out(torch.tensor_split(x, num_outputs, dim=axis), axis,
                      squeeze_axis)


@register("SliceChannel")
def SliceChannel(x, num_outputs=1, axis=1, squeeze_axis=False):
    return split(x, num_outputs=num_outputs, axis=axis,
                 squeeze_axis=squeeze_axis)


@register("split_v2")
def split_v2(x, indices_or_sections=1, axis=0, squeeze_axis=False,
             sections=0):
    """numpy-style split: an int gives equal sections, a tuple the split
    points."""
    if sections and sections > 0:
        spec = int(sections)
    elif isinstance(indices_or_sections, int):
        spec = int(indices_or_sections)
    else:
        spec = [int(i) for i in indices_or_sections]
    return _split_out(torch.tensor_split(x, spec, dim=axis), axis,
                      squeeze_axis)


@register("slice")
def slice_op(x, begin=(), end=(), step=()):
    """``x[b:e:s, ...]`` per leading axis; a negative step (which torch's
    basic indexing lacks) gathers the rows in Python's order."""
    step = step or (None,) * len(begin)
    out = x
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        sl = slice(b, e, s)
        if s is not None and s < 0:
            idx = torch.arange(*sl.indices(out.shape[ax]), device=x.device)
            out = out.index_select(ax, idx)
        else:
            out = out[(slice(None),) * ax + (sl,)]
    return out


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("slice_like")
def slice_like(x, shape_like, axes=()):
    axes = axes or tuple(range(min(x.dim(), shape_like.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return x[tuple(idx)]


def pad_array(x, widths, mode, value):
    """``x`` padded by ``widths`` ((before, after) per axis) with
    ``value`` (``constant``) or numpy's ``edge`` / ``reflect`` rows,
    gathered through index arrays so any axis may be padded."""
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [int(lo), int(hi)]
        return F.pad(x, flat, value=float(value)) if any(flat) else x
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"pad mode {mode}")
    out = x
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(out.shape[ax]), (int(lo), int(hi)),
                         mode=mode)
            out = out.index_select(ax, torch.as_tensor(idx,
                                                       device=x.device))
    return out


@register("pad")
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    widths = [(pad_width[2 * i], pad_width[2 * i + 1])
              for i in range(len(pad_width) // 2)]
    return pad_array(x, widths, mode, constant_value)


@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    """Contracts the last axis of ``a`` with the first of ``b``;
    ``transpose_a`` moves ``a``'s first axis last, ``transpose_b``
    ``b``'s last axis first."""
    a, b = _amp.cast_inputs("dot", a, b)
    if transpose_a and a.dim() > 1:
        a = a.permute(*range(1, a.dim()), 0)
    if transpose_b and b.dim() > 1:
        b = b.permute(b.dim() - 1, *range(0, b.dim() - 1))
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    a, b = _amp.cast_inputs("batch_dot", a, b)
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("where")
def where(cond, a, b):
    return torch.where(cond != 0, a, b)


@register("depth_to_space")
def depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * bs * bs, h // bs, w // bs)


@register("diag")
def diag(x, k=0):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


@register("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("zeros_like_legacy", differentiable=False)
def zeros_like_legacy(x):
    return torch.zeros_like(x)


@register("batch_take")
def batch_take(a, indices):
    """out[i] = a[i, indices[i]], the index clipped to the row."""
    idx = indices.reshape(-1).long().clamp(0, a.shape[1] - 1)
    return a[torch.arange(a.shape[0], device=a.device), idx]


@register("khatri_rao")
def khatri_rao(*matrices):
    """Column-wise Kronecker product."""
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("reshape_like")
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """``lhs`` in ``rhs``'s shape, or a dimension range of each."""
    lshape, rshape = list(lhs.shape), list(rhs.shape)

    def _resolve(idx, ndim, default):
        if idx is None:
            return default
        idx = int(idx)
        return idx + ndim if idx < 0 else idx

    lb = _resolve(lhs_begin, len(lshape), 0)
    le = _resolve(lhs_end, len(lshape), len(lshape))
    rb = _resolve(rhs_begin, len(rshape), 0)
    re_ = _resolve(rhs_end, len(rshape), len(rshape))
    return lhs.reshape(tuple(lshape[:lb] + rshape[rb:re_] + lshape[le:]))


@register("cumsum")
def cumsum(a, axis=None, dtype=None):
    out = torch.cumsum(a if axis is not None else a.reshape(-1),
                       dim=axis if axis is not None else 0)
    if dtype is not None:
        from ..ndarray.ndarray import dtype_torch

        out = out.to(dtype_torch(dtype))
    return out


@register("logsumexp")
def logsumexp(data, axis=None, keepdims=False):
    if axis is None:
        dims = tuple(range(data.dim()))
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.logsumexp(data, dim=dims, keepdim=keepdims)


@register("onehot_encode", differentiable=False)
def onehot_encode(indices, out_like):
    """Legacy one-hot: (B,) indices, (B, C) in ``out_like``'s dtype."""
    from .nn import _onehot

    return _onehot(indices, out_like.shape[1], out_like.dtype)


@register("choose_element_0index", differentiable=False)
def choose_element_0index(lhs, rhs):
    """out[i] = lhs[i, rhs[i]] (legacy)."""
    return torch.gather(lhs, 1, rhs.long()[:, None])[:, 0]


@register("fill_element_0index", differentiable=False)
def fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with out[i, rhs[i]] = mhs[i] (legacy)."""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.long()), mhs.to(lhs.dtype))


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------
@register("linalg_gemm2")
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-3):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return alpha * torch.matmul(a, b)


@register("linalg_gemm")
def linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha op(A) op(B) + beta C; the matrices span (axis, axis + 1)."""
    axis = int(axis)
    moved = axis not in (-2, a.dim() - 2)
    if moved:
        a, b, c = (t.movedim((axis, axis + 1), (-2, -1)) for t in (a, b, c))
    ta = a.transpose(-1, -2) if transpose_a else a
    tb = b.transpose(-1, -2) if transpose_b else b
    out = alpha * torch.matmul(ta, tb) + beta * c
    if moved:
        out = out.movedim((-2, -1), (axis, axis + 1))
    return out


@register("linalg_syrk")
def linalg_syrk(a, transpose=False, alpha=1.0):
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


@register("linalg_potrf")
def linalg_potrf(a):
    return torch.linalg.cholesky(a)


@register("linalg_potri")
def linalg_potri(a, lower=True):
    """(A A^T)^-1 from the Cholesky factor A."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    inv_a = torch.linalg.solve_triangular(a, eye.expand_as(a), upper=not lower)
    inv_t = inv_a.transpose(-1, -2)
    return inv_t @ inv_a if lower else inv_a @ inv_t


@register("linalg_trsm")
def linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    if transpose:
        a = a.transpose(-1, -2)
        lower = not lower
    rhs = b.transpose(-1, -2) if rightside else b
    out = torch.linalg.solve_triangular(a, rhs, upper=not lower)
    if rightside:
        out = out.transpose(-1, -2)
    return alpha * out


@register("linalg_trmm")
def linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = tri.transpose(-1, -2)
    out = torch.matmul(b, tri) if rightside else torch.matmul(tri, b)
    return alpha * out


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(a, offset=0):
    """(..., n) values on diagonal ``offset`` of (..., n+|k|, n+|k|)."""
    return torch.diag_embed(a, offset=int(offset), dim1=-2, dim2=-1)


@register("linalg_inverse")
def linalg_inverse(a):
    return torch.linalg.inv(a)


@register("linalg_det")
def linalg_det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet")
def linalg_slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("linalg_gelqf", differentiable=False)
def linalg_gelqf(a):
    """A = L Q, Q with orthonormal rows, returned as (Q, L)."""
    q, r = torch.linalg.qr(a.transpose(-1, -2))
    return q.transpose(-1, -2), r.transpose(-1, -2)
