"""Ulysses all-to-all sequence parallelism (exact attention).

Counterpart of ``mxnet_tpu/parallel/ulysses.py``.  Each process of an
``sp`` slice holds (N, L/sp, D) of q, k and v.  One ``all_to_all_single``
trades the sequence block for a head block, (N/sp, L, D): every token of
1/sp of the heads; attention runs locally; a second all-to-all brings
the output back to (N, L/sp, D).  Each all-to-all is an autograd
function whose backward is the other one.  Blocks are exchanged in the
mesh's order of the slice, which may differ from its process group's
(``ring.group_order``).

The local attention is ``ops.kernels.flash_attention``: kernels K3-K5 on
a card, their plain versions on the CPU, as the JAX ``_local_attn`` calls
the Pallas kernel where it is enabled.  N must divide by the slice size
(the all-to-all shards heads); the error is the JAX one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..base import MXNetError

__all__ = ["ulysses_self_attention", "ulysses_plan"]


def ulysses_plan(sp, dp=0, n_devices=None, rules=None, accum_steps=1):
    """Compat shim: :func:`~mxnet_tpu_torch.parallel.plan.ulysses_plan`."""
    from .plan import ulysses_plan as _up

    return _up(sp, dp=dp, n_devices=n_devices, rules=rules,
               accum_steps=accum_steps)


def _seq2head(x, group, n, pos):
    """(N, Ll, D) -> (N/n, n Ll, D): the j-th of the slice's ranks (in the
    mesh's order) gets rows j N/n ... of every rank's sequence block,
    blocks in the mesh's order (``pos``: :func:`ring.group_order`)."""
    import torch.distributed as dist

    from .ring import from_group, to_group

    N, Ll, D = x.shape
    send = to_group(x.reshape(n, N // n, Ll, D), pos).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    out = from_group(out, pos)
    return out.permute(1, 0, 2, 3).reshape(N // n, n * Ll, D)


def _head2seq(x, group, n, pos):
    """(N/n, L, D) -> (N, L/n, D), the inverse of :func:`_seq2head`."""
    import torch.distributed as dist

    from .ring import from_group, to_group

    Nh, L, D = x.shape
    parts = to_group(x.reshape(Nh, n, L // n, D).permute(1, 0, 2, 3),
                     pos).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return from_group(out, pos).reshape(Nh * n, L // n, D)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, pos):
        ctx.group, ctx.n, ctx.pos = group, n, pos
        return _seq2head(x, group, n, pos)

    @staticmethod
    def backward(ctx, g):
        return _head2seq(g, ctx.group, ctx.n, ctx.pos), None, None, None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, pos):
        ctx.group, ctx.n, ctx.pos = group, n, pos
        return _head2seq(x, group, n, pos)

    @staticmethod
    def backward(ctx, g):
        return _seq2head(g, ctx.group, ctx.n, ctx.pos), None, None, None


def ulysses_self_attention(mesh, q, k, v, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           axis: str = "sp",
                           batch_axes: Optional[tuple] = None):
    """Exact self-attention of this process's (N, L/sp, D) blocks over
    ``axis`` of ``mesh``; returns its (N, L/sp, D) block of the output.
    (The JAX function takes the global arrays; the port's processes each
    pass their own block, so N here is already the local one.)"""
    from ..ops.kernels import flash_attention
    from .ring import group_order, sp_slice

    shape = dict(mesh.shape)
    if axis not in shape:
        raise MXNetError(f"mesh has no {axis!r} axis: {tuple(shape)}")
    S = shape[axis]
    if q.shape[0] % S:
        raise MXNetError(
            f"Ulysses SP: local N={q.shape[0]}/1 heads*batch not "
            f"divisible by {axis}={S} (the all-to-all shards heads)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    group, ranks, _idx, n = sp_slice(mesh, axis)
    if n == 1:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale)
    pos = group_order(ranks)
    qh, kh, vh = (_SeqToHead.apply(t, group, n, pos) for t in (q, k, v))
    out = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                          causal=causal, sm_scale=sm_scale)
    return _HeadToSeq.apply(out, group, n, pos)
