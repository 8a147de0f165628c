"""Ring attention and K/V-gather attention over a sequence-sharded axis.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  Each process of an ``sp``
slice holds a length L/sp block of q, k and v, (N, L/sp, D), and calls
these functions with that block; the result is its block of the output.

``ring_attention``: a ``torch.autograd.Function``.  The forward is a
ring: each step folds the visiting K/V block into an online-softmax
state (running max ``m``, sum ``l``, accumulator), and K/V move one
process on along the ``sp`` slice (``batch_isend_irecv``, sent to the
next rank and received from the previous one, as the JAX ``ppermute``
(i -> i+1) does).  The backward is a second ring in which (k, v, dk, dv)
travel while q, do, lse and delta stay; dk and dv are home after a full
turn.  The JAX ring is a ``jnp`` composition, not a Pallas kernel, so its
per-block products stay plain torch here too, in f32, with the same
causal offsets (``q_off`` = this rank's index x L/sp, ``k_off`` that of
the visiting block's owner).  A slice of one process exchanges nothing.

``gather_attention``: the port's counterpart of what GSPMD does for the
JAX step under the default ``gspmd`` mode, which runs the kernel over the
gathered sequence.  K and V are all-gathered over ``sp`` (its backward a
reduce-scatter of dK and dV), and the attention is
``ops.kernels.flash_attention``: kernels K3-K5 on a card, their plain
versions on the CPU.  Non-causal, the local q, (N, L/sp, D), attends to
the gathered (N, L, D) (K3 takes Lq != Lk).  Causal, K3's mask is aligned
at position 0, so q is gathered too and the kernel runs over the prefix
that ends with this rank's block, (N, q_off + L/sp, D), of which this
rank keeps its own rows; the rows before it carry no cotangent, so their
dq is zero and the reduce-scatter returns each rank its own.

The all-gather and the all-to-all order a slice's blocks by rank in its
process group, which ``new_group`` sorts; a mesh built over a permuted
device list orders them by its own index, so :func:`group_order` maps
between the two.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["ring_attention", "ring_self_attention", "gather_attention",
           "gather_sequence", "group_order", "ring_plan", "sp_slice"]

_NEG = -1e30


def ring_plan(sp, dp=0, n_devices=None, rules=None, accum_steps=1):
    """Compat shim: :func:`~mxnet_tpu_torch.parallel.plan.ring_plan`."""
    from .plan import ring_plan as _rp

    return _rp(sp, dp=dp, n_devices=n_devices, rules=rules,
               accum_steps=accum_steps)


def sp_slice(mesh, axis: str = "sp"):
    """(group, ranks of this process's slice, its index, slice size) over
    ``axis`` of ``mesh`` (the active scope's when None); no group for a
    slice of one."""
    if mesh is None:
        from .scope import ring_scope_mesh

        mesh = ring_scope_mesh()
    if mesh is None or mesh.axis_size(axis) == 1:
        return None, None, 0, 1
    return (mesh.group(axis), mesh.slice_ranks(axis),
            mesh.axis_index(axis), mesh.axis_size(axis))


def group_order(ranks):
    """The process-group rank of each of a slice's ``ranks`` (given in the
    mesh's order), or None where the two orders agree.  A group's ranks
    are the sorted global ranks, as ``new_group`` sorts them (and the
    default group's are the global ranks)."""
    if ranks is None:
        return None
    srt = sorted(ranks)
    pos = [srt.index(r) for r in ranks]
    return None if pos == list(range(len(pos))) else pos


def to_group(blocks, pos):
    """(n, ...) blocks in the mesh's order -> in the group's order (block
    ``pos[m]`` of the result is block ``m``)."""
    if pos is None:
        return blocks
    inv = sorted(range(len(pos)), key=pos.__getitem__)
    return blocks[inv]


def from_group(blocks, pos):
    """(n, ...) blocks in the group's order -> in the mesh's order."""
    return blocks if pos is None else blocks[pos]


def _block(q, k, q_off, k_off, causal, sm_scale):
    """Scores of local q against one visiting k block, f32."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(lq, device=q.device)[:, None]
        kpos = k_off + torch.arange(lk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None], s, torch.full_like(s, _NEG))
    return s


def _rotate(tensors, ranks, idx, group):
    """Each tensor sent to the next rank of the slice and replaced by the
    previous rank's (one batch of point-to-point operations)."""
    import torch.distributed as dist

    n = len(ranks)
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, b in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, b, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return bufs


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, slice_info, causal, sm_scale):
        group, ranks, idx, n = slice_info
        lq, lk = q.shape[1], k.shape[1]
        q_off = idx * lq
        m = torch.full(q.shape[:2], _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:2], dtype=torch.float32, device=q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i in range(n):
            k_off = ((idx - i) % n) * lk
            s = _block(q, kb, q_off, k_off, causal, sm_scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vb.float())
            m = m_new
            if i < n - 1:
                kb, vb = _rotate((kb, vb), ranks, idx, group)
        safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = (acc / safe_l[..., None]).to(q.dtype)
        lse = m + torch.log(safe_l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.slice_info, ctx.causal, ctx.sm_scale = slice_info, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, idx, n = ctx.slice_info
        causal, sm_scale = ctx.causal, ctx.sm_scale
        lq, lk = q.shape[1], k.shape[1]
        q_off = idx * lq
        dof = do.float()
        delta = (dof * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        qf = q.float()
        for i in range(n):
            k_off = ((idx - i) % n) * lk
            s = _block(q, kb, q_off, k_off, causal, sm_scale)
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.matmul(p.transpose(1, 2), dof)
            dp = torch.matmul(dof, vb.float().transpose(1, 2))
            ds = p * (dp - delta[..., None]) * sm_scale
            dq = dq + torch.matmul(ds, kb.float())
            dk = dk + torch.matmul(ds.transpose(1, 2), qf)
            if n > 1:  # after n turns dk and dv are home
                if i < n - 1:
                    kb, vb, dk, dv = _rotate((kb, vb, dk, dv), ranks, idx,
                                             group)
                else:
                    dk, dv = _rotate((dk, dv), ranks, idx, group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   sm_scale: Optional[float] = None, mesh=None):
    """Exact attention of this process's q block against every K/V block
    of its ``axis_name`` slice of ``mesh`` (default: the active scope's).
    q: (N, Lq/sp, D), k/v: (N, Lk/sp, D)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, sp_slice(mesh, axis_name), bool(causal),
                       float(sm_scale))


def ring_self_attention(mesh, q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None, axis: str = "sp",
                        batch_axes: Optional[tuple] = None):
    """The ring over ``axis`` of ``mesh``.  Unlike the JAX function, which
    takes global arrays and shards them itself, q/k/v here are this
    process's block (N / batch, L / sp, D) and so is the result; the
    batch axes only split N, which the ring does not touch."""
    return ring_attention(q, k, v, axis_name=axis, causal=causal,
                          sm_scale=sm_scale, mesh=mesh)


class _GatherSeq(torch.autograd.Function):
    """(N, L/sp, D) blocks -> (N, L, D), the slice's blocks in the mesh's
    order; the backward sums the gradient over the slice and keeps this
    rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n, pos):
        import torch.distributed as dist

        ctx.group, ctx.n, ctx.pos = group, n, pos
        x = x.contiguous()
        N, Ll, D = x.shape
        buf = torch.empty((n * N, Ll, D), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, x, group=group)
        blocks = from_group(buf.view(n, N, Ll, D), pos)
        return blocks.permute(1, 0, 2, 3).reshape(N, n * Ll, D)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = ctx.n
        N, L, D = g.shape
        parts = to_group(g.reshape(N, n, L // n, D).permute(1, 0, 2, 3),
                         ctx.pos).reshape(n * N, L // n, D)
        out = torch.empty((N, L // n, D), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, parts.contiguous(), group=ctx.group)
        return out, None, None, None


def gather_sequence(x, mesh=None, axis: str = "sp"):
    """The slice's (N, L/sp, D) blocks of ``x`` gathered to (N, L, D)."""
    group, ranks, _idx, n = sp_slice(mesh, axis)
    if n == 1:
        return x
    return _GatherSeq.apply(x, group, n, group_order(ranks))


def gather_attention(q, k, v, causal: bool = False,
                     sm_scale: Optional[float] = None, mesh=None,
                     axis: str = "sp"):
    """This process's q block against K/V gathered over ``axis`` (see the
    module's docstring)."""
    from ..ops.kernels import flash_attention

    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = gather_sequence(k, mesh, axis), gather_sequence(v, mesh, axis)
    if not causal:
        return flash_attention(q.contiguous(), kf.contiguous(),
                               vf.contiguous(), causal=False,
                               sm_scale=sm_scale)
    _g, _r, idx, _n = sp_slice(mesh, axis)
    lq = q.shape[1]
    q_off = idx * lq
    end = q_off + lq
    qf = gather_sequence(q, mesh, axis)
    out = flash_attention(qf[:, :end].contiguous(), kf[:, :end].contiguous(),
                          vf[:, :end].contiguous(), causal=True,
                          sm_scale=sm_scale)
    return out[:, q_off:]
