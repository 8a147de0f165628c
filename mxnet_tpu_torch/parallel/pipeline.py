"""Pipeline parallelism: a GPipe schedule over the ``pp`` slice of a mesh
of processes.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  The JAX schedule is a
``lax.scan`` over ``ppermute`` inside a ``shard_map``, all stages one
program.  Here each process of a ``pp`` slice is one stage, running its
L/S consecutive layers of a uniform stack on M microbatches:

  forward   stage 0 takes microbatch m from the feed, every other stage
            receives it from the one before; each stage sends its output
            on (``batch_isend_irecv`` on the slice), and the last stage
            keeps the outputs.  They are then broadcast from the last
            stage to every ``pp`` rank, as the JAX ``psum`` of the last
            stage's buffer gives them.
  backward  the microbatches in reverse: the last stage takes the
            cotangent of its outputs (once; every ``pp`` rank holds the
            same, and the others' are dropped), every other stage
            receives it from the one after, backpropagates through its
            layers and sends the input's gradient to the one before.  Stage
            0's input gradients are broadcast to every ``pp`` rank, so the
            layers before the pipeline (which every rank runs alike) take
            the same gradient everywhere.

Each stage keeps the autograd graphs of its M microbatches from the
forward to the backward (GPipe's activation memory).  The JAX schedule
computes discarded values on its bubble ticks; this one does not, since
only the results must agree.  Forward and backward are one
``torch.autograd.Function``, whose backward runs ``torch.autograd.grad``
over each microbatch's graph and returns the parameters' gradients, so
they accumulate as any others do.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..base import MXNetError

__all__ = ["pipeline_apply", "pipeline_plan"]


def pipeline_plan(pp, microbatches=4, dp=0, n_devices=None, rules=None,
                  accum_steps=1):
    """Compat shim: the GPipe pipeline strategy as a
    :class:`~mxnet_tpu_torch.parallel.plan.Plan`."""
    from .plan import pipeline_plan as _pp

    return _pp(pp, microbatches=microbatches, dp=dp, n_devices=n_devices,
               rules=rules, accum_steps=accum_steps)


class _Stage:
    """This process's place in the ``pp`` slice."""

    def __init__(self, mesh, axis: str):
        self.size = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.ranks = mesh.slice_ranks(axis) if axis in mesh.axis_names \
            else [None]
        self.group = mesh.group(axis) if self.size > 1 else None

    @property
    def first(self):
        return self.index == 0

    @property
    def last(self):
        return self.index == self.size - 1

    def _p2p(self, ops):
        import torch.distributed as tdist

        if not ops:
            return
        for work in tdist.batch_isend_irecv(ops):
            work.wait()

    def send(self, t, to: int):
        import torch.distributed as tdist

        self._p2p([tdist.P2POp(tdist.isend, t.contiguous(), self.ranks[to],
                               group=self.group)])

    def recv(self, like, frm: int):
        import torch.distributed as tdist

        buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        self._p2p([tdist.P2POp(tdist.irecv, buf, self.ranks[frm],
                               group=self.group)])
        return buf

    def broadcast(self, t, frm: int):
        import torch.distributed as tdist

        if self.size == 1:
            return t
        t = t.contiguous()
        tdist.broadcast(t, self.ranks[frm], group=self.group)
        return t


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, run, names, x_micro, *params):
        graphs = []
        outs = torch.empty_like(x_micro)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(p.requires_grad)
                      for p in params]
            local = dict(zip(names, leaves))
            for m in range(x_micro.shape[0]):
                inp = (x_micro[m] if stage.first
                       else stage.recv(x_micro[m], stage.index - 1))
                inp = inp.detach().requires_grad_(ctx.needs_input_grad[3]
                                                  or not stage.first)
                out = run(local, inp)
                graphs.append((inp, out))
                if stage.last:
                    outs[m] = out.detach()
                else:
                    stage.send(out.detach(), stage.index + 1)
        ctx.stage, ctx.graphs, ctx.leaves = stage, graphs, leaves
        ctx.x_like = x_micro
        return stage.broadcast(outs, stage.size - 1)

    @staticmethod
    def backward(ctx, gy):
        stage, graphs, leaves = ctx.stage, ctx.graphs, ctx.leaves
        want = [p for p in leaves if p.requires_grad]
        acc = [None] * len(want)
        gx = torch.zeros_like(ctx.x_like)
        for m in reversed(range(len(graphs))):
            inp, out = graphs[m]
            g = (gy[m] if stage.last
                 else stage.recv(out.detach(), stage.index + 1))
            wrt = [inp] + want if inp.requires_grad else want
            grads = torch.autograd.grad(out, wrt, g, allow_unused=True)
            if inp.requires_grad:
                g_in, grads = grads[0], grads[1:]
                if stage.first:
                    gx[m] = g_in
                else:
                    stage.send(g_in, stage.index - 1)
            for i, gp in enumerate(grads):
                if gp is not None:
                    acc[i] = gp if acc[i] is None else acc[i] + gp
            graphs[m] = None
        gx = stage.broadcast(gx, 0)
        it = iter(acc)
        pgrads = [next(it) if p.requires_grad else None for p in leaves]
        pgrads = [torch.zeros_like(p) if p.requires_grad and g is None
                  else g for p, g in zip(leaves, pgrads)]
        return (None, None, None, gx, *pgrads)


def _stage_rows(mesh, axis: str, leaves: Dict[str, torch.Tensor]):
    """Each whole stack's rows for this process's stage."""
    S, r = mesh.axis_size(axis), mesh.axis_index(axis)
    n = next(iter(leaves.values())).shape[0] // S
    return {k: v[r * n:(r + 1) * n] for k, v in leaves.items()}


def pipeline_apply(mesh, fn: Callable, stacked_params, x_micro,
                   axis: str = "pp", batch_axes=(), param_specs=None,
                   stage_local: bool = False):
    """Run L stacked uniform layers as a pp-stage pipeline.

    mesh: a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` with a size-S
        ``axis``; L must be divisible by S.
    fn(params_slice, x) -> y with y.shape == x.shape (one layer; the slice
        is a dict of the stack's tensors at one layer).
    stacked_params: dict of tensors with leading dim L, the whole stack on
        every process (this stage takes its L/S rows, differentiably), or
        with ``stage_local`` this stage's L/S rows already (a step's
        sharded parameters).  ``param_specs`` is accepted for the JAX
        signature; tensor parallelism inside a stage is the layer's own
        (``fn`` all-reduces its row-parallel outputs over ``tp``).
    x_micro: (M, b, ...) microbatches of this process's block of the batch
        (``batch_axes`` is the JAX signature's: the step has already cut
        the block).
    Returns (M, b, ...) outputs on every ``pp`` rank.
    """
    shape = dict(mesh.shape)
    if axis not in shape:
        raise MXNetError(f"mesh has no {axis!r} axis: {tuple(shape)}")
    if not stacked_params:
        raise MXNetError("stacked_params is empty")
    S = shape[axis]
    names = list(stacked_params)
    L = stacked_params[names[0]].shape[0] * (S if stage_local else 1)
    if L % S:
        raise MXNetError(
            f"{L} stacked layers not divisible by {axis}={S} stages")
    params = (dict(stacked_params) if stage_local
              else _stage_rows(mesh, axis, stacked_params))

    def run(local, x):
        for i in range(local[names[0]].shape[0]):
            x = fn({k: v[i] for k, v in local.items()}, x)
        return x

    return _Pipeline.apply(_Stage(mesh, axis), run, names, x_micro,
                           *[params[k] for k in names])
