"""BatchNorm over the global batch of a step of several processes.

The JAX step compiles one program over the global batch, so its
BatchNorm's statistics are the whole batch's (GSPMD inserts the
all-reduce; ``mxnet_tpu/gluon/contrib/nn/__init__.py``).  The port runs a
process per card, each holding its block of the batch, so a BatchNorm in
training under the step's ``batch_reduction_scope`` takes this route
instead of the local one:

  forward   each process's per-channel count, mean and M2 (the sum of
            squared deviations from its own mean, from one fused variance
            and mean), one all-gather over the scope's group (the data
            axes, ``dp`` x ``sp``: the processes of a ``tp`` or ``pp``
            slice hold the same block and are not counted twice), then
            Chan's merge of the moments in rank order, so every process
            computes the same global mean and biased variance, bit for
            bit.  The variance is never E[x^2] - E[x]^2.
  backward  the per-channel sums of dy and dy * x_hat, one all-reduce,
            then dx = gamma * invstd * (dy - sum(dy) / N - x_hat *
            sum(dy * x_hat) / N) over the global count N; gamma's and
            beta's gradients stay this process's sums, which the step's
            gradient all-reduce adds up as it does every other one.

Both collectives sit in one ``torch.autograd.Function``, whose backward
uses the group its forward captured (on a card the backward runs on
autograd's device thread, which does not see the step's scopes).  The
statistics and the arithmetic are f32 whatever the data's dtype (bf16,
and NHWC with the channel last; f64 data keeps f64); the output is
rounded to the data's dtype once.  Outside the scope, or over one
process, BatchNorm takes its local route unchanged.

:func:`sync_torch_batch_norms` routes the ``torch.nn`` BatchNorm modules
of a plain torch block here too (with torch's running-statistics rule:
the unbiased variance, ``momentum`` the weight of the new value or None
for the cumulative mean).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

__all__ = ["sync_batch_norm", "sync_torch_batch_norms"]


def _view(t: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return t.reshape(shape)


def _acc(dtype) -> torch.dtype:
    """The statistics' dtype: f32, or f64 for f64 data."""
    return torch.promote_types(dtype, torch.float32)


def _merge(pieces: torch.Tensor):
    """(mean, biased variance, count) of per-process (count, mean, M2)
    rows ``pieces`` (world, 3, C): the global mean, and M2 as the sum of
    the processes' M2 and of their counts times their means' squared
    deviations from it (Chan et al.), reduced in rank order."""
    n, means, m2 = pieces[:, 0], pieces[:, 1], pieces[:, 2]
    total = n.sum(0)
    mean = (n * means).sum(0) / total
    m2 = m2.sum(0) + (n * (means - mean).square()).sum(0)
    return mean, m2 / total, total


class _SyncBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis, group, world):
        import torch.distributed as tdist

        nd = x.dim()
        dims = [d for d in range(nd) if d != axis]
        acc = _acc(x.dtype)
        xf = x.to(acc)
        count = xf.numel() // max(1, xf.shape[axis])
        var, mean = torch.var_mean(xf, dims, correction=0)
        local = torch.stack([torch.full_like(mean, float(count)), mean,
                             var * count])
        pieces = local.new_empty((world * 3,) + tuple(mean.shape))
        tdist.all_gather_into_tensor(pieces, local, group=group)
        mean, var, total = _merge(pieces.view(world, 3, -1))
        invstd = torch.rsqrt(var + eps)
        scale = invstd if weight is None else invstd * weight.to(acc)
        shift = (torch.zeros_like(mean) if bias is None
                 else bias.to(acc))
        out = torch.addcmul(_view(shift, nd, axis),
                            xf - _view(mean, nd, axis), _view(scale, nd, axis))
        ctx.save_for_backward(x, weight, bias, mean, invstd, total)
        ctx.axis, ctx.group = axis, group
        ctx.mark_non_differentiable(mean, var, total)
        return out.to(x.dtype), mean, var, total

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dtotal):
        import torch.distributed as tdist

        x, weight, bias, mean, invstd, total = ctx.saved_tensors
        axis, nd = ctx.axis, x.dim()
        dims = [d for d in range(nd) if d != axis]
        acc = _acc(x.dtype)
        xc = x.to(acc) - _view(mean, nd, axis)
        dyf = dy.to(acc)
        sum_dy = dyf.sum(dims)
        sum_dy_xc = (dyf * xc).sum(dims)
        both = torch.stack([sum_dy, sum_dy_xc])
        tdist.all_reduce(both, group=ctx.group)
        scale = invstd if weight is None else invstd * weight.to(acc)
        # dx = scale * (dy - sum(dy) / N - x_hat * sum(dy * x_hat) / N),
        # x_hat = xc * invstd
        k1 = -scale * invstd.square() * both[1] / total
        k0 = -scale * both[0] / total
        dx = torch.addcmul(torch.addcmul(_view(k0, nd, axis), xc,
                                         _view(k1, nd, axis)),
                           dyf, _view(scale, nd, axis))
        dweight = ((sum_dy_xc * invstd).to(weight.dtype)
                   if weight is not None and ctx.needs_input_grad[1]
                   else None)
        dbias = (sum_dy.to(bias.dtype)
                 if bias is not None and ctx.needs_input_grad[2] else None)
        return dx.to(x.dtype), dweight, dbias, None, None, None, None


def sync_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], eps: float, axis: int,
                    reduction: Tuple) -> Tuple[torch.Tensor, ...]:
    """BatchNorm of ``x`` over every axis but ``axis`` with the
    statistics of the global batch -> (out, mean, biased variance, count),
    the last three f32 (f64 for f64 data) and without gradient.
    ``reduction`` is the step's ``(group, world)``
    (``scope.batch_reduction()``); ``weight`` None scales by 1, ``bias``
    None shifts by 0."""
    group, world = reduction
    return _SyncBatchNorm.apply(x, weight, bias, float(eps),
                                axis % x.dim(), group, int(world))


def _torch_bn_forward(module, forward, x):
    """A ``torch.nn`` BatchNorm's forward: the global route in training
    under a step's batch reduction of more than one process, else the
    module's own."""
    from .scope import batch_reduction

    red = batch_reduction()
    batch_stats = module.training or module.running_mean is None
    if red is None or red[1] <= 1 or not batch_stats:
        return forward(x)
    module._check_input_dim(x)
    out, mean, var, total = sync_batch_norm(
        x, module.weight, module.bias, module.eps, 1, red)
    if module.training and module.track_running_stats:
        module.num_batches_tracked.add_(1)
        m = (1.0 / float(module.num_batches_tracked)
             if module.momentum is None else module.momentum)
        with torch.no_grad():
            unbiased = var * (total / (total - 1).clamp(min=1))
            for run, stat in ((module.running_mean, mean),
                              (module.running_var, unbiased)):
                run.mul_(1 - m).add_(stat.to(run.dtype) * m)
    return out


def sync_torch_batch_norms(block: torch.nn.Module) -> None:
    """Route every ``torch.nn`` BatchNorm module of ``block`` through
    :func:`sync_batch_norm` under a step's batch reduction (each once)."""
    for m in block.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) \
                and not getattr(m, "_mx_sync_bn", False):
            m.forward = functools.partial(_torch_bn_forward, m, m.forward)
            m._mx_sync_bn = True
