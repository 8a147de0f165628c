"""The optimizer update ops, registered with ``differentiable=False``.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
``src/operator/optimizer_op.*``): ``sgd_update``, ``sgd_mom_update`` and
their ``mp_`` forms (a 16-bit weight with an f32 master copy),
``nag_mom_update``, ``adam_update``, ``mp_adam_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update``, ``rmsprop_update``,
``rmspropalex_update``, ``adagrad_update``, ``adadelta_update``,
``lamb_update_phase1/2`` and the ``multi_*`` / ``preloaded_multi_*`` forms.
Each is plain torch on tensors, the JAX op's formulas in its order: the
gradient term in f32 (``grad * rescale_grad``, the clip, ``+ wd * w``),
the state in f32, the new weight rounded to the weight's dtype once.
Each returns new tensors; the optimizer classes swap them in.
"""
from __future__ import annotations

import torch

from .registry import register

_F32 = torch.float32


def _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient):
    g = grad.to(_F32) * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight.to(_F32)


@register("sgd_update", differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    return (weight.to(_F32) - lr * g).to(weight.dtype)


@register("sgd_mom_update", differentiable=False)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_mom = momentum * mom.to(_F32) - lr * g
    new_w = weight.to(_F32) + new_mom
    return new_w.to(weight.dtype), new_mom.to(mom.dtype)


@register("mp_sgd_update", differentiable=False)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd_rescale(grad, weight32, rescale_grad, wd, clip_gradient)
    new32 = weight32 - lr * g
    return new32.to(weight.dtype), new32


@register("mp_sgd_mom_update", differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _apply_wd_rescale(grad, weight32, rescale_grad, wd, clip_gradient)
    new_mom = momentum * mom - lr * g
    new32 = weight32 + new_mom
    return new32.to(weight.dtype), new_mom, new32


@register("nag_mom_update", differentiable=False)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_mom = momentum * mom.to(_F32) + g
    new_w = weight.to(_F32) - lr * (g + momentum * new_mom)
    return new_w.to(weight.dtype), new_mom.to(mom.dtype)


@register("adam_update", differentiable=False)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight.to(_F32) - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w.to(weight.dtype), new_mean, new_var


@register("mp_adam_update", differentiable=False)
def mp_adam_update(weight, grad, mean, var, weight32, lr=0.001, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight32, rescale_grad, wd, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new32 = weight32 - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new32.to(weight.dtype), new_mean, new_var, new32


@register("ftrl_update", differentiable=False)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.to(_F32) * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight.to(_F32)
    denom = (beta + torch.sqrt(new_n)) / lr + wd
    new_w = torch.where(new_z.abs() > lamda1,
                        -(new_z - torch.sign(new_z) * lamda1) / denom,
                        torch.zeros((), dtype=_F32, device=new_z.device))
    return new_w.to(weight.dtype), new_z, new_n


@register("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, 0.0, clip_gradient)
    new_w = weight.to(_F32) * (1 - lr * wd) - lr * torch.sign(g)
    return new_w.to(weight.dtype)


@register("signum_update", differentiable=False)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    new_w = weight.to(_F32) * (1 - lr * wd_lh) + lr * torch.sign(new_mom)
    return new_w.to(weight.dtype), new_mom


@register("rmsprop_update", differentiable=False)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight.to(_F32) - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w.to(weight.dtype), new_n


@register("rmspropalex_update", differentiable=False)
def rmspropalex_update(weight, grad, n, g_buf, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_buf + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight.to(_F32) + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w.to(weight.dtype), new_n, new_g, new_delta


@register("adagrad_update", differentiable=False)
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_hist = history + torch.square(g)
    new_w = weight.to(_F32) - lr * g / (torch.sqrt(new_hist) + epsilon)
    return new_w.to(weight.dtype), new_hist


@register("adadelta_update", differentiable=False)
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, wd, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
        new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    new_w = weight.to(_F32) - delta
    return new_w.to(weight.dtype), new_acc_g, new_acc_delta


@register("lamb_update_phase1", differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.to(_F32) * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    update = m / (torch.sqrt(v) + epsilon) + wd * weight.to(_F32)
    return update, new_mean, new_var


@register("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    r1v = r1.reshape(())
    r2v = r2.reshape(())
    if lower_bound >= 0:
        r1v = torch.clamp(r1v, min=lower_bound)
    if upper_bound >= 0:
        r1v = torch.clamp(r1v, max=upper_bound)
    ratio = torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                        torch.ones((), dtype=r1v.dtype, device=r1v.device))
    new_w = weight.to(_F32) - lr * ratio * g_update
    return new_w.to(weight.dtype)


# ---------------------------------------------------------------------------
# multi-tensor forms: one op call updates many parameters
# ---------------------------------------------------------------------------
def _norm_list(v, n):
    vals = [float(x) for x in (v if isinstance(v, (tuple, list)) else [v])]
    if len(vals) == 1:
        vals = vals * n
    return vals


@register("multi_sgd_update", differentiable=False)
def multi_sgd_update(*data, lrs=(0.01,), wds=(0.0,), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """data = [w0, g0, w1, g1, ...]; returns the updated weights."""
    n = int(num_weights)
    lrs, wds = _norm_list(lrs, n), _norm_list(wds, n)
    outs = [sgd_update(data[2 * i], data[2 * i + 1], lr=lrs[i], wd=wds[i],
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient) for i in range(n)]
    return tuple(outs) if n > 1 else outs[0]


@register("multi_sgd_mom_update", differentiable=False)
def multi_sgd_mom_update(*data, lrs=(0.01,), wds=(0.0,), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """data = [w0, g0, m0, w1, g1, m1, ...]; returns (w_i, m_i) pairs."""
    n = int(num_weights)
    lrs, wds = _norm_list(lrs, n), _norm_list(wds, n)
    outs = []
    for i in range(n):
        outs.extend(sgd_mom_update(
            *data[3 * i:3 * i + 3], lr=lrs[i], momentum=momentum, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_update", differentiable=False)
def multi_mp_sgd_update(*data, lrs=(0.01,), wds=(0.0,), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """data = [w0, g0, w32_0, ...]; returns (w_i, w32_i) pairs."""
    n = int(num_weights)
    lrs, wds = _norm_list(lrs, n), _norm_list(wds, n)
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_update(
            *data[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_mom_update", differentiable=False)
def multi_mp_sgd_mom_update(*data, lrs=(0.01,), wds=(0.0,), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """data = [w0, g0, m0, w32_0, ...]; returns (w_i, m_i, w32_i)
    triples."""
    n = int(num_weights)
    lrs, wds = _norm_list(lrs, n), _norm_list(wds, n)
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_mom_update(
            *data[4 * i:4 * i + 4], lr=lrs[i], momentum=momentum, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register("preloaded_multi_sgd_update", differentiable=False)
def preloaded_multi_sgd_update(*data, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=1):
    """Like ``multi_sgd_update``, with lrs and wds as the two trailing
    arrays."""
    n = int(num_weights)
    lrs, wds = data[-2], data[-1]
    outs = []
    for i in range(n):
        w, g = data[2 * i], data[2 * i + 1]
        g2 = _apply_wd_rescale(g, w, rescale_grad, wds[i], clip_gradient)
        outs.append((w.to(_F32) - lrs[i] * g2).to(w.dtype))
    return tuple(outs) if n > 1 else outs[0]


@register("preloaded_multi_sgd_mom_update", differentiable=False)
def preloaded_multi_sgd_mom_update(*data, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    n = int(num_weights)
    lrs, wds = data[-2], data[-1]
    outs = []
    for i in range(n):
        w, g, m = data[3 * i], data[3 * i + 1], data[3 * i + 2]
        g2 = _apply_wd_rescale(g, w, rescale_grad, wds[i], clip_gradient)
        nm = momentum * m.to(_F32) - lrs[i] * g2
        outs.extend([(w.to(_F32) + nm).to(w.dtype), nm.to(m.dtype)])
    return tuple(outs)
