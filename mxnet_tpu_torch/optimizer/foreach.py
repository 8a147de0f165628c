"""The multi-tensor update terms shared by the fused optimizer apply
(``fused.py``) and the training step (``parallel/data_parallel.py``).

Each helper runs ``torch._foreach_*`` calls over lists of f32 tensors, in
place, with the per-parameter scalars (lr after the schedule and
``lr_mult``, wd after ``wd_mult``, Adam's bias-corrected lr) as lists.
A list of scalars that differ costs one multi-tensor call per distinct
value, never one launch per parameter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["axpy_", "grad_terms_", "sgd_", "adam_"]


def axpy_(ys, xs, alphas: Sequence[float]) -> None:
    """``ys[i] += alphas[i] * xs[i]``: the parameters grouped by their
    alpha, one ``torch._foreach_add_`` a group."""
    groups: Dict[float, Tuple[List, List]] = {}
    for y, x, a in zip(ys, xs, alphas):
        yg, xg = groups.setdefault(float(a), ([], []))
        yg.append(y)
        xg.append(x)
    for a, (yg, xg) in groups.items():
        torch._foreach_add_(yg, xg, alpha=a)


def grad_terms_(g, ws, scale=1.0, clip: Optional[float] = None,
                wds: Sequence[float] = ()):
    """``g = clip(g * scale, +-clip) + wds[i] * ws[i]`` in place on the f32
    list ``g``; ``scale`` a float or a 0-d tensor (the global-norm
    factor), ``clip`` None for no element clip, and the wd term left out
    when every ``wds[i]`` is 0."""
    if isinstance(scale, torch.Tensor) or scale != 1.0:
        torch._foreach_mul_(g, scale)
    if clip is not None:
        torch._foreach_clamp_min_(g, -float(clip))
        torch._foreach_clamp_max_(g, float(clip))
    if any(wds):
        axpy_(g, ws, wds)
    return g


def sgd_(ws, g, moms, momentum: float, lrs: Sequence[float]) -> None:
    """SGD in place: ``w -= lr * g``, or with momenta ``m = momentum * m -
    lr * g; w += m``."""
    neg = [-lr for lr in lrs]
    if moms is None:
        axpy_(ws, g, neg)
        return
    torch._foreach_mul_(moms, float(momentum))
    axpy_(moms, g, neg)
    torch._foreach_add_(ws, moms)


def adam_(ws, g, means, vars_, beta1: float, beta2: float, epsilon: float,
          steps: Sequence[float]) -> None:
    """MXNet's Adam in place: ``m = b1 m + (1 - b1) g; v = b2 v + (1 - b2)
    g^2; w -= step * m / (sqrt(v) + eps)``, ``steps[i]`` the lr with the
    bias correction ``sqrt(1 - b2^t) / (1 - b1^t)`` folded in."""
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, g, alpha=1 - beta1)
    torch._foreach_mul_(vars_, beta2)
    torch._foreach_addcmul_(vars_, g, g, value=1 - beta2)
    denom = torch._foreach_sqrt(vars_)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_addcdiv_(ws, means, denom, [-s for s in steps])
