"""Dynamic loss scaling with every transition of the scaler on the device.

Counterpart of ``mxnet_tpu/precision/loss_scale.py``.  In
``DataParallelStep``'s scaled step:

  * the loss is multiplied by the scale before the backward (small fp16
    gradients then survive the 5-bit exponent);
  * the un-scale folds into the optimizer's ``rescale_grad`` multiply
    (``rescale / scale``);
  * overflow detection is one reduction over the gradient list
    (:func:`grads_finite`);
  * a non-finite step selects the old parameters, optimizer state (Adam's
    ``t`` too) and BatchNorm statistics, halves the scale and resets the
    growth counter;
  * ``growth_interval`` consecutive finite steps double the scale.

The scaler state -- ``scale`` (f32), ``growth`` (int32 consecutive-finite
counter), ``skipped`` (int32 cumulative skips) -- is 0-d device tensors;
no function here reads a value back to the host.

:func:`overflow_flag` is the eager export: one reduction over a gradient
list returning a device bool, which ``contrib.amp.DynamicLossScaler``
reads back once per step.
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import LossScaleConfig

__all__ = ["init_scaler_host", "init_scaler", "grads_finite",
           "scaler_update", "overflow_flag", "SCALER_KEYS"]

# checkpoint key order (state_dict writes `amp.<key>` opt_state entries)
SCALER_KEYS = ("scale", "growth", "skipped")


def init_scaler_host(cfg: LossScaleConfig) -> Dict[str, object]:
    """Fresh host-side scaler state (numpy scalars, as the JAX
    function's)."""
    import numpy as np

    return {"scale": np.float32(cfg.init_scale),
            "growth": np.int32(0),
            "skipped": np.int32(0)}


def init_scaler(cfg: LossScaleConfig, device) -> Dict[str, torch.Tensor]:
    """The scaler state of :func:`init_scaler_host` as 0-d tensors on
    ``device``."""
    return {k: torch.tensor(v, device=device)
            for k, v in init_scaler_host(cfg).items()}


def _all_finite(tensors):
    """A 0-d device bool, True when every element of every tensor is
    finite.  ``x * 0`` is 0 for a finite ``x`` and NaN for an infinite or
    NaN one, and the L2 norms propagate the NaN: two multi-tensor calls
    and one reduction, exact for any finite value (no sum of squares of
    the values themselves, which could overflow)."""
    if not tensors:
        return torch.ones((), dtype=torch.bool)
    zeros = torch._foreach_mul(list(tensors), 0.0)
    norms = torch._foreach_norm(zeros)
    return torch.isfinite(torch.stack(norms).sum())


def grads_finite(grads):
    """The all-finite flag over the trainable gradients (the step passes
    only those)."""
    return _all_finite(grads)


def scaler_update(state: Dict[str, torch.Tensor], finite,
                  cfg: LossScaleConfig) -> Dict[str, torch.Tensor]:
    """One transition of the scaler, on the device.

    Not finite: scale *= backoff (floored at 1.0), the growth counter
    resets, the skip counter counts.  ``growth_interval`` consecutive
    finite steps: scale *= growth_factor and the counter resets.  With
    ``dynamic=False`` the scale is pinned; only the skip counter moves.
    """
    scale = state["scale"]
    growth = state["growth"]
    skipped = state["skipped"] + (~finite).to(torch.int32)
    if not cfg.dynamic:
        return {"scale": scale, "growth": growth, "skipped": skipped}
    grown = (growth + 1) >= cfg.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grown, scale * cfg.growth_factor, scale),
        torch.clamp(scale * cfg.backoff_factor, min=1.0)).to(torch.float32)
    new_growth = torch.where(finite & ~grown, growth + 1,
                             torch.zeros_like(growth)).to(torch.int32)
    return {"scale": new_scale, "growth": new_growth, "skipped": skipped}


def overflow_flag(tensors):
    """One reduction over a list of tensors -> a 0-d device bool (True =
    some element is infinite or NaN).  Nothing is read back: the caller
    decides when to."""
    return ~_all_finite(tensors)
