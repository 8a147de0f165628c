"""AMP implementation (see the package docstring)."""
from __future__ import annotations

import contextlib
import logging

import numpy as np

from ...base import MXNetError

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "DynamicLossScaler"]

_amp_state = {
    "initialized": False,
    "target_dtype": None,
    "loss_scaler": None,
}


def _grads(params):
    """The gradient tensors of the Parameters that have one."""
    out = []
    for param in params:
        if param.grad_req == "null":
            continue
        g = param._tensor().grad
        if g is not None:
            out.append(g)
    return out


class DynamicLossScaler:
    """Dynamic loss scaling for fp16 (unused for bf16).  Overflow
    detection is one reduction over every gradient
    (``precision.loss_scale.overflow_flag``) and one readback, where the
    bool is the API's answer."""

    def __init__(self, init_scale=2.0**16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        from ...precision.loss_scale import overflow_flag

        grads = _grads(params)
        if not grads:
            return False
        return bool(overflow_flag(grads))

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.loss_scale = max(self.loss_scale / self.scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable mixed precision: bfloat16 by default, float16 accepted
    (with a :class:`DynamicLossScaler`)."""
    if target_dtype in ("float16", np.float16):
        target_dtype = "float16"
    elif target_dtype not in ("bfloat16",):
        raise MXNetError(f"AMP target_dtype must be bfloat16 or float16, "
                         f"got {target_dtype}")
    _amp_state["initialized"] = True
    _amp_state["target_dtype"] = target_dtype
    if target_dtype == "float16":
        _amp_state["loss_scaler"] = DynamicLossScaler()
    else:
        _amp_state["loss_scaler"] = None  # bf16: f32's exponent range
    logging.info("AMP enabled with target dtype %s", target_dtype)


def init_trainer(trainer) -> None:
    """Attach AMP to a Trainer: f32 master weights (the optimizer's
    multi-precision path) and the loss scaler ``scale_loss`` reads."""
    if not _amp_state["initialized"]:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    trainer._optimizer.multi_precision = True
    trainer._amp_loss_scaler = _amp_state["loss_scaler"]


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Scale the loss for the backward.  bf16: the identity.  fp16:
    multiplies by the dynamic scale and sets the Trainer's ``_scale`` to
    its inverse, which ``Trainer.step``'s rescale divides back out; after
    the block, an overflow halves the scale and zeroes the gradients, so
    the step is a no-op."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    trainer._scale = 1.0 / scaler.loss_scale
    from ... import autograd as _ag

    # the multiply must join the graph even when scale_loss is used
    # outside the record scope
    prev = _ag.set_recording(True)
    try:
        if isinstance(loss, (list, tuple)):
            scaled = [l * scaler.loss_scale for l in loss]
        else:
            scaled = loss * scaler.loss_scale
    finally:
        _ag.set_recording(prev)
    yield scaled
    overflow = scaler.has_overflow(trainer._params)
    scaler.update_scale(overflow)
    if overflow:
        for param in trainer._params:
            param.zero_grad()


def unscale(trainer) -> None:
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for g in _grads(trainer._params):
        g.mul_(inv)


def convert_hybrid_block(block, target_dtype=None, target_dtype_ops=None,
                         fp32_ops=None, conditional_fp32_ops=None,
                         excluded_sym_names=None, ctx=None,
                         cast_optional_params=False):
    """Cast a HybridBlock's parameters (BatchNorm's running stats too) to
    the AMP dtype; the norm ops compute their moments in f32 whatever
    the input dtype."""
    dtype = target_dtype or _amp_state["target_dtype"] or "bfloat16"
    block.cast(dtype)
    return block


def convert_model(sym, arg_params, aux_params, target_dtype=None, **kwargs):
    """Cast a symbolic model's argument arrays (NDArrays or tensors) to the
    AMP dtype; the symbol and the aux arrays are returned as they are."""
    from ...ndarray.ndarray import NDArray, dtype_torch

    dtype = dtype_torch(target_dtype or _amp_state["target_dtype"]
                        or "bfloat16")
    new_args = {}
    for k, v in arg_params.items():
        new_args[k] = (NDArray(v._data.to(dtype), ctx=v.context)
                       if isinstance(v, NDArray) else v.to(dtype))
    return sym, new_args, dict(aux_params)
