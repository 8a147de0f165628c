"""The graph-level AMP pass: apply a cast policy to a block apply.

Counterpart of ``mxnet_tpu/precision/amp_pass.py``.  Where
``contrib.amp`` casts PARAMETERS (``block.cast('bfloat16')``, after
which every op runs in bf16), this pass applies the policy per op class
during the forward that ``DataParallelStep`` runs (``runtime.
cast_inputs`` at each call site and at the registry's dispatch):

  * ``low``-class ops (matmul/conv) take their f32 float inputs cast to
    the policy dtype: the parameters stay f32 master copies;
  * ``widen``-class ops (softmax/norm/reductions) take any 16-bit float
    inputs cast back to f32;
  * block outputs are cast to f32 at the boundary, so the loss and its
    gradient seed are f32.

With no policy the apply is returned unchanged: the AMP-off step is bit
for bit the step without the pass.
"""
from __future__ import annotations

import torch

from .config import AmpPolicy, LossScaleConfig, PrecisionConfig
from .runtime import amp_scope

__all__ = ["apply_amp", "amp_scope", "AmpPolicy", "LossScaleConfig",
           "PrecisionConfig"]


def _widen(t):
    return (t.float() if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.dtype != torch.float32 else t)


def apply_amp(apply_fn, policy: AmpPolicy):
    """Wrap a ``fn(params, key, *inputs) -> (out_or_list, aux)`` block
    apply so that it runs under ``policy``, with f32 outputs at the
    boundary.  Identity when ``policy`` is None."""
    if policy is None:
        return apply_fn

    def amp_apply(params, key, *inputs):
        with amp_scope(policy):
            out, aux = apply_fn(params, key, *inputs)
        if isinstance(out, list):
            out = [_widen(o) for o in out]
        else:
            out = _widen(out)
        return out, aux

    return amp_apply
