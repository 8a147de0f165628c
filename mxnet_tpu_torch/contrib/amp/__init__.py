"""AMP for Gluon training scripts: ``init``, ``init_trainer``,
``scale_loss``, ``unscale``, ``convert_hybrid_block``, ``convert_model``
and ``DynamicLossScaler``, the counterpart of ``mxnet_tpu/contrib/amp``.

The working dtype is bfloat16 by default: it has f32's exponent range, so
no loss scaling is needed and ``scale_loss`` is the identity (kept so
MXNet scripts run unchanged).  float16 gets a real
:class:`DynamicLossScaler`.  A converted block's parameters are cast to
the target dtype; ``init_trainer`` turns on the optimizer's
multi-precision path (f32 master weights).
"""
from .amp import (init, init_trainer, scale_loss, unscale,
                  convert_hybrid_block, convert_model, DynamicLossScaler)

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "DynamicLossScaler"]
