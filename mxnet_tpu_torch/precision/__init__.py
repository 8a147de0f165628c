"""The precision subsystem of the port: graph-level AMP, dynamic loss
scaling on the device, and calibrated int8 / weight-only int4 serving.

Counterpart of ``mxnet_tpu/precision/``, with its names:

  * ``amp_pass`` -- the cast policy (per-op-class dispositions carried by
    a serializable :class:`~mxnet_tpu_torch.precision.config.AmpPolicy`)
    applied during ``DataParallelStep``'s forward;
  * ``loss_scale`` -- the dynamic loss-scale state machine as device
    tensors inside the step (non-finite steps select the old state; no
    host readback);
  * ``quantize`` -- post-training int8 (calibrated) and int4 (weight
    only) serving adapters over ``ops/quantization.py``.

Env surface: MX_AMP, MX_AMP_POLICY, MX_LOSS_SCALE, MX_QUANTIZE,
MX_QUANT_CALIB, MX_SERVE_INT4, MX_QUANT_GROUP (the rewrites are
registered graph passes: ``passes/builtin.py``).
"""
from .config import (AmpPolicy, LossScaleConfig, PrecisionConfig,
                     DEFAULT_LOW_OPS, DEFAULT_WIDEN_OPS)
from .amp_pass import apply_amp
from .runtime import amp_scope, quant_scope, quant_entry
from . import loss_scale
from .quantize import (QuantizedAdapter, quantize_adapter,
                       maybe_quantize_adapter, Int4WeightAdapter,
                       int4_adapter, maybe_int4_adapter)

__all__ = ["AmpPolicy", "LossScaleConfig", "PrecisionConfig",
           "DEFAULT_LOW_OPS", "DEFAULT_WIDEN_OPS", "apply_amp",
           "amp_scope", "quant_scope", "quant_entry", "loss_scale",
           "QuantizedAdapter", "quantize_adapter",
           "maybe_quantize_adapter", "Int4WeightAdapter",
           "int4_adapter", "maybe_int4_adapter"]
