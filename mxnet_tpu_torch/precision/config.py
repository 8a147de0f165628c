"""Serializable precision configuration: the AMP cast policy, the dynamic
loss-scale hyperparameters, and the :class:`PrecisionConfig` pair a
``DataParallelStep`` takes.

The port's own copy of ``mxnet_tpu/precision/config.py``, with the same
names, defaults, validation and JSON: the module is pure Python (base and
dataclasses only), because the op registry's dispatch hook and the
layers' call sites read the active policy on every call.

Op CLASSES get dispositions:

  * ``low``   -- compute in the target dtype (the matmul/conv families,
    which run on the tensor cores with f32 accumulation);
  * ``widen`` -- force f32 (softmax/norm/reduction families, whose 16-bit
    error compounds);
  * anything else passes through in whatever dtype arrives (torch's type
    promotion widens mixed operands, as jnp's does).

Env surface: ``MX_AMP`` turns the pass on (``bf16``/``bfloat16``/``1`` or
``fp16``/``float16``), ``MX_AMP_POLICY`` overrides the op lists as inline
JSON, ``MX_LOSS_SCALE`` configures the dynamic loss scaler (``dynamic``,
a fixed float, or ``0`` to disable; fp16 turns it on by default, bf16
leaves it off -- bf16 shares f32's exponent range).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

from ..base import MXNetError

__all__ = ["AmpPolicy", "LossScaleConfig", "PrecisionConfig",
           "DEFAULT_LOW_OPS", "DEFAULT_WIDEN_OPS"]

# matmul/conv compute classes: 16-bit inputs, f32 accumulation (fp16
# inputs accumulate in f32 in ops/nn.py, bf16 on the tensor cores)
DEFAULT_LOW_OPS: Tuple[str, ...] = (
    "FullyConnected", "Convolution", "Deconvolution",
    "dot", "batch_dot", "_contrib_flash_attention",
)

# numerically-sensitive classes: f32 inputs regardless of what arrives
# (reductions/softmax/norms — the reference AMP's FP32_FUNCS analog)
DEFAULT_WIDEN_OPS: Tuple[str, ...] = (
    "softmax", "log_softmax", "SoftmaxActivation", "SoftmaxOutput",
    "softmax_cross_entropy", "BatchNorm", "LayerNorm", "InstanceNorm",
    "GroupNorm", "L2Normalization", "norm", "sum", "sum_axis", "mean",
    "logsumexp", "exp", "log",
)

_AMP_DTYPES = ("bfloat16", "float16")


@dataclass(frozen=True)
class AmpPolicy:
    """Per-op-class cast policy of the graph-level AMP pass."""

    dtype: str = "bfloat16"
    low: Tuple[str, ...] = DEFAULT_LOW_OPS
    widen: Tuple[str, ...] = DEFAULT_WIDEN_OPS

    def __post_init__(self):
        if self.dtype not in _AMP_DTYPES:
            raise MXNetError(
                f"AmpPolicy: dtype must be one of {_AMP_DTYPES}, got "
                f"{self.dtype!r}")
        object.__setattr__(self, "low", tuple(self.low))
        object.__setattr__(self, "widen", tuple(self.widen))
        both = set(self.low) & set(self.widen)
        if both:
            raise MXNetError(
                f"AmpPolicy: ops {sorted(both)} appear in both the low and "
                f"widen lists — a policy must give each op ONE disposition")

    def op_class(self, op_name: str) -> Optional[str]:
        """'low' / 'widen' / None for one registered op name (the
        registry dispatch hook's single lookup)."""
        if op_name in self.low:
            return "low"
        if op_name in self.widen:
            return "widen"
        return None

    def signature(self) -> Tuple:
        """Hashable structural identity (executable fingerprints)."""
        return ("amp", self.dtype, self.low, self.widen)

    def to_json(self) -> dict:
        return {"dtype": self.dtype, "low": list(self.low),
                "widen": list(self.widen)}

    @classmethod
    def from_json(cls, rec: dict) -> "AmpPolicy":
        return cls(dtype=rec.get("dtype", "bfloat16"),
                   low=tuple(rec.get("low", DEFAULT_LOW_OPS)),
                   widen=tuple(rec.get("widen", DEFAULT_WIDEN_OPS)))


@dataclass(frozen=True)
class LossScaleConfig:
    """Dynamic loss scaling.  Every state transition runs on the device
    inside the step (``loss_scale.py``); these hyperparameters are host
    constants and join the step's signature.  ``dynamic=False`` pins
    ``init_scale`` forever (a static scale; skip-step protection still
    applies)."""

    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200
    dynamic: bool = True

    def __post_init__(self):
        if self.init_scale <= 0:
            raise MXNetError("LossScaleConfig: init_scale must be > 0")
        if self.growth_factor <= 1.0:
            raise MXNetError("LossScaleConfig: growth_factor must be > 1")
        if not (0.0 < self.backoff_factor < 1.0):
            raise MXNetError(
                "LossScaleConfig: backoff_factor must be in (0, 1)")
        if self.growth_interval < 1:
            raise MXNetError(
                "LossScaleConfig: growth_interval must be >= 1")

    def signature(self) -> Tuple:
        return ("loss_scale", self.init_scale, self.growth_factor,
                self.backoff_factor, self.growth_interval, self.dynamic)

    def to_json(self) -> dict:
        return {"init_scale": self.init_scale,
                "growth_factor": self.growth_factor,
                "backoff_factor": self.backoff_factor,
                "growth_interval": self.growth_interval,
                "dynamic": self.dynamic}

    @classmethod
    def from_json(cls, rec: dict) -> "LossScaleConfig":
        return cls(init_scale=float(rec.get("init_scale", 2.0 ** 15)),
                   growth_factor=float(rec.get("growth_factor", 2.0)),
                   backoff_factor=float(rec.get("backoff_factor", 0.5)),
                   growth_interval=int(rec.get("growth_interval", 200)),
                   dynamic=bool(rec.get("dynamic", True)))


@dataclass(frozen=True)
class PrecisionConfig:
    """The precision of a training step: the AMP policy (or None for
    full f32) and the loss-scale config (or None for unscaled)."""

    amp: Optional[AmpPolicy] = None
    loss_scale: Optional[LossScaleConfig] = None

    def signature(self) -> Tuple:
        return ("precision",
                self.amp.signature() if self.amp is not None else None,
                self.loss_scale.signature()
                if self.loss_scale is not None else None)

    def to_json(self) -> dict:
        return {
            "amp": self.amp.to_json() if self.amp is not None else None,
            "loss_scale": (self.loss_scale.to_json()
                           if self.loss_scale is not None else None),
        }

    @classmethod
    def from_json(cls, rec: Optional[dict]) -> Optional["PrecisionConfig"]:
        if rec is None:
            return None
        amp = rec.get("amp")
        ls = rec.get("loss_scale")
        return cls(amp=AmpPolicy.from_json(amp) if amp else None,
                   loss_scale=(LossScaleConfig.from_json(ls)
                               if ls else None))

    # -- env surface ---------------------------------------------------
    @classmethod
    def from_env(cls, environ=None) -> Optional["PrecisionConfig"]:
        """MX_AMP / MX_AMP_POLICY / MX_LOSS_SCALE -> a PrecisionConfig,
        or None when MX_AMP is unset/off.  Read ONCE at step
        construction (the policy is part of the step's identity;
        re-reading per step would let an env flip change a running
        step)."""
        environ = environ if environ is not None else os.environ
        raw = (environ.get("MX_AMP") or "").strip().lower()
        if raw in ("", "0", "false", "off"):
            return None
        if raw in ("1", "true", "on", "bf16", "bfloat16"):
            dtype = "bfloat16"
        elif raw in ("fp16", "float16"):
            dtype = "float16"
        else:
            raise MXNetError(
                f"MX_AMP={raw!r}: expected bf16/bfloat16/1 or fp16/float16 "
                f"(or 0/off)")
        pol_raw = (environ.get("MX_AMP_POLICY") or "").strip()
        if pol_raw:
            try:
                rec = json.loads(pol_raw)
            except ValueError as e:
                raise MXNetError(
                    f"MX_AMP_POLICY is not valid JSON ({e}); expected "
                    '{"low": [...], "widen": [...], "dtype": ...}')
            rec.setdefault("dtype", dtype)
            amp = AmpPolicy.from_json(rec)
        else:
            amp = AmpPolicy(dtype=dtype)
        ls_raw = (environ.get("MX_LOSS_SCALE") or "").strip().lower()
        if ls_raw in ("0", "false", "off", "none"):
            ls = None
        elif ls_raw in ("", "auto"):
            # fp16's 5-bit exponent underflows small grads without
            # scaling; bf16 shares f32's exponent range and needs none
            ls = LossScaleConfig() if dtype == "float16" else None
        elif ls_raw in ("1", "dynamic", "true", "on"):
            ls = LossScaleConfig()
        else:
            try:
                ls = LossScaleConfig(init_scale=float(ls_raw),
                                     dynamic=False)
            except ValueError:
                raise MXNetError(
                    f"MX_LOSS_SCALE={ls_raw!r}: expected 'dynamic', a "
                    f"fixed scale float, or 0/off") from None
        return cls(amp=amp, loss_scale=ls)
