"""The built-in pass catalog of the port.

Counterpart of ``mxnet_tpu/passes/builtin.py``, with its pass names and
signatures:

  * ``amp`` -- the AMP cast policy (``precision/amp_pass.apply_amp``);
  * ``quant_int8`` -- calibrated int8 serving (``precision/quantize.py``);
  * ``quant_int4`` -- weight-only int4 serving;
  * ``fused_kernels`` -- substitute the registered kernels
    (``ops/kernels/registry.py``) for their op-class at the dispatch
    point.

And the pipeline factories: :func:`pipeline_for_training` (from a
``PrecisionConfig`` and MX_PALLAS_FUSED) and :func:`pipeline_for_serving`
(the adapter's passes and MX_PALLAS_FUSED), both subject to MX_PASSES.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

from ..base import MXNetError
from . import hooks
from .pipeline import (GraphPass, PassPipeline, apply_env_toggles,
                       register_pass_type)

__all__ = ["AmpPass", "QuantizeInt8Pass", "QuantizeInt4Pass",
           "FusedKernelPass", "fused_kernels_from_env",
           "pipeline_for_training", "pipeline_for_serving"]


@register_pass_type
class AmpPass(GraphPass):
    """AMP as a pipeline pass: low-class ops take policy-dtype inputs,
    widen-class ops f32, block outputs widen at the boundary
    (``precision/amp_pass.apply_amp``)."""

    name = "amp"

    def __init__(self, policy, enabled: bool = True):
        super().__init__(enabled=enabled)
        if policy is None:
            raise MXNetError("AmpPass: policy must be an AmpPolicy (a "
                             "policy-less pass is just absent — don't add "
                             "it to the pipeline)")
        self.policy = policy

    def signature(self) -> Tuple:
        return self.policy.signature()

    def scope(self):
        from ..precision.runtime import amp_scope

        return amp_scope(self.policy)

    def wrap_apply(self, apply_fn):
        from ..precision.amp_pass import apply_amp

        return apply_amp(apply_fn, self.policy)

    def config_json(self) -> dict:
        return {"policy": self.policy.to_json()}

    @classmethod
    def from_config(cls, rec: dict) -> "AmpPass":
        from ..precision.config import AmpPolicy

        return cls(AmpPolicy.from_json(rec.get("policy") or {}))


class _QuantPassBase(GraphPass):
    """The serving quant passes: a {id(layer): twin} map activated through
    ``runtime.quant_scope`` (``gluon.nn.Dense``/``Conv2D`` consult it),
    with a restart-stable per-layer signature.  ``from_config`` rebuilds
    a descriptor (same signature, no twins); entering its scope raises,
    because twins hold device buffers only the live model can make."""

    def __init__(self, entries, layer_sig: Tuple, enabled: bool = True):
        super().__init__(enabled=enabled)
        self._entries = entries
        self._layer_sig = tuple(layer_sig)

    def scope(self):
        if self._entries is None:
            raise MXNetError(
                f"{self.name}: descriptor-only pass (rebuilt from JSON) "
                "cannot activate — quantized twins hold device buffers; "
                "re-quantize the live adapter instead")
        from ..precision.runtime import quant_scope

        return quant_scope(self._entries)


@register_pass_type
class QuantizeInt8Pass(_QuantPassBase):
    """Calibrated int8 serving: the scope maps Dense/Conv2D layers onto
    their int8 twins inside the adapter's prefill and decode."""

    name = "quant_int8"

    def __init__(self, entries, calib_mode: str, layer_sig: Tuple,
                 enabled: bool = True):
        super().__init__(entries, layer_sig, enabled=enabled)
        self.calib_mode = calib_mode

    def signature(self) -> Tuple:
        return ("int8", self.calib_mode, self._layer_sig)

    def config_json(self) -> dict:
        return {"calib_mode": self.calib_mode,
                "layers": [list(e) for e in self._layer_sig]}

    @classmethod
    def from_config(cls, rec: dict) -> "QuantizeInt8Pass":
        return cls(None, rec.get("calib_mode", "naive"),
                   tuple(tuple(e) for e in rec.get("layers", ())))


@register_pass_type
class QuantizeInt4Pass(_QuantPassBase):
    """Weight-only int4 serving: Dense/Conv2D weights packed two per byte
    with group-wise scales (MX_QUANT_GROUP), dequantized at each call."""

    name = "quant_int4"

    def __init__(self, entries, group_size: int, layer_sig: Tuple,
                 enabled: bool = True):
        super().__init__(entries, layer_sig, enabled=enabled)
        self.group_size = int(group_size)

    def signature(self) -> Tuple:
        return ("int4", self.group_size, self._layer_sig)

    def config_json(self) -> dict:
        return {"group_size": self.group_size,
                "layers": [list(e) for e in self._layer_sig]}

    @classmethod
    def from_config(cls, rec: dict) -> "QuantizeInt4Pass":
        return cls(None, int(rec.get("group_size", 32)),
                   tuple(tuple(e) for e in rec.get("layers", ())))


@register_pass_type
class FusedKernelPass(GraphPass, hooks.OpHook):
    """Substitute registered kernels for their op-class at the dispatch
    point.  The pass is its own dispatch hook: ``_invoke_impl`` asks
    ``substitute(op_name, attrs, platform)`` and swaps the op's
    implementation when the registry carries a kernel for the op-class on
    the platform of the op's inputs.  Disabled or absent, dispatch is
    untouched."""

    name = "fused_kernels"

    def __init__(self, ops: Optional[Iterable[str]] = None,
                 enabled: bool = True):
        super().__init__(enabled=enabled)
        # None = every registered kernel, resolved now so later registry
        # growth cannot change a live pass's identity
        if ops is None:
            from ..ops.kernels import registry as kreg

            ops = kreg.registered_ops()
        self._ops = tuple(sorted(ops))

    def signature(self) -> Tuple:
        return ("fused", self._ops)

    def scope(self):
        return hooks.op_hook(self)

    def substitute(self, op_name, attrs, platform=None):
        if op_name not in self._ops:
            return None
        from ..ops.kernels import registry as kreg

        return kreg.substitution(op_name, platform)

    def config_json(self) -> dict:
        return {"ops": list(self._ops)}

    @classmethod
    def from_config(cls, rec: dict) -> "FusedKernelPass":
        ops = rec.get("ops")
        return cls(ops=tuple(ops) if ops is not None else None)


def fused_kernels_from_env(environ=None) -> Optional[FusedKernelPass]:
    """MX_PALLAS_FUSED: ``auto`` (default) turns the pass on where the
    kernels run natively, i.e. when ``torch.cuda.is_available()``; ``1``
    forces it (the CPU takes the plain versions); ``0`` keeps the stock
    op implementations.  Any other value raises."""
    environ = environ if environ is not None else os.environ
    raw = (environ.get("MX_PALLAS_FUSED") or "auto").strip().lower()
    if raw in ("0", "false", "off"):
        return None
    if raw in ("1", "true", "on"):
        return FusedKernelPass()
    if raw != "auto":
        raise MXNetError(
            f"MX_PALLAS_FUSED={raw!r}: expected auto, 1/on, or 0/off")
    import torch

    return FusedKernelPass() if torch.cuda.is_available() else None


def pipeline_for_training(precision=None, environ=None) -> PassPipeline:
    """The training pipeline: the precision config's AMP policy (when
    set), then fused-kernel substitution when MX_PALLAS_FUSED resolves
    on, then MX_PASSES toggles.  With neither, the pipeline is empty and
    ``wrap_apply`` is the identity."""
    passes = []
    if precision is not None and precision.amp is not None:
        passes.append(AmpPass(precision.amp))
    fused = fused_kernels_from_env(environ)
    if fused is not None:
        passes.append(fused)
    return apply_env_toggles(PassPipeline(passes), environ)


def pipeline_for_serving(adapter=None, environ=None) -> PassPipeline:
    """The serving pipeline: the adapter's own passes (``adapter.passes``)
    then fused-kernel substitution, then MX_PASSES toggles."""
    passes = list(getattr(adapter, "passes", ()) or ())
    fused = fused_kernels_from_env(environ)
    if fused is not None:
        passes.append(fused)
    return apply_env_toggles(PassPipeline(passes), environ)
