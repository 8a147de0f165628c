"""The built-in pass catalog of the port: the ``fused_kernels`` pass.

Counterpart of ``mxnet_tpu/passes/builtin.py`` limited to
:class:`FusedKernelPass`, which substitutes the registered kernels
(``ops/kernels/registry.py``) for their op-class at the dispatch point,
and the pipeline factories built from it.  ``amp``, ``quant_int8`` and
``quant_int4`` wait for the port of ``precision/``.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

from ..base import MXNetError
from . import hooks
from .pipeline import (GraphPass, PassPipeline, apply_env_toggles,
                       register_pass_type)

__all__ = ["FusedKernelPass", "fused_kernels_from_env",
           "pipeline_for_training", "pipeline_for_serving"]


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
    """The training pipeline: fused-kernel substitution when
    MX_PALLAS_FUSED resolves on, then MX_PASSES toggles.  A precision
    config with an AMP policy raises: the ``amp`` pass is not ported."""
    if precision is not None and getattr(precision, "amp", None) is not None:
        raise MXNetError("pipeline_for_training: the amp pass is not ported "
                         "to mxnet_tpu_torch yet")
    passes = []
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
