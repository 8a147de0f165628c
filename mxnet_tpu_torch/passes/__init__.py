"""Graph pass pipeline of the port.

Counterpart of ``mxnet_tpu/passes/``: named, toggleable :class:`GraphPass`
objects in an ordered :class:`PassPipeline` with one shared
``signature()``/``fingerprint()``, over the single op dispatch point
(``ops/registry._invoke_impl``), which reads one module global,
``hooks._OP_HOOKS``.  The catalog holds ``fused_kernels`` only.

Environment: MX_PASSES (toggles), MX_PALLAS_FUSED (the fused-kernel
pass).
"""
from . import hooks
from .pipeline import (GraphPass, PassPipeline, apply_env_toggles,
                       available_passes, fingerprint, register_pass_type,
                       resolve_pass_type)
from .builtin import (FusedKernelPass, fused_kernels_from_env,
                      pipeline_for_serving, pipeline_for_training)

__all__ = ["GraphPass", "PassPipeline", "register_pass_type",
           "available_passes", "resolve_pass_type", "apply_env_toggles",
           "fingerprint", "FusedKernelPass", "fused_kernels_from_env",
           "pipeline_for_training", "pipeline_for_serving", "hooks"]
