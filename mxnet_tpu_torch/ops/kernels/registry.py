"""Fused-kernel registry: kernels keyed by op-class and platform.

Counterpart of ``mxnet_tpu/ops/pallas/registry.py``.  Each entry maps a
registered op name (the op-class, ``ops/registry.py``) to a function with
the op's calling convention that runs a hand-written kernel, tagged with
the platforms it may substitute on.  The ``fused_kernels`` pass
(``passes/builtin.FusedKernelPass``) asks :func:`substitution` at the
dispatch point and swaps the op's implementation in.

The platform is the device type of the op's inputs.  Every entry takes
``("cpu", "cuda")``: on CUDA tensors the kernel runs, on CPU tensors its
plain version (the wrappers decide by device).

Catalog, as the JAX package's: ``LayerNorm`` (K1), ``_contrib_add_layer_norm``
(K6) and ``_contrib_flash_attention`` (K3-K5).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ...base import MXNetError

__all__ = ["register_kernel", "registered_ops", "substitution",
           "KernelEntry"]


class KernelEntry:
    __slots__ = ("op_name", "platforms", "fn")

    def __init__(self, op_name: str, platforms: Tuple[str, ...],
                 fn: Callable):
        self.op_name = op_name
        self.platforms = tuple(platforms)
        self.fn = fn


_KERNELS: Dict[str, KernelEntry] = {}


def register_kernel(op_name: str,
                    platforms: Tuple[str, ...] = ("cpu", "cuda")):
    """Decorator: register ``fn`` as the fused substitute for ``op_name``
    on ``platforms``.  ``fn`` must take the op's arrays and attributes
    exactly: the pass swaps it in blind."""

    def deco(fn: Callable) -> Callable:
        if op_name in _KERNELS:
            raise MXNetError(
                f"fused kernel for op {op_name!r} registered twice")
        _KERNELS[op_name] = KernelEntry(op_name, platforms, fn)
        return fn

    return deco


def registered_ops():
    return sorted(_KERNELS)


def _default_platform() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def substitution(op_name: str,
                 platform: Optional[str] = None) -> Optional[Callable]:
    """The kernel to substitute for ``op_name`` on ``platform`` (default:
    ``cuda`` when a card is present, else ``cpu``), or None."""
    entry = _KERNELS.get(op_name)
    if entry is None:
        return None
    plat = platform if platform is not None else _default_platform()
    return entry.fn if plat in entry.platforms else None


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------
@register_kernel("LayerNorm")
def _layer_norm_sub(data, gamma, beta, axis=-1, eps=1e-5,
                    output_mean_var=False):
    # the kernel is row-wise over the last axis; other attributes keep the
    # stock implementation (which returns mean/var and takes any axis)
    if output_mean_var or axis not in (-1, data.dim() - 1) or data.dim() < 2:
        from ..registry import get_op

        return get_op("LayerNorm").fn(data, gamma, beta, axis=axis, eps=eps,
                                      output_mean_var=output_mean_var)
    from .layer_norm import LayerNormFunction

    c = data.shape[-1]
    out = LayerNormFunction.apply(data.reshape(-1, c).contiguous(), gamma,
                                  beta, eps)
    return out.reshape(data.shape)


@register_kernel("_contrib_add_layer_norm")
def _add_layer_norm_sub(data, residual, gamma, beta, eps=1e-5):
    from .layer_norm import AddLayerNormFunction

    c = data.shape[-1]
    out = AddLayerNormFunction.apply(data.reshape(-1, c).contiguous(),
                                     residual.reshape(-1, c).contiguous(),
                                     gamma, beta, eps)
    return out.reshape(data.shape)


@register_kernel("_contrib_flash_attention")
def _flash_attention_sub(q, k, v, causal=False, sm_scale=None):
    from .flash_attention import flash_attention

    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, sm_scale=sm_scale)
