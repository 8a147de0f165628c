"""Precision scopes: the one global each hot call site consults.

Counterpart of ``mxnet_tpu/precision/runtime.py``.  Two scopes live here
because their consumers sit on the hottest paths of the package (the op
registry's dispatch, the layers' forwards) and pay one module-global read
when precision is off:

  * :func:`amp_scope` -- while active, :func:`cast_inputs` applies the
    AMP cast policy: ``low``-class ops get their f32 float inputs cast
    down to the policy dtype, ``widen``-class ops get their 16-bit float
    inputs cast up to f32.  The JAX package applies it at one point, the
    registry's dispatch, which every JAX layer goes through.  The port's
    layers and models call torch directly, so the policy is applied at
    the registry (:class:`_AmpHook`, through the pass pipeline's hooks)
    AND at each call site that stands for a registry op of the two
    lists: ``gluon.nn.Dense`` and ``ops.nn.fully_connected``
    (``FullyConnected``), ``ops.nn.convolution`` (``Convolution``), the
    masked attention's ``bmm`` and ``softmax`` (``batch_dot``,
    ``softmax``), ``flash_attention`` (``_contrib_flash_attention``),
    ``gluon.nn.LayerNorm`` (``LayerNorm``), ``ops.nn.batch_norm``
    (``BatchNorm``) and ``gluon.loss.log_softmax`` (``log_softmax``).
    A cast is idempotent, so a registry call that reaches a cast site
    casts once.
  * :func:`quant_scope` -- while active, :func:`quant_entry` resolves a
    Dense/Conv2D layer to its quantized twin (``precision/quantize.py``);
    the layer's forward then runs the twin.

Scopes nest and restore; they are set around a forward by one thread.
"""
from __future__ import annotations

import contextlib

import torch

from ..passes import hooks as _hooks

__all__ = ["amp_scope", "amp_active", "cast_inputs", "quant_scope",
           "quant_entry"]

_AMP_POLICY = None   # the active AmpPolicy, or None (the fast-path check)
_QUANT_MAP = None    # the active {id(layer): twin}, or None

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _AmpHook(_hooks.OpHook):
    """The AMP pass's dispatch hook: the policy's casts on one registry
    call's NDArray inputs."""

    def rewrite_inputs(self, op_name, inputs):
        tensors = [x._data for x in inputs]
        cast = cast_inputs(op_name, *tensors)
        if all(a is b for a, b in zip(cast, tensors)):
            return inputs
        from .. import autograd
        from ..ndarray.ndarray import NDArray

        if autograd.is_recording():
            # the originals enter the graph here, not at the op
            autograd.register_leaves(inputs)
        return [x if t is x._data else NDArray(t, ctx=x.context)
                for x, t in zip(inputs, cast)]


_AMP_HOOK = _AmpHook()


def amp_active() -> bool:
    return _AMP_POLICY is not None


@contextlib.contextmanager
def amp_scope(policy):
    """Activate ``policy`` (an :class:`~mxnet_tpu_torch.precision.config.
    AmpPolicy`) for the ops called inside the block."""
    global _AMP_POLICY
    prev = _AMP_POLICY
    _AMP_POLICY = policy
    try:
        with _hooks.op_hook(_AMP_HOOK):
            yield
    finally:
        _AMP_POLICY = prev


def cast_inputs(op_name: str, *tensors):
    """The active policy applied to one op call's tensors: a tuple of the
    same length, each floating tensor cast as the op's class says (None
    and non-floating entries pass through).  With no policy active it is
    one global read and returns ``tensors`` itself."""
    policy = _AMP_POLICY
    if policy is None:
        return tensors
    cls = policy.op_class(op_name)
    if cls is None:
        return tensors
    low = _TORCH_DTYPES[policy.dtype]
    if cls == "low":
        src, dst = torch.float32, low
    else:  # widen
        src, dst = low, torch.float32
    return tuple(t.to(dst) if t is not None and t.dtype == src else t
                 for t in tensors)


@contextlib.contextmanager
def quant_scope(mapping):
    """Activate a {id(layer): twin} mapping for the layers called inside
    the block (a quantized serving adapter's prefill and decode)."""
    global _QUANT_MAP
    prev = _QUANT_MAP
    _QUANT_MAP = mapping
    try:
        yield
    finally:
        _QUANT_MAP = prev


def quant_entry(layer):
    """The active quantized twin of ``layer``, or None (one global read
    when quantization is off)."""
    m = _QUANT_MAP
    if m is None:
        return None
    return m.get(id(layer))
