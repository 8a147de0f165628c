"""Quantized serving: calibrated int8 and weight-only int4 twins of the
Dense/Conv2D layers inside the serving engine's prefill and decode.

Counterpart of ``mxnet_tpu/precision/quantize.py``.  A
:class:`QuantizedAdapter` wraps any :class:`~mxnet_tpu_torch.serving.
engine.ServingAdapter` whose ``.model`` is a Gluon block: its
``prefill``/``decode``/``decode_logits`` run the wrapped adapter's bodies
under the ``quant_int8`` pass's scope (:func:`runtime.quant_scope`), in
which every selected ``gluon.nn.Dense``/``Conv2D`` runs its int8 twin
(``contrib.quantization.QuantizedDense``/``QuantizedConv2D``: quantize the
input with the calibrated threshold, the exact int8 product, dequantize).
The weights are quantized once, at construction, into int8 device
buffers.  Activation thresholds come from :func:`calibrate`, which
observes each layer's input through forward pre-hooks over
representative eager forwards (a greedy ``translate`` for seq2seq
serving), as ``quantize_net`` does.

:class:`Int4WeightAdapter` is weight-only int4: each selected weight is
packed two per byte with group-wise f16 scales (``MX_QUANT_GROUP``) and
dequantized at each call; activations stay f32, so there is no
calibration.

Layer selection (:func:`collect_quantizable`) walks the module tree as the
JAX function walks ``_children`` (the same paths, e.g.
``encoder.layers.0.attn.qkv``): every Dense, and every NCHW Conv2D.
Transformer-big's tied output projection is no Dense, so it stays f32.
The quant and weight buffers register under the ``quantized`` memwatch
category.

Env surface: ``MX_QUANTIZE`` (``int8`` on, ``0``/unset off) with
``MX_QUANT_CALIB`` (``naive``/``entropy``, default naive) drives
:func:`maybe_quantize_adapter`; ``MX_SERVE_INT4`` (``1``/``int4`` on)
with ``MX_QUANT_GROUP`` (default 32, even) drives
:func:`maybe_int4_adapter`.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..base import MXNetError

__all__ = ["QuantizedAdapter", "quantize_adapter", "maybe_quantize_adapter",
           "Int4WeightAdapter", "int4_adapter", "maybe_int4_adapter",
           "collect_quantizable", "calibrate"]


def _calib_tools():
    from ..contrib import quantization as cq

    return cq


def collect_quantizable(block, exclude: Iterable[str] = ()) -> List[Tuple]:
    """[(path, layer)] for every Dense/Conv2D reachable from ``block``,
    depth first, any container shape (the serving rewrite never replays
    children, so composite blocks are safe)."""
    from ..gluon import nn as gnn

    exclude = set(exclude or ())
    out: List[Tuple] = []

    def walk(blk, path):
        for key, child in blk._modules.items():
            if child is None:
                continue
            p = f"{path}.{key}" if path else str(key)
            if isinstance(child, gnn.Conv2D):
                # the quantized convolution is NC-first; a channel-last
                # conv stays f32, as in the JAX package
                if not child.channel_last and p not in exclude \
                        and child.name not in exclude:
                    out.append((p, child))
            elif isinstance(child, gnn.Dense):
                if p not in exclude and child.name not in exclude:
                    out.append((p, child))
            else:
                walk(child, p)

    walk(block, "")
    return out


def calibrate(layers: List[Tuple], calib_data, calib_fn: Callable,
              calib_mode: str = "naive",
              num_calib_batches: Optional[int] = None,
              root=None) -> Dict[str, float]:
    """Observe each layer's input over ``calib_data`` -> {path: threshold}.
    ``calib_fn(batch)`` runs one representative eager forward; forward
    pre-hooks on the layers feed the calibrator.  With ``root`` (the block
    ``calib_fn`` runs), hybridized blocks under it are switched off for
    the pass and back on after, as the JAX function does."""
    from .. import autograd

    if calib_mode not in ("naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r} "
                         "(naive/entropy)")
    cq = _calib_tools()
    calib = cq._Calibrator(calib_mode)
    handles = cq._hook_layers(calib, layers)
    hybridized = cq._active_blocks(root, []) if root is not None else []
    for b in hybridized:
        b._active = False
    try:
        with autograd.pause(), torch.no_grad():
            for i, batch in enumerate(calib_data):
                calib_fn(batch)
                if num_calib_batches and i + 1 >= num_calib_batches:
                    break
    finally:
        for h in handles:
            h.remove()
        for b in hybridized:
            b._active = True
    thresholds = {}
    for path, _layer in layers:
        t = calib.threshold(path)
        cq.check_calibrated_threshold(path, calib_mode,
                                      calib.minmax[path], t)
        thresholds[path] = t
    return thresholds


class _TracedTwin:
    """The int8 twin of one Dense/Conv2D as the serving rewrite calls it,
    ``twin(x, bias)``, ``bias`` the layer's own parameter (the snapshot
    zeros of a bias-less layer otherwise), with the layer path, its
    thresholds and byte accounting."""

    def __init__(self, impl, path: str, act_thresh: Optional[float]):
        self._impl = impl
        self.path = path
        self.act_thresh = act_thresh
        self._w_thresh = impl._w_thresh
        self.orig_nbytes = impl.orig_nbytes
        self.nbytes = impl.nbytes

    def arrays(self):
        i = self._impl
        return [i._qweight, i._w_min, i._w_max]

    def __call__(self, x, bias):
        return self._impl._forward(
            x, bias if bias is not None else self._impl._bias)


class _Int4Twin:
    """The int4 twin of one Dense/Conv2D: the weight-only impl with the
    layer path, a digest of the packed buffers (the signature part; a
    weight-only path has no thresholds) and byte accounting."""

    def __init__(self, impl, path: str):
        self._impl = impl
        self.path = path
        h = hashlib.sha256()
        h.update(impl._packed.cpu().numpy().tobytes())
        h.update(impl._scales.cpu().numpy().tobytes())
        self.digest = h.hexdigest()[:16]
        self.orig_nbytes = impl.orig_nbytes
        self.nbytes = impl.nbytes

    def arrays(self):
        i = self._impl
        return [i._packed, i._scales]

    def __call__(self, x, bias):
        return self._impl._forward(
            x, bias if bias is not None else self._impl._bias)


def _quantized_arrays(adapter):
    """memwatch provider: the quantized weight buffers and their range or
    scale tensors (the ``quantized`` census category)."""
    out = []
    for entry in adapter._entries.values():
        out.extend(entry.arrays())
    return out


def _param_bytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


class _RewriteAdapterBase:
    """The shared shell of the quantized serving adapters: mirror the
    wrapped adapter's interface facts, register the census, and run its
    bodies under ``self._pass``'s scope.  Subclasses build ``_inner``,
    ``_entries``/``_by_path`` and ``_pass``, then call
    ``_init_common``."""

    def _init_common(self, inner):
        from .. import memwatch

        self.uses_pages = inner.uses_pages
        self.num_layers = inner.num_layers
        self.num_heads = inner.num_heads
        self.head_dim = inner.head_dim
        # the engine builds its pass pipeline from this
        # (passes.pipeline_for_serving reads adapter.passes)
        self.passes = (self._pass,)
        memwatch.register("quantized", self, _quantized_arrays)

    @staticmethod
    def _resolve_model(inner, who: str):
        model = getattr(inner, "model", None)
        if model is None:
            raise MXNetError(
                f"{who}: the wrapped adapter exposes no .model to "
                "quantize (an adapter around a logits function owns no "
                "layer tree: quantize the underlying block and wrap that)")
        return model

    # -- identity ------------------------------------------------------
    @property
    def model(self):
        return self._inner.model

    def quant_signature(self) -> Tuple:
        """The quantization config's structural identity: the pass's
        signature."""
        return self._pass.signature()

    # -- params accounting ---------------------------------------------
    def quantized_param_bytes(self) -> int:
        """Bytes of the weights as the quantized program holds them:
        int8 or packed for the rewritten layers' weights, their own dtype
        for everything else (biases, norms, embeddings, excluded
        layers)."""
        rewritten = {id(layer.weight)
                     for _path, layer in collect_quantizable(self.model)
                     if id(layer) in self._entries}
        total = sum(e.nbytes for e in self._entries.values())
        for p in self.model.parameters():
            if id(p) not in rewritten:
                total += _param_bytes(p)
        return total

    def fp32_param_bytes(self) -> int:
        return sum(_param_bytes(p) for p in self.model.parameters())

    def quantized_weight_bytes(self) -> int:
        """Bytes of just the rewritten layers' weights as the quantized
        program holds them."""
        return sum(e.nbytes for e in self._entries.values())

    def fp32_weight_bytes(self) -> int:
        """Original bytes of just the rewritten layers' weights."""
        return sum(e.orig_nbytes for e in self._entries.values())

    # -- the delegated interface ---------------------------------------
    def extra_state(self, slots, device, dtype=torch.float32):
        return self._inner.extra_state(slots, device, dtype)

    def prefill_src(self, request):
        return self._inner.prefill_src(request)

    def prefill(self, src):
        with self._pass.scope():
            return self._inner.prefill(src)

    def install(self, state, slot, request):
        return self._inner.install(state, slot, request)

    def validate(self, request):
        return self._inner.validate(request)

    def max_positions(self):
        return self._inner.max_positions()

    def decode(self, tok, pos, table, pages, rows, lengths, extra, pools):
        with self._pass.scope():
            return self._inner.decode(tok, pos, table, pages, rows,
                                      lengths, extra, pools)

    def decode_logits(self, tok, pos, table, pages, rows, lengths, extra,
                      pools):
        with self._pass.scope():
            return self._inner.decode_logits(tok, pos, table, pages, rows,
                                             lengths, extra, pools)

    def advance_extra(self, extra, nxt, pos):
        with self._pass.scope():
            return self._inner.advance_extra(extra, nxt, pos)


class QuantizedAdapter(_RewriteAdapterBase):
    """Int8 twin of a ServingAdapter (see the module docstring).  Build it
    with :func:`quantize_adapter` (calibrated); this constructor takes
    thresholds already computed, by path."""

    precision = "int8"

    def __init__(self, inner, thresholds: Dict[str, Optional[float]],
                 calib_mode: str = "naive",
                 exclude: Iterable[str] = ()):
        from ..gluon import nn as gnn
        from ..passes.builtin import QuantizeInt8Pass

        cq = _calib_tools()
        model = self._resolve_model(inner, "QuantizedAdapter")
        self._inner = inner
        self._calib_mode = calib_mode
        self._entries: Dict[int, object] = {}
        self._by_path: Dict[str, object] = {}
        for path, layer in collect_quantizable(model, exclude):
            if path not in thresholds:
                raise MXNetError(
                    f"QuantizedAdapter: no calibration threshold for "
                    f"layer {path!r} (calibrate observed a different "
                    f"layer set?)")
            impl_cls = (cq.QuantizedConv2D if isinstance(layer, gnn.Conv2D)
                        else cq.QuantizedDense)
            twin = _TracedTwin(impl_cls(layer, thresholds[path]),
                               path, thresholds[path])
            self._entries[id(layer)] = twin
            self._by_path[path] = twin
        if not self._entries:
            raise MXNetError(
                "QuantizedAdapter: no quantizable Dense/Conv2D layers "
                "found in the wrapped adapter's model")
        per_layer = tuple(sorted(
            (path, round(e._w_thresh, 8),
             round(e.act_thresh, 8) if e.act_thresh is not None else None)
            for path, e in self._by_path.items()))
        self._pass = QuantizeInt8Pass(self._entries, calib_mode, per_layer)
        self._init_common(inner)


class Int4WeightAdapter(_RewriteAdapterBase):
    """Weight-only int4 twin of a ServingAdapter: about 0.14x the weight
    bytes at the default group of 32, no calibration.  Build it with
    :func:`int4_adapter` / :func:`maybe_int4_adapter`."""

    precision = "int4"

    def __init__(self, inner, group_size: int = 32,
                 exclude: Iterable[str] = ()):
        from ..gluon import nn as gnn
        from ..passes.builtin import QuantizeInt4Pass

        cq = _calib_tools()
        model = self._resolve_model(inner, "Int4WeightAdapter")
        self._inner = inner
        self._group_size = int(group_size)
        self._entries: Dict[int, object] = {}
        self._by_path: Dict[str, object] = {}
        for path, layer in collect_quantizable(model, exclude):
            impl = (cq.Int4Conv2D(layer, self._group_size)
                    if isinstance(layer, gnn.Conv2D)
                    else cq.Int4Dense(layer, self._group_size))
            twin = _Int4Twin(impl, path)
            self._entries[id(layer)] = twin
            self._by_path[path] = twin
        if not self._entries:
            raise MXNetError(
                "Int4WeightAdapter: no quantizable Dense/Conv2D layers "
                "found in the wrapped adapter's model")
        per_layer = tuple(sorted(
            (path, e.digest) for path, e in self._by_path.items()))
        self._pass = QuantizeInt4Pass(self._entries, self._group_size,
                                      per_layer)
        self._init_common(inner)


def quantize_adapter(adapter, calib_data, calib_fn: Callable,
                     calib_mode: str = "naive",
                     exclude: Iterable[str] = (),
                     num_calib_batches: Optional[int] = None
                     ) -> QuantizedAdapter:
    """Calibrate and wrap: an int8 serving adapter in one call.
    ``calib_fn(batch)`` runs one representative eager forward per
    calibration batch (a greedy ``translate`` over prompts for seq2seq
    serving)."""
    model = getattr(adapter, "model", None)
    if model is None:
        raise MXNetError("quantize_adapter: adapter exposes no .model")
    layers = collect_quantizable(model, exclude)
    if not layers:
        raise MXNetError("quantize_adapter: no quantizable Dense/Conv2D "
                         "layers in the adapter's model")
    thresholds = calibrate(layers, calib_data, calib_fn,
                           calib_mode=calib_mode,
                           num_calib_batches=num_calib_batches,
                           root=model)
    return QuantizedAdapter(adapter, thresholds, calib_mode=calib_mode,
                            exclude=exclude)


def _env_off(name: str) -> bool:
    return (os.environ.get(name) or "").strip().lower() in \
        ("", "0", "false", "off")


def maybe_quantize_adapter(adapter, calib_data=None, calib_fn=None,
                           exclude: Iterable[str] = ()):
    """The env gate: ``MX_QUANTIZE=int8`` (or ``1``) quantizes ``adapter``
    with the ``MX_QUANT_CALIB`` mode (default naive); unset or ``0``
    returns the adapter untouched.  Calibration data is required when
    quantization is on."""
    raw = (os.environ.get("MX_QUANTIZE") or "").strip().lower()
    if _env_off("MX_QUANTIZE"):
        return adapter
    if raw not in ("1", "int8", "true", "on"):
        raise MXNetError(f"MX_QUANTIZE={raw!r}: expected int8/1 or 0/off")
    mode = (os.environ.get("MX_QUANT_CALIB") or "naive").strip().lower()
    if calib_data is None or calib_fn is None:
        raise MXNetError(
            "MX_QUANTIZE=int8 needs calibration data: pass calib_data + "
            "calib_fn to maybe_quantize_adapter (post-training int8 "
            "without calibrated ranges would quantize on the fly per "
            "step — run quantize_adapter explicitly if that is intended)")
    return quantize_adapter(adapter, calib_data, calib_fn, calib_mode=mode,
                            exclude=exclude)


def int4_adapter(adapter, group_size: int = 32,
                 exclude: Iterable[str] = ()) -> Int4WeightAdapter:
    """Wrap ``adapter`` for weight-only int4 serving; the packing is a
    pure function of the weights."""
    return Int4WeightAdapter(adapter, group_size=group_size,
                             exclude=exclude)


def maybe_int4_adapter(adapter, exclude: Iterable[str] = ()):
    """The env gate: ``MX_SERVE_INT4=1`` (or ``int4``) wraps ``adapter``
    for weight-only int4 serving with the ``MX_QUANT_GROUP`` group size
    (default 32); unset or ``0`` returns it untouched.  Together with
    ``MX_QUANTIZE`` it raises: both rewrites claim the same layers."""
    raw = (os.environ.get("MX_SERVE_INT4") or "").strip().lower()
    if _env_off("MX_SERVE_INT4"):
        return adapter
    if raw not in ("1", "int4", "true", "on"):
        raise MXNetError(f"MX_SERVE_INT4={raw!r}: expected int4/1 or 0/off")
    if not _env_off("MX_QUANTIZE"):
        raise MXNetError(
            "MX_SERVE_INT4 and MX_QUANTIZE are both set: the int4 and "
            "int8 rewrites claim the same Dense/Conv layers — pick one")
    graw = (os.environ.get("MX_QUANT_GROUP") or "32").strip()
    try:
        group = int(graw)
    except ValueError:
        raise MXNetError(f"MX_QUANT_GROUP={graw!r}: expected an even int")
    return int4_adapter(adapter, group_size=group, exclude=exclude)
