"""INT8 post-training quantization and the weight-only INT4 twins.

Counterpart of ``mxnet_tpu/contrib/quantization.py``: the calibrators
(``naive`` per-layer min/max, ``entropy`` the KL-optimal symmetric
threshold over a streaming 2048-bin histogram, ``none`` on the fly), the
weight packers (``_quantize_weight_np``, ``_quantize_weight_int4_np``,
numpy, byte for byte the JAX package's), the quantized twins of
``gluon.nn.Dense`` and ``Conv2D`` over ``ops/quantization.py``, and the
Gluon driver :func:`quantize_net`.  The twins take torch tensors (or
NDArrays, and then give NDArrays back) and keep their buffers on the
layer's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["quantize_net", "quantize_model", "calib_entropy_threshold",
           "check_calibrated_threshold", "QuantizedDense", "QuantizedConv2D",
           "Int4Dense", "Int4Conv2D"]


def check_calibrated_threshold(path: str, calib_mode: str, minmax,
                               thresh: float) -> None:
    """Reject a zero/degenerate calibration threshold LOUDLY, naming the
    layer and calibration mode.

    A layer whose calibration batches produced only zeros (or whose
    activations were non-finite) yields a floor/garbage threshold; a 0.0
    scale would then silently quantize every activation to zero — the
    quantized net "works" and emits nonsense.  Both ``quantize_net`` and
    ``precision.quantize`` route every per-layer threshold through here.
    """
    mn, mx = (float(minmax[0]), float(minmax[1])) if minmax else (0.0, 0.0)
    amax = max(abs(mn), abs(mx))
    if not np.isfinite(thresh) or not np.isfinite(amax):
        raise MXNetError(
            f"quantization calibration for layer {path!r} "
            f"(calib_mode={calib_mode!r}) observed non-finite activations "
            f"(range [{mn}, {mx}]) — the model is diverging or the "
            f"calibration data is corrupt; quantizing would bake NaN/inf "
            f"scales into the int8 graph")
    if amax <= 0.0 or thresh <= 0.0:
        raise MXNetError(
            f"quantization calibration for layer {path!r} "
            f"(calib_mode={calib_mode!r}) produced a degenerate threshold "
            f"(observed activation range [{mn}, {mx}]): every calibrated "
            f"activation is zero, so int8 quantization would map the "
            f"layer's real inputs to zero.  Calibrate with representative "
            f"data, or exclude the layer (exclude_layers)")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def calib_entropy_threshold(arr: np.ndarray, num_bins: int = 2048,
                            num_quantized_bins: int = 255) -> float:
    """KL-divergence-optimal symmetric threshold: scan candidate
    thresholds, pick the one whose quantized distribution diverges
    least."""
    arr = np.abs(np.asarray(arr, np.float64).ravel())
    amax = float(arr.max()) if arr.size else 0.0
    if amax <= 0:
        return 1e-6
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    return _entropy_threshold_from_hist(hist, edges,
                                        num_quantized_bins=num_quantized_bins)


def _entropy_threshold_from_hist(hist: np.ndarray, edges: np.ndarray,
                                 num_quantized_bins: int = 255) -> float:
    num_bins = len(hist)
    amax = float(edges[-1])
    if amax <= 0:
        return 1e-6
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return amax
    pn_full = hist / total
    best_kl, best_t = np.inf, amax
    # candidate thresholds: bin boundaries from num_quantized_bins upward.
    # KL is measured against the FULL (unclipped) distribution so that
    # clipping real mass costs divergence — otherwise the smallest
    # candidate (255 bins -> 255 levels, lossless) degenerately wins.
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 64)):
        t = edges[i]
        p = hist[:i]
        if p.sum() == 0:
            continue
        # quantize the in-range part into num_quantized_bins, expand back
        factor = i / num_quantized_bins
        q = np.zeros(num_bins)
        for j in range(num_quantized_bins):
            lo = int(np.floor(j * factor))
            hi = max(int(np.floor((j + 1) * factor)), lo + 1)
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        qn = q / total  # mass beyond i is clipped away: qn[i:] == 0
        mask = pn_full > 0
        kl = float(np.sum(np.where(
            mask,
            pn_full * np.log(np.maximum(pn_full, 1e-12)
                             / np.maximum(qn, 1e-12)),
            0.0)))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return float(best_t)


class _StreamingHist:
    """Fixed-size |x| histogram accumulated incrementally (a per-layer
    histogram, never the activations).
    When a new batch exceeds the current range, existing bins are merged
    by an integer factor and the width grows — O(num_bins) memory total,
    vs O(batches x activation size) for buffering samples."""

    def __init__(self, num_bins: int = 2048):
        self.num_bins = num_bins
        self.hist = np.zeros(num_bins, np.float64)
        self.width = None  # bin width; range is [0, num_bins * width)

    def add(self, absarr: np.ndarray) -> None:
        amax = float(absarr.max()) if absarr.size else 0.0
        if self.width is None:
            self.width = max(amax / self.num_bins, 1e-12)
        limit = self.num_bins * self.width
        if amax > limit:
            factor = int(np.ceil(amax / limit))
            merged = np.zeros(self.num_bins, np.float64)
            idx = np.arange(self.num_bins) // factor
            np.add.at(merged, idx, self.hist)
            self.hist = merged
            self.width *= factor
            limit = self.num_bins * self.width
        h, _ = np.histogram(absarr, bins=self.num_bins, range=(0.0, limit))
        self.hist += h

    @property
    def edges(self) -> np.ndarray:
        return np.arange(self.num_bins + 1) * self.width


class _Calibrator:
    def __init__(self, mode: str):
        self.mode = mode
        self.minmax: Dict[str, List[float]] = {}
        self.hists: Dict[str, _StreamingHist] = {}

    def observe(self, name: str, arr) -> None:
        a = np.asarray(arr, np.float32)
        mm = self.minmax.setdefault(name, [np.inf, -np.inf])
        mm[0] = min(mm[0], float(a.min()))
        mm[1] = max(mm[1], float(a.max()))
        if self.mode == "entropy":
            self.hists.setdefault(name, _StreamingHist()).add(
                np.abs(a.ravel()))

    def threshold(self, name: str) -> float:
        if name not in self.minmax:
            raise MXNetError(f"no calibration data observed for {name}")
        if self.mode == "entropy":
            h = self.hists[name]
            return _entropy_threshold_from_hist(h.hist, h.edges)
        mn, mx = self.minmax[name]
        return max(abs(mn), abs(mx), 1e-6)


# ---------------------------------------------------------------------------
# quantized layers
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """A tensor or NDArray as a float32 numpy array."""
    t = x._data if hasattr(x, "_data") else x
    return t.detach().float().cpu().numpy()


def _unwrap(x):
    """(tensor, wrap): ``wrap`` turns a result back into what came in."""
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return x._data, lambda t: NDArray(t, ctx=t.device)
    return x, lambda t: t


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _quantize_weight_np(w: np.ndarray):
    t = max(float(np.abs(w).max()), 1e-12)
    q = np.clip(np.round(w * (127.0 / t)), -127, 127).astype(np.int8)
    return q, t


def _conv_kwargs(conv):
    """The layer's convolution attributes; the twins compute NCHW."""
    if conv.channel_last:
        raise MXNetError(f"{conv.name}: the quantized convolution is NCHW "
                         "(the JAX op's layout); an NHWC Conv2D stays f32")
    return conv.kwargs


class _QuantizedLayerBase:
    """Inference only: quantize the input, run the int8 op, dequantize the
    int32 accumulator back to f32, apply the layer's activation.
    ``_forward(x, bias)`` is the one copy of that sequence, which the
    eager twins here and the serving rewrite in ``precision/quantize.py``
    both run."""

    def _q_input(self, x):
        from ..ops import quantization as q

        if self._calib_thresh is not None:
            return q.quantize_v2(x, min_calib_range=-self._calib_thresh,
                                 max_calib_range=self._calib_thresh)
        return q.quantize_v2(x)

    def _activate(self, out):
        from ..ops import nn as _ops

        return _ops.activation(out, self._act_type) if self._act_type \
            else out

    def __call__(self, x):
        t, wrap = _unwrap(x)
        with torch.no_grad():
            return wrap(self._forward(t, self._bias))


def _dense_consts(t_act: float, t_w: float):
    """The f32 scalars of a calibrated int8 Dense, computed on the host as
    the op chain computes them on the device (``quantize_v2`` ->
    ``quantized_fully_connected`` -> ``dequantize``): the input scale, the
    bias's accumulator scale and the dequantization scale."""
    from ..ops import quantization as q

    t_d = q.calib_thresh(-t_act, t_act)
    tdw = t_d * np.float32(t_w)
    acc_range = tdw * np.float32(q._INT32_MAX / (127.0 * 127.0))
    return (float(np.float32(127.0) / t_d),
            float(np.float32(127.0 * 127.0)
                  / np.maximum(tdw, np.float32(1e-12))),
            float(np.maximum(acc_range, np.float32(1e-12))
                  / np.float32(q._INT32_MAX)))


class QuantizedDense(_QuantizedLayerBase):
    """The int8 twin of a ``gluon.nn.Dense``.  With a calibrated threshold
    every scale is a host constant (:func:`_dense_consts`), so a call is
    the input quantization, the int8 product, the bias fold and one
    multiply, with no per-call scalar tensors; the result equals the
    ``ops.quantization`` chain's bit for bit."""

    def __init__(self, dense, calib_thresh: Optional[float]):
        w = _host(dense.weight)
        dev = dense.weight.device
        qw, tw = _quantize_weight_np(w)
        self._qweight = torch.from_numpy(qw).to(dev)
        # constants built once (the inference hot path)
        self._w_min = _f32([-tw], dev)
        self._w_max = _f32([tw], dev)
        self._w_thresh = float(tw)
        self._no_bias = dense.bias is None
        self._bias = (dense.bias.detach() if dense.bias is not None
                      else torch.zeros(dense._units, device=dev))
        self._units = dense._units
        self._flatten = dense.flatten
        self._act_type = dense.act
        self._calib_thresh = calib_thresh
        self._consts = (None if calib_thresh is None
                        else _dense_consts(calib_thresh, tw))
        self.orig_nbytes = int(w.nbytes)
        self.nbytes = int(qw.nbytes)

    def _forward(self, x, bias):
        from ..ops import quantization as q

        if self._consts is not None:
            q_scale, acc_scale, deq_scale = self._consts
            if self._flatten and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            qx = torch.clamp(torch.round(x.float() * q_scale), -127,
                             127).to(torch.int8)
            acc = q.int8_matmul(qx, self._qweight)
            if not self._no_bias:
                acc = acc + torch.round(bias.float() * acc_scale).to(
                    torch.int32)
            return self._activate(acc.float() * deq_scale)
        qx, mn, mx = self._q_input(x)
        acc, amn, amx = q.quantized_fully_connected(
            qx, self._qweight, bias, mn, mx, self._w_min, self._w_max,
            num_hidden=self._units, no_bias=self._no_bias,
            flatten=self._flatten)
        return self._activate(q.dequantize(acc, amn, amx))


class QuantizedConv2D(_QuantizedLayerBase):
    def __init__(self, conv, calib_thresh: Optional[float]):
        self._kwargs = dict(_conv_kwargs(conv))
        w = _host(conv.weight)
        dev = conv.weight.device
        qw, tw = _quantize_weight_np(w)
        self._qweight = torch.from_numpy(qw).to(dev)
        self._w_min = _f32([-tw], dev)
        self._w_max = _f32([tw], dev)
        self._w_thresh = float(tw)
        nf = int(self._kwargs["num_filter"])
        self._no_bias = conv.bias is None
        self._bias = (conv.bias.detach() if conv.bias is not None
                      else torch.zeros(nf, device=dev))
        self._act_type = conv.act
        self._calib_thresh = calib_thresh
        self.orig_nbytes = int(w.nbytes)
        self.nbytes = int(qw.nbytes)

    def _forward(self, x, bias):
        from ..ops import quantization as q

        qx, mn, mx = self._q_input(x)
        k = self._kwargs
        acc, amn, amx = q.quantized_conv(
            qx, self._qweight, bias, mn, mx, self._w_min, self._w_max,
            kernel=k["kernel"], stride=k["stride"], dilate=k["dilate"],
            pad=k["pad"], num_filter=int(k["num_filter"]),
            num_group=k["num_group"], no_bias=self._no_bias)
        return self._activate(q.dequantize(acc, amn, amx))


# ---------------------------------------------------------------------------
# int4 weight-only twins (serving; precision/quantize.py's int4 path)
# ---------------------------------------------------------------------------
def _quantize_weight_int4_np(w: np.ndarray, group_size: int = 32):
    """Pack a 2-D weight 2-per-byte with group-wise symmetric scales.

    Groups of ``group_size`` run along the input dim (axis 1); the input
    dim is zero-padded to a group multiple (padding quantizes to exact
    zeros, sliced off again by ``_contrib_dequantize_int4``'s ``cols``).
    Per group: thresh = max|w|, scale = thresh / 7, q = round(w / scale)
    clipped to [-7, 7].  Two consecutive columns share a byte (low nibble
    = even column).  Scales are f16 — 2 bytes per ``group_size`` weights,
    so total bytes = 0.5 + 2/group_size per weight (0.5625 at g=32)
    vs 4.0 for f32: the ~0.14x weight-bytes ratio.  Numpy, byte for byte
    the JAX package's packer.
    """
    if group_size < 2 or group_size % 2:
        raise MXNetError(
            f"int4 group_size must be even and >= 2, got {group_size}")
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise MXNetError(
            f"_quantize_weight_int4_np packs 2-D weights, got {w.shape}")
    rows, cols = w.shape
    pad = (-cols) % group_size
    if pad:
        w = np.pad(w, ((0, 0), (0, pad)))
    g = w.reshape(rows, -1, group_size)
    thresh = np.maximum(np.abs(g).max(axis=-1), 1e-12)
    # f16 ROUND-TRIPPED before quantizing: the dequant side reads f16
    # scales, so q must be computed against the value it will actually
    # be multiplied by
    scales = (thresh / 7.0).astype(np.float16)
    q = np.clip(np.round(g / scales.astype(np.float32)[..., None]),
                -7, 7).astype(np.int8).reshape(rows, -1)
    lo = q[:, 0::2].astype(np.uint8) & 0x0F
    hi = q[:, 1::2].astype(np.uint8) & 0x0F
    packed = (lo | (hi << 4)).astype(np.uint8)
    return packed, scales, cols


class _Int4LayerBase(_QuantizedLayerBase):
    """Weight-only int4 twin: the packed weight and its f16 group scales
    are the resident buffers; ``_forward`` dequantizes them
    (``ops.quantization.dequantize_int4``) and runs the f32 op.  No
    activation quantization, hence no calibration."""

    def _dequant(self):
        from ..ops import quantization as q

        return q.dequantize_int4(self._packed, self._scales,
                                 group_size=self._group, cols=self._cols)

    def _pack(self, w: np.ndarray, dev, group_size: int) -> None:
        packed, scales, cols = _quantize_weight_int4_np(w, group_size)
        self._packed = torch.from_numpy(packed).to(dev)
        self._scales = torch.from_numpy(scales).to(dev)
        self._group = int(group_size)
        self._cols = cols
        self.nbytes = int(packed.nbytes) + int(scales.nbytes)


class Int4Dense(_Int4LayerBase):
    def __init__(self, dense, group_size: int = 32):
        w = _host(dense.weight)
        dev = dense.weight.device
        self._pack(w, dev, group_size)
        self._units = dense._units
        self._flatten = dense.flatten
        self._act_type = dense.act
        self._no_bias = dense.bias is None
        self._bias = (dense.bias.detach() if dense.bias is not None
                      else torch.zeros(dense._units, device=dev))
        self.orig_nbytes = int(w.nbytes)

    def _forward(self, x, bias):
        from ..ops import nn as _ops

        w = self._dequant()
        args = (x, w) if self._no_bias else (x, w, bias)
        return self._activate(_ops.fully_connected(
            *args, num_hidden=self._units, no_bias=self._no_bias,
            flatten=self._flatten))


class Int4Conv2D(_Int4LayerBase):
    def __init__(self, conv, group_size: int = 32):
        self._kwargs = dict(_conv_kwargs(conv))
        w = _host(conv.weight)
        dev = conv.weight.device
        self._wshape = tuple(w.shape)
        # the OIHW weight packed as (O, I*kh*kw); _forward reshapes the
        # dequantized matrix back before the convolution
        self._pack(w.reshape(w.shape[0], -1), dev, group_size)
        nf = int(self._kwargs["num_filter"])
        self._no_bias = conv.bias is None
        self._bias = (conv.bias.detach() if conv.bias is not None
                      else torch.zeros(nf, device=dev))
        self._act_type = conv.act
        self.orig_nbytes = int(w.nbytes)

    def _forward(self, x, bias):
        from ..ops import nn as _ops

        w = self._dequant().reshape(self._wshape)
        k = dict(self._kwargs, no_bias=self._no_bias)
        args = (x, w) if self._no_bias else (x, w, bias)
        return self._activate(_ops.convolution(*args, **k))


def _active_blocks(block, found):
    """Every hybridized block under ``block`` (itself included).  Both
    calibration drivers (``quantize_net`` here and
    ``precision.quantize.calibrate``) switch these off for the eager
    calibration pass and back on after, as the JAX package does: there a
    CachedOp fast path skips forward pre-hooks."""
    for m in block.modules():
        if getattr(m, "_active", False):
            found.append(m)
    return found


def _children(block):
    """(key, child) of a block's direct children, in order."""
    return list(block._modules.items())


def _hook_layers(calib, targets):
    """Forward pre-hooks feeding ``calib`` each target layer's input:
    a list of handles.  ``targets`` is [(path, layer)]."""
    return [layer.register_forward_pre_hook(
        (lambda pp: lambda _blk, args: calib.observe(pp, _host(args[0])))(p))
        for p, layer in targets]


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def quantize_net(network, calib_data=None, calib_mode: str = "naive",
                 quantized_dtype: str = "int8", exclude_layers=None,
                 num_calib_batches: Optional[int] = None, ctx=None):
    """Post-training-quantize a Gluon net's Conv2D/Dense layers to int8.
    Returns a callable net; the original is not modified."""
    from .. import autograd
    from ..gluon import nn as gnn

    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported (the "
                         "reference's uint8 'shifted' mode is not carried)")
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    if not isinstance(network, (gnn.HybridSequential, gnn.Sequential)):
        raise MXNetError(
            "quantize_net requires a (Hybrid)Sequential root: the "
            "quantized net replays children in order, which is not valid "
            "for a custom-forward block (residual adds etc. would be "
            "silently dropped).  Wrap the sequential portion you want "
            "quantized, or quantize per-layer with the contrib.quantize_* "
            "ops.")
    exclude = set(exclude_layers or [])

    # only layers reachable through Sequential-style containers: the
    # quantized net calls parts in order, which is not valid inside an
    # arbitrary composite block (a residual's skip connection)
    targets = []  # (parent, attr_key, layer, path)

    def walk(block, path):
        for key, child in _children(block):
            p = f"{path}.{key}" if path else str(key)
            if isinstance(child, (gnn.Conv2D, gnn.Dense)) and p not in exclude \
                    and child.name not in exclude:
                targets.append((block, key, child, p))
            elif isinstance(child, (gnn.HybridSequential, gnn.Sequential)):
                walk(child, p)
    walk(network, "")
    if not targets:
        raise MXNetError(
            "no quantizable Conv2D/Dense layers found in Sequential "
            "containers (non-sequential composites stay f32)")

    thresholds: Dict[str, Optional[float]] = {p: None for *_, p in targets}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        calib = _Calibrator(calib_mode)
        handles = _hook_layers(calib, [(p, layer)
                                       for _, _, layer, p in targets])
        hybridized = _active_blocks(network, [])
        for b in hybridized:
            b._active = False
        try:
            with autograd.pause(), torch.no_grad():
                for i, batch in enumerate(calib_data):
                    data = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    network(data)
                    if num_calib_batches and i + 1 >= num_calib_batches:
                        break
        finally:
            for h in handles:
                h.remove()
            for b in hybridized:
                b._active = True
        thresholds = {}
        for *_, p in targets:
            t = calib.threshold(p)
            # a degenerate (all-zero / non-finite) calibration is a data
            # bug, not a preference: fail naming the layer and mode
            check_calibrated_threshold(p, calib_mode, calib.minmax.get(p), t)
            thresholds[p] = t

    # a thin mirror of the tree whose quantizable leaves are int8 twins;
    # untouched blocks are shared with the original (read-only here)
    impls = {}
    for _, _, layer, path in targets:
        impls[path] = (QuantizedConv2D(layer, thresholds[path])
                       if isinstance(layer, gnn.Conv2D)
                       else QuantizedDense(layer, thresholds[path]))

    class _QuantizedNet:
        def __init__(self, block, path=""):
            self._block = block
            self._parts = []
            for key, child in _children(block):
                p = f"{path}.{key}" if path else str(key)
                if p in impls:
                    self._parts.append(impls[p])
                elif any(t.startswith(p + ".") for t in impls):
                    self._parts.append(_QuantizedNet(child, p))
                else:
                    self._parts.append(child)

        def __call__(self, x):
            if not self._parts:  # leaf block with no quantized children
                return self._block(x)
            with torch.no_grad():
                for part in self._parts:
                    x = part(x)
            return x

    return _QuantizedNet(network)


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, calib_mode="none", **kwargs):
    """Symbolic-API driver: not implemented, as in the JAX package
    (returning the symbol unchanged would be a silent f32 no-op)."""
    raise MXNetError(
        "quantize_model (symbolic graph rewrite) is not implemented; use "
        "contrib.quantization.quantize_net on a Gluon block, or the "
        "contrib.quantize_* ops directly")
