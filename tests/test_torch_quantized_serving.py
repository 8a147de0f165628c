"""Quantized serving in the port against the JAX package, case for case
with tests/test_quantized_serving.py: calibrated int8
(``QuantizedAdapter``) and weight-only int4 (``Int4WeightAdapter``)
adapters through the ``ServingEngine``.

The weights: the reverse-task Transformer (units 32, 2 layers) trained
once in the JAX package (the recipe of tests/test_quantized_serving.py,
through tests/test_torch_serving_frontdoor.py's fixture) and carried by
name.  Both engines run in this process on the CPU; the port's int8
product is the integer matmul, K1 and K2 their plain versions.
Tolerances, stated before the first run:

  * the layers selected for quantization: the same paths and Gluon names;
  * calibration thresholds (naive and entropy, greedy ``translate`` over
    the sources): within rtol 1e-5 of JAX's (each is a max or a histogram
    edge over f32 activations that the two packages round differently);
  * the int8 engine's tokens: EQUAL to the JAX int8 engine's, both held to
    the JAX calibration (carried by ``convert.quant_thresholds_from_
    mxnet_tpu``); the int4 engine's tokens: EQUAL to the JAX int4
    engine's;
  * params and weight bytes: EQUAL to JAX's;
  * the twin: equal to composing the quantization ops by hand.
"""
import json

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu.precision import int4_adapter as jax_int4_adapter
from mxnet_tpu.precision import quantize_adapter as jax_quantize_adapter
from mxnet_tpu.precision.quantize import \
    collect_quantizable as jax_collect_quantizable
from mxnet_tpu.serving import Request as JaxRequest
from mxnet_tpu.serving import ServingEngine as JaxServingEngine
from mxnet_tpu.serving import TransformerAdapter as JaxTransformerAdapter
from mxnet_tpu_torch import memwatch, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import (quant_buffers_from_mxnet_tpu,
                                     quant_thresholds_from_mxnet_tpu)
from mxnet_tpu_torch.ops import quantization as q
from mxnet_tpu_torch.precision import (Int4WeightAdapter, QuantizedAdapter,
                                       int4_adapter, maybe_int4_adapter,
                                       maybe_quantize_adapter,
                                       quantize_adapter)
from mxnet_tpu_torch.precision.quantize import calibrate, collect_quantizable
from mxnet_tpu_torch.serving import Request, ServingEngine, TransformerAdapter

from test_torch_serving_frontdoor import BOS, EOS, trained  # noqa: F401

ENGINE = dict(slots=3, page_size=4, max_len=12, stream_every=4)
ARRIVALS = [0, 0, 0, 2, 5, 9]


def _port_calib_fn(tnet):
    def calib_fn(batch):
        tnet.translate(torch.from_numpy(batch), bos_id=BOS, eos_id=EOS,
                       max_len=10, beam_size=1)
    return calib_fn


def _jax_calib_fn(jnet):
    def calib_fn(batch):
        jnet.translate(jnd.array(batch, dtype="int32"), bos_id=BOS,
                       eos_id=EOS, max_len=10, beam_size=1)
    return calib_fn


def _batches(src):
    return [src[i:i + 1] for i in range(len(src))]


def _jax_int8(jnet, src, mode="naive"):
    return jax_quantize_adapter(JaxTransformerAdapter(jnet, src_max_len=7),
                                _batches(src), _jax_calib_fn(jnet),
                                calib_mode=mode)


def _port_int8(tnet, src, mode="naive"):
    return quantize_adapter(TransformerAdapter(tnet, src_max_len=7),
                            _batches(src), _port_calib_fn(tnet),
                            calib_mode=mode)


def _jax_thresholds_by_name(jnet, jqad):
    return {layer.name: jqad._by_path[path].act_thresh
            for path, layer in jax_collect_quantizable(jnet)}


def _serve_both(jad, tad, src):
    jeng = JaxServingEngine(jad, **ENGINE)
    teng = ServingEngine(tad, device="cpu", **ENGINE)
    out = []
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        reqs = [cls(src[i], max_new_tokens=9, bos_id=BOS, eos_id=EOS)
                for i in range(6)]
        got = eng.serve(reqs, arrival_steps=ARRIVALS)
        out.append([[int(t) for t in got[r.id]] for r in reqs])
    return out, teng


def test_same_layers_selected(trained):
    jnet, tnet, _src = trained
    tl = collect_quantizable(tnet)
    jl = jax_collect_quantizable(jnet)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    # Gluon names without each net's prefix (each package counts its own
    # name scopes, so the prefixes depend on what ran before)
    assert ([layer.name[len(tnet.prefix):] for _, layer in tl]
            == [layer.name[len(jnet.prefix):] for _, layer in jl])
    assert len(tl) == 22  # 2 encoder x 4 Dense + 2 decoder x 7 Dense


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibration_thresholds_match_jax(trained, mode):
    jnet, tnet, src = trained
    layers = collect_quantizable(tnet)
    got = calibrate(layers, _batches(src), _port_calib_fn(tnet),
                    calib_mode=mode, root=tnet)
    from mxnet_tpu.precision.quantize import calibrate as jax_calibrate

    want = jax_calibrate(jax_collect_quantizable(jnet), _batches(src),
                         _jax_calib_fn(jnet), calib_mode=mode, root=jnet)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   err_msg=path)


def test_int8_engine_tokens_equal_jax(trained):
    jnet, tnet, src = trained
    jqad = _jax_int8(jnet, src)
    thresholds = quant_thresholds_from_mxnet_tpu(
        tnet, _jax_thresholds_by_name(jnet, jqad), jnet.prefix)
    tqad = QuantizedAdapter(TransformerAdapter(tnet, src_max_len=7),
                            thresholds)
    # the weights quantize byte for byte; the carry is then a no-op
    for path, twin in tqad._by_path.items():
        np.testing.assert_array_equal(
            twin._impl._qweight.numpy(),
            jqad._by_path[path]._impl._qweight.asnumpy())
    quant_buffers_from_mxnet_tpu(tqad, {
        layer.name: {"_qweight": jqad._by_path[p]._impl._qweight.asnumpy()}
        for p, layer in jax_collect_quantizable(jnet)}, jnet.prefix)
    (jtok, ttok), teng = _serve_both(jqad, tqad, src)
    assert ttok == jtok
    # the memorised task is solved through int8, not just agreed upon
    for i, toks in enumerate(ttok[:3]):
        assert toks[:6] == list(src[i, :6][::-1])
    assert teng.statusz_snapshot()["precision"] == "int8"
    assert tqad.quant_signature() == jqad.quant_signature()


def test_port_calibrated_int8_engine_solves_the_task(trained):
    jnet, tnet, src = trained
    tqad = _port_int8(tnet, src)
    eng = ServingEngine(tqad, device="cpu", **ENGINE)
    reqs = [Request(src[i], max_new_tokens=9, bos_id=BOS, eos_id=EOS)
            for i in range(3)]
    out = eng.serve(reqs)
    for i, r in enumerate(reqs):
        assert list(out[r.id][:6]) == list(src[i, :6][::-1])


def test_int4_engine_tokens_equal_jax(trained):
    jnet, tnet, src = trained
    jad = jax_int4_adapter(JaxTransformerAdapter(jnet, src_max_len=7),
                           group_size=32)
    tad = int4_adapter(TransformerAdapter(tnet, src_max_len=7),
                       group_size=32)
    assert isinstance(tad, Int4WeightAdapter) and tad.precision == "int4"
    for path, twin in tad._by_path.items():
        jimpl = jad._by_path[path]._impl
        assert twin.digest == jad._by_path[path].digest
        np.testing.assert_array_equal(twin._impl._packed.numpy(),
                                      jimpl._packed.asnumpy())
    assert tad.quant_signature() == jad.quant_signature()
    (jtok, ttok), teng = _serve_both(jad, tad, src)
    assert ttok == jtok
    assert teng.statusz_snapshot()["precision"] == "int4"


def test_params_bytes_equal_jax(trained):
    jnet, tnet, src = trained
    jqad = _jax_int8(jnet, src)
    tqad = QuantizedAdapter(TransformerAdapter(tnet, src_max_len=7),
                            quant_thresholds_from_mxnet_tpu(
                                tnet, _jax_thresholds_by_name(jnet, jqad),
                                jnet.prefix))
    jad4 = jax_int4_adapter(JaxTransformerAdapter(jnet, src_max_len=7))
    tad4 = int4_adapter(TransformerAdapter(tnet, src_max_len=7))
    for t, j in ((tqad, jqad), (tad4, jad4)):
        for fn in ("quantized_param_bytes", "fp32_param_bytes",
                   "quantized_weight_bytes", "fp32_weight_bytes"):
            assert getattr(t, fn)() == getattr(j, fn)(), fn
    assert tqad.quantized_param_bytes() < 0.5 * tqad.fp32_param_bytes()


def test_twin_equals_the_composed_ops(trained):
    _jnet, tnet, src = trained
    qad = _port_int8(tnet, src)
    path, layer = collect_quantizable(tnet)[0]
    twin = qad._by_path[path]
    impl = twin._impl
    x = torch.from_numpy(np.random.RandomState(1).randn(
        3, impl._qweight.shape[1]).astype(np.float32))
    got = twin(x, layer.bias.detach())
    t = twin.act_thresh
    qx, mn, mx_ = q.quantize_v2(x, min_calib_range=-t, max_calib_range=t)
    acc, amn, amx = q.quantized_fully_connected(
        qx, impl._qweight, layer.bias.detach(), mn, mx_, impl._w_min,
        impl._w_max, num_hidden=impl._units, no_bias=impl._no_bias,
        flatten=impl._flatten)
    assert torch.equal(got, q.dequantize(acc, amn, amx))


def test_precision_labels_in_statusz_and_telemetry(trained, tmp_path):
    _jnet, tnet, src = trained
    telemetry.reset()
    telemetry.enable(str(tmp_path))
    try:
        eng = ServingEngine(_port_int8(tnet, src), device="cpu", slots=2,
                            page_size=4, max_len=10, stream_every=4)
        eng.serve([Request(src[i], max_new_tokens=5, bos_id=BOS,
                           eos_id=EOS) for i in range(2)])
        assert telemetry.summary()["serving"]["precision"] == "int8"
        assert ('mx_serve_precision_info{rank="0",precision="int8"} 1'
                in telemetry.render_prometheus())
        telemetry.flush()
        with open(telemetry.event_path(str(tmp_path), 0)) as f:
            events = [json.loads(line) for line in f]
        serve = [e for e in events if e["kind"] == "serve_request"]
        assert serve and all(e["precision"] == "int8" for e in serve)
    finally:
        telemetry.reset()
        memwatch.reset()


def test_quantized_census_category_and_structure(trained):
    _jnet, tnet, src = trained
    qad = _port_int8(tnet, src)
    eng = ServingEngine(qad, device="cpu", slots=2, page_size=4, max_len=8,
                        stream_every=2)
    cats = memwatch.census()["categories"]
    assert "quantized" in cats, sorted(cats)
    # every int8 weight and its two range tensors, 22 Dense layers
    assert cats["quantized"]["count"] >= 3 * len(qad._entries)
    f32 = ServingEngine(TransformerAdapter(tnet, src_max_len=7),
                        device="cpu", slots=2, page_size=4, max_len=8,
                        stream_every=2)
    assert f32.statusz_snapshot()["precision"] == "fp32"
    # the quant pass joins the structural identity the swap checks
    assert eng._structure_parts({}) != f32._structure_parts({})
    assert eng._structure_parts({})[3][1][0] == "quant_int8"


def test_env_gates(trained, monkeypatch):
    _jnet, tnet, src = trained
    adapter = TransformerAdapter(tnet, src_max_len=7)
    for name in ("MX_QUANTIZE", "MX_SERVE_INT4", "MX_QUANT_GROUP"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_quantize_adapter(adapter) is adapter
    assert maybe_int4_adapter(adapter) is adapter
    monkeypatch.setenv("MX_QUANTIZE", "int8")
    with pytest.raises(MXNetError, match="calibration data"):
        maybe_quantize_adapter(adapter)
    monkeypatch.setenv("MX_QUANT_CALIB", "naive")
    qad = maybe_quantize_adapter(adapter, _batches(src[:1]),
                                 _port_calib_fn(tnet))
    assert isinstance(qad, QuantizedAdapter) and qad.precision == "int8"
    monkeypatch.setenv("MX_SERVE_INT4", "1")
    with pytest.raises(MXNetError, match="pick one"):
        maybe_int4_adapter(adapter)
    monkeypatch.setenv("MX_QUANTIZE", "int4")
    with pytest.raises(MXNetError, match="MX_QUANTIZE"):
        maybe_quantize_adapter(adapter, _batches(src[:1]),
                               _port_calib_fn(tnet))
    monkeypatch.setenv("MX_QUANTIZE", "0")
    monkeypatch.setenv("MX_QUANT_GROUP", "16")
    ad4 = maybe_int4_adapter(adapter)
    assert isinstance(ad4, Int4WeightAdapter) and ad4._group_size == 16


def test_adapter_without_model_raises_and_empty_calibration_names_it(
        trained):
    class NoModel:
        num_layers = num_heads = head_dim = 1

    with pytest.raises(MXNetError, match="model"):
        QuantizedAdapter(NoModel(), {})
    with pytest.raises(MXNetError, match="model"):
        Int4WeightAdapter(NoModel())
    _jnet, tnet, src = trained
    with pytest.raises(MXNetError, match="no calibration data"):
        calibrate(collect_quantizable(tnet), _batches(src[:1]),
                  lambda batch: None, calib_mode="naive")


def test_calibrate_observes_through_hybridized_blocks():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=4),
                nn.Dense(4, in_units=8))
    net.initialize(ctx=tmx.cpu())
    net.hybridize()
    x = nd.array(np.random.RandomState(0).rand(2, 4).astype(np.float32),
                 ctx=tmx.cpu())
    net(x)
    assert net._active
    layers = collect_quantizable(net)
    thresholds = calibrate(layers, [x], lambda b: net(b),
                           calib_mode="naive", root=net)
    assert set(thresholds) == {p for p, _ in layers}
    assert all(t > 0 for t in thresholds.values())
    assert net._active  # hybridization restored after the pass
