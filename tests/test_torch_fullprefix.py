"""``FullPrefixAdapter`` and the engine's path without pages, against the
JAX engine.

The setup of ``tests/test_serving.py``'s FullPrefixAdapter case: the tiny
Transformer memorising the reverse task (trained in the JAX package, its
weights carried into the port; the fixture of
``tests/test_torch_serving_frontdoor.py``), its decoder over a fixed
source as a decoder-only logits function of the (S, L) token buffer.
Tokens must be equal, token for token: between the two engines, and
with a host greedy loop over the same buffer through the same logits
function.  What the adapter cannot serve is refused with the JAX
engine's messages.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.serving import FullPrefixAdapter as JaxFullPrefixAdapter
from mxnet_tpu.serving import Request as JaxRequest
from mxnet_tpu.serving import ServingEngine as JaxServingEngine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.precision.quantize import QuantizedAdapter
from mxnet_tpu_torch.serving import (FullPrefixAdapter, Request,
                                     ServingEngine)
from test_torch_serving_frontdoor import BOS, trained  # noqa: F401

PAD, L = 0, 10
PROMPTS = [np.array([1, 14, 5], np.int32), np.array([1, 8], np.int32),
           np.array([1, 9, 9, 4, 3], np.int32), np.array([1], np.int32),
           np.array([1, 6, 12], np.int32)]


def _jax_fn(jnet):
    def lm_logits(F, buf):
        src = F.ones((buf.shape[0], 3), dtype="int32") * 5
        return jnet._decode_h(F, buf, *jnet._encode_h(F, src))

    return lm_logits


def _port_fn(tnet):
    def lm_logits(buf):
        src = torch.full((buf.shape[0], 3), 5, dtype=torch.int32,
                         device=buf.device)
        return tnet._decode_h(buf, *tnet._encode_h(src))

    return lm_logits


def _serve(trained, n, max_new, arrivals=None, **kw):
    jnet, tnet, _ = trained
    jeng = JaxServingEngine(JaxFullPrefixAdapter(_jax_fn(jnet), max_len=L,
                                                 pad_id=PAD),
                            max_len=L, **kw)
    jreqs = [JaxRequest(p, max_new_tokens=max_new, bos_id=BOS, eos_id=-1)
             for p in PROMPTS[:n]]
    want = jeng.serve(jreqs, arrival_steps=arrivals)
    teng = ServingEngine(FullPrefixAdapter(_port_fn(tnet), max_len=L,
                                           pad_id=PAD),
                         max_len=L, device="cpu", **kw)
    treqs = [Request(p, max_new_tokens=max_new, bos_id=BOS, eos_id=-1)
             for p in PROMPTS[:n]]
    got = teng.serve(treqs, arrival_steps=arrivals)
    return teng, [list(got[r.id]) for r in treqs], \
        [list(want[r.id]) for r in jreqs]


def test_tokens_equal_jax_engine_and_host_greedy_loop(trained):
    eng, got, want = _serve(trained, 2, 4, slots=2, stream_every=2)
    assert got == want
    fn = _port_fn(trained[1])
    for p, toks in zip(PROMPTS, got):
        buf = np.full((1, L), PAD, np.int32)
        buf[0, :len(p)] = p
        pos = len(p) - 1
        loop = []
        with torch.no_grad():
            for _ in range(4):
                logits = fn(torch.from_numpy(buf))
                tok = int(torch.log_softmax(logits, -1)[0, pos].argmax())
                loop.append(tok)
                pos += 1
                buf[0, pos] = tok
        assert toks == loop
    assert eng._cache is None and eng.pool_bytes == 0
    snap = eng.statusz_snapshot()
    assert "pages_free" not in snap and snap["max_len"] == L


def test_mid_flight_joins_and_recycled_slots_equal_jax(trained):
    """Five requests through two slots with arrivals: a slot's buffer row
    is rewritten at each admission."""
    _eng, got, want = _serve(trained, 5, 5, arrivals=[0, 0, 1, 3, 4],
                             slots=2, stream_every=3)
    assert got == want
    assert all(len(t) == 5 for t in got)


def test_jax_host_loop_agrees(trained):
    """The JAX test's own host loop, through the JAX logits function, gives
    the port engine's tokens too."""
    jnet = trained[0]
    fn = _jax_fn(jnet)
    _eng, got, _ = _serve(trained, 2, 4, slots=2, stream_every=2)
    for p, toks in zip(PROMPTS, got):
        buf = np.full((1, L), PAD, np.int32)
        buf[0, :len(p)] = p
        pos = len(p) - 1
        want = []
        with jag.pause():
            for _ in range(4):
                lp = fn(jnd, jnd.array(buf, dtype="int32")).log_softmax(
                    axis=-1).asnumpy()[0, pos]
                want.append(int(lp.argmax()))
                pos += 1
                buf[0, pos] = want[-1]
        assert toks == want


def _refusals(pkg_err, adapter_cls, engine_cls, request_cls, fn, **kw):
    msgs = {}
    ad = adapter_cls(fn, max_len=L, pad_id=PAD)
    for key, extra in (("spec", {"spec_k": 2}),
                       ("prefix_cache", {"prefix_cache": True})):
        with pytest.raises(pkg_err) as ei:
            engine_cls(ad, slots=2, max_len=L, **kw, **extra)
        msgs[key] = str(ei.value)
    eng = engine_cls(ad, slots=2, max_len=L, **kw)
    with pytest.raises(pkg_err) as ei:
        eng.submit(request_cls(np.arange(1, 8, dtype=np.int32),
                               max_new_tokens=4, bos_id=BOS, eos_id=-1))
    msgs["overflow"] = str(ei.value).split(" needs ", 1)[1]
    with pytest.raises(pkg_err) as ei:
        eng.submit(request_cls(np.array([1, 2], np.int32),
                               max_new_tokens=2, bos_id=BOS, eos_id=-1,
                               prefix=np.array([4, 5], np.int32)))
    msgs["prefix"] = str(ei.value).split(" carries ", 1)[1]
    return msgs


def test_refusals_carry_the_jax_messages(trained):
    jnet, tnet, _ = trained
    got = _refusals(MXNetError, FullPrefixAdapter, ServingEngine, Request,
                    _port_fn(tnet), device="cpu")
    want = _refusals(JaxMXNetError, JaxFullPrefixAdapter, JaxServingEngine,
                     JaxRequest, _jax_fn(jnet))
    assert got == want
    assert "would silently truncate" in got["overflow"]


def test_quantized_adapter_refuses_a_full_prefix_adapter():
    ad = FullPrefixAdapter(lambda buf: None, max_len=8)
    assert ad.uses_pages is False
    with pytest.raises(MXNetError, match="model"):
        QuantizedAdapter(ad, {})
