"""The port engine's telemetry against the JAX engine's.

The same traffic goes through the JAX engine and the port's engine with
each package's recorder on (each its own directory): greedy with
mid-flight joins, then ``spec_k`` 2, then the prefix cache.  The
sequences of serving events (``serve_request``, ``serve_prefix``,
``spec_verify``, ``serve_preempt``, the ``serve_*`` spans, ...) must
match once time fields are dropped: request ids, tokens, causes, prefix
hits, proposed and accepted.  The weights are the reverse-task net of
tests/test_torch_serving_frontdoor.py, trained in the JAX package and
carried by name.
"""
import json

import numpy as np
import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serving import Request as JaxRequest
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.serving import Request

from test_torch_serving_frontdoor import ARRIVALS, BOS, EOS, _engines, trained

SERVING = {"serve_request", "serve_prefix", "spec_verify", "spec_draft",
           "serve_preempt", "serve_pool_pressure", "serve_prefix_evict",
           "serve_prefix_invalidate", "weight_swap"}
DROP = {"t", "mono", "pid", "tid", "span", "parent", "rank"}


@pytest.fixture
def recorders(tmp_path):
    jtel.reset()
    ttel.reset()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jtel.enable(jd)
    ttel.enable(td)
    yield jd, td
    jtel.reset()
    ttel.reset()


def _serving_events(tel, directory):
    tel.flush()
    with open(tel.event_path(directory, 0)) as f:
        events = [json.loads(line) for line in f]
    out = []
    for e in events:
        if e["kind"] in SERVING or (
                e["kind"] == "span" and e["name"].startswith("serve_")):
            out.append({k: v for k, v in e.items()
                        if k not in DROP and not k.endswith("_ms")})
    return out


def _traffic(eng, req_cls, src, mode):
    if mode == "prefix":
        prefix = np.array([9, 8, 7, 6, 5], np.int32)
        reqs = [req_cls(src[i % 2], max_new_tokens=6, bos_id=BOS,
                        eos_id=-1, prefix=prefix, request_id=f"p{i}")
                for i in range(4)]
        for r in reqs:
            eng.serve([r])
    else:
        reqs = [req_cls(s, max_new_tokens=9, bos_id=BOS, eos_id=EOS,
                        request_id=f"{mode}{i}")
                for i, s in enumerate(src[:4])]
        eng.serve(reqs, arrival_steps=ARRIVALS)
    return {r.id: list(r.stream) for r in reqs}


@pytest.mark.parametrize("mode", ["greedy", "spec", "prefix"])
def test_serving_event_streams_equal_jax(trained, recorders, mode):
    jnet, tnet, src = trained
    kw = {"greedy": {}, "spec": {"spec_k": 2},
          "prefix": {"prefix_cache": True}}[mode]
    jeng, teng = _engines(jnet, tnet, **kw)
    jd, td = recorders
    jtoks = _traffic(jeng, JaxRequest, src, mode)
    ttoks = _traffic(teng, Request, src, mode)
    assert ttoks == jtoks
    je, te = _serving_events(jtel, jd), _serving_events(ttel, td)
    assert [(e["kind"], e.get("name")) for e in te] == \
        [(e["kind"], e.get("name")) for e in je]
    assert te == je
    reqs = [e for e in te if e["kind"] == "serve_request"]
    assert len(reqs) == 4
    assert {e["request_id"]: e["tokens"] for e in reqs} == \
        {k: len(v) for k, v in ttoks.items()}
    if mode == "spec":
        ver = [e for e in te if e["kind"] == "spec_verify"]
        assert ver and sum(e["accepted"] for e in ver) > 0
    if mode == "prefix":
        hits = [(e["kind"], e["hit"]) for e in te
                if e["kind"] == "serve_prefix"]
        assert ("serve_prefix", True) in hits
        assert ("serve_prefix", False) in hits
        assert {e["cause"] for e in reqs} == {"cache_miss", "none"}
    # the serving rollups, but for their times
    ts, js = ttel.summary()["serving"], jtel.summary()["serving"]
    assert ts.keys() == js.keys()
    assert {k: v for k, v in ts.items() if "ms" not in k} == \
        {k: v for k, v in js.items() if "ms" not in k}
