"""Zero-downtime weight hot-swap in the port's engine, case for case with
tests/test_serving_swap.py, plus one cross case: a checkpoint the JAX
package's ``AsyncCheckpointer`` wrote is swapped into the port's engine
mid-stream, and the tokens equal the JAX engine's after the same swap.

Models are tiny Transformers on the CPU (2 slots, pages of 4, ``max_len``
16); the port's weights come from seeded torch generators.  Tokens are
compared exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import checkpoint, memwatch, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import Transformer, label_smoothed_ce
from mxnet_tpu_torch.serving import Request, ServingEngine, TransformerAdapter

PAD, BOS, EOS = 0, 1, 2
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=48, dropout=0.0)


@pytest.fixture
def tele(tmp_path):
    telemetry.reset()
    memwatch.reset()
    telemetry.enable(str(tmp_path / "tele"))
    yield str(tmp_path / "tele")
    telemetry.reset()
    memwatch.reset()


def _tiny_model(seed=0, **kw):
    return Transformer(16, device="cpu",
                       generator=torch.Generator().manual_seed(seed),
                       **dict(CFG, **kw))


def _engine(net, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 16)
    kw.setdefault("stream_every", 2)
    return ServingEngine(TransformerAdapter(net, src_max_len=8),
                         device="cpu", **kw)


def _ckpt(net, d, sharded=False):
    ck = checkpoint.AsyncCheckpointer(d, save_every=1, keep=2,
                                      sharded=sharded)
    ck.step(net)
    ck.close()
    return d


def _reqs(rng, n, max_new=8, tag=""):
    return [Request(rng.randint(3, 16, 5), max_new_tokens=max_new,
                    bos_id=BOS, eos_id=EOS, request_id=f"{tag}{i}")
            for i in range(n)]


def _events(directory, kind):
    telemetry.flush()
    with open(telemetry.event_path(directory, 0)) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


def _again(reqs, max_new):
    return [Request(r.tokens, max_new_tokens=max_new, bos_id=BOS,
                    eos_id=EOS, request_id=r.id) for r in reqs]


# ---------------------------------------------------------------------------
# the mid-stream flip
# ---------------------------------------------------------------------------
def _stage_at_first_boundary(eng, ckdir, seen):
    """Make ``eng`` call ``swap_weights(ckdir)`` from its live run loop at
    its first stream boundary, recording the staged census bytes, and
    record the step count of every flip in ``seen["flips"]``."""
    consume, apply = eng._consume, eng._apply_pending_swap
    seen["flips"] = []

    def staged_consume(handles):
        consume(handles)
        if "staged" not in seen:
            assert eng._running
            assert eng.swap_weights(ckdir) == 1
            assert eng.weight_generation == 0
            assert eng._swap_pending is not None
            seen["staged"] = memwatch.census()["categories"].get(
                "staging", {}).get("nbytes", 0)

    def recorded_apply():
        if eng._swap_pending is not None:
            seen["flips"].append(eng.step_count)
        apply()

    eng._consume = staged_consume
    eng._apply_pending_swap = recorded_apply


def test_hot_swap_mid_stream(tele, tmp_path):
    """A swap staged while the run loop is live applies at the next
    stream boundary: wave A finishes across the flip with nothing
    dropped, wave B (arriving after) decodes what a fresh engine on the
    new weights decodes, and no parameter's address changes."""
    net_a = _tiny_model(0)
    ckdir = _ckpt(_tiny_model(7), str(tmp_path / "ck"))
    eng = _engine(net_a)
    addrs = {n: p.data_ptr() for n, p in net_a.named_parameters()}
    rng = np.random.RandomState(3)
    wave_a = _reqs(rng, 2, max_new=10, tag="a")
    wave_b = _reqs(rng, 2, max_new=10, tag="b")
    seen = {}
    _stage_at_first_boundary(eng, ckdir, seen)
    out = eng.serve(wave_a + wave_b, arrival_steps=[0, 0, 8, 8])
    staged = seen["staged"]
    assert staged == sum(p.numel() * 4 for p in net_a.parameters())
    assert eng.weight_generation == 1
    # staged during the first burst, flipped at its end, with wave A
    # mid-flight and wave B not yet arrived
    assert seen["flips"] == [2], seen["flips"]
    assert eng._swap_pending is None and not eng._staging
    assert "staging" not in memwatch.census()["categories"]
    assert {n: p.data_ptr() for n, p in net_a.named_parameters()} == addrs
    for r in wave_a + wave_b:
        assert len(out[r.id]) == r.max_new_tokens, r.id
        assert r.stream.finished
    ref = _engine(_tiny_model(7)).serve(_again(wave_b, 10))
    for r in wave_b:
        np.testing.assert_array_equal(out[r.id], ref[r.id])
    old = _engine(_tiny_model(0)).serve(_again(wave_b, 10))
    assert all(not np.array_equal(out[r.id], old[r.id]) for r in wave_b)
    swaps = _events(tele, "weight_swap")
    assert len(swaps) == 1 and swaps[0]["generation"] == 1
    assert swaps[0]["staged_bytes"] == staged and swaps[0]["step"] == 1
    sv = telemetry.summary()["serving"]
    assert sv["weight_generation"] == 1 and sv["weight_swaps"] == 1
    prom = telemetry.render_prometheus()
    assert 'mx_serve_weight_generation{rank="0"} 1' in prom
    assert "mx_serve_weight_swaps_total" in prom
    # wave A decoded across the swap window: its cause says so
    causes = {e["request_id"]: e["cause"]
              for e in _events(tele, "serve_request")}
    assert causes == {"a0": "swap", "a1": "swap", "b0": "none",
                      "b1": "none"}


def test_idle_swap_applies_immediately(tele, tmp_path):
    net_a = _tiny_model(0)
    ckdir = _ckpt(_tiny_model(7), str(tmp_path / "ck"))
    eng = _engine(net_a)
    src = np.array([3, 4, 5, 6, 7], np.int32)
    before = eng.serve([Request(src, max_new_tokens=6, bos_id=BOS,
                                eos_id=EOS, request_id="r0")])["r0"]
    # an idle flip runs on this thread, outside the run loop's no_grad
    assert torch.is_grad_enabled()
    assert eng.swap_weights(ckdir) == 1
    assert eng.weight_generation == 1 and not eng._staging
    assert all(p.grad_fn is None for p in net_a.parameters())
    after = eng.serve([Request(src, max_new_tokens=6, bos_id=BOS,
                               eos_id=EOS, request_id="r1")])["r1"]
    ref = _engine(_tiny_model(7)).serve(
        [Request(src, max_new_tokens=6, bos_id=BOS, eos_id=EOS,
                 request_id="r2")])["r2"]
    np.testing.assert_array_equal(after, ref)
    assert not np.array_equal(before, after)


def test_swap_staged_between_loops_flips_before_admission(tele, tmp_path):
    """A swap staged while a loop was marked live but ended before its
    next boundary flips as the next loop starts, before it admits
    anything: every request of that loop decodes on the new weights."""
    ckdir = _ckpt(_tiny_model(7), str(tmp_path / "ck"))
    eng = _engine(_tiny_model(0))
    seen = {"staged": 0}
    _stage_at_first_boundary(eng, ckdir, seen)
    eng._running = True
    try:
        assert eng.swap_weights(ckdir) == 1
    finally:
        eng._running = False
    assert eng.weight_generation == 0 and eng._swap_pending is not None
    reqs = _reqs(np.random.RandomState(4), 2, max_new=6, tag="c")
    out = eng.serve(reqs)
    assert seen["flips"] == [0] and eng.weight_generation == 1
    ref = _engine(_tiny_model(7)).serve(_again(reqs, 6))
    for r in reqs:
        np.testing.assert_array_equal(out[r.id], ref[r.id])


def test_swap_from_sharded_checkpoint(tele, tmp_path):
    """Format 2 (per-rank shard files, no gathered ``params.nd``) swaps
    in, and a second swap bumps the generation to 2."""
    net_a, net_b = _tiny_model(0), _tiny_model(7)
    ckdir = _ckpt(net_b, str(tmp_path / "shard_ck"), sharded=True)
    with open(os.path.join(ckdir, "step-1", "meta.json")) as f:
        assert json.load(f)["format"] == 2
    assert not os.path.exists(os.path.join(ckdir, "step-1", "params.nd"))
    eng = _engine(net_a)
    assert eng.swap_weights(ckdir) == 1
    assert eng.weight_generation == 1
    q = np.array([3, 4, 5], np.int32)
    got = eng.serve([Request(q, max_new_tokens=6, bos_id=BOS, eos_id=EOS,
                             request_id="s0")])["s0"]
    ref = _engine(net_b).serve(
        [Request(q, max_new_tokens=6, bos_id=BOS, eos_id=EOS,
                 request_id="s1")])["s1"]
    np.testing.assert_array_equal(got, ref)
    assert eng.swap_weights(_ckpt(_tiny_model(0),
                                  str(tmp_path / "back"))) == 1
    assert eng.weight_generation == 2


# ---------------------------------------------------------------------------
# rejection: verify before publish
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("other", ["smaller", "vocab", "bfloat16"])
def test_swap_rejected_on_structure_mismatch(other, tele, tmp_path):
    """A checkpoint of another structure is rejected loudly: the old
    weights keep serving, the generation stays, staging stays empty, and
    a rejected ``weight_swap`` event books the reason."""
    if other == "smaller":
        src = Transformer(16, units=16, hidden_size=32, num_heads=4,
                          num_layers=1, max_length=48, dropout=0.0,
                          device="cpu")
    elif other == "vocab":
        src = Transformer(24, device="cpu", **CFG)
    else:
        src = _tiny_model(7).cast("bfloat16")
    ckdir = _ckpt(src, str(tmp_path / "ck"))
    eng = _engine(_tiny_model(0))
    q = np.array([3, 4, 5], np.int32)
    before = eng.serve([Request(q, max_new_tokens=5, bos_id=BOS,
                                eos_id=EOS, request_id="p0")])["p0"]
    with pytest.raises(MXNetError, match="fingerprint|missing parameter"):
        eng.swap_weights(ckdir)
    assert eng.weight_generation == 0 and not eng._staging
    assert eng._swap_pending is None
    after = eng.serve([Request(q, max_new_tokens=5, bos_id=BOS,
                               eos_id=EOS, request_id="p1")])["p1"]
    np.testing.assert_array_equal(before, after)
    rej = [e for e in _events(tele, "weight_swap") if e.get("rejected")]
    assert len(rej) == 1 and rej[0]["generation"] == 0
    assert telemetry.summary()["serving"]["weight_generation"] == 0


def _trained_reverse_net(seed=7):
    """A net trained a little on the reverse task: an untrained net
    parrots a forced prefix whatever its weights, which would hide a
    failed invalidation."""
    from mxnet_tpu_torch.parallel import DataParallelStep

    rng = np.random.RandomState(2)
    L = 6
    src = np.zeros((8, L + 1), np.int32)
    tgt_in = np.zeros((8, L + 2), np.int32)
    tgt_out = np.zeros((8, L + 2), np.int32)
    for b in range(8):
        toks = rng.randint(3, 16, L)
        src[b, :L] = toks
        tgt_in[b, 0] = BOS
        tgt_in[b, 1:L + 1] = toks[::-1]
        tgt_out[b, :L] = toks[::-1]
        tgt_out[b, L] = EOS
    net = _tiny_model(seed)
    step = DataParallelStep(
        net, lambda lo, la: label_smoothed_ce(lo, la, smoothing=0.0),
        optimizer="adam", optimizer_params={"learning_rate": 5e-3},
        device="cpu")
    for _ in range(16):
        step.step((src, tgt_in), tgt_out.astype(np.float32))
    return net


def test_swap_invalidates_prefix_cache(tele, tmp_path):
    """Prefix-cache entries are generation-stamped and die at the flip:
    a post-swap request with the SAME (source, prefix) misses,
    re-ingests under the new weights, and decodes what a fresh engine on
    the new checkpoint decodes."""
    net_a, net_b = _tiny_model(0), _trained_reverse_net()
    ckdir = _ckpt(net_b, str(tmp_path / "ck"))
    src = np.array([3, 4, 5], np.int32)
    prefix = np.array([6, 7, 8, 9, 10], np.int32)

    def mk(rid):
        return Request(src, max_new_tokens=5, bos_id=BOS, eos_id=-1,
                       request_id=rid, prefix=prefix)

    eng = _engine(net_a, prefix_cache=True)
    eng.serve([mk("r0")])
    eng.serve([mk("r1")])
    assert eng._prefix.hits == 2 and len(eng._prefix) == 2
    assert eng._cache.num_pages - 1 - eng._cache.pages_free > 0
    assert eng.swap_weights(ckdir) == 1
    assert len(eng._prefix) == 0
    assert eng._cache.pages_free == eng._cache.num_pages - 1
    out = eng.serve([mk("r2")])["r2"]
    assert eng._prefix.hits == 2, "post-swap request must MISS, not fork"
    ref = _engine(net_b, prefix_cache=True).serve([mk("r3")])["r3"]
    np.testing.assert_array_equal(out, ref)
    old = _engine(_tiny_model(0), prefix_cache=True).serve([mk("r4")])["r4"]
    assert not np.array_equal(out, old)
    inval = _events(tele, "serve_prefix_invalidate")
    assert len(inval) == 1 and inval[0]["dropped"] == 2


def test_swap_rejects_missing_or_torn_checkpoint(tmp_path):
    eng = _engine(_tiny_model(0))
    os.makedirs(str(tmp_path / "empty"), exist_ok=True)
    with pytest.raises(MXNetError, match="no valid checkpoint"):
        eng.swap_weights(str(tmp_path / "empty"))
    ckdir = _ckpt(_tiny_model(7), str(tmp_path / "ck"))
    pnd = os.path.join(ckdir, "step-1", "params.nd")
    with open(pnd, "r+b") as f:
        f.truncate(os.path.getsize(pnd) // 2)
    with pytest.raises(MXNetError, match="no valid checkpoint"):
        eng.swap_weights(ckdir)
    assert eng.weight_generation == 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_jax_written_checkpoint_swaps_into_port_engine(tmp_path):
    """The JAX package's checkpoint of a JAX net swapped mid-stream into
    both packages' engines (same starting weights, carried by name): the
    streams, before and after the flip, are equal token for token."""
    import mxnet_tpu as mx
    from mxnet_tpu import checkpoint as jckpt
    from mxnet_tpu import nd
    from mxnet_tpu.models.transformer import Transformer as JaxTransformer
    from mxnet_tpu.serving import Request as JaxRequest
    from mxnet_tpu.serving import ServingEngine as JaxServingEngine
    from mxnet_tpu.serving import TransformerAdapter as JaxAdapter
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params

    def jax_net(seed):
        mx.random.seed(seed)
        net = JaxTransformer(16, **CFG)
        net.initialize(mx.init.Xavier())
        net(nd.array([[3, 4, 5, 0, 0]], dtype="int32"),
            nd.array([[BOS, 3, 4, 5, 0, 0]], dtype="int32"))
        return net

    ja, jb = jax_net(0), jax_net(7)
    ckdir = str(tmp_path / "ck")
    ck = jckpt.AsyncCheckpointer(ckdir, save_every=1)
    ck.step(jb)
    ck.close()
    ta = Transformer(16, device="cpu", init_weights=False, **CFG)
    from_mxnet_tpu_params(ta, {k: p.data().asnumpy() for k, p in
                               ja.collect_params().items()}, ja.prefix)
    kw = dict(slots=2, page_size=4, max_len=16, stream_every=2)
    jeng = JaxServingEngine(JaxAdapter(ja, src_max_len=8), **kw)
    teng = _engine(ta)
    rng = np.random.RandomState(3)
    srcs = [rng.randint(3, 16, 5) for _ in range(4)]
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        seen = {}
        _stage_at_first_boundary(eng, ckdir, seen)
        reqs = [req_cls(s, max_new_tokens=10, bos_id=BOS, eos_id=EOS,
                        request_id=f"x{i}") for i, s in enumerate(srcs)]
        out = eng.serve(reqs, arrival_steps=[0, 0, 8, 8])
        assert eng.weight_generation == 1 and seen["flips"] == [2]
        outs.append({k: list(v) for k, v in out.items()})
    assert outs[1] == outs[0]
    # the post-flip requests decode on the new weights
    fresh = _engine(_tiny_model(5))
    assert checkpoint.restore(ckdir, fresh._adapter.model) == 1
    ref = fresh.serve([Request(s, max_new_tokens=10, bos_id=BOS,
                               eos_id=EOS, request_id=f"x{i}")
                       for i, s in enumerate(srcs[2:], start=2)])
    for k, v in ref.items():
        assert outs[1][k] == list(v)
