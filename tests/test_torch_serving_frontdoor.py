"""The serving front door of the port's engine against the JAX engine,
case for case with tests/test_serving_frontdoor.py: seeded sampling,
speculative decoding, the copy-on-write prefix cache, ``statusz_snapshot``
and ``serve_beam``.

The weights: a tiny Transformer memorising the reverse task is trained in
the JAX package (the recipe of tests/test_serving_frontdoor.py, so greedy
tokens are decision-stable) and carried into the port; the sampling cases
use the untrained net (flat logits, so samples differ from greedy), also
carried.  Both engines run in this process on the CPU, the JAX engine on
its default path (the XLA gather, the plain reference of the Pallas
kernel), the port on K1's and K2's plain versions.  Tokens are compared
exactly.  Seeds do not carry across the packages, so the sampled-tokens
cases replace both packages' Gumbel and uniform draws by one fixed numpy
noise (one row per slot, the same at every step).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models.transformer import Transformer as JaxTransformer
from mxnet_tpu.models.transformer import label_smoothed_ce
from mxnet_tpu.serving import Request as JaxRequest
from mxnet_tpu.serving import ServingEngine as JaxServingEngine
from mxnet_tpu.serving import TransformerAdapter as JaxTransformerAdapter
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.models.transformer import Transformer
from mxnet_tpu_torch.serving import Request, ServingEngine, TransformerAdapter

PAD, BOS, EOS = 0, 1, 2
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=20, dropout=0.0)
ARRIVALS = [0, 0, 3, 6]


def _reverse_batch(rng, B, L=6, vocab=16):
    src = np.zeros((B, L + 1), np.int32)
    tgt_in = np.zeros((B, L + 2), np.int32)
    tgt_out = np.zeros((B, L + 2), np.int32)
    for b in range(B):
        toks = rng.randint(3, vocab, L)
        src[b, :L] = toks
        tgt_in[b, 0] = BOS
        tgt_in[b, 1:L + 1] = toks[::-1]
        tgt_out[b, :L] = toks[::-1]
        tgt_out[b, L] = EOS
    return src, tgt_in, tgt_out


def _carry(jnet):
    tnet = Transformer(16, device="cpu", **dict(
        CFG, max_length=jnet.pos._max_length))
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy()
                                 for k, p in jnet.collect_params().items()},
                          jnet.prefix)
    return tnet


@pytest.fixture(scope="module")
def trained():
    """The JAX net memorising the reverse task, its port twin and the
    sources."""
    from mxnet_tpu.parallel import DataParallelStep, local_mesh

    mx.random.seed(0)
    jnet = JaxTransformer(16, **CFG)
    jnet.initialize(mx.init.Xavier())
    src, tgt_in, tgt_out = _reverse_batch(np.random.RandomState(2), 8)
    step = DataParallelStep(
        jnet, lambda lo, la: label_smoothed_ce(lo, la, smoothing=0.0),
        mesh=local_mesh(devices=[mx.current_context().jax_device]),
        optimizer="adam", optimizer_params={"learning_rate": 5e-3})
    sb, tb = nd.array(src, dtype="int32"), nd.array(tgt_in, dtype="int32")
    lb = nd.array(tgt_out.astype(np.float32))
    for _ in range(48):
        step.step((sb, tb), lb)
    step.sync_to_block()
    return jnet, _carry(jnet), src


@pytest.fixture(scope="module")
def fresh():
    """An untrained net (flat logits) in both packages."""
    mx.random.seed(1)
    jnet = JaxTransformer(16, **dict(CFG, max_length=48))
    jnet.initialize(mx.init.Xavier())
    one = nd.array(np.array([[3, 4]], np.int32), dtype="int32")
    jnet(one, one)  # the deferred shapes
    return jnet, _carry(jnet)


def _engines(jnet, tnet, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 16)
    kw.setdefault("stream_every", 4)
    return (JaxServingEngine(JaxTransformerAdapter(jnet, src_max_len=7),
                             **kw),
            ServingEngine(TransformerAdapter(tnet, src_max_len=7),
                          device="cpu", **kw))


def _serve(eng, req_cls, sources, arrivals=None, **req_kw):
    reqs = [req_cls(s, bos_id=BOS, **req_kw) for s in sources]
    out = eng.serve(reqs, arrival_steps=arrivals)
    return [list(out[r.id]) for r in reqs], reqs


@pytest.fixture(scope="module")
def jax_greedy(trained):
    """The JAX greedy engine's tokens for the first 4 sources."""
    jnet, tnet, src = trained
    jeng, _ = _engines(jnet, tnet)
    toks, _ = _serve(jeng, JaxRequest, src[:4], ARRIVALS, max_new_tokens=9,
                     eos_id=EOS)
    return toks


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_sampling_temp_zero_equals_jax_greedy(trained, jax_greedy):
    """Temperature 0 through the sampling engine is the greedy lane: the
    JAX greedy engine's tokens, and the port's greedy engine's."""
    jnet, tnet, src = trained
    _, teng = _engines(jnet, tnet, sampling=True)
    got, reqs = _serve(teng, Request, src[:4], ARRIVALS, max_new_tokens=9,
                       eos_id=EOS)
    assert got == jax_greedy
    assert all(r.temperature == 0.0 for r in reqs)
    _, plain = _engines(jnet, tnet)
    assert _serve(plain, Request, src[:4], ARRIVALS, max_new_tokens=9,
                  eos_id=EOS)[0] == jax_greedy


def _sampled(tnet, prompts, slots, temp, pool_pages=None, **kw):
    eng = ServingEngine(TransformerAdapter(tnet, src_max_len=7), slots=slots,
                        page_size=4, max_len=16, stream_every=4,
                        pool_pages=pool_pages, sampling=True, device="cpu",
                        **kw)
    reqs = [Request(p, max_new_tokens=8, bos_id=BOS, eos_id=-1,
                    temperature=temp, top_k=6, top_p=0.9, seed=100 + i)
            for i, p in enumerate(prompts)]
    out = eng.serve(reqs)
    return [list(out[r.id]) for r in reqs], reqs


def test_seeded_sampling_reproducible_across_restarts(fresh):
    """A sampled stream is a function of the request and its seed: a
    fresh engine with another slot count replays it token for token, and
    it differs from greedy; distinct seeds give distinct streams."""
    tnet = fresh[1]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 16, 5) for _ in range(4)]
    first, _ = _sampled(tnet, prompts, 3, 0.9)
    assert _sampled(tnet, prompts, 2, 0.9)[0] == first
    assert first != _sampled(tnet, prompts, 3, 0.0)[0]
    assert len({tuple(s) for s in first}) > 1


def test_seeded_sampling_survives_preemption(fresh):
    """A pool too small for both requests preempts one mid-decode; its
    re-admission re-derives the same stream."""
    tnet = fresh[1]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(3, 16, 5) for _ in range(2)]
    roomy, _ = _sampled(tnet, prompts, 2, 0.9)
    tight, reqs = _sampled(tnet, prompts, 2, 0.9, pool_pages=4)
    assert sum(r.preemptions for r in reqs) >= 1
    assert tight == roomy


def test_sampling_rejected_on_greedy_engine(fresh):
    _, teng = _engines(*fresh)
    with pytest.raises(MXNetError, match="sampling=True"):
        teng.submit(Request(np.array([3, 4], np.int32), max_new_tokens=4,
                            bos_id=BOS, eos_id=EOS, temperature=0.7))


def _same_noise(monkeypatch, slots, vocab):
    """Replace both packages' noise by one numpy source: a Gumbel row and
    an accept coin per slot, the same at every step (a seed whose rows
    overrule this net's logits at times)."""
    import jax.numpy as jnp
    import mxnet_tpu.serving.engine as jax_engine
    from mxnet_tpu_torch.serving import sampling

    rng = np.random.RandomState(3)
    G = rng.gumbel(size=(slots, vocab)).astype(np.float32)
    U = rng.uniform(size=(slots,)).astype(np.float32)
    monkeypatch.setattr(jax_engine, "_gumbel_rows",
                        lambda subs, V: jnp.asarray(G))
    monkeypatch.setattr(jax_engine, "_uniform_rows",
                        lambda subs: jnp.asarray(U))

    def rows(a, ctr):
        t = torch.from_numpy(a)
        return t.reshape(slots, *([1] * (ctr.dim() - 1)), *a.shape[1:]) \
            .expand(*ctr.shape, *a.shape[1:])

    monkeypatch.setattr(sampling, "_gumbel_rows",
                        lambda key, ctr, V: rows(G, ctr))
    monkeypatch.setattr(sampling, "_uniform_rows",
                        lambda key, ctr: rows(U, ctr))


@pytest.mark.parametrize("spec_k", [0, 2])
def test_sampled_tokens_equal_jax_under_one_noise(fresh, monkeypatch,
                                                  spec_k):
    """With the same noise in both packages, the port's filter, Gumbel
    selection and (with spec_k 2) accept/resample give the JAX engine's
    sampled tokens, with the same draft counts."""
    jnet, tnet = fresh
    _same_noise(monkeypatch, 3, 16)
    jeng, teng = _engines(jnet, tnet, sampling=True, spec_k=spec_k)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, 16, 5) for _ in range(4)]
    kw = dict(max_new_tokens=9, eos_id=-1, temperature=0.9, top_k=6,
              top_p=0.9)
    want, _ = _serve(jeng, JaxRequest, prompts, ARRIVALS, **kw)
    got, _ = _serve(teng, Request, prompts, ARRIVALS, **kw)
    assert got == want
    greedy, _ = _serve(_engines(jnet, tnet)[1], Request, prompts, ARRIVALS,
                       max_new_tokens=9, eos_id=-1)
    assert got != greedy, "the noise must have chosen some tokens"
    assert (teng._spec_proposed, teng._spec_accepted) == \
        (jeng._spec_proposed, jeng._spec_accepted)
    if spec_k:
        assert teng._spec_proposed > 0


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 4])
def test_spec_decode_equals_plain_and_jax(trained, jax_greedy, K):
    """Draft + one verify dispatch per boundary emits the plain greedy
    tokens, and proposes and accepts what the JAX engine does."""
    jnet, tnet, src = trained
    jeng, teng = _engines(jnet, tnet, spec_k=K)
    want, _ = _serve(jeng, JaxRequest, src[:4], ARRIVALS, max_new_tokens=9,
                     eos_id=EOS)
    got, _ = _serve(teng, Request, src[:4], ARRIVALS, max_new_tokens=9,
                    eos_id=EOS)
    assert got == want == jax_greedy
    assert teng._spec_proposed > 0
    assert 0 < teng._spec_accepted <= teng._spec_proposed
    assert (teng._spec_proposed, teng._spec_accepted) == \
        (jeng._spec_proposed, jeng._spec_accepted)
    assert teng.pages_free == teng.num_pages - 1


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------
def _continuation(eng, req_cls, src, prefix):
    reqs = [req_cls(src, max_new_tokens=6, bos_id=BOS, eos_id=-1,
                    prefix=prefix) for _ in range(2)]
    eng.serve([reqs[0]])   # cold: miss, ingest (and register)
    eng.serve([reqs[1]])   # warm: a copy-on-write fork when the cache is on
    return [list(r.stream) for r in reqs], reqs


def test_prefix_fork_and_continuation_equal_jax(trained):
    """A forced prefix continues the plain greedy stream exactly; a cache
    hit (page fork) equals the cold ingest, cache on or off; the hits and
    misses are the JAX engine's; the entry's pages come back when it is
    dropped."""
    jnet, tnet, src = trained
    _, plain_eng = _engines(jnet, tnet)
    plain = _serve(plain_eng, Request, src[:1], max_new_tokens=11,
                   eos_id=-1)[0][0]
    prefix = np.asarray(plain[:5], np.int32)  # a full page + a tail of 1
    jeng, teng = _engines(jnet, tnet, prefix_cache=True)
    (cold, warm), reqs = _continuation(teng, Request, src[0], prefix)
    assert cold == plain[5:11]
    assert warm == cold, "the fork must equal the teacher-forced miss"
    assert [r.prefix_hit for r in reqs] == [False, True]
    (jcold, jwarm), _ = _continuation(jeng, JaxRequest, src[0], prefix)
    assert (jcold, jwarm) == (cold, warm)
    assert (teng._prefix.hits, teng._prefix.misses) == \
        (jeng._prefix.hits, jeng._prefix.misses)
    assert teng._prefix.hits >= 1 and teng._prefix.misses >= 1
    assert teng.pages_free == jeng._cache.pages_free
    assert teng.pages_free < teng.num_pages - 1, "the entry holds pages"
    while teng._drop_one_prefix_entry():
        pass
    assert teng.pages_free == teng.num_pages - 1
    _, off = _engines(jnet, tnet)
    assert _continuation(off, Request, src[0], prefix)[0] == [cold, cold]
    assert off.pages_free == off.num_pages - 1


def test_prefix_over_capacity_rejected(fresh):
    _, teng = _engines(*fresh, prefix_cache=True)  # max_len 16
    with pytest.raises(MXNetError, match="max_len"):
        teng.submit(Request(np.array([3], np.int32), max_new_tokens=9,
                            bos_id=BOS, eos_id=EOS,
                            prefix=np.arange(3, 11, dtype=np.int32)))


def test_prefix_pool_pressure_drops_entries_before_preempting(trained):
    """Pool pressure takes back a cached entry's pages before it would
    preempt a live request, and the tokens stay those of a roomy
    engine."""
    jnet, tnet, src = trained
    prefix = np.array([5, 6, 7, 8, 9], np.int32)
    kw = dict(prefix_cache=True, slots=2)
    _, roomy = _engines(jnet, tnet, **kw)
    # 7 usable pages: two live requests of one (source, prefix) need 7
    # (the shared full page and 3 private each), the entry's tail copy an
    # 8th
    _, tight = _engines(jnet, tnet, pool_pages=8, **kw)
    outs = []
    for eng in (roomy, tight):
        reqs = [Request(src[0], max_new_tokens=9, bos_id=BOS, eos_id=-1,
                        prefix=prefix) for _ in range(3)]
        out = eng.serve(reqs)
        outs.append([list(out[r.id]) for r in reqs])
        assert sum(r.preemptions for r in reqs) == 0
    assert outs[0] == outs[1]
    # the dropped entry costs the tight engine a later miss
    assert tight._prefix.misses > roomy._prefix.misses


def _live_rows(eng, slot, pos):
    """Every layer's K and V rows ``[0, pos)`` of ``slot``, gathered
    through its page table."""
    pages = eng._state["table"][slot].long()
    return [p[pages].flatten(0, 1)[:pos].clone()
            for kv in eng._cache.pools for p in kv]


def test_ingest_mid_decode_keeps_live_rows():
    """A prefix ingest writes ``_prefix_chunk`` positions past every
    slot's pos, live ones included. With max_len 60 on pages of 16 a
    table sized for the burst alone has 64 rows: a live slot at pos 59
    would see its writes at 64..66 clamp onto rows 48..50 of its own last
    page. The table covers the chunk, so every live row survives the
    ingest and both requests give their tokens served alone."""
    net = Transformer(16, device="cpu", generator=torch.Generator()
                      .manual_seed(3), **dict(CFG, max_length=64))
    adapter = TransformerAdapter(net, src_max_len=7)
    kw = dict(slots=2, page_size=16, max_len=60, stream_every=4,
              device="cpu")
    rng = np.random.RandomState(0)
    a = (rng.randint(3, 16, 6), 57, np.array([5, 6, 7], np.int32))
    b = (rng.randint(3, 16, 6), 8, np.array([4, 9, 3], np.int32))

    def serve(pairs, arrivals, spy=False):
        eng = ServingEngine(adapter, **kw)
        seen = []
        if spy:
            ingest = eng._ingest_body

            def checked(feed, n):
                live = [(s, int(eng._state["pos"][s]))
                        for s, m in enumerate(eng._slots)
                        if m is not None and int(n[s]) == 0]
                before = {s: _live_rows(eng, s, p) for s, p in live}
                ingest(feed, n)
                for s, p in live:
                    seen.append(p)
                    assert all(torch.equal(x, y) for x, y in zip(
                        before[s], _live_rows(eng, s, p))), \
                        f"the ingest wrote slot {s}'s rows below pos {p}"
            eng._ingest_body = checked
        reqs = [Request(src, n, bos_id=BOS, eos_id=-1, prefix=pre)
                for src, n, pre in pairs]
        out = eng.serve(reqs, arrival_steps=arrivals)
        return [list(out[r.id]) for r in reqs], seen

    (got_a, got_b), seen = serve([a, b], [0, 56], spy=True)
    assert seen == [59], "b's ingest must land while a decodes at pos 59"
    assert got_a == serve([a], [0])[0][0]
    assert got_b == serve([b], [0])[0][0]


def test_failed_prefix_admission_keeps_fcfs_order(fresh):
    """A request whose prefix does not fit goes back to the queue head
    ahead of the requests popped behind it, in their order."""
    _, teng = _engines(*fresh, prefix_cache=True)
    prefix = np.array([5, 6, 7], np.int32)
    reqs = [Request(np.array([3, 4], np.int32), max_new_tokens=4,
                    bos_id=BOS, eos_id=-1, prefix=prefix if i == 1 else None)
            for i in range(3)]
    for r in reqs:
        teng.submit(r)
    teng._install_prefix = lambda *args: False  # the pool is short once
    assert teng._admit_ready() == 1
    assert [r.id for r in teng._sched._q] == [reqs[1].id, reqs[2].id]
    del teng._install_prefix
    teng.run()
    assert all(r.stream.finished and len(r.stream) == 4 for r in reqs)
    while teng._drop_one_prefix_entry():
        pass
    assert teng.pages_free == teng.num_pages - 1


# ---------------------------------------------------------------------------
# statusz and beam serving
# ---------------------------------------------------------------------------
def test_statusz_snapshot_equals_jax(fresh):
    jeng, teng = _engines(*fresh, sampling=True, spec_k=2, prefix_cache=True)
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        eng.serve([cls(np.array([3, 4, 5], np.int32), max_new_tokens=4,
                       bos_id=BOS, eos_id=EOS)])
    snap, want = teng.statusz_snapshot(), jeng.statusz_snapshot()
    assert snap == want
    assert snap["precision"] == "fp32" and snap["sampling"] is True
    assert snap["active_slots"] == 0 and snap["steps"] > 0


def test_serve_beam_equals_jax_and_translate(trained):
    """serve_beam batches the requests through translate: the JAX
    serve_beam's tokens, and the port's translate per request."""
    jnet, tnet, src = trained
    jeng, teng = _engines(jnet, tnet)
    jreqs = [JaxRequest(src[i], max_new_tokens=9, bos_id=BOS, eos_id=EOS)
             for i in range(3)]
    jout = jeng.serve_beam(jreqs, beam_size=3)
    treqs = [Request(src[i], max_new_tokens=9, bos_id=BOS, eos_id=EOS)
             for i in range(3)]
    tout = teng.serve_beam(treqs, beam_size=3)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert list(tout[tr.id]) == list(jout[jr.id]), f"request {i}"
        assert tr.stream.finished
        ref = list(tnet.translate(torch.from_numpy(src[i:i + 1]), bos_id=BOS,
                                  eos_id=EOS, max_len=10, beam_size=3)[0, 1:])
        if EOS in ref:
            ref = ref[:ref.index(EOS) + 1]
        assert list(tout[tr.id]) == ref[:9]
    with pytest.raises(MXNetError, match="beam serving"):
        teng.serve_beam([Request(src[0], 4, BOS, EOS, prefix=[3])])
