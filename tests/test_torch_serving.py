"""The port's paged KV cache, scheduler and serving engine, alone and
against the JAX package's engine.

The slice as a whole: a tiny Transformer memorising the reverse task is
trained in the JAX package (the recipe of tests/test_serving.py's
``trained`` fixture, so greedy tokens are decision-stable), its weights
carried into the port, and the same requests served by both engines with
mid-flight arrivals.  The JAX engine runs the TPU path's kernels in
interpret mode (``TransformerAdapter(fused=True)`` for the paged kernel,
``MX_PALLAS_FUSED=1`` for the LayerNorm kernel); the port runs kernel
K1's and K2's plain versions.  Tokens must be equal, token for token.
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
from mxnet_tpu_torch.models.transformer import Transformer, _attend_cached
from mxnet_tpu_torch.serving import (ContinuousBatchingScheduler, PagedKVCache,
                                     PagedStepCache, Request, ServingEngine,
                                     TransformerAdapter, gather_pages,
                                     page_coords, paged_attend, write_page)

PAD, BOS, EOS = 0, 1, 2
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=20, dropout=0.0)


# ---------------------------------------------------------------------------
# paged cache math and allocator (the cases of tests/test_serving.py)
# ---------------------------------------------------------------------------
def test_paged_allocator_alloc_free_exhaustion():
    cache = PagedKVCache(1, 6, 4, 2, 4, device="cpu")  # page 0 is trash
    assert cache.pages_free == 5
    got = cache.alloc("a", 3)
    assert len(got) == 3 and 0 not in got
    assert cache.alloc("b", 3) is None, "all-or-nothing"
    assert cache.pages_free == 2
    assert cache.alloc("b", 2) is not None
    assert cache.pages_free == 0
    assert cache.free_slot("a") == 3
    assert cache.pages_free == 3
    row = cache.table_row("b", 4)
    assert row.shape == (4,) and row.dtype == np.int32
    assert (row[2:] == 0).all()
    with pytest.raises(MXNetError):
        PagedKVCache(1, 1, 4, 2, 4, device="cpu")


def test_paged_allocator_adopt_refcounts():
    cache = PagedKVCache(1, 6, 4, 2, 4, device="cpu")
    pages = cache.alloc("a", 2)
    cache.adopt("b", pages)
    assert [cache.refcount(p) for p in pages] == [2, 2]
    assert cache.free_slot("a") == 0, "shared pages outlive one owner"
    assert cache.free_slot("b") == 2
    assert cache.pages_free == 5
    with pytest.raises(MXNetError, match="not currently owned"):
        cache.adopt("c", pages)


def test_write_page_and_coords_roundtrip():
    rng = np.random.RandomState(1)
    S, H, hd, ps, P = 4, 2, 4, 4, 2
    pool = torch.zeros((S * P + 1, ps, H, hd))
    table = torch.from_numpy(
        1 + np.arange(S * P, dtype=np.int32).reshape(S, P))
    pos = torch.tensor([0, 3, 4, 7], dtype=torch.int32)
    vals = torch.from_numpy(rng.randn(S, H, hd).astype(np.float32))
    pages, rows = page_coords(table, pos, ps)
    write_page(pool, pages, rows, vals)  # in place
    dense = gather_pages(pool, table).numpy()  # (S, P*ps, C)
    for s, p in enumerate((0, 3, 4, 7)):
        np.testing.assert_array_equal(dense[s, p], vals[s].reshape(-1))
        assert (np.delete(dense[s], p, axis=0) == 0).all()


def test_page_coords_clamps_past_the_table():
    """An empty slot's position keeps counting; past the table it clamps
    to the last column (zero -> the trash page), never out of range."""
    table = torch.tensor([[3, 4], [0, 0]], dtype=torch.int32)
    pages, rows = page_coords(table, torch.tensor([5, 40],
                                                  dtype=torch.int32), 4)
    assert pages.tolist() == [4, 0] and rows.tolist() == [1, 0]


def _scattered_pools(rng, S, H, hd, ps, P, lens):
    C, Lmax = H * hd, ps * P
    dense_K = rng.randn(S, Lmax, C).astype(np.float32)
    dense_V = rng.randn(S, Lmax, C).astype(np.float32)
    keep = np.zeros((S, Lmax), np.float32)
    for s, L in enumerate(lens):
        keep[s, :L] = 1.0
    table = 1 + rng.permutation(S * P).reshape(S, P).astype(np.int32)
    kpool = np.zeros((S * P + 1, ps, H, hd), np.float32)
    vpool = np.zeros_like(kpool)
    for s in range(S):
        for j in range(P):
            kpool[table[s, j]] = dense_K[s, j * ps:(j + 1) * ps] \
                .reshape(ps, H, hd)
            vpool[table[s, j]] = dense_V[s, j * ps:(j + 1) * ps] \
                .reshape(ps, H, hd)
    t = torch.from_numpy
    return t(dense_K), t(dense_V), t(keep), t(table), t(kpool), t(vpool)


def test_paged_attend_bitwise_identical_to_dense():
    """Gather-by-page-table attention over scattered pages is bitwise the
    dense-cache ``_attend_cached`` for the same rows."""
    rng = np.random.RandomState(0)
    S, H, hd, ps, P = 3, 4, 8, 4, 2
    K, V, keep, table, kp, vp = _scattered_pools(rng, S, H, hd, ps, P,
                                                 (5, 8, 1))
    assert torch.equal(gather_pages(kp, table), K)
    q = torch.from_numpy(rng.randn(S, 1, H * hd).astype(np.float32))
    ref = _attend_cached(q, K, V, keep, H, hd)
    assert torch.equal(paged_attend(q, kp, vp, table, keep, H, hd), ref)


def test_paged_step_cache_kernel_matches_gather():
    """PagedStepCache (kernel K2's path) agrees with the gather path for
    the same write + attend."""
    class _Attn:  # the two attributes update_and_attend reads
        num_heads, head_dim = 4, 8

    rng = np.random.RandomState(5)
    S, H, hd, ps, P = 3, 4, 8, 4, 2
    C, Lmax = H * hd, ps * P
    table = torch.from_numpy(
        1 + np.arange(S * P, dtype=np.int32).reshape(S, P))
    pos = torch.tensor([2, 5, 0], dtype=torch.int32)
    keep = (torch.arange(Lmax)[None] < (pos + 1)[:, None]).float()
    pages, rows = page_coords(table, pos, ps)
    kp = torch.from_numpy(rng.randn(S * P + 1, ps, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(S * P + 1, ps, H, hd).astype(np.float32))
    q, k, v = (torch.from_numpy(rng.randn(S, 1, C).astype(np.float32))
               for _ in range(3))
    kp2, vp2 = kp.clone(), vp.clone()
    out = PagedStepCache(kp, vp, table, pages, rows, pos + 1) \
        .update_and_attend(_Attn, q, k, v)
    write_page(kp2, pages, rows, k.reshape(S, H, hd))
    write_page(vp2, pages, rows, v.reshape(S, H, hd))
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    ref = paged_attend(q, kp2, vp2, table, keep, H, hd)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_scheduler_queue_bound_backpressure():
    sched = ContinuousBatchingScheduler(bound=2)
    sched.submit(Request([3], 4, BOS, EOS))
    sched.submit(Request([3], 4, BOS, EOS))
    with pytest.raises(MXNetError):
        sched.submit(Request([3], 4, BOS, EOS))
    assert sched.depth == 2
    ready = sched.pop_ready(free_slots=2, pages_free=1)
    assert len(ready) == 1, "one free page admits one request"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _port_net(seed=0, max_length=20):
    return Transformer(16, device="cpu", generator=torch.Generator()
                       .manual_seed(seed), **dict(CFG, max_length=max_length))


def test_engine_continuous_batching_frees_pages():
    """Slots and pages recycle mid-flight: 6 requests through 2 slots
    finish in fewer steps than one at a time, and every page returns."""
    eng = ServingEngine(TransformerAdapter(_port_net(), src_max_len=6),
                        slots=2, page_size=4, max_len=12, stream_every=4,
                        device="cpu")
    rng = np.random.RandomState(1)
    lens = [4, 9, 5, 11, 6, 8]
    reqs = [Request(rng.randint(3, 16, 4), max_new_tokens=n, bos_id=BOS,
                    eos_id=-1) for n in lens]
    out = eng.serve(reqs, arrival_steps=[0, 0, 2, 5, 7, 9])
    assert all(len(out[r.id]) == n for r, n in zip(reqs, lens))
    assert all(r.stream.finished for r in reqs)
    assert eng.step_count < sum(lens), eng.step_count
    assert eng.pages_free == eng.num_pages - 1
    assert sum(steps for steps, _ in eng.burst_times) == eng.step_count


def test_engine_rejects_what_it_cannot_serve():
    net = _port_net(max_length=16)
    with pytest.raises(MXNetError, match="max_positions"):
        ServingEngine(TransformerAdapter(net, src_max_len=6), slots=1,
                      page_size=4, max_len=32, device="cpu")
    eng = ServingEngine(TransformerAdapter(net, src_max_len=6), slots=1,
                        page_size=4, max_len=8, device="cpu")
    with pytest.raises(MXNetError, match="max_len"):
        eng.submit(Request([5], max_new_tokens=20, bos_id=BOS, eos_id=EOS))
    with pytest.raises(MXNetError, match="src_max_len"):
        eng.submit(Request(np.arange(3, 10), max_new_tokens=4, bos_id=BOS,
                           eos_id=EOS))
    tight = ServingEngine(TransformerAdapter(net, src_max_len=6), slots=2,
                          page_size=4, pool_pages=3, max_len=12,
                          stream_every=4, device="cpu")
    with pytest.raises(MXNetError, match="raise pool_pages"):
        tight.serve([Request([5, 6, 7], max_new_tokens=12, bos_id=BOS,
                             eos_id=EOS) for _ in range(2)])


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


@pytest.fixture(scope="module")
def trained():
    """The JAX net memorising the reverse task (tests/test_serving.py's
    recipe) and its port twin with the same weights."""
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
    tnet = Transformer(16, device="cpu", **CFG)
    from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}, jnet.prefix)
    return jnet, tnet, src


def _serve_both(monkeypatch, trained, n_req, max_new, eos, arrivals=None,
                **engine_kw):
    """Serve the first ``n_req`` sources through both engines; assert
    equal tokens.  Returns the port's engine and requests."""
    jnet, tnet, src = trained
    monkeypatch.setenv("MX_PALLAS_FUSED", "1")  # Pallas LayerNorm kernel
    jeng = JaxServingEngine(JaxTransformerAdapter(jnet, src_max_len=7,
                                                  fused=True), **engine_kw)
    jreqs = [JaxRequest(src[i], max_new_tokens=max_new, bos_id=BOS,
                        eos_id=eos) for i in range(n_req)]
    want = jeng.serve(jreqs, arrival_steps=arrivals)
    teng = ServingEngine(TransformerAdapter(tnet, src_max_len=7),
                         device="cpu", **engine_kw)
    treqs = [Request(src[i], max_new_tokens=max_new, bos_id=BOS,
                     eos_id=eos) for i in range(n_req)]
    got = teng.serve(treqs, arrival_steps=arrivals)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert list(got[tr.id]) == list(want[jr.id]), f"request {i}"
        assert tr.stream.finished
    assert teng.pages_free == teng.num_pages - 1
    return teng, treqs


def test_engine_tokens_equal_jax_engine(trained, monkeypatch):
    """The slice as a whole: 6 requests, mid-flight arrivals, 3 slots,
    pages of 4 — the port's engine emits the JAX engine's tokens."""
    src = trained[2]
    teng, treqs = _serve_both(
        monkeypatch, trained, 6, 9, EOS, arrivals=[0, 0, 0, 2, 5, 9],
        slots=3, page_size=4, max_len=12, stream_every=4)
    for i, r in enumerate(treqs):
        # the memorised task really decodes the reversal, then EOS
        assert list(r.stream.tokens[:6]) == list(src[i, :6][::-1])
        assert r.stream.finish_reason == "eos"


def test_engine_pool_pressure_preempts_and_matches_jax(trained, monkeypatch):
    """A pool that holds ~1.5 requests: the port preempts the youngest
    request back to the queue head and recomputes it, and still emits
    the JAX engine's tokens (greedy decode is deterministic)."""
    _, tnet, src = trained
    teng, treqs = _serve_both(
        monkeypatch, trained, 2, 6, -1, slots=2, page_size=1,
        pool_pages=10, max_len=6, stream_every=1)
    assert sum(r.preemptions for r in treqs) >= 1
    roomy = ServingEngine(TransformerAdapter(tnet, src_max_len=7),
                          slots=2, page_size=1, max_len=6, stream_every=1,
                          device="cpu")
    roomy.serve([Request(src[i], max_new_tokens=6, bos_id=BOS, eos_id=-1)
                 for i in range(2)])
    assert teng.step_count > roomy.step_count


def test_engine_bf16_pools_tokens_equal_jax_engine(trained, monkeypatch):
    """``dtype="bfloat16"`` on both engines: bf16 KV pools and encoder
    memory, f32 weights and queries (K2 reads an f32 q over bf16 pools);
    the port emits the JAX engine's tokens."""
    teng, treqs = _serve_both(
        monkeypatch, trained, 6, 9, EOS, arrivals=[0, 0, 0, 2, 5, 9],
        slots=3, page_size=4, max_len=12, stream_every=4, dtype="bfloat16")
    assert all(k.dtype == v.dtype == torch.bfloat16
               for k, v in teng._cache.pools)
    assert teng._state["mem"].dtype == torch.bfloat16
    assert teng._state["src_keep"].dtype == torch.bool
    assert all(r.stream.finish_reason == "eos" for r in treqs)


def test_engine_default_dtype_stays_float32(trained):
    """Without ``dtype`` the pools and the memory are f32, as before; a
    dtype the kernels do not take is refused."""
    tnet = trained[1]
    eng = ServingEngine(TransformerAdapter(tnet, src_max_len=7), slots=2,
                        page_size=4, max_len=8, device="cpu")
    assert all(k.dtype == v.dtype == torch.float32
               for k, v in eng._cache.pools)
    assert eng._state["mem"].dtype == torch.float32
    with pytest.raises(MXNetError, match="serving dtype"):
        ServingEngine(TransformerAdapter(tnet, src_max_len=7), slots=2,
                      page_size=4, max_len=8, device="cpu", dtype="int8")
