"""``Transformer.translate`` (beam search on the paged KV cache) and
``DenseStepCache`` of the port against the JAX package.

The weights: the reverse-task net trained in the JAX package (the recipe
of tests/test_serving.py), carried into the port.  The JAX ``translate``
runs its default path (the XLA gather, the plain reference of the Pallas
paged kernel); the port's runs K1's and K2's plain versions.  Hypotheses
are compared exactly.  Dense and paged decode logits agree within atol
1e-5 (K2's plain version and the dense attention reduce in other orders).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models.transformer import Transformer as JaxTransformer
from mxnet_tpu.models.transformer import label_smoothed_ce
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.models.transformer import DenseStepCache, Transformer
from mxnet_tpu_torch.serving import (PagedKVCache, PagedStepCache, Request,
                                     ServingEngine, TransformerAdapter,
                                     page_coords)

PAD, BOS, EOS = 0, 1, 2
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=20, dropout=0.0)


@pytest.fixture(scope="module")
def trained():
    from mxnet_tpu.parallel import DataParallelStep, local_mesh

    rng = np.random.RandomState(2)
    src = np.zeros((8, 7), np.int32)
    tgt_in = np.zeros((8, 8), np.int32)
    tgt_out = np.zeros((8, 8), np.int32)
    for b in range(8):
        toks = rng.randint(3, 16, 6)
        src[b, :6] = toks
        tgt_in[b, 0] = BOS
        tgt_in[b, 1:7] = toks[::-1]
        tgt_out[b, :6] = toks[::-1]
        tgt_out[b, 6] = EOS
    mx.random.seed(0)
    jnet = JaxTransformer(16, **CFG)
    jnet.initialize(mx.init.Xavier())
    step = DataParallelStep(
        jnet, lambda lo, la: label_smoothed_ce(lo, la, smoothing=0.0),
        mesh=local_mesh(devices=[mx.current_context().jax_device]),
        optimizer="adam", optimizer_params={"learning_rate": 5e-3})
    sb, tb = nd.array(src, dtype="int32"), nd.array(tgt_in, dtype="int32")
    lb = nd.array(tgt_out.astype(np.float32))
    # fewer steps than the serving tests' 48: a half-trained net leaves
    # the beams real choices to make
    for _ in range(24):
        step.step((sb, tb), lb)
    step.sync_to_block()
    tnet = Transformer(16, device="cpu", **CFG)
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy()
                                 for k, p in jnet.collect_params().items()},
                          jnet.prefix)
    return jnet, tnet, src


@pytest.mark.parametrize("beam,incremental", [(1, True), (3, True),
                                              (4, True), (1, False),
                                              (3, False), (4, False)])
def test_translate_equals_jax(trained, beam, incremental):
    jnet, tnet, src = trained
    sb = src[:2]
    want = jnet.translate(nd.array(sb, dtype="int32"), bos_id=BOS,
                          eos_id=EOS, max_len=8, beam_size=beam,
                          incremental=incremental, page_size=4)
    got = tnet.translate(torch.from_numpy(sb), bos_id=BOS, eos_id=EOS,
                         max_len=8, beam_size=beam, incremental=incremental,
                         page_size=4)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == BOS).all()


def test_translate_beam1_equals_greedy_engine(trained):
    """translate(beam_size=1) is the greedy engine's stream, token for
    token (both take argmax over log-softmax)."""
    _, tnet, src = trained
    eng = ServingEngine(TransformerAdapter(tnet, src_max_len=7), slots=3,
                        page_size=4, max_len=12, stream_every=4,
                        device="cpu")
    reqs = [Request(src[i], max_new_tokens=9, bos_id=BOS, eos_id=EOS)
            for i in range(5)]
    out = eng.serve(reqs, arrival_steps=[0, 0, 0, 2, 5])
    hyp = tnet.translate(torch.from_numpy(src[:5]), bos_id=BOS, eos_id=EOS,
                         max_len=10, beam_size=1)
    for i, r in enumerate(reqs):
        ref = list(hyp[i, 1:])
        if EOS in ref:
            ref = ref[:ref.index(EOS) + 1]
        assert list(out[r.id]) == ref, f"request {i}"


def test_translate_sync_cadence_invariant(trained):
    """The early-exit cadence does not change the result: syncing every
    step == never syncing mid-loop."""
    _, tnet, src = trained
    sb = torch.from_numpy(src[:2])
    a = tnet.translate(sb, bos_id=BOS, eos_id=EOS, max_len=10, beam_size=3,
                       sync_every=1)
    b = tnet.translate(sb, bos_id=BOS, eos_id=EOS, max_len=10, beam_size=3,
                       sync_every=0)
    np.testing.assert_array_equal(a, b)


def test_translate_rejects_max_len_past_the_table(trained):
    _, tnet, src = trained
    with pytest.raises(MXNetError, match="positional table"):
        tnet.translate(torch.from_numpy(src[:1]), bos_id=BOS, eos_id=EOS,
                       max_len=40)


def test_dense_step_cache_equals_paged(trained):
    """Four decode steps through per-layer DenseStepCaches and through
    the paged cache (K2's plain version) from the same tokens: equal
    greedy tokens, logits within atol 1e-5."""
    _, tnet, src = trained
    B, L, ps = 3, 8, 4
    sb = torch.from_numpy(src[:B])
    with torch.no_grad():
        mem, keep_src = tnet._encode_h(sb)
        sa = tnet.decoder.layers[0].self_attn
        C = sa.num_heads * sa.head_dim
        n_layers = len(tnet.decoder.layers)
        dense = [(torch.zeros(B, L, C), torch.zeros(B, L, C))
                 for _ in range(n_layers)]
        cache = PagedKVCache(n_layers, B * 2 + 1, ps, sa.num_heads,
                             sa.head_dim, device="cpu")
        table = (1 + torch.arange(B * 2, dtype=torch.int32)).reshape(B, 2)
        tok = torch.full((B, 1), BOS, dtype=torch.int32)
        for t in range(4):
            pos = torch.tensor([t], dtype=torch.int32)
            keep = (torch.arange(L)[None] <= t).float().expand(B, L)
            lg_d = tnet._decode_step(tok, pos, mem, keep_src,
                                     [DenseStepCache(K, V, keep, t)
                                      for K, V in dense])
            pages, rows = page_coords(table, pos, ps)
            lengths = (pos + 1).expand(B).contiguous()
            lg_p = tnet._decode_step(tok, pos, mem, keep_src,
                                     [PagedStepCache(k, v, table, pages,
                                                     rows, lengths)
                                      for k, v in cache.pools])
            np.testing.assert_allclose(lg_d.numpy(), lg_p.numpy(),
                                       atol=1e-5, rtol=0)
            nxt = torch.argmax(lg_d, dim=-1).to(torch.int32)
            assert torch.equal(nxt, torch.argmax(lg_p, dim=-1).to(torch.int32))
            tok = nxt[:, None]
