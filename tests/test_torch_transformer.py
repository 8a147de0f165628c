"""The port's Transformer vs the JAX package's, with the same weights.

A tiny ``Transformer(vocab=16, units=32, hidden_size=64, num_heads=4,
num_layers=2)`` is built and initialised in the JAX package, its weights
carried into the port by ``convert.from_mxnet_tpu_params`` (numpy only),
and both models see the same token inputs.  Checked: the full
``forward(src, tgt)`` logits and ``_decode_step`` logits over a paged KV
cache — on the JAX side through ``PagedStepCache(fused=True)``, the
Pallas paged kernel in interpret mode; on the port's side through
kernel K2's plain version.  Tolerance atol 1e-4: f32 throughout, sums in
a different order, and errors compound over two layers and the tied
vocabulary projection.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models.transformer import Transformer as JaxTransformer
from mxnet_tpu.serving.paged_cache import PagedKVCache as JaxPagedKVCache
from mxnet_tpu.serving.paged_cache import PagedStepCache as JaxPagedStepCache
from mxnet_tpu.serving.paged_cache import page_coords as jax_page_coords
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.models.transformer import Transformer
from mxnet_tpu_torch.serving import PagedKVCache, PagedStepCache, page_coords

ATOL = 1e-4
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=20, dropout=0.0)


def jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    jnet = JaxTransformer(16, **CFG)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.ones((1, 3), np.int32), dtype="int32"),
         nd.array(np.ones((1, 2), np.int32), dtype="int32"))
    tnet = Transformer(16, device="cpu", **CFG).eval()
    from_mxnet_tpu_params(tnet, jax_params(jnet), jnet.prefix)
    return jnet, tnet


def _src_tgt():
    rng = np.random.RandomState(3)
    src = rng.randint(3, 16, (3, 7)).astype(np.int32)
    src[1, 5:] = 0   # padded sources: the key-padding mask matters
    src[2, 2:] = 0
    tgt = rng.randint(3, 16, (3, 6)).astype(np.int32)
    tgt[:, 0] = 1
    tgt[2, 4:] = 0
    return src, tgt


def test_forward_logits_match_jax(pair):
    jnet, tnet = pair
    src, tgt = _src_tgt()
    want = jnet(nd.array(src, dtype="int32"),
                nd.array(tgt, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    assert got.shape == (3, 6, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_paged_decode_step_logits_match_jax(pair):
    """Four decode positions over a paged cache with scattered pages,
    teacher-forced with the same tokens on both sides."""
    jnet, tnet = pair
    src, tgt = _src_tgt()
    B, ps, P = src.shape[0], 2, 3
    H, hd = 4, 8
    table_np = (1 + np.random.RandomState(1).permutation(B * P)) \
        .reshape(B, P).astype(np.int32)

    jmem, jkeep = jnet._encode_h(nd, nd.array(src, dtype="int32"))
    jcache = JaxPagedKVCache(2, B * P + 1, ps, H, hd)
    jpools = [list(kv) for kv in jcache.pools]
    jtable = nd.array(table_np, dtype="int32")

    with torch.no_grad():
        tmem, tkeep = tnet._encode_h(torch.from_numpy(src))
    np.testing.assert_allclose(tmem.numpy(), jmem.asnumpy(), atol=ATOL)
    tcache = PagedKVCache(2, B * P + 1, ps, H, hd, device="cpu")
    ttable = torch.from_numpy(table_np)

    for t in range(4):
        pos_np = np.full((B,), t, np.int32)
        tok_np = tgt[:, t:t + 1]
        pos = nd.array(pos_np, dtype="int32")
        pages, rows = jax_page_coords(jtable, pos, ps)
        caches = [JaxPagedStepCache(kp, vp, jtable, pages, rows, None,
                                    lengths=pos + 1, fused=True)
                  for kp, vp in jpools]
        want = jnet._decode_step(nd, nd.array(tok_np, dtype="int32"), pos,
                                 jmem, jkeep, caches).asnumpy()
        jpools = [[c.k_pool, c.v_pool] for c in caches]

        tpos = torch.from_numpy(pos_np)
        tpages, trows = page_coords(ttable, tpos, ps)
        tcaches = [PagedStepCache(kp, vp, ttable, tpages, trows, tpos + 1)
                   for kp, vp in tcache.pools]
        with torch.no_grad():
            got = tnet._decode_step(torch.from_numpy(tok_np), tpos, tmem,
                                    tkeep, tcaches).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"decode position {t}")
    # the pools hold the same K/V the JAX cache wrote
    for (kp, vp), (jk, jv) in zip(tcache.pools, jpools):
        np.testing.assert_allclose(kp.numpy(), jk.asnumpy(), atol=ATOL)
        np.testing.assert_allclose(vp.numpy(), jv.asnumpy(), atol=ATOL)


def test_convert_refuses_missing_extra_and_misshapen(pair):
    jnet, tnet = pair
    params = jax_params(jnet)
    p = jnet.prefix
    target = Transformer(16, device="cpu", **CFG)
    short = dict(params)
    del short[p + "dec_layer1_ln3_gamma"]
    with pytest.raises(MXNetError, match="missing"):
        from_mxnet_tpu_params(target, short, p)
    with pytest.raises(MXNetError, match="extra"):
        from_mxnet_tpu_params(target, dict(params, **{p + "bogus": 0}), p)
    bad = dict(params)
    bad[p + "embed_weight"] = params[p + "embed_weight"][:, :8]
    with pytest.raises(MXNetError, match="shape"):
        from_mxnet_tpu_params(target, bad, p)
    with pytest.raises(MXNetError, match="prefix"):
        from_mxnet_tpu_params(target, params, "other0_")


def test_seeded_init_is_reproducible():
    a = Transformer(16, device="cpu", generator=torch.Generator()
                    .manual_seed(5), **CFG)
    b = Transformer(16, device="cpu", generator=torch.Generator()
                    .manual_seed(5), **CFG)
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    ln = a.decoder.layers[0].ln3
    assert torch.equal(ln.weight, torch.ones(32))
    assert torch.equal(ln.bias, torch.zeros(32))
