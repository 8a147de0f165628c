"""The port's BERT vs the JAX package's, with the same weights.

A JAX ``bert_small(dropout=0.0)`` (vocab 512, units 64, FFN 128, 2
layers, 4 heads) is initialised by ``mx.init.Normal(0.02)``, its weights
are carried into the port's ``bert_small`` by
``convert.from_mxnet_tpu_params`` (numpy only), and both see the same
tokens.  Logits agree within atol 1e-5 (f32 both sides, sums in another
order) without a mask, where the port attends through
``flash_attention`` (the plain versions of K3-K5 on the CPU), and with a
``valid_length``, where both take the dense masked path.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.models.bert import bert_base, bert_small
from mxnet_tpu_torch.models.transformer import Transformer

ATOL = 1e-5
transformer_mod = importlib.import_module(
    "mxnet_tpu_torch.models.transformer")


def jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _tokens(seed=0, shape=(3, 12)):
    return np.random.RandomState(seed).randint(0, 512, shape).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    np.random.seed(0)
    jnet = jax_bert_small(dropout=0.0)
    jnet.initialize(mx.init.Normal(0.02))
    jnet(nd.array(_tokens(), dtype="int32"))   # resolves deferred init
    tnet = bert_small(dropout=0.0, device="cpu").eval()
    from_mxnet_tpu_params(tnet, jax_params(jnet), jnet.prefix)
    return jnet, tnet


def test_logits_match_jax_without_mask(pair):
    jnet, tnet = pair
    tok = _tokens(1)
    want = jnet(nd.array(tok, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(tok)).numpy()
    assert got.shape == (3, 12, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_logits_match_jax_with_valid_length_and_token_types(pair):
    jnet, tnet = pair
    tok = _tokens(2)
    types = (np.arange(12)[None, :] >= 6).astype(np.int32).repeat(3, 0)
    vlen = np.array([12, 7, 1], np.float32)
    want = jnet(nd.array(tok, dtype="int32"), nd.array(types, dtype="int32"),
                nd.array(vlen)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(tok), torch.from_numpy(types),
                   torch.from_numpy(vlen)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_convert_carries_every_parameter(pair):
    """Every Gluon name maps to exactly one port parameter, with BERT's
    own segment map (no enc/dec renames) and the Transformer keeping its."""
    jnet, tnet = pair
    params = jax_params(jnet)
    names = {jnet.prefix + gluon_name(tnet, k) for k in tnet.state_dict()}
    assert names == set(params)
    assert gluon_name(tnet, "decoder.weight") == "decoder_weight"
    assert gluon_name(tnet, "bert.token_type_embed.weight") == \
        "bert_type_embed_weight"
    assert gluon_name(tnet, "bert.encoder.layers.1.ffn.ffn_2.bias") == \
        "bert_encoder_layer1_ffn_ffn2_bias"
    assert gluon_name(tnet, "bert.embed_ln.weight") == "bert_embed_ln_gamma"
    seq2seq = Transformer(16, units=8, hidden_size=16, num_heads=2,
                          num_layers=1, max_length=4, device="cpu")
    assert gluon_name(seq2seq, "decoder.layers.0.self_attn.qkv.weight") == \
        "dec_layer0_self_qkv_weight"
    for key, value in tnet.state_dict().items():
        np.testing.assert_array_equal(
            value.numpy(), params[jnet.prefix + gluon_name(tnet, key)])


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the port's flash_attention from the model."""
    calls = []
    real = transformer_mod.flash_attention

    def wrapped(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(transformer_mod, "flash_attention", wrapped)
    return calls


def test_flash_route_taken_without_mask_and_dropout_zero(spy):
    net = bert_small(dropout=0.0, device="cpu").train()
    net(torch.from_numpy(_tokens()))
    # one call per layer on (B * H, T, hd)
    assert spy == [torch.Size([12, 12, 16])] * 2


def test_dense_route_with_a_mask(spy):
    net = bert_small(dropout=0.0, device="cpu").eval()
    net(torch.from_numpy(_tokens()), valid_length=torch.tensor([12, 5, 3]))
    assert spy == []


def test_dense_route_with_dropout_in_training_flash_in_eval(spy):
    net = bert_small(dropout=0.1, device="cpu").train()
    net(torch.from_numpy(_tokens()))
    assert spy == []
    net.eval()
    with torch.no_grad():
        net(torch.from_numpy(_tokens()))
    assert len(spy) == 2


def test_seeded_init_is_normal_002_and_reproducible():
    a = bert_small(device="cpu", generator=torch.Generator().manual_seed(3))
    b = bert_small(device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.bert.word_embed.weight.detach()
    assert abs(float(w.std()) - 0.02) < 2e-3 and abs(float(w.mean())) < 1e-3
    assert torch.equal(a.decoder.bias, torch.zeros(512))
    assert torch.equal(a.mlm_ln.weight, torch.ones(64))
    assert torch.equal(a.bert.encoder.layers[1].ln2.bias, torch.zeros(64))


def test_bert_base_sizes():
    """bert_base's layer sizes give the published 133,545,786 parameters
    (vocab 30522, untied decoder, pooler); built on the meta device so no
    memory is drawn."""
    with torch.device("meta"):
        net = bert_base(dropout=0.0, device="meta")
    assert sum(p.numel() for p in net.parameters()) == 133_545_786
    assert len(net.bert.encoder.layers) == 12
    assert net.bert.pos_embed.weight.shape == (512, 768)


@pytest.mark.parametrize("activation,fn", [
    ("gelu", lambda h: 0.5 * h * (1 + torch.erf(h / 2 ** 0.5))),
    ("relu", lambda h: h.clamp_min(0)),
])
def test_ffn_activation(activation, fn):
    """``"gelu"`` is exact erf GELU (the JAX ``LeakyReLU(act_type="gelu")``),
    ``"relu"`` ReLU; the encoder defaults to gelu as the JAX classes do, and
    the seq2seq Transformer passes relu."""
    ffn = transformer_mod.PositionwiseFFN(8, 16, activation=activation)
    g = torch.Generator().manual_seed(0)
    for lin in (ffn.ffn_1, ffn.ffn_2):  # drawn, not left uninitialized
        torch.nn.init.normal_(lin.weight, generator=g)
    x = torch.randn(3, 8, generator=g)
    want = ffn.ffn_2(fn(ffn.ffn_1(x)))
    torch.testing.assert_close(ffn(x), want)
    cell = transformer_mod.TransformerEncoderCell(8, 16, 2)
    assert cell.ffn.act(torch.tensor([-1.0])).item() < 0  # gelu, not relu
    seq2seq = Transformer(16, units=8, hidden_size=16, num_heads=2,
                          num_layers=1, max_length=4, device="cpu")
    for layer in (seq2seq.encoder.layers[0], seq2seq.decoder.layers[0]):
        assert layer.ffn.act(torch.tensor([-1.0])).item() == 0


def test_ffn_refuses_unknown_activation():
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(MXNetError, match="activation"):
        transformer_mod.PositionwiseFFN(8, 16, activation="swish")
