"""BERT's dense attention route against the JAX package on the CPU: the
masked and causal ``MultiHeadAttention`` eagerly, through its graph
spelling on tensors, and exported (node for node the JAX export, then
``SymbolBlock`` in both packages); a masked ``bert_small`` training step
(``valid_length``, dropout 0) against the JAX ``DataParallelStep``; the
masked encoder's export node for node; a ``valid_length`` BERT, whose
body reads ``inputs.shape``, raising in both packages when traced; and
at dropout 0.1 the share of attention probabilities the training route
zeroes, 0.1 within 0.02 (the JAX route: dense in training, fused in
predict mode).

Tolerances: outputs atol 1e-5 (f32, one or two layers); the training
losses rtol 2e-4 at every step and parameters atol 2e-4 at the end, as
``test_torch_training.py`` holds the unmasked step; graphs exactly
(op, attributes, input wiring, variable names; op-node name counters and
the deferred ``__shape__`` of a JAX variable aside).
"""
import json

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import bert_small as jbert_small
from mxnet_tpu.models.transformer import MultiHeadAttention as JMHA
from mxnet_tpu.parallel import DataParallelStep as JStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.gluon.block import F as TF
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.models.bert import bert_small
from mxnet_tpu_torch.parallel import DataParallelStep
from torch_fresh_names import fresh_jax_names  # noqa: F401

ATOL = 1e-5
CPU = tmx.cpu()
TOKENS = np.random.RandomState(0).randint(0, 512, (4, 16)).astype(np.int32)
VLEN = np.array([16, 9, 12, 5], np.float32)


def graph_key(n):
    attrs = {k: v for k, v in (n.get("attrs") or {}).items()
             if k != "__shape__"}
    return (n["op"], n["name"] if n["op"] == "null" else None, attrs,
            [i[:2] for i in n["inputs"]])


def assert_same_graph(tpath, jpath):
    T = json.load(open(f"{tpath}-symbol.json"))
    J = json.load(open(f"{jpath}-symbol.json"))
    assert [graph_key(n) for n in T["nodes"]] == \
        [graph_key(n) for n in J["nodes"]]
    assert T["heads"] == J["heads"] and T["arg_nodes"] == J["arg_nodes"]
    return [n["op"] for n in T["nodes"]]


def carry(jblock, tblock):
    tblock.initialize(ctx=CPU)
    got = tblock.collect_params()
    for name, p in jblock.collect_params().items():
        got[name].set_data(tmx.nd.array(p.data().asnumpy(), ctx=CPU))


def nd(mx, a):
    return (tmx.nd.array(a, ctx=CPU, dtype=a.dtype) if mx is tmx
            else jmx.nd.array(a, dtype=a.dtype))


def _sb(mx, path, names, inputs):
    sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", names,
                                      f"{path}-0000.params", ctx=mx.cpu())
    return sb(*[nd(mx, a) for a in inputs]).asnumpy()


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax_eager_and_exported(tmp_path, causal):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 16).astype(np.float32)
    mask = (rng.rand(2, 6, 6) > 0.3).astype(np.float32)
    mask[:, :, 0] = 1.0  # every query keeps a key
    prefix = "dense_c_" if causal else "dense_"
    jb = JMHA(16, 2, 0.1, causal=causal, prefix=prefix)
    jb.initialize(jmx.init.Xavier())
    want = jb(jmx.nd.array(x), jmx.nd.array(mask)).asnumpy()
    tb = ttr.MultiHeadAttention(16, 2, 0.1, causal=causal, prefix=prefix)
    carry(jb, tb)
    tb.eval()
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        eager = tb(xt, mt).numpy()
        params = {n: p._tensor() for n, p in tb._reg_params.items()}
        spelled = tb.hybrid_forward(TF, xt, mt, **params).numpy()
    np.testing.assert_allclose(eager, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(spelled, want, atol=ATOL, rtol=0)

    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tb.export(tpath, 0, input_names=("data", "mask"))
    jb.export(jpath, 0, input_names=("data", "mask"))
    ops = assert_same_graph(tpath, jpath)
    assert "_contrib_flash_attention" not in ops
    assert ops.count("batch_dot") == 2 and ops.count("Dropout") == 1
    assert ("cumsum" in ops) == causal
    for path in (tpath, jpath):
        for mx in (tmx, jmx):
            got = _sb(mx, path, ["data", "mask"], [x, mask])
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unmasked_export_keeps_the_fused_route_at_dropout(tmp_path):
    """At dropout 0.1 an export (autograd not training) writes the fused
    attention, in both packages, with the Dropout nodes of the block."""
    jb = JMHA(16, 2, 0.1, prefix="fusedexp_")
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(np.ones((1, 4, 16), np.float32)))
    tb = ttr.MultiHeadAttention(16, 2, 0.1, prefix="fusedexp_")
    carry(jb, tb)
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tb.export(tpath, 0)
    jb.export(jpath, 0)
    ops = assert_same_graph(tpath, jpath)
    assert ops.count("_contrib_flash_attention") == 1
    assert "batch_dot" not in ops


def _jax_bert(dropout=0.0):
    jmx.random.seed(0)
    np.random.seed(0)
    net = jbert_small(dropout=dropout, prefix="bertformlm0_")
    net.initialize(jmx.init.Normal(0.02))
    net(jmx.nd.array(TOKENS, dtype="int32"))  # resolves deferred init
    return net


def test_masked_training_step_matches_jax():
    jnet = _jax_bert()
    start = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    jstep = JStep(jnet, lambda lg, lb: jce(lg.reshape(-1, lg.shape[-1]),
                                           lb.reshape(-1)),
                  mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                  optimizer="adam", optimizer_params={"learning_rate": 1e-3})
    types = np.zeros_like(TOKENS)
    jdata = (jmx.nd.array(TOKENS, dtype="int32"),
             jmx.nd.array(types, dtype="int32"), jmx.nd.array(VLEN))
    jlosses = [float(np.asarray(jstep.step(
        jdata, jmx.nd.array(TOKENS.astype(np.float32))))) for _ in range(3)]

    tnet = bert_small(dropout=0.0, device="cpu", prefix="bertformlm0_")
    from_mxnet_tpu_params(tnet, start, jnet.prefix)
    tce = SoftmaxCrossEntropyLoss()
    tstep = DataParallelStep(
        tnet, lambda lg, lb: tce(lg.reshape(-1, lg.shape[-1]),
                                 lb.reshape(-1)),
        optimizer="adam", optimizer_params={"learning_rate": 1e-3},
        device="cpu")
    losses = [float(tstep.step((TOKENS, types, VLEN),
                               TOKENS.astype(np.float32)))
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)
    assert losses[-1] < losses[0]
    jfinal = {k: np.asarray(v) for k, v in jstep.params.items()}
    for k, v in tnet.state_dict().items():
        np.testing.assert_allclose(
            v.numpy(), jfinal[jnet.prefix + gluon_name(tnet, k)], rtol=0,
            atol=2e-4, err_msg=k)


def test_valid_length_bert_traces_no_graph_in_either(tmp_path):
    """The JAX body reads ``inputs.shape[1]``, which a Symbol lacks; the
    port's raises the same error rather than write a graph JAX cannot."""
    jnet = _jax_bert(dropout=0.1)
    tnet = bert_small(dropout=0.1, device="cpu", prefix="bertformlm0_")
    names = ("data", "types", "valid_length")
    with pytest.raises(AttributeError, match="shape"):
        jnet.export(str(tmp_path / "j"), 0, input_names=names)
    with pytest.raises(AttributeError, match="shape"):
        tnet.export(str(tmp_path / "t"), 0, input_names=names)


def test_masked_encoder_exports_node_for_node(tmp_path):
    """The graph a ``valid_length`` BERT runs past its mask: the encoder
    of a dropout-0.1 ``bert_small`` with a (B, T, T) mask input, node for
    node JAX's, and its outputs in predict mode in both packages equal
    the eager encoder's."""
    jnet = _jax_bert(dropout=0.1)
    tnet = bert_small(dropout=0.1, device="cpu", prefix="bertformlm0_")
    from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}, jnet.prefix)
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tnet.bert.encoder.export(tpath, 0, input_names=("data", "mask"))
    jnet.bert.encoder.export(jpath, 0, input_names=("data", "mask"))
    ops = assert_same_graph(tpath, jpath)
    assert ops.count("LayerNorm") == 4 and ops.count("batch_dot") == 4
    assert ops.count("Dropout") == 6  # attention, residual, FFN a layer
    rng = np.random.RandomState(4)
    x = rng.randn(4, 16, 64).astype(np.float32)
    keep = (np.arange(16)[None] < VLEN[:, None]).astype(np.float32)
    mask = keep[:, :, None] * keep[:, None, :]
    with torch.no_grad():
        want = tnet.bert.encoder.eval()(torch.from_numpy(x),
                                        torch.from_numpy(mask)).numpy()
    for mx in (tmx, jmx):
        got = _sb(mx, tpath, ["data", "mask"], [x, mask])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = ttr.flash_attention

    def wrapped(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttr, "flash_attention", wrapped)
    return calls


def test_dropout_share_and_the_route_by_mode(flash_calls):
    """Training at dropout 0.1 attends densely and zeroes 0.1 of the
    attention probabilities (within 0.02); a predict-mode call (NDArray,
    ``autograd.predict_mode``) of the same model takes the fused route."""
    net = bert_small(dropout=0.1, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    seen = []

    def hook(module, args, out):
        seen.append((args[0].detach(), out.detach()))

    for cell in net.bert.encoder.layers:
        torch.nn.Module.register_forward_hook(cell.attn.attn_drop, hook)
    tok = np.random.RandomState(5).randint(0, 512, (4, 64)).astype(np.int32)
    with tag.record(), tag.train_mode():
        net(tmx.nd.array(tok, ctx=CPU, dtype="int32"))
    assert flash_calls == [] and len(seen) == 2
    for probs, dropped in seen:
        live = probs > 0
        share = float(((dropped == 0) & live).sum() / live.sum())
        assert abs(share - 0.1) <= 0.02, share
        kept = dropped[dropped != 0] / probs[dropped != 0]
        torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))
    seen.clear()
    with tag.predict_mode():
        net(tmx.nd.array(tok, ctx=CPU, dtype="int32"))
    assert len(flash_calls) == 2 and seen == []
