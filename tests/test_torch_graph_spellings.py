"""The graph spellings of the seq2seq ``Transformer``, its decoder cell
and cross attention and every ``gluon.rnn`` cell and layer, against the
JAX package on the CPU (the detectors' are in
``test_torch_graph_spellings_detectors.py``).

Where the JAX block traces a Symbol graph, the port's writes the same
graph node for node (op, attributes, input wiring, variable names;
op-node name counters and a JAX variable's deferred ``__shape__``
aside), and ``SymbolBlock`` of the port's export, run in both packages,
gives the port's eager outputs (atol 1e-5).  Where the JAX block cannot
be traced (a recurrent cell or layer reads its input's context or
shape), the port raises too, and ``unroll`` inside a hybridized block
gives the JAX block's outputs with the same weights (atol 1e-5).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import transformer as jtr
from mxnet_tpu_torch.gluon.block import F as TF
from mxnet_tpu_torch.models import transformer as ttr
from torch_fresh_names import fresh_jax_names  # noqa: F401

CPU = tmx.cpu()
ATOL = 1e-5


def graph_key(n):
    attrs = {k: v for k, v in (n.get("attrs") or {}).items()
             if k != "__shape__"}
    return (n["op"], n["name"] if n["op"] == "null" else None, attrs,
            [i[:2] for i in n["inputs"]])


def jax_graph(block, names):
    out = block(*[jmx.sym.var(n) for n in names])
    if isinstance(out, (list, tuple)):
        out = jmx.sym.Group(list(out))
    return json.loads(out.tojson())


def export_and_compare(tmp_path, tblock, jblock, names, inputs, want,
                       **tol):
    path = str(tmp_path / "t")
    tblock.export(path, 0, input_names=names)
    T = json.load(open(f"{path}-symbol.json"))
    J = jax_graph(jblock, names)
    assert [graph_key(n) for n in T["nodes"]] == \
        [graph_key(n) for n in J["nodes"]]
    assert T["heads"] == J["heads"]
    for mx in (tmx, jmx):
        sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", list(names),
                                          f"{path}-0000.params",
                                          ctx=mx.cpu())
        arrs = [mx.nd.array(a, dtype=a.dtype, **(
            {"ctx": CPU} if mx is tmx else {})) for a in inputs]
        got = sb(*arrs)
        got = got if isinstance(got, (list, tuple)) else [got]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.asnumpy(), w, **(tol or {
                "atol": ATOL, "rtol": 0}))
    return [n["op"] for n in T["nodes"]]


def _tokens(rng, shape, vocab):
    t = rng.randint(3, vocab, shape).astype(np.int32)
    t[1, -2:] = 0  # padding: the key-padding masks matter
    return t


@pytest.mark.parametrize("tie", [True, False])
def test_seq2seq_transformer(tmp_path, tie):
    rng = np.random.RandomState(0)
    kw = dict(units=16, hidden_size=32, num_heads=2, num_layers=2,
              max_length=16, dropout=0.1, tie_embeddings=tie)
    tnet = ttr.Transformer(30, device="cpu", prefix="s2s_",
                           generator=torch.Generator().manual_seed(0), **kw)
    jnet = jtr.Transformer(30, prefix="s2s_", **kw)
    src, tgt = _tokens(rng, (2, 7), 30), _tokens(rng, (2, 5), 30)
    with torch.no_grad():
        want = tnet.eval()(torch.from_numpy(src), torch.from_numpy(tgt))
    ops = export_and_compare(tmp_path, tnet, jnet, ("src", "tgt"),
                             [src, tgt], [want.numpy()])
    # every attention is masked, so dense: 2 per decoder layer, 1 per
    # encoder layer, two products each; the causal rule in each decoder
    assert ops.count("batch_dot") == 2 * 6 and ops.count("cumsum") == 2
    assert "_contrib_flash_attention" not in ops
    with torch.no_grad():
        spelled = tnet.hybrid_forward(TF, torch.from_numpy(src),
                                      torch.from_numpy(tgt))
    torch.testing.assert_close(spelled, want, atol=ATOL, rtol=0)


def test_decoder_cell_and_cross_attention(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 16).astype(np.float32)
    mem = rng.randn(2, 7, 16).astype(np.float32)
    keep = (rng.rand(2, 1, 7) > 0.3).astype(np.float32)
    keep[..., 0] = 1
    cross_mask = np.repeat(keep, 5, axis=1)
    self_mask = np.ones((2, 5, 5), np.float32)
    cell = ttr.TransformerDecoderCell(16, 32, 2, 0.1, prefix="dcell_")
    cell.initialize(tmx.init.Xavier(), ctx=CPU)
    jcell = jtr.TransformerDecoderCell(16, 32, 2, 0.1, prefix="dcell_")
    args = [x, mem, self_mask, cross_mask]
    with torch.no_grad():
        want = cell.eval()(*[torch.from_numpy(a) for a in args]).numpy()
    export_and_compare(tmp_path, cell, jcell, ("x", "mem", "sm", "cm"),
                       args, [want])
    cross = ttr.MultiHeadCrossAttention(16, 2, 0.1, prefix="xattn_")
    cross.initialize(tmx.init.Xavier(), ctx=CPU)
    jcross = jtr.MultiHeadCrossAttention(16, 2, 0.1, prefix="xattn_")
    args = [x, mem, cross_mask]
    with torch.no_grad():
        want = cross.eval()(*[torch.from_numpy(a) for a in args]).numpy()
    (tmp_path / "x").mkdir()
    export_and_compare(tmp_path / "x", cross, jcross, ("x", "mem", "m"),
                       args, [want])


# ---------------------------------------------------------------------------
# gluon.rnn: no graph in either package
# ---------------------------------------------------------------------------
def _cells(rnn):
    return {
        "rnn": lambda: rnn.RNNCell(8, input_size=4, prefix="c_"),
        "lstm": lambda: rnn.LSTMCell(8, input_size=4, prefix="c_"),
        "gru": lambda: rnn.GRUCell(8, input_size=4, prefix="c_"),
        "dropout": lambda: rnn.DropoutCell(0.5, prefix="c_"),
        "zoneout": lambda: rnn.ZoneoutCell(
            rnn.RNNCell(4, input_size=4, prefix="c_"), 0.3, 0.3),
        "residual": lambda: rnn.ResidualCell(
            rnn.GRUCell(4, input_size=4, prefix="c_")),
    }


def _n_states(cell):
    return len(cell.state_info())


@pytest.mark.parametrize("kind", sorted(_cells(tmx.gluon.rnn)))
def test_cells_trace_no_graph_in_either(kind):
    for mx in (jmx, tmx):
        cell = _cells(mx.gluon.rnn)[kind]()
        states = [mx.sym.var(f"h{i}") for i in range(_n_states(cell))]
        with pytest.raises(AttributeError):
            cell(mx.sym.var("x"), states)
        with pytest.raises(AttributeError):
            cell.unroll(2, [mx.sym.var("x0"), mx.sym.var("x1")],
                        begin_state=states)


@pytest.mark.parametrize("layer", ["RNN", "LSTM", "GRU"])
def test_layers_trace_no_graph_in_either(layer):
    for mx in (jmx, tmx):
        lay = getattr(mx.gluon.rnn, layer)(8, num_layers=2, input_size=4)
        with pytest.raises(AttributeError):
            lay(mx.sym.var("x"))
        n = 2 if layer == "LSTM" else 1
        with pytest.raises(AttributeError):
            lay(mx.sym.var("x"), [mx.sym.var(f"h{i}") for i in range(n)])


def _stack_block(mx):
    rnn = mx.gluon.rnn

    class Stack(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = rnn.SequentialRNNCell()
                self.cell.add(rnn.LSTMCell(6, input_size=4))
                self.cell.add(rnn.ResidualCell(rnn.GRUCell(6, input_size=6)))

        def hybrid_forward(self, F, x, h0, c0, h1):
            out, _ = self.cell.unroll(3, x, begin_state=[h0, c0, h1],
                                      layout="NTC", merge_outputs=True)
            return out

    return Stack(prefix="stack_")


def test_unroll_in_a_hybridized_block_matches_jax():
    rng = np.random.RandomState(6)
    ins = [rng.randn(2, 3, 4).astype(np.float32)] + [
        rng.randn(2, 6).astype(np.float32) for _ in range(3)]
    jb = _stack_block(jmx)
    jb.initialize(jmx.init.Xavier())
    jb.hybridize()
    want = jb(*[jmx.nd.array(a) for a in ins]).asnumpy()
    tb = _stack_block(tmx)
    tb.initialize(ctx=CPU)
    params = tb.collect_params()
    for name, p in jb.collect_params().items():
        params[name].set_data(tmx.nd.array(p.data().asnumpy(), ctx=CPU))
    tb.hybridize()
    got = tb(*[tmx.nd.array(a, ctx=CPU) for a in ins])
    np.testing.assert_allclose(got.asnumpy(), want, atol=ATOL, rtol=0)
    assert tb._cached_op.num_entries == 1
