"""The port's recurrent stack against the JAX package's on the CPU: the
``_fused_rnn`` op (every mode, two layers, bidirectional), the
``_begin_state_zeros*`` ops and the packed ``RNN`` op (one case each in
``torch_op_parity``); the ``gluon.rnn`` layers (``RNN``, ``LSTM``,
``GRU``; ``TNC`` and ``NTC``; bidirectional) and cells (every cell,
``unroll`` with ``merge_outputs`` and ``valid_length``), each built in
both packages in one name scope and carried by Gluon name; ``CTCLoss``;
and the LSTM language model (``models.word_lm``) at vocabulary 50, width
16, two layers, batch 3 and 5 steps, through ``gluon.Trainer`` SGD with
``clip_global_norm``, two truncated-BPTT steps with the state carried
and detached.

Tolerances: 1e-5 relative and absolute on outputs, states, losses and
gradients (f32 both, the recurrences multiply in another order);
parameters after each Trainer step (lr 1.0) within 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.models import RNNModel
from mxnet_tpu_torch.ops.rnn_ops import rnn_packed_layout
from torch_op_parity import Case, check, rng_for, uniform

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = tmx.cpu()
GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}
T, B, I, H = 4, 3, 5, 6


def _fused_case(mode, bidirectional, layers=2):
    r = rng_for(f"fused-{mode}-{bidirectional}")
    dirs = 2 if bidirectional else 1
    g = GATES[mode]
    weights = []
    for layer in range(layers):
        inp = I if layer == 0 else H * dirs
        for _ in range(dirs):
            weights += [uniform(r, (g * H, inp), -0.4, 0.4),
                        uniform(r, (g * H, H), -0.4, 0.4),
                        uniform(r, (g * H,), -0.2, 0.2),
                        uniform(r, (g * H,), -0.2, 0.2)]
    states = [uniform(r, (T, B, I)), uniform(r, (layers * dirs, B, H)),
              uniform(r, (layers * dirs, B, H))]
    grad = None if mode == "lstm" else [0, 1] + list(range(3, 3 + len(
        weights)))
    return Case("_fused_rnn", states + weights,
                {"mode": mode, "state_size": H, "num_layers": layers,
                 "bidirectional": bidirectional}, key_at=1, grad=grad,
                tag=f"{mode}{'_bi' if bidirectional else ''}",
                rtol=1e-5, atol=1e-6)


def _packed_case(mode, bidirectional, state_outputs):
    r = rng_for(f"packed-{mode}")
    dirs = 2 if bidirectional else 1
    _, total = rnn_packed_layout(mode, I, H, 2, bidirectional)
    inputs = [uniform(r, (T, B, I)), uniform(r, (total,), -0.3, 0.3),
              uniform(r, (2 * dirs, B, H))]
    if mode == "lstm":
        inputs.append(uniform(r, (2 * dirs, B, H)))
    return Case("RNN", inputs,
                {"mode": mode, "state_size": H, "num_layers": 2,
                 "bidirectional": bidirectional,
                 "state_outputs": state_outputs},
                tag=f"{mode}{'_bi' if bidirectional else ''}",
                rtol=1e-5, atol=1e-6)


def _cases():
    c = [_fused_case(m, bi) for m in GATES for bi in (False, True)]
    r = rng_for("begin")
    c += [Case("_begin_state_zeros", [uniform(r, (4, 3))],
               {"num_hidden": 5}),
          Case("_begin_state_zeros_layers", [uniform(r, (7, 4, 3))],
               {"num_hidden": 5, "num_layers": 2}),
          _packed_case("lstm", True, True), _packed_case("gru", False, True),
          _packed_case("rnn_relu", False, False)]
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


# ---------------------------------------------------------------------------
# layers and cells, built in both packages
# ---------------------------------------------------------------------------
class _Pkg:
    def __init__(self, mx, gluon, nd, autograd, ctx):
        self.mx, self.gluon, self.nd, self.autograd = mx, gluon, nd, autograd
        self.ctx = ctx

    def array(self, a):
        return self.nd.array(a, ctx=self.ctx)


JAX = _Pkg(jmx, jgluon, jnd, jag, jmx.cpu())
PORT = _Pkg(tmx, tgluon, tnd, tag, CPU)


def _carry(jblock, tblock):
    """The JAX block's weights into the port's by Gluon name, through
    ``convert.from_mxnet_tpu_params`` (which refuses a missing or extra
    name)."""
    jparams = {k: p.data().asnumpy()
               for k, p in jblock.collect_params().items()}
    assert sorted(tblock.collect_params().keys()) == sorted(jparams)
    prefix = tblock.prefix if all(k.startswith(tblock.prefix)
                                  for k in jparams) else ""
    convert.from_mxnet_tpu_params(tblock, jparams, prefix)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy()


def _assert_tree(got, want, tol=TOL):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w, tol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


def _run(pkg, block, call, inputs, seed):
    """Forward ``call(block, *arrays)`` under record, then backward of
    sum(out * w) over every output with seeded w: (outputs, input grads,
    parameter grads)."""
    arrays = [pkg.array(a) for a in inputs]
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record():
        out = call(block, *arrays)
        outs = _flat(out)
        rng = np.random.RandomState(seed)
        total = None
        for o in outs:
            w = pkg.array(rng.standard_normal(o.shape).astype(np.float32))
            term = (o * w).sum()
            total = term if total is None else total + term
    total.backward()
    params = {k: p.grad().asnumpy() for k, p in
              block.collect_params().items() if p.grad_req != "null"}
    return _np(out), [a.grad.asnumpy() for a in arrays], params


def _twins(make, init_input):
    jb, tb = make(jgluon), make(tgluon)
    jb.initialize(jmx.init.Uniform(0.3), ctx=JAX.ctx)
    tb.initialize(ctx=CPU)
    return jb, tb


def _compare_blocks(make, call, inputs, jcall=None):
    """``call(block, *arrays)`` in both packages (``jcall`` for the JAX
    block, where it differs) from the same weights."""
    jcall = jcall or call
    jb, tb = _twins(make, inputs)
    # a first call finishes the deferred shapes in both
    jcall(jb, *[JAX.array(a) for a in inputs])
    call(tb, *[PORT.array(a) for a in inputs])
    _carry(jb, tb)
    jo, jgi, jgp = _run(JAX, jb, jcall, inputs, 0)
    to, tgi, tgp = _run(PORT, tb, call, inputs, 0)
    _assert_tree(to, jo)
    _assert_tree(tgi, jgi)
    assert sorted(tgp) == sorted(jgp)
    for k in jgp:
        np.testing.assert_allclose(tgp[k], jgp[k], **TOL, err_msg=k)


LAYERS = {
    "lstm": lambda g: g.rnn.LSTM(H, 2, prefix="rnn_"),
    "lstm_bi_ntc": lambda g: g.rnn.LSTM(H, 2, layout="NTC",
                                        bidirectional=True, prefix="rnn_"),
    "gru": lambda g: g.rnn.GRU(H, 2, prefix="rnn_"),
    "gru_bi": lambda g: g.rnn.GRU(H, 1, bidirectional=True, prefix="rnn_"),
    "rnn_relu": lambda g: g.rnn.RNN(H, 2, prefix="rnn_"),
    "rnn_tanh_ntc": lambda g: g.rnn.RNN(H, 1, activation="tanh",
                                        layout="NTC", prefix="rnn_"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_with_states_matches_jax(name):
    ntc = "ntc" in name
    dirs = 2 if "bi" in name else 1
    layers = 1 if name in ("gru_bi", "rnn_tanh_ntc") else 2
    r = rng_for(name)
    x = uniform(r, (B, T, I) if ntc else (T, B, I))
    states = [uniform(r, (layers * dirs, B, H))
              for _ in range(2 if name.startswith("lstm") else 1)]

    def call(block, x, *states):
        return block(x, list(states))

    _compare_blocks(LAYERS[name], call, [x] + states)


def test_layer_without_states_and_begin_state():
    r = rng_for("nostate")
    x = uniform(r, (T, B, I))
    _compare_blocks(LAYERS["lstm"], lambda b, x: b(x), [x])
    t = tgluon.rnn.LSTM(H, 2, bidirectional=True)
    j = jgluon.rnn.LSTM(H, 2, bidirectional=True)
    assert t.state_info(B) == j.state_info(B)
    assert [s.shape for s in t.begin_state(B, ctx=CPU)] == \
        [s.shape for s in j.begin_state(B)]


CELLS = {
    "rnn": lambda g: g.rnn.RNNCell(H, prefix="cell_"),
    "rnn_relu": lambda g: g.rnn.RNNCell(H, activation="relu",
                                        prefix="cell_"),
    "lstm": lambda g: g.rnn.LSTMCell(H, prefix="cell_"),
    "gru": lambda g: g.rnn.GRUCell(H, prefix="cell_"),
}


def _sequential(g):
    net = g.rnn.SequentialRNNCell(prefix="seq_")
    with net.name_scope():
        net.add(g.rnn.LSTMCell(H))
        net.add(g.rnn.DropoutCell(0.5))
        net.add(g.rnn.ResidualCell(g.rnn.GRUCell(H)))
    return net


def _bidirectional(g):
    with g.nn.HybridSequential(prefix="bi_").name_scope():
        return g.rnn.BidirectionalCell(g.rnn.LSTMCell(H, prefix="l_"),
                                       g.rnn.GRUCell(H, prefix="r_"))


def _zoneout(g):
    return g.rnn.ZoneoutCell(g.rnn.GRUCell(H, prefix="z_"), 0.3, 0.2)


CELLS.update({"sequential": _sequential, "bidirectional": _bidirectional,
              "zoneout": _zoneout})


def _pkg(x):
    return JAX if isinstance(x, jnd.NDArray) else PORT


def _zeros_like_states(block, x):
    """Zero begin states, given explicitly: the JAX containers' and
    modifiers' own ``begin_state`` cannot be called by their ``unroll``
    (it passes the batch size positionally)."""
    pkg = _pkg(x)
    return [pkg.array(np.zeros(info["shape"], np.float32))
            for info in block.state_info(B)]


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, merge):
    """``unroll`` over an NTC batch (the first cell of a sequential stack
    is fed H-wide inputs so the residual adds), predict mode: dropout and
    zoneout are the identity."""
    r = rng_for("cell-" + name)
    width = H if name == "sequential" else I
    x = uniform(r, (B, T, width))

    def call(block, x):
        with _pkg(x).autograd.predict_mode():
            return block.unroll(T, x, _zeros_like_states(block, x),
                                layout="NTC", merge_outputs=merge)

    _compare_blocks(CELLS[name], call, [x])


@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_cell_unroll_valid_length_matches_jax(name):
    """Outputs past each sequence's length zeroed, the states those of
    its last valid step; TNC, the merged output returned.  The JAX
    ``unroll`` passes ``valid_length`` to its ops as an attribute, which
    eager dispatch rejects, so the JAX side is what it spells out: the
    cell stepped T times, then the ``SequenceLast`` and ``SequenceMask``
    ops."""
    r = rng_for("valid-" + name)
    x = uniform(r, (T, B, I))
    valid = np.array([2, 4, 1], np.float32)

    def call(block, x):
        return block.unroll(T, x, layout="TNC",
                            valid_length=PORT.array(valid))

    def jcall(block, x):
        v = JAX.array(valid)
        states = _zeros_like_states(block, x)
        outs, seen = [], []
        for t in range(T):
            out, states = block(x[t], states)
            outs.append(out)
            seen.append(states)
        last = [jnd.SequenceLast(jnd.stack(*e, axis=0), v,
                                 use_sequence_length=True, axis=0)
                for e in zip(*seen)]
        return (jnd.SequenceMask(jnd.stack(*outs, axis=0), v,
                                 use_sequence_length=True, axis=0), last)

    _compare_blocks(CELLS[name], call, [x], jcall=jcall)


def test_bidirectional_unroll_valid_length():
    """The right cell reads each sequence reversed within its length and
    its outputs come back in order: at each sequence's valid steps the
    right half equals the right cell run alone over the reversed valid
    prefix; past the length the outputs are zero."""
    r = rng_for("bi-valid")
    x = uniform(r, (T, B, I))
    valid = [2, 4, 1]
    bi = _bidirectional(tgluon)
    bi.initialize(ctx=CPU)
    out, states = bi.unroll(T, PORT.array(x), layout="TNC",
                            merge_outputs=True,
                            valid_length=PORT.array(np.float32(valid)))
    out = out.asnumpy()
    r_cell = bi.r_cell
    for b, n in enumerate(valid):
        seq = PORT.array(x[:n, b:b + 1][::-1].copy())
        ro, _ = r_cell.unroll(n, seq, layout="TNC", merge_outputs=True)
        np.testing.assert_allclose(out[:n, b, H:], ro.asnumpy()[::-1, 0],
                                   **TOL)
        assert not out[n:, b].any()
    assert [s.shape for s in states] == [(B, H)] * 3


def test_dropout_and_zoneout_cells_draw_in_training():
    x = tnd.ones((B, T, H), ctx=CPU)
    drop = tgluon.rnn.DropoutCell(0.5)
    zone = tgluon.rnn.ZoneoutCell(tgluon.rnn.GRUCell(H), 0.5, 0.5)
    zone.initialize(ctx=CPU)
    with tag.record():
        out, _ = drop.unroll(T, x, merge_outputs=True)
        zout, states = zone.unroll(T, x, merge_outputs=True)
    o = out.asnumpy()
    assert set(np.unique(o)) <= {0.0, 2.0} and (o == 0).any()
    assert zout.shape == (B, T, H) and np.isfinite(zout.asnumpy()).all()
    with pytest.raises(tmx.MXNetError, match="unroll"):
        tgluon.rnn.BidirectionalCell(tgluon.rnn.GRUCell(H),
                                     tgluon.rnn.GRUCell(H))(x, [])


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_loss_block_matches_jax(layout):
    r = rng_for("ctc-" + layout)
    pred = uniform(r, (B, 7, 5) if layout == "NTC" else (7, B, 5), -2, 2)
    label = np.array([[0, 1, 1], [2, 3, -1], [3, -1, -1]], np.float32)
    plen = np.array([7, 6, 5], np.float32)

    def call(block, pred, label, plen):
        return block(pred, label, plen)

    def make(g):
        return g.loss.CTCLoss(layout=layout)

    jb, tb = make(jgluon), make(tgluon)
    jo, jgi, _ = _run(JAX, jb, call, [pred, label, plen], 1)
    to, tgi, _ = _run(PORT, tb, call, [pred, label, plen], 1)
    _assert_tree(to, jo)
    np.testing.assert_allclose(tgi[0], jgi[0], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the language model, trained a step at a time in both packages
# ---------------------------------------------------------------------------
VOCAB, WIDTH, LAYERS_LM, BATCH, STEPS, CLIP, LR = 50, 16, 2, 3, 5, 5.0, 1.0


class JaxRNNModel(jgluon.HybridBlock):
    """The JAX package's blocks in the same model (MXNet's
    word_language_model example)."""

    def __init__(self, prefix):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.drop = jgluon.nn.Dropout(0.0)
            self.encoder = jgluon.nn.Embedding(VOCAB, WIDTH)
            self.rnn = jgluon.rnn.LSTM(WIDTH, LAYERS_LM, dropout=0.0,
                                       input_size=WIDTH)
            self.decoder = jgluon.nn.Dense(VOCAB, in_units=WIDTH)

    def hybrid_forward(self, F, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(output.reshape((-1, WIDTH))), hidden


def _lm_batches():
    rng = np.random.RandomState(0)
    stream = rng.randint(0, VOCAB, (2 * STEPS + 1) * BATCH)
    data = stream[:2 * STEPS * BATCH].reshape(BATCH, -1).T
    target = stream[1:2 * STEPS * BATCH + 1].reshape(BATCH, -1).T
    return [(data[i * STEPS:(i + 1) * STEPS].astype(np.float32),
             target[i * STEPS:(i + 1) * STEPS].astype(np.float32))
            for i in range(2)]


def _lm_step(pkg, net, trainer, hidden, x, y):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = [h.detach() for h in hidden]
    with pkg.autograd.record():
        logits, hidden = net(pkg.array(x), hidden)
        loss = loss_fn(logits, pkg.array(y.reshape(-1)))
    loss.backward()
    params = net.collect_params()
    grads = {k: p.grad().asnumpy().copy() for k, p in params.items()}
    norm = pkg.gluon.utils.clip_global_norm(
        [p.grad() for p in params.values()], CLIP * STEPS * BATCH)
    trainer.step(STEPS * BATCH)
    after = {k: p.data().asnumpy().copy() for k, p in params.items()}
    return (logits.asnumpy(), loss.asnumpy(), grads, float(norm), after,
            hidden)


def test_lstm_language_model_trains_as_the_jax_one():
    jnet = JaxRNNModel(prefix="lm_")
    jnet.initialize(jmx.init.Uniform(0.05), ctx=JAX.ctx)
    tnet = RNNModel("lstm", VOCAB, WIDTH, WIDTH, LAYERS_LM, dropout=0.0,
                    prefix="lm_")
    tnet.initialize(ctx=CPU)
    _carry(jnet, tnet)
    runs = {}
    for pkg, net in ((JAX, jnet), (PORT, tnet)):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": LR})
        hidden = net.rnn.begin_state(BATCH, ctx=pkg.ctx)
        steps = []
        for x, y in _lm_batches():
            out = _lm_step(pkg, net, trainer, hidden, x, y)
            hidden = out[-1]
            steps.append(out[:-1] + (_np(hidden),))
        runs[pkg is PORT] = steps
    for (tl, tloss, tg, tn, ta, th), (jl, jloss, jg, jn, ja, jh) in zip(
            runs[True], runs[False]):
        np.testing.assert_allclose(tl, jl, **TOL)
        np.testing.assert_allclose(tloss, jloss, **TOL)
        np.testing.assert_allclose(tn, jn, rtol=1e-5)
        assert sorted(tg) == sorted(jg)
        for k in jg:
            np.testing.assert_allclose(tg[k], jg[k], **TOL, err_msg=k)
            np.testing.assert_allclose(ta[k], ja[k], **TOL, err_msg=k)
        _assert_tree(th, jh)
    assert runs[True][1][1].mean() < runs[True][0][1].mean() + 1.0
