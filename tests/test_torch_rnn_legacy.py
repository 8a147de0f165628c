"""The port's legacy ``mx.rnn`` against the JAX package's on the CPU: the
cases of ``tests/test_rnn_legacy.py``, each cell's unrolled graph built in
both packages and run from the same weights (outputs rtol 1e-5 / atol 1e-6,
gradients within 1e-5 of the largest max abs, ``torch_sym_parity``);
``pack_weights`` / ``unpack_weights``; ``BucketSentenceIter``'s batches
equal to the JAX iterator's for one seed; three ``BucketingModule`` steps of
a GRU language model equal to the JAX module's; and the RNN checkpoints
both ways.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_sym_parity import (assert_grads_close, assert_same_run, both,
                              nd_array)

CPU = tmx.cpu()


def _weights(build, shapes, seed, scale=0.3):
    """Seeded values for every argument of ``build(tmx)`` but the
    inputs named in ``shapes``."""
    sym = build(tmx)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _check_cell(make_cell, T, B, I, seed, merge=True, layout="NTC"):
    def build(mx):
        outputs, _ = make_cell(mx).unroll(T, inputs=mx.sym.Variable("data"),
                                          layout=layout,
                                          merge_outputs=merge)
        return outputs

    shape = (B, T, I) if layout == "NTC" else (T, B, I)
    feeds = _weights(build, {"data": shape}, seed)
    feeds["data"] = np.random.RandomState(seed + 1).randn(*shape).astype(
        np.float32)
    t, j = both(build, {"data": shape}, feeds)
    assert_same_run(t, j)
    return t


def test_rnn_cell_unroll_shapes():
    t = _check_cell(lambda mx: mx.rnn.RNNCell(10, prefix="rnn_"), 3, 2, 4, 0)
    assert t["outputs"][0].shape == (2, 3, 10)
    cell = tmx.rnn.RNNCell(10, prefix="rnn_")
    assert sorted(cell.params._params) == [
        "rnn_h2h_bias", "rnn_h2h_weight", "rnn_i2h_bias", "rnn_i2h_weight"]


@pytest.mark.parametrize("kind", ["LSTMCell", "GRUCell"])
def test_lstm_gru_cell_unroll(kind):
    t = _check_cell(lambda mx: getattr(mx.rnn, kind)(
        6, prefix=kind.lower()[:4] + "_"), 3, 2, 4, 1)
    assert t["outputs"][0].shape == (2, 3, 6)


def test_sequential_and_residual_stack():
    def make(mx):
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.LSTMCell(8, prefix="l0_"))
        stack.add(mx.rnn.ResidualCell(mx.rnn.LSTMCell(8, prefix="l1_")))
        return stack

    t = _check_cell(make, 3, 2, 8, 2)
    assert t["outputs"][0].shape == (2, 3, 8)
    _, states = make(tmx).unroll(3, inputs=tmx.sym.Variable("data"),
                                 merge_outputs=True)
    assert len(states) == 4


def test_bidirectional_cell_tnc():
    t = _check_cell(lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(5, prefix="l_"), mx.rnn.LSTMCell(5, prefix="r_")),
        4, 2, 3, 3, layout="TNC")
    assert t["outputs"][0].shape == (4, 2, 10)


def test_dropout_zoneout_cells_inference():
    def stack(mx):
        s = mx.rnn.SequentialRNNCell()
        s.add(mx.rnn.GRUCell(6, prefix="g0_"))
        s.add(mx.rnn.DropoutCell(0.5, prefix="do_"))
        return s

    def build_stack(mx):
        return stack(mx).unroll(3, inputs=mx.sym.Variable("data"),
                                merge_outputs=True)[0]

    def build_zone(mx):
        z = mx.rnn.ZoneoutCell(mx.rnn.RNNCell(4, prefix="z_"),
                               zoneout_states=0.3)
        return z.unroll(2, inputs=mx.sym.Variable("data"),
                        merge_outputs=True)[0]

    for build, shape in ((build_stack, (2, 3, 4)), (build_zone, (1, 2, 4))):
        feeds = _weights(build, {"data": shape}, 4)
        feeds["data"] = np.ones(shape, np.float32)
        t, j = both(build, {"data": shape}, feeds, is_train=False,
                    backward=False, grad_req="null")
        assert_same_run(t, j)
        assert np.isfinite(t["outputs"][0]).all()


def _fused_build(mode, layers, bidirectional, get_next_state=False):
    def build(mx):
        cell = mx.rnn.FusedRNNCell(5, num_layers=layers, mode=mode,
                                   bidirectional=bidirectional,
                                   prefix=f"{mode}_",
                                   get_next_state=get_next_state)
        out, _ = cell.unroll(4, inputs=mx.sym.Variable("data"),
                             merge_outputs=True)
        return out

    return build


@pytest.mark.parametrize("mode,layers,bidirectional", [
    ("lstm", 1, False), ("lstm", 2, True), ("gru", 2, False),
    ("rnn_tanh", 1, True)])
def test_fused_cell_matches_jax(mode, layers, bidirectional):
    build = _fused_build(mode, layers, bidirectional)
    feeds = _weights(build, {"data": (2, 4, 3)}, 5, scale=0.2)
    feeds["data"] = np.random.RandomState(6).randn(2, 4, 3).astype(
        np.float32)
    t, j = both(build, {"data": (2, 4, 3)}, feeds)
    assert_same_run(t, j)


def test_fused_cell_matches_unfused():
    T, B, I, H = 4, 2, 3, 5
    fused = tmx.rnn.FusedRNNCell(H, num_layers=1, mode="lstm",
                                 prefix="lstm_", get_next_state=True)
    f_out, _ = fused.unroll(T, inputs=tmx.sym.Variable("data"),
                            merge_outputs=True)
    ex = f_out.simple_bind(ctx=CPU, data=(B, T, I))
    rng = np.random.RandomState(0)
    flat = rng.randn(*ex.arg_dict["lstm_parameters"].shape).astype(
        np.float32) * 0.2
    x = rng.randn(B, T, I).astype(np.float32)
    fused_out = ex.forward(data=x, lstm_parameters=flat)[0].asnumpy()
    stack = fused.unfuse()
    s_out, _ = stack.unroll(T, inputs=tmx.sym.Variable("data"),
                            merge_outputs=True)
    ex2 = s_out.simple_bind(ctx=CPU, data=(B, T, I))
    per_cell = stack.pack_weights(fused.unpack_weights(
        {"lstm_parameters": nd_array(tmx, flat)}))
    ex2.copy_params_from(per_cell)
    np.testing.assert_allclose(ex2.forward(data=x)[0].asnumpy(), fused_out,
                               rtol=1e-4, atol=1e-5)


def test_pack_unpack_weights_match_jax():
    rng = np.random.RandomState(1)
    raw = {"lstm_i2h_weight": rng.randn(16, 3), "lstm_i2h_bias":
           rng.randn(16), "lstm_h2h_weight": rng.randn(16, 4),
           "lstm_h2h_bias": rng.randn(16)}
    got = []
    for mx in (tmx, jmx):
        cell = mx.rnn.LSTMCell(4, prefix="lstm_")
        args = {k: nd_array(mx, v.astype(np.float32)) for k, v in raw.items()}
        unpacked = cell.unpack_weights(dict(args))
        packed = cell.pack_weights(dict(unpacked))
        got.append(({k: v.asnumpy() for k, v in unpacked.items()},
                    {k: v.asnumpy() for k, v in packed.items()}))
        for k in args:
            np.testing.assert_allclose(packed[k].asnumpy(),
                                       args[k].asnumpy())
    for a, b in zip(got[0], got[1]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_fused_pack_unpack_match_jax():
    fl = {}
    for mx in (tmx, jmx):
        fused = mx.rnn.FusedRNNCell(5, num_layers=2, mode="lstm",
                                    prefix="lstm_", bidirectional=True)
        out, _ = fused.unroll(3, inputs=mx.sym.Variable("data"),
                              merge_outputs=True)
        n = out.infer_shape(data=(2, 3, 4))[0][1][0]
        flat = np.random.RandomState(3).randn(n).astype(np.float32)
        unpacked = fused.unpack_weights({"lstm_parameters":
                                         nd_array(mx, flat)})
        assert unpacked["lstm_l0_i2h_i_weight"].shape == (5, 4)
        assert unpacked["lstm_r1_h2h_o_bias"].shape == (5,)
        packed = fused.pack_weights(dict(unpacked))
        np.testing.assert_allclose(packed["lstm_parameters"].asnumpy(), flat)
        fl[mx] = {k: v.asnumpy() for k, v in unpacked.items()}
    assert sorted(fl[tmx]) == sorted(fl[jmx])
    for k in fl[jmx]:
        np.testing.assert_array_equal(fl[tmx][k], fl[jmx][k])


def test_fused_unroll_default_merge_returns_tensor():
    fused = tmx.rnn.FusedRNNCell(4, num_layers=1, mode="gru", prefix="gru_")
    out, _ = fused.unroll(3, inputs=tmx.sym.Variable("data"))
    assert isinstance(out, tmx.sym.Symbol)
    ex = out.simple_bind(ctx=CPU, data=(2, 3, 5))
    assert ex.forward()[0].shape == (2, 3, 4)


def test_sequential_stack_with_fused_cell():
    def make(mx):
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.FusedRNNCell(6, num_layers=1, mode="gru",
                                      prefix="gru_", get_next_state=True))
        stack.add(mx.rnn.LSTMCell(6, prefix="lstm_"))
        return stack

    t = _check_cell(make, 3, 4, 5, 7)
    assert t["outputs"][0].shape == (4, 3, 6)


@pytest.mark.parametrize("via_json", [False, True])
def test_lstm_forget_bias_initialized(via_json):
    got = []
    for mx in (tmx, jmx):
        cell = mx.rnn.LSTMCell(4, prefix="lstm_", forget_bias=3.0)
        outputs, _ = cell.unroll(2, inputs=mx.sym.Variable("data"),
                                 merge_outputs=True)
        if via_json:
            # the init attribute crosses the file: each package reads the
            # other's
            other = jmx if mx is tmx else tmx
            outputs = other.sym.load_json(outputs.tojson())
            mx = other
        mod = mx.mod.Module(outputs, data_names=["data"], label_names=[],
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (1, 2, 3))], for_training=False)
        mod.init_params(initializer=mx.init.Zero())
        got.append(mod.get_params()[0]["lstm_i2h_bias"].asnumpy())
    for bias in got:
        np.testing.assert_allclose(bias[4:8], 3.0)
        np.testing.assert_allclose(bias[:4], 0.0)


def _batches(mx, sents, seed, **kw):
    random.seed(seed)
    np.random.seed(seed)
    if mx is tmx:
        kw["ctx"] = CPU
    it = mx.rnn.BucketSentenceIter(sents, **kw)
    return it, [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy())
                for b in it]


def test_encode_sentences_and_bucket_iter_match_jax():
    sents = [["a", "b", "c"], ["a", "c"], ["b", "c", "a", "b"],
             ["a", "b"], ["c", "b", "a"]] * 4
    coded = [mx.rnn.encode_sentences(sents, start_label=1, invalid_label=0)
             for mx in (tmx, jmx)]
    assert coded[0] == coded[1] and len(coded[0][1]) == 4
    got = [_batches(mx, coded[0][0], 11, batch_size=2, buckets=[2, 3, 4],
                    invalid_label=0) for mx in (tmx, jmx)]
    assert got[0][0].provide_data == got[1][0].provide_data
    assert len(got[0][1]) == len(got[1][1]) == len(got[0][0].idx) > 0
    for (k, d, l), (jk, jd, jl) in zip(got[0][1], got[1][1]):
        assert k == jk
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(l, jl)
        assert d.shape == (2, k)
        np.testing.assert_array_equal(l[:, :-1], d[:, 1:])


def test_bucket_iter_empty_bucket_ok():
    it, batches = _batches(tmx, [[1, 2], [3, 4], [5, 6], [7, 8]], 0,
                           batch_size=2, buckets=[2, 10], invalid_label=0)
    assert [b[0] for b in batches] == [2, 2]


def _gru_lm(mx, V=4, H=16):
    def sym_gen(seq_len):
        embed = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=V,
                                 output_dim=8, name="embed")
        outputs, _ = mx.rnn.GRUCell(H, prefix="gru_").unroll(
            seq_len, inputs=embed, layout="NTC", merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(outputs, shape=(-1, H)),
                                     num_hidden=V, name="pred")
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, name="softmax"),
                ["data"], ["softmax_label"])

    return sym_gen


def _lm_corpus():
    base = [1, 2, 3] * 5
    return [base[s:s + ln] for s in range(3) for ln in (4, 6)
            for _ in range(8)]


def test_bucketing_module_with_bucket_iter_converges():
    it, _ = _batches(tmx, _lm_corpus(), 0, batch_size=4, buckets=[4, 6],
                     invalid_label=0)
    mod = tmx.mod.BucketingModule(_gru_lm(tmx),
                                  default_bucket_key=it.default_bucket_key,
                                  context=CPU)
    mod.fit(it, num_epoch=2,
            eval_metric=tmx.metric.Perplexity(ignore_label=None),
            optimizer="adam", optimizer_params={"learning_rate": 0.05})
    score = dict(mod.score(it, tmx.metric.Perplexity(ignore_label=None)))
    assert score["perplexity"] < 2.5


def test_bucketing_module_steps_match_jax():
    sym = _gru_lm(tmx)(6)[0]
    shapes, _, _ = sym.infer_shape(data=(4, 6), softmax_label=(4, 6))
    rs = np.random.RandomState(9)
    params = {n: (rs.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    got = []
    for mx in (tmx, jmx):
        it, _ = _batches(mx, _lm_corpus(), 2, batch_size=4, buckets=[4, 6],
                         invalid_label=0)
        it.reset()
        mod = mx.mod.BucketingModule(_gru_lm(mx), default_bucket_key=6,
                                     context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: nd_array(mx, v)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        keys = []
        for batch, _ in zip(it, range(3)):
            keys.append(batch.bucket_key)
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        got.append((keys, {k: v.asnumpy()
                           for k, v in mod.get_params()[0].items()}))
    assert got[0][0] == got[1][0] and len(set(got[0][0])) == 2
    assert_grads_close(got[0][1], got[1][1])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_rnn_checkpoint_crosses(tmp_path, writer, reader):
    pkgs = {"port": tmx, "jax": jmx}
    wmx, rmx = pkgs[writer], pkgs[reader]
    rng = np.random.RandomState(0)
    raw = {"lstm_i2h_weight": rng.randn(16, 3), "lstm_i2h_bias":
           rng.randn(16), "lstm_h2h_weight": rng.randn(16, 4),
           "lstm_h2h_bias": rng.randn(16)}
    cell = wmx.rnn.LSTMCell(4, prefix="lstm_")
    outputs, _ = cell.unroll(2, inputs=wmx.sym.Variable("data"),
                             merge_outputs=True)
    prefix = str(tmp_path / "model")
    wmx.rnn.save_rnn_checkpoint(
        cell, prefix, 1, outputs,
        {k: nd_array(wmx, v.astype(np.float32)) for k, v in raw.items()}, {})
    sym, arg2, _ = rmx.rnn.load_rnn_checkpoint(
        rmx.rnn.LSTMCell(4, prefix="lstm_"), prefix, 1)
    assert sym.list_arguments() == outputs.list_arguments()
    for k, v in raw.items():
        np.testing.assert_allclose(arg2[k].asnumpy(), v.astype(np.float32),
                                   rtol=1e-6)
