"""The port's ``mx.mod`` against the JAX package's on the CPU: the cases of
``tests/test_module.py``; three SGD steps (and three Adam steps) of one MLP
through ``Module`` from the same parameters, within 1e-5 of max abs of the
JAX ``Module``'s parameters; ``Module`` checkpoints both ways (a JAX
``save_checkpoint`` loaded by the port's ``Module.load`` and the reverse,
equal outputs; the optimizer states too); a small BERT's exported graph
trained two Adam steps through ``Module`` in both packages; and
``BucketingModule`` sharing one set of parameters across buckets.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models.bert import bert_small as jbert_small
from torch_sym_parity import OUT_TOL, assert_grads_close, nd_array

CPU = tmx.cpu()


def _toy_problem(n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    w = rs.randn(8).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def _mlp_sym(mx):
    sym = mx.sym
    fc1 = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _iter(mx, x, y, batch, **kw):
    if mx is tmx:
        kw["ctx"] = CPU
    return mx.io.NDArrayIter(x, y, batch_size=batch, **kw)


def _module(mx, sym, **kw):
    return mx.mod.Module(sym, context=mx.cpu(), **kw)


def _params(seed=3):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(16, 8).astype(np.float32) * 0.4,
            "fc1_bias": rs.randn(16).astype(np.float32) * 0.1,
            "fc2_weight": rs.randn(2, 16).astype(np.float32) * 0.4,
            "fc2_bias": rs.randn(2).astype(np.float32) * 0.1}


def test_module_fit_converges():
    x, y = _toy_problem()
    train = _iter(tmx, x, y, 32, shuffle=True)
    mod = _module(tmx, _mlp_sym(tmx))
    mod.fit(train, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.02},
            initializer=tmx.init.Xavier())
    train.reset()
    assert dict(mod.score(train, "acc"))["accuracy"] > 0.9


def test_module_forward_predict_shapes():
    x, y = _toy_problem(64)
    outs = []
    for mx in (tmx, jmx):
        it = _iter(mx, x, y, 16)
        mod = _module(mx, _mlp_sym(mx))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=False)
        mod.init_params(arg_params={k: nd_array(mx, v)
                                    for k, v in _params().items()})
        out = mod.predict(it)
        assert out.shape == (64, 2)
        outs.append(out.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **OUT_TOL)
    np.testing.assert_allclose(outs[0].sum(axis=1), np.ones(64), rtol=1e-4)


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01})])
def test_three_steps_match_jax(optimizer, params):
    x, y = _toy_problem(48, seed=5)
    got = []
    for mx in (tmx, jmx):
        it = _iter(mx, x, y, 16)
        mod = _module(mx, _mlp_sym(mx))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: nd_array(mx, v)
                                    for k, v in _params().items()})
        mod.init_optimizer(optimizer=optimizer, optimizer_params=params)
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        arg, _ = mod.get_params()
        got.append({k: v.asnumpy() for k, v in arg.items()})
    assert_grads_close(got[0], got[1])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_module_checkpoint_crosses(tmp_path, writer, reader):
    x, y = _toy_problem(64)
    pkgs = {"port": tmx, "jax": jmx}
    wmx, rmx = pkgs[writer], pkgs[reader]
    prefix = str(tmp_path / "toy")
    it = _iter(wmx, x, y, 16)
    mod = _module(wmx, _mlp_sym(wmx))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: nd_array(wmx, v)
                                for k, v in _params().items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    mod.forward_backward(next(iter(it)))
    mod.update()
    mod.save_checkpoint(prefix, 3)
    it.reset()
    mod.forward(next(iter(it)), is_train=False)
    want = mod.get_outputs()[0].asnumpy()

    mod2 = rmx.mod.Module.load(prefix, 3, context=rmx.cpu())
    it2 = _iter(rmx, x, y, 16)
    mod2.bind(data_shapes=it2.provide_data, label_shapes=it2.provide_label,
              for_training=False)
    mod2.init_params()
    mod2.forward(next(iter(it2)), is_train=False)
    np.testing.assert_allclose(mod2.get_outputs()[0].asnumpy(), want,
                               **OUT_TOL)


def test_optimizer_states_roundtrip(tmp_path):
    x, y = _toy_problem(32)
    prefix = str(tmp_path / "opt")
    outs = []
    for load in (False, True):
        it = _iter(tmx, x, y, 16)
        mod = (tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                   context=CPU) if load
               else _module(tmx, _mlp_sym(tmx)))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=None if load else {
            k: nd_array(tmx, v) for k, v in _params().items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        batches = list(it)
        if not load:
            mod.forward_backward(batches[0])
            mod.update()
            mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        mod.forward_backward(batches[1])
        mod.update()
        outs.append(mod.get_params()[0]["fc1_weight"].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)


def test_module_get_set_params():
    x, y = _toy_problem(32)
    it = _iter(tmx, x, y, 16)
    mod = _module(tmx, _mlp_sym(tmx))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=tmx.init.Xavier())
    arg, aux = mod.get_params()
    assert set(arg) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    orig = arg["fc1_weight"].asnumpy().copy()
    mod._exec.arg_dict["fc1_weight"]._set_data(
        tmx.nd.zeros(orig.shape, ctx=CPU)._data)
    mod.set_params(arg, aux)
    np.testing.assert_allclose(mod._exec.arg_dict["fc1_weight"].asnumpy(),
                               orig)


def _bucket_sym_gen(mx):
    def sym_gen(seq_len):
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                   name="fc_shared")
        return (mx.sym.SoftmaxOutput(fc, name="softmax"), ("data",),
                ("softmax_label",))

    return sym_gen


def test_bucketing_module_matches():
    rs = np.random.RandomState(4)
    xs = [rs.rand(4, 8).astype(np.float32) for _ in range(4)]
    got = []
    for mx in (tmx, jmx):
        mod = mx.mod.BucketingModule(_bucket_sym_gen(mx), default_bucket_key=8,
                                     context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params={
            "fc_shared_weight": nd_array(mx, rs.randn(4, 8).astype(
                np.float32) * 0.0 + 0.1),
            "fc_shared_bias": nd_array(mx, np.zeros(4, np.float32))})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        for i, x in enumerate(xs[:3]):
            key = 8 if i != 1 else 9  # a second bucket of the same shape
            batch = mx.io.DataBatch(
                data=[nd_array(mx, x)],
                label=[nd_array(mx, np.full(4, i % 4, np.float32))],
                bucket_key=key, provide_data=[("data", (4, 8))],
                provide_label=[("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        assert sorted(mod._buckets) == [8, 9]
        mods = list(mod._buckets.values())
        assert (mods[0]._exec.arg_dict["fc_shared_weight"]
                is mods[1]._exec.arg_dict["fc_shared_weight"])
        mod.forward(mx.io.DataBatch(data=[nd_array(mx, xs[3])],
                                    label=[nd_array(mx, np.zeros(
                                        4, np.float32))], bucket_key=8),
                    is_train=False)
        got.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(got[0], got[1], **OUT_TOL)


def test_module_input_grads():
    got = []
    for mx in (tmx, jmx):
        out = mx.sym.LinearRegressionOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=1, name="fc"), name="lro")
        mod = mx.mod.Module(out, label_names=("lro_label",),
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 3))],
                 label_shapes=[("lro_label", (2, 1))], inputs_need_grad=True)
        mod.init_params(initializer=mx.init.One())
        mod.init_optimizer()
        batch = mx.io.DataBatch(
            data=[nd_array(mx, np.arange(6, dtype=np.float32).reshape(2, 3))],
            label=[nd_array(mx, np.zeros((2, 1), np.float32))])
        mod.forward_backward(batch)
        got.append((mod._exec.grad_dict["fc_weight"].asnumpy(),
                    mod.get_input_grads()[0].asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert np.abs(got[0][0]).sum() > 0


def test_monitor_collects_stats(caplog):
    rng = np.random.RandomState(0)
    X = rng.randn(32, 6).astype(np.float32)
    Y = rng.randint(0, 4, 32).astype(np.float32)
    fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    out = tmx.sym.SoftmaxOutput(fc, tmx.sym.Variable("softmax_label"),
                                name="softmax")
    mod = _module(tmx, out)
    it = _iter(tmx, X, Y, 8)
    mon = tmx.Monitor(interval=2, pattern=".*fc.*")
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.monitor"):
        mod.fit(it, num_epoch=1, monitor=mon,
                optimizer_params={"learning_rate": 0.1})
    msgs = [r.message for r in caplog.records
            if r.name == "mxnet_tpu_torch.monitor"]
    assert any("fc_weight" in m for m in msgs), msgs
    assert any("fc_weight_grad" in m for m in msgs), msgs
    assert not any("softmax" in m for m in msgs)
    mon2 = tmx.Monitor(interval=1)
    mod.install_monitor(mon2)
    mon2.tic()
    it.reset()
    mod.forward(next(iter(it)), is_train=False)
    stats = mon2.toc()
    assert stats and all(len(t) == 3 for t in stats)


def test_bert_small_module_two_adam_steps(tmp_path):
    """The slice's main path at bert_small's widths: the JAX export,
    an MLM head (SoftmaxOutput over the (B*T, V) reshape, batch
    normalization), two Adam steps through Module in both packages."""
    jn = jbert_small(dropout=0.0, prefix="bertformlm0_")
    jn.initialize(jmx.init.Normal(0.02))
    rs = np.random.RandomState(6)
    x = rs.randint(0, 512, (2, 16)).astype(np.float32)
    jn(jmx.nd.array(x))
    path = str(tmp_path / "bert")
    jn.export(path, 0)
    got = []
    for mx in (tmx, jmx):
        body = mx.sym.load(f"{path}-symbol.json")
        head = mx.sym.SoftmaxOutput(mx.sym.Reshape(body, shape=(-1, 512)),
                                    normalization="batch", name="softmax")
        arg, aux = mx.model.load_params(path, 0)
        mod = _module(mx, head)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", (x.size,))])
        mod.init_params(arg_params=arg, aux_params=aux, allow_missing=True)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 1e-3})
        batch = mx.io.DataBatch([nd_array(mx, x)],
                                [nd_array(mx, x.reshape(-1))])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()}
        got.append((mod.get_outputs()[0].asnumpy(), grads,
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()}))
    np.testing.assert_allclose(got[0][0], got[1][0], rtol=1e-5, atol=1e-6)
    assert_grads_close(got[0][1], got[1][1])
    assert_grads_close(got[0][2], got[1][2])
