"""The port's ``nd.sparse``, row-sparse gradients and lazy optimizer
updates, against the JAX package in one process.

The cases of ``tests/test_sparse_namespace.py`` (the ``nd.sparse``
functions) and ``tests/test_sparse_grad.py`` (``Embedding(sparse_grad=
True)``, the lazy SGD and Adam updates) run through both packages on the
same numpy inputs and weights; components (values, indices, indptr) and
dense forms are held to the JAX arrays.  Tolerances: index components and
untouched rows exactly; f32 values and updated rows within rtol 1e-6 (the
same f32 operations, summed in another order where ids repeat).
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsparse
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import local_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsparse
from mxnet_tpu_torch.parallel import DataParallelStep

CPU = tmx.cpu()
VOCAB, DIM = 12, 4
RTOL, ATOL = 1e-6, 1e-7
W0 = np.random.RandomState(3).normal(0, 0.1, (VOCAB, DIM)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _components(a):
    """(values, indices[, indptr]) of a sparse array of either package as
    numpy, indices as int64."""
    out = [np.asarray(a.data.asnumpy()),
           np.asarray(a.indices.asnumpy()).astype(np.int64)]
    if a.stype == "csr":
        out.append(np.asarray(a.indptr.asnumpy()).astype(np.int64))
    return out


def _same_sparse(t, j):
    assert t.stype == j.stype and tuple(t.shape) == tuple(j.shape)
    tc, jc = _components(t), _components(j)
    _close(tc[0], jc[0])
    for a, b in zip(tc[1:], jc[1:]):
        np.testing.assert_array_equal(a, b)
    _close(t.asnumpy(), j.asnumpy())


# ---------------------------------------------------------------------------
# nd.sparse (tests/test_sparse_namespace.py)
# ---------------------------------------------------------------------------
def _rs(pkg, dense):
    kw = {"ctx": CPU} if pkg is tnd else {}
    return pkg.array(dense, **kw).tostype("row_sparse")


def _csr(pkg, dense):
    kw = {"ctx": CPU} if pkg is tnd else {}
    return pkg.array(dense, **kw).tostype("csr")


def _arr(pkg, x):
    return pkg.array(x, ctx=CPU) if pkg is tnd else pkg.array(x)


def test_sparse_elemwise_add_stays_sparse():
    a = np.zeros((6, 3), np.float32)
    a[1], a[4] = 1, 2
    b = np.zeros((6, 3), np.float32)
    b[1], b[2] = 10, 5
    for op in ("add", "subtract"):
        t = getattr(tsparse, op)(_rs(tnd, a), _rs(tnd, b))
        j = getattr(jsparse, op)(_rs(jnd, a), _rs(jnd, b))
        _same_sparse(t, j)
    t = tsparse.multiply(_rs(tnd, a), _rs(tnd, b))
    assert t.stype == "default"
    np.testing.assert_array_equal(t.asnumpy(), a * b)


def test_sparse_dot_csr():
    a = np.zeros((4, 5), np.float32)
    a[0, 1], a[3, 4] = 2, 7
    b = np.random.RandomState(0).rand(5, 2).astype(np.float32)
    t = tsparse.dot(_csr(tnd, a), _arr(tnd, b)).asnumpy()
    j = jsparse.dot(_csr(jnd, a), _arr(jnd, b)).asnumpy()
    _close(t, j)
    _close(t, a @ b)


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_dot_csr_transpose_a(seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(6, 9).astype(np.float32) * (rng.rand(6, 9) < 0.3)
    r = rng.rand(6, 3).astype(np.float32)
    t = tsparse.dot(_csr(tnd, a), _arr(tnd, r), transpose_a=True).asnumpy()
    j = jsparse.dot(_csr(jnd, a), _arr(jnd, r), transpose_a=True).asnumpy()
    _close(t, j)
    _close(t, a.T @ r)


def test_sparse_retain_and_zeros_like():
    a = np.zeros((5, 2), np.float32)
    a[1], a[3] = 3, 4
    keep = np.array([1, 2], np.float32)
    t = tsparse.retain(_rs(tnd, a), _arr(tnd, keep))
    j = jsparse.retain(_rs(jnd, a), _arr(jnd, keep))
    _same_sparse(t, j)
    for pkg, sp in ((tnd, tsparse), (jnd, jsparse)):
        z = sp.zeros_like(_rs(pkg, a))
        assert z.stype == "row_sparse" and tuple(z.shape) == (5, 2)
        assert z.asnumpy().sum() == 0


def test_sparse_dot_transpose_b_and_sparse_rhs():
    a = np.zeros((4, 5), np.float32)
    a[0, 1], a[3, 4] = 2, 7
    b = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    t = tsparse.dot(_csr(tnd, a), _arr(tnd, b), transpose_b=True).asnumpy()
    j = jsparse.dot(_csr(jnd, a), _arr(jnd, b), transpose_b=True).asnumpy()
    _close(t, j)
    e = np.eye(5, 2, dtype=np.float32)
    t = tsparse.dot(_csr(tnd, a), _rs(tnd, e)).asnumpy()
    j = jsparse.dot(_csr(jnd, a), _rs(jnd, e)).asnumpy()
    _close(t, j)


def test_sparse_zeros_like_csr_keeps_stype():
    a = np.zeros((3, 4), np.float32)
    a[1, 2] = 5
    t = tsparse.zeros_like(_csr(tnd, a))
    j = jsparse.zeros_like(_csr(jnd, a))
    assert t.stype == j.stype == "csr" and tuple(t.shape) == (3, 4)
    for a_, b_ in zip(_components(t), _components(j)):
        np.testing.assert_array_equal(a_, b_)


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_both_ways(stype):
    rng = np.random.RandomState(7)
    a = (rng.rand(5, 6) * (rng.rand(5, 6) < 0.4)).astype(np.float32)
    a[2] = 0
    t = tnd.cast_storage(_arr(tnd, a), stype)
    j = jnd.cast_storage(_arr(jnd, a), stype)
    _same_sparse(t, j)
    back_t = tnd.cast_storage(t, "default")
    back_j = jnd.cast_storage(j, "default")
    assert back_t.stype == "default"
    np.testing.assert_array_equal(back_t.asnumpy(), back_j.asnumpy())
    np.testing.assert_array_equal(back_t.asnumpy(), a)
    # tostype between the sparse types goes through the dense form
    other = "csr" if stype == "row_sparse" else "row_sparse"
    _same_sparse(t.tostype(other), j.tostype(other))
    assert t.tostype(stype) is t
    # out= of the target storage type receives the result
    out = tsparse.zeros(stype, a.shape, ctx=CPU)
    assert tnd.cast_storage(_arr(tnd, a), stype, out=out) is out
    _same_sparse(out, j)
    with pytest.raises(MXNetError, match="stype"):
        tnd.cast_storage(_arr(tnd, a), "default", out=out)


def test_constructors_from_components_and_scipy():
    import scipy.sparse as sp

    vals = np.array([[1, 2], [3, 4]], np.float32)
    t = tsparse.row_sparse_array((vals, [0, 3]), shape=(5, 2), ctx=CPU)
    j = jsparse.row_sparse_array((vals, [0, 3]), shape=(5, 2))
    _same_sparse(t, j)
    m = sp.random(6, 7, density=0.3, random_state=1, format="csr",
                  dtype=np.float32)
    t = tsparse.array(m, ctx=CPU)
    j = jsparse.array(m)
    _same_sparse(t, j)
    _close(t.asnumpy(), m.toarray())
    c = tsparse.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape,
                           ctx=CPU)
    _same_sparse(c, j)
    for stype in ("row_sparse", "csr"):
        z = tsparse.zeros(stype, (4, 3), ctx=CPU)
        assert z.stype == stype and z.asnumpy().sum() == 0
        assert tsparse.empty(stype, (4, 3), ctx=CPU).stype == stype
    with pytest.raises(MXNetError, match="shape"):
        tsparse.row_sparse_array((vals, [0, 3]), ctx=CPU)
    with pytest.raises(MXNetError, match="scipy"):
        tsparse.array(np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# row-sparse gradients and the lazy updates (tests/test_sparse_grad.py)
# ---------------------------------------------------------------------------
def _jnet(sparse):
    net = jgluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse)
    net.initialize()
    net.weight.set_data(jnd.array(W0))
    return net, net.weight


def _tnet(sparse):
    net = tgluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse)
    net.initialize(ctx=CPU)
    p = next(iter(net.collect_params().values()))
    p.set_data(W0)
    return net, p


def _backward(pkg, ag, net, x):
    with ag.record():
        loss = (net(_arr(pkg, x)) ** 2).sum()
    loss.backward()


def test_embedding_sparse_grad_is_row_sparse():
    x = np.array([[1, 3], [3, 5]], np.float32)
    tnet, tp = _tnet(True)
    jnet, jp = _jnet(True)
    _backward(tnd, tag, tnet, x)
    _backward(jnd, jag, jnet, x)
    g = tp.grad()
    assert isinstance(g, tsparse.RowSparseNDArray)
    _same_sparse(g, jp.grad())
    np.testing.assert_array_equal(_components(g)[1], [1, 3, 5])
    dnet, dp = _tnet(False)
    _backward(tnd, tag, dnet, x)
    assert dp.grad().stype == "default"
    _close(g.asnumpy(), dp.grad().asnumpy())


def _train(pkg, ag, gluon, make, sparse, opt, params, xs, batch=1):
    net, p = make(sparse)
    trainer = gluon.Trainer(net.collect_params(), opt, params)
    for x in xs:
        _backward(pkg, ag, net, x)
        trainer.step(batch)
    return p.data().asnumpy(), trainer


def test_sgd_lazy_update_touches_only_looked_up_rows():
    params = {"learning_rate": 0.5, "wd": 0.1, "momentum": 0.9}
    xs = [np.array([[1, 3]], np.float32)]
    wt, _ = _train(tnd, tag, tgluon, _tnet, True, "sgd", params, xs)
    wj, _ = _train(jnd, jag, jgluon, _jnet, True, "sgd", params, xs)
    _close(wt, wj)
    for r in range(VOCAB):
        if r in (1, 3):
            assert not np.allclose(wt[r], W0[r])
        else:
            np.testing.assert_array_equal(wt[r], W0[r])


def test_duplicate_ids_do_not_touch_row0():
    params = {"learning_rate": 0.5, "wd": 0.3, "momentum": 0.9}
    xs = [np.array([[5, 5, 5, 3]], np.float32)] * 3
    wt, _ = _train(tnd, tag, tgluon, _tnet, True, "sgd", params, xs)
    wj, _ = _train(jnd, jag, jgluon, _jnet, True, "sgd", params, xs)
    _close(wt, wj)
    np.testing.assert_array_equal(wt[0], W0[0])
    assert not np.allclose(wt[5], W0[5]) and not np.allclose(wt[3], W0[3])


def test_sparse_training_matches_dense():
    xs = [np.array([[1, 3], [5, 7]], np.float32),
          np.array([[0, 2], [3, 3]], np.float32)]
    params = {"learning_rate": 0.2}
    dense, _ = _train(tnd, tag, tgluon, _tnet, False, "sgd", params, xs, 2)
    sparse, _ = _train(tnd, tag, tgluon, _tnet, True, "sgd", params, xs, 2)
    jax_sparse, _ = _train(jnd, jag, jgluon, _jnet, True, "sgd", params,
                           xs, 2)
    np.testing.assert_allclose(sparse, dense, rtol=1e-5, atol=1e-6)
    _close(sparse, jax_sparse)


def _adam_states(trainer):
    upd = trainer._updaters[0]
    mean, var = upd.states[0]
    return mean.asnumpy(), var.asnumpy()


def _lazy_adam_f64(xs, lr, wd, f32_scalars, b1=0.9, b2=0.999, eps=1e-8):
    """The lazy Adam rule (``mxnet_tpu/optimizer/optimizer.py:231-240``)
    in float64 on the host for ``(net(x) ** 2).sum()``: weight, mean and
    var.  ``f32_scalars`` rounds the scalars to f32 first and takes
    1 - beta in f32, as the JAX row-sparse kernel does (its scalars are
    traced f32 arguments)."""
    f = np.float32 if f32_scalars else float
    w = W0.astype(np.float64)
    mean, var = np.zeros_like(w), np.zeros_like(w)
    for t, x in enumerate(xs, 1):
        ids, counts = np.unique(x.astype(np.int64), return_counts=True)
        g = 2.0 * counts[:, None] * w[ids] + float(f(wd)) * w[ids]
        lr_t = lr * np.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        B1, B2 = float(f(b1)), float(f(b2))
        om1, om2 = float(f(1) - f(b1)), float(f(1) - f(b2))
        mean[ids] = B1 * mean[ids] + om1 * g
        var[ids] = B2 * var[ids] + om2 * g * g
        w[ids] -= (float(f(lr_t)) * mean[ids]
                   / (np.sqrt(var[ids]) + float(f(eps))))
    return w, mean, var


def test_adam_sparse_update_is_lazy_and_matches_the_rule():
    """Lazy Adam: untouched rows (weight and both moments) exactly as they
    started; touched rows the rule's.  The JAX kernel's own f32 scalars
    (1 - 0.999 rounds to 0.0009999871 in f32, 1.3e-5 from 0.001) put it
    ~1e-6 from the port, so each is held to the rule as it computes it."""
    params = {"learning_rate": 0.1, "wd": 1e-2}
    xs = [np.array([[2, 4]], np.float32), np.array([[4, 9]], np.float32),
          np.array([[2, 2]], np.float32)]
    wt, tt = _train(tnd, tag, tgluon, _tnet, True, "adam", params, xs)
    wj, tj = _train(jnd, jag, jgluon, _jnet, True, "adam", params, xs)
    for got, trainer, f32 in ((wt, tt, False), (wj, tj, True)):
        rule = _lazy_adam_f64(xs, 0.1, 1e-2, f32)
        _close(got, rule[0])
        for a, b in zip(_adam_states(trainer), rule[1:]):
            # f32 roundings of each step's sum, of the moment's scale
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max())
    untouched = [r for r in range(VOCAB) if r not in (2, 4, 9)]
    np.testing.assert_array_equal(wt[untouched], W0[untouched])
    np.testing.assert_array_equal(wt[untouched], wj[untouched])
    mean, var = _adam_states(tt)
    assert not mean[untouched].any() and not var[untouched].any()
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=2e-6)


def test_autograd_grad_returns_row_sparse():
    x = np.array([1, 1, 6], np.float32)
    got = []
    for pkg, ag in ((tnd, tag), (jnd, jag)):
        w = _arr(pkg, W0)
        w.attach_grad()
        with ag.record():
            out = pkg.Embedding(_arr(pkg, x), w, input_dim=VOCAB,
                                output_dim=DIM, sparse_grad=True)
            loss = out.sum()
        got.append(ag.grad(loss, w))
    assert isinstance(got[0], tsparse.RowSparseNDArray)
    _same_sparse(*got)
    dense = got[0].asnumpy()
    np.testing.assert_allclose(dense[1], np.full(DIM, 2.0))
    np.testing.assert_allclose(dense[6], np.full(DIM, 1.0))
    np.testing.assert_allclose(dense[0], np.zeros(DIM))


def test_dense_buffer_takes_a_sparse_gradient_dense():
    """``attach_grad`` gives a dense buffer: backward writes the sparse
    gradient's dense form into it, as the JAX tape densifies."""
    x = np.array([1, 1, 6], np.float32)
    got = []
    for pkg, ag in ((tnd, tag), (jnd, jag)):
        w = _arr(pkg, W0)
        w.attach_grad()
        with ag.record():
            loss = pkg.Embedding(_arr(pkg, x), w, input_dim=VOCAB,
                                 output_dim=DIM, sparse_grad=True).sum()
        loss.backward()
        got.append(w.grad)
    assert got[0].stype == "default"
    _close(got[0].asnumpy(), got[1].asnumpy())


def test_zero_grad_resets_sparse_buffer():
    tnet, tp = _tnet(True)
    _backward(tnd, tag, tnet, np.array([[1]], np.float32))
    assert tp.grad()._data.shape[0] > 0
    tnet.collect_params().zero_grad()
    assert tp.grad()._data.shape[0] == 0
    assert tp.grad().stype == "row_sparse"
    assert tp.grad().asnumpy().sum() == 0


def test_grad_req_add_merges_two_backward_passes():
    xs = [np.array([[1, 3]], np.float32), np.array([[3, 7, 7]], np.float32)]
    grads = []
    for pkg, ag, make in ((tnd, tag, _tnet), (jnd, jag, _jnet)):
        net, p = make(True)
        p.grad_req = "add"
        for x in xs:
            _backward(pkg, ag, net, x)
        grads.append(p.grad())
    _same_sparse(*grads)
    np.testing.assert_array_equal(_components(grads[0])[1], [1, 3, 7])


def test_tied_weight_gets_every_row():
    """A weight looked up sparsely and also used densely takes the dense
    sum: a dense cotangent into a sparse buffer touches every row, as the
    JAX tape's."""
    x = np.array([[1, 3]], np.float32)
    grads = []
    for pkg, ag, make in ((tnd, tag, _tnet), (jnd, jag, _jnet)):
        net, p = make(True)
        with ag.record():
            loss = (net(_arr(pkg, x)) ** 2).sum() + (p.data() * 0.5).sum()
        loss.backward()
        grads.append(p.grad())
    assert grads[0].stype == "row_sparse"
    np.testing.assert_array_equal(_components(grads[0])[1],
                                  np.arange(VOCAB))
    _close(grads[0].asnumpy(), grads[1].asnumpy())


def test_hybridized_embedding_grad_covers_every_row():
    """Inside a hybridized block's call the JAX package's ops are traced
    and differentiated densely: the row-sparse buffer gets every row."""
    x = np.array([[1, 3], [3, 5]], np.float32)
    grads = []
    for pkg, ag, make in ((tnd, tag, _tnet), (jnd, jag, _jnet)):
        net, p = make(True)
        net.hybridize()
        _backward(pkg, ag, net, x)
        grads.append(p.grad())
    _same_sparse(*grads)
    np.testing.assert_array_equal(_components(grads[0])[1],
                                  np.arange(VOCAB))


def test_clip_global_norm_over_row_sparse_grads():
    x = np.array([[1, 3], [3, 5]], np.float32)
    out = []
    for pkg, ag, make, gluon in ((tnd, tag, _tnet, tgluon),
                                 (jnd, jag, _jnet, jgluon)):
        net, p = make(True)
        _backward(pkg, ag, net, x)
        norm = gluon.utils.clip_global_norm([p.grad()], 0.1)
        out.append((norm, p.grad()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    _same_sparse(out[0][1], out[1][1])


@pytest.mark.parametrize("name", ["nag", "adamax", "nadam", "adagrad",
                                  "adadelta", "rmsprop", "ftrl", "signum",
                                  "lamb"])
def test_other_optimizers_refuse_a_row_sparse_gradient(name):
    """The JAX classes without a lazy update hand the values to their dense
    op, which fails on the shapes; the port refuses by name."""
    vals = np.ones((2, DIM), np.float32)
    jopt = jmx.optimizer.create(name, learning_rate=0.1)
    jw = jnd.array(W0)
    jg = jsparse.row_sparse_array((vals, [1, 2]), shape=(VOCAB, DIM))
    with pytest.raises(Exception):
        jopt.update_multi_precision(0, jw, jg,
                                    jopt.create_state_multi_precision(0, jw))
    topt = tmx.optimizer.create(name, learning_rate=0.1)
    tw = _arr(tnd, W0)
    tg = tsparse.row_sparse_array((vals, [1, 2]), shape=(VOCAB, DIM),
                                  ctx=CPU)
    with pytest.raises(MXNetError, match="lazy update of SGD and Adam"):
        topt.update_multi_precision(0, tw, tg,
                                    topt.create_state_multi_precision(0, tw))


def test_kvstore_reduces_a_sparse_value_dense():
    vals = np.arange(2 * DIM, dtype=np.float32).reshape(2, DIM)
    out = []
    for pkg, sp, kw in ((tnd, tsparse, {"ctx": CPU}), (jnd, jsparse, {})):
        kv = (tmx if pkg is tnd else jmx).kv.create("local")
        kv.init(0, pkg.zeros((VOCAB, DIM), **kw))
        kv.push(0, [sp.row_sparse_array((vals, [2, 5]), shape=(VOCAB, DIM),
                                        **kw),
                    pkg.ones((VOCAB, DIM), **kw)])
        o = pkg.zeros((VOCAB, DIM), **kw)
        kv.pull(0, out=o)
        out.append(o.asnumpy())
    _close(out[0], out[1])


def _step_net(gluon, sparse, ctx=None):
    net = gluon.nn.HybridSequential(prefix="sp_")
    with net.name_scope():
        net.add(gluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse))
    net.initialize(**({"ctx": ctx} if ctx is not None else {}))
    next(iter(net.collect_params().values())).set_data(
        W0 if ctx is not None else jnd.array(W0))
    return net


def test_fused_step_stays_dense():
    """The training step differentiates functionally in the JAX package,
    so ``sparse_grad`` changes nothing there; the port's step is dense
    too: with wd the sparse net's update equals the dense net's (a lazy
    update would leave the untouched rows alone)."""
    x = np.array([[1, 3], [3, 5]], np.float32)
    y = np.zeros((2, 2, DIM), np.float32)
    params = {"learning_rate": 0.5, "wd": 0.1}
    got = {}
    for sparse in (True, False):
        step = DataParallelStep(_step_net(tgluon, sparse, CPU),
                                tgluon.loss.L2Loss(), optimizer="sgd",
                                optimizer_params=params, device=CPU)
        step.step(x, y)
        step.sync_to_block()
        got[("port", sparse)] = next(iter(
            step.block.collect_params().values())).data().asnumpy()
        jstep = JaxStep(_step_net(jgluon, sparse), jgluon.loss.L2Loss(),
                        mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                        optimizer="sgd", optimizer_params=params)
        jstep.step(jnd.array(x), jnd.array(y))
        jstep.sync_to_block()
        got[("jax", sparse)] = next(iter(
            jstep.block.collect_params().values())).data().asnumpy()
    for pkg in ("port", "jax"):
        np.testing.assert_array_equal(got[(pkg, True)], got[(pkg, False)])
    _close(got[("port", True)], got[("jax", True)])
    assert not np.allclose(got[("port", True)][0], W0[0])  # wd: every row
