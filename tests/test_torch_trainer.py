"""The port's Gluon training loop against the JAX package's.

LeNet and the MLP of ``examples/train_mnist.py`` (the LeNet at the
example's widths) are built in both packages inside a ``net_`` name scope,
so their Parameters have the same names; the JAX net is initialized by
``mx.init.Xavier()``, finishes its deferred shapes on a first batch, and
its weights are carried into the port by name (``Parameter.set_data``).
Both then run ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
``backward()`` -> ``Trainer.step(B)`` on the same batches (numpy,
``RandomState(0)``), the JAX net unhybridized, the port's hybridized.

Tolerances: every parameter after every step within ``rtol=1e-4,
atol=1e-5`` of the JAX one under SGD (``TOL``), both f32: the sums run in
another order, so the gradients differ in the last bits, and SGD passes
that on linearly.  Under Adam ``atol`` is ``5e-5``, half a percent of the
lr of 0.01 (``ADAM_TOL``): Adam's step is ``lr * m / (sqrt(v) + eps)``,
which for a gradient within a few ``eps`` of zero turns a last-bit
difference of the gradient into a visible part of ``lr`` (one element of
LeNet's 400,000 in the second step moves 1.3e-5 apart).  The gradients
of ``grad_req="add"`` within ``TOL``.

Each fault the comparison must catch is planted once in the port
(``test_planted_*``): ``grad_req="add"`` overwriting, ``lr_mult``
ignored, and ``rescale_grad`` not divided by the batch size; each makes
the same comparison fail.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.parameter import \
    DeferredInitializationError as JaxDeferred

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError

B = 16
TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_TOL = dict(rtol=1e-4, atol=5e-5)
_RNG = np.random.RandomState(0)
X = (_RNG.rand(4 * B, 1, 28, 28) > 0.7).astype(np.float32) \
    + _RNG.randn(4 * B, 1, 28, 28).astype(np.float32) * 0.15
Y = _RNG.randint(0, 10, 4 * B).astype(np.float32)
OPTS = {"sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                        "wd": 1e-4}),
        "adam": ("adam", {"learning_rate": 0.01})}


class _Pkg:
    def __init__(self, mx, gluon, nd, autograd, ctx):
        self.mx, self.gluon, self.nd, self.autograd = mx, gluon, nd, autograd
        self.ctx = ctx

    def array(self, a):
        return self.nd.array(a, ctx=self.ctx)


JAX = _Pkg(jmx, jgluon, jnd, jag, jmx.cpu())
PORT = _Pkg(tmx, tgluon, tnd, tag, tmx.cpu())


def lenet(gluon):
    net = gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(20, 5, activation="relu"),
                gluon.nn.MaxPool2D(2, 2),
                gluon.nn.Conv2D(50, 5, activation="relu"),
                gluon.nn.MaxPool2D(2, 2), gluon.nn.Flatten(),
                gluon.nn.Dense(500, activation="relu"), gluon.nn.Dense(10))
    return net


def mlp(gluon):
    net = gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(gluon.nn.Flatten(), gluon.nn.Dense(128, activation="relu"),
                gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(10))
    return net


NETS = {"lenet": lenet, "mlp": mlp}


def _nets(kind):
    """(JAX net, port net) with the same weights."""
    jnet = NETS[kind](jgluon)
    jnet.initialize(jmx.init.Xavier(), ctx=JAX.ctx)
    jnet(JAX.array(X[:B]))
    tnet = NETS[kind](tgluon)
    tnet.initialize(ctx=PORT.ctx)
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        tparams[name].set_data(p.data().asnumpy())
    tnet.hybridize()
    return jnet, tnet


def _snapshot(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


def _backward(pkg, net, loss_fn, i):
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.array(X[i * B:(i + 1) * B])),
                       pkg.array(Y[i * B:(i + 1) * B]))
    loss.backward()


def _train(pkg, net, trainer, steps, hook=None):
    """The parameters after each of ``steps`` steps."""
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for i in range(steps):
        if hook is not None:
            hook(i, trainer)
        _backward(pkg, net, loss_fn, i)
        trainer.step(B)
        out.append(_snapshot(net))
    return out


def _close(got, want, tol=TOL) -> bool:
    return all(np.allclose(g[k], w[k], **tol) for g, w in zip(got, want)
               for k in w)


def _assert_close(got, want, tol=TOL):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **tol,
                                       err_msg=f"step {step} {k}")


_REF = {}


def _jax_reference(kind, opt):
    """The JAX trajectory of ``kind`` under ``opt`` and its start."""
    if (kind, opt) not in _REF:
        jnet, tnet = _nets(kind)
        start = _snapshot(jnet)
        name, params = OPTS[opt]
        traj = _train(JAX, jnet, jgluon.Trainer(jnet.collect_params(), name,
                                                dict(params)), 3)
        _REF[kind, opt] = (start, traj)
    return _REF[kind, opt]


def _port_net(kind, start):
    tnet = NETS[kind](tgluon)
    tnet.initialize(ctx=PORT.ctx)
    for name, p in tnet.collect_params().items():
        p.set_data(start[name])
    tnet.hybridize()
    return tnet


@pytest.mark.parametrize("route", ["fused", "per_param", "kvstore"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("kind", ["lenet", "mlp"])
def test_trainer_steps_match_jax(kind, opt, route, monkeypatch):
    """Three steps of the port's Trainer equal the JAX Trainer's: through
    ``FusedUpdater.apply``, the per-parameter ``Updater``
    (``MX_FUSED_UPDATE=0``), or a ``KVStore`` instance that updates on
    push (``update_on_kvstore``)."""
    start, want = _jax_reference(kind, opt)
    if route == "per_param":
        monkeypatch.setenv("MX_FUSED_UPDATE", "0")
    tnet = _port_net(kind, start)
    name, params = OPTS[opt]
    kv = tmx.kv.create("device") if route == "kvstore" else "device"
    trainer = tgluon.Trainer(tnet.collect_params(), name, dict(params),
                             kvstore=kv)
    got = _train(PORT, tnet, trainer, 3)
    _assert_close(got, want, ADAM_TOL if opt == "adam" else TOL)
    if route == "fused":
        assert trainer._updaters[0].last_info["n_fused"] == len(start)
    if route == "kvstore":
        assert trainer._update_on_kvstore and trainer._updaters is None
    assert trainer.optimizer.rescale_grad == pytest.approx(1.0 / B)
    assert tnet._cached_op.num_entries == 1


def _add_run(pkg, net, plant=None):
    """grad_req='add': two backward passes summed, a step, zero_grad, one
    more pass and step; the gradients after the sum and the parameters
    after each step."""
    params = net.collect_params()
    params.setattr("grad_req", "add")
    if plant is not None:
        plant(params)
    trainer = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    _backward(pkg, net, loss_fn, 0)
    _backward(pkg, net, loss_fn, 1)
    grads = {k: p.grad().asnumpy().copy() for k, p in params.items()}
    trainer.step(2 * B)
    first = _snapshot(net)
    params.zero_grad()
    _backward(pkg, net, loss_fn, 2)
    trainer.step(B)
    return [grads, first, _snapshot(net)]


def test_grad_req_add_accumulates_until_zero_grad():
    jnet, tnet = _nets("mlp")
    _assert_close(_add_run(PORT, tnet), _add_run(JAX, jnet))


def test_planted_grad_req_add_overwriting_is_caught():
    """The port's backward overwriting an ``add`` buffer (each data
    view told ``write``) fails the comparison above."""
    jnet, tnet = _nets("mlp")

    def plant(params):
        for p in params.values():
            p._view._grad_req = "write"

    assert not _close(_add_run(PORT, tnet, plant), _add_run(JAX, jnet))


def _lr_mult_run(pkg, net, trainer_cls=None):
    net.collect_params(".*dense.*").setattr("lr_mult", 0.25)
    net.collect_params(".*conv.*").setattr("wd_mult", 0.0)
    cls = trainer_cls or pkg.gluon.Trainer
    trainer = cls(net.collect_params(), "sgd",
                  {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3})
    return _train(pkg, net, trainer, 2)


def test_lr_mult_and_wd_mult_through_setattr():
    jnet, tnet = _nets("lenet")
    _assert_close(_lr_mult_run(PORT, tnet), _lr_mult_run(JAX, jnet))
    # the multipliers are the attributes DataParallelStep reads
    w = tnet.collect_params()["net_dense0_weight"]
    assert w.data()._data.lr_mult == 0.25 and w.lr_mult == 0.25


def test_planted_lr_mult_ignored_is_caught(monkeypatch):
    jnet, tnet = _nets("lenet")
    want = _lr_mult_run(JAX, jnet)
    monkeypatch.setattr(tmx.optimizer.Optimizer, "_mult",
                        lambda self, index, by_index, attr: 1.0)
    assert not _close(_lr_mult_run(PORT, tnet), want)


def test_planted_rescale_not_divided_by_batch_is_caught():
    class Undivided(tgluon.Trainer):
        def step(self, batch_size, ignore_stale_grad=False):
            super().step(1, ignore_stale_grad)

    start, want = _jax_reference("mlp", "sgd")
    tnet = _port_net("mlp", start)
    name, params = OPTS["sgd"]
    got = _train(PORT, tnet, Undivided(tnet.collect_params(), name,
                                       dict(params)), 3)
    assert not _close(got, want)


def test_set_learning_rate_between_steps():
    jnet, tnet = _nets("mlp")

    def hook(i, trainer):
        if i == 1:
            trainer.set_learning_rate(0.002)

    runs = []
    for pkg, net in ((PORT, tnet), (JAX, jnet)):
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        runs.append(_train(pkg, net, trainer, 3, hook))
        assert trainer.learning_rate == pytest.approx(0.002)
    _assert_close(*runs, ADAM_TOL)


@pytest.mark.parametrize("route", ["fused", "kvstore"])
def test_save_states_load_states_round_trip(route, tmp_path):
    """Two steps, ``save_states``, a fresh Trainer that ``load_states``,
    a third step: the parameters equal three straight steps of the JAX
    Trainer (Adam's moments and update counts come back)."""
    start, want = _jax_reference("mlp", "adam")
    tnet = _port_net("mlp", start)
    name, params = OPTS["adam"]

    def trainer():
        kv = tmx.kv.create("device") if route == "kvstore" else "device"
        return tgluon.Trainer(tnet.collect_params(), name, dict(params),
                              kvstore=kv)

    stepped = trainer()
    got = _train(PORT, tnet, stepped, 2)
    fname = str(tmp_path / "states")
    stepped.save_states(fname)
    resumed = trainer()
    resumed.load_states(fname)
    _backward(PORT, tnet, tgluon.loss.SoftmaxCrossEntropyLoss(), 2)
    resumed.step(B)
    _assert_close(got + [_snapshot(tnet)], want, ADAM_TOL)


def test_step_before_first_forward_raises():
    """A net whose shapes are still deferred cannot step, in either
    package; the first call finishes the shapes."""
    for pkg, err in ((PORT, DeferredInitializationError),
                     (JAX, JaxDeferred)):
        net = mlp(pkg.gluon)
        net.initialize(pkg.mx.init.Xavier(), ctx=pkg.ctx)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        with pytest.raises(err):
            trainer.step(B)
        _backward(pkg, net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), 0)
        trainer.step(B)
        assert net.collect_params()["net_dense0_weight"].shape == (128, 784)


def _example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_mnist.py"
    spec = importlib.util.spec_from_file_location("train_mnist_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mnist_example_loop_on_the_port_cpu():
    """``examples/train_mnist.py``'s loop with ``mxnet_tpu_torch`` in
    place of ``mxnet_tpu`` and the CPU: ``initialize(Xavier)``,
    ``hybridize``, Adam through ``gluon.Trainer``, ``record`` /
    ``backward`` / ``step``, ``metric.Accuracy``, one epoch of
    ``synthetic_mnist(2048)`` at batch 64.  The parameters after each of
    the first three steps equal the JAX package's from the same weights
    (``ADAM_TOL``), and the epoch's train accuracy passes 0.9 (the example's
    gate is 0.95 after three epochs)."""
    ex = _example()
    Xm, ym = ex.synthetic_mnist()
    jnet = ex.build_net("lenet")
    jnet.initialize(jmx.init.Xavier(), ctx=JAX.ctx)
    jnet.hybridize()
    tnet = _example_port_net(ex)
    bsz = 64
    perm = np.random.RandomState(42).permutation(len(Xm))
    runs = {}
    metric = tmx.metric.Accuracy()
    for pkg, net in ((JAX, jnet), (PORT, tnet)):
        if pkg is PORT:
            tparams = net.collect_params()
            jparams = jnet.collect_params()
            for (tk, tp), (jk, jp) in zip(tparams.items(), jparams.items()):
                tp.set_data(start[jk])
        else:
            net(JAX.array(Xm[:bsz]))
            start = _snapshot(net)
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        steps = 3 if pkg is JAX else len(Xm) // bsz
        snaps = []
        for i in range(steps):
            idx = perm[i * bsz:(i + 1) * bsz]
            data, label = pkg.array(Xm[idx]), pkg.array(ym[idx])
            with pkg.autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(bsz)
            if pkg is PORT:
                metric.update(label, out)
            if i < 3:
                snaps.append(list(_snapshot(net).values()))
        runs[pkg is PORT] = snaps
    for step, (got, want) in enumerate(zip(runs[True], runs[False])):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **ADAM_TOL,
                                       err_msg=f"step {step}")
    name, acc = metric.get()
    assert name == "accuracy" and acc > 0.9, acc


def _example_port_net(ex):
    """The example's ``build_net("lenet")`` on the port: the same code
    with the port's ``gluon``."""
    saved = ex.gluon
    ex.gluon = tgluon
    try:
        net = ex.build_net("lenet")
    finally:
        ex.gluon = saved
    net.initialize(tmx.init.Xavier(), ctx=PORT.ctx)
    net.hybridize()
    return net


def test_trainer_updates_in_place():
    """The updates write into the module's tensors: the ``nn.Parameter``
    objects and their storage stay those the module holds."""
    start, _ = _jax_reference("mlp", "adam")
    tnet = _port_net("mlp", start)
    before = {n: (t, t.data_ptr()) for n, t in tnet.named_parameters()}
    _train(PORT, tnet, tgluon.Trainer(tnet.collect_params(), "adam",
                                      {"learning_rate": 0.01}), 2)
    for n, t in tnet.named_parameters():
        assert before[n][0] is t and before[n][1] == t.data_ptr()
