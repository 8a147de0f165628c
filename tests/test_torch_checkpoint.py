"""The port's checkpoints against the JAX package's: formats 1 and 2
written by either package load in the other with every array (and the
Trainer's optimizer states) equal bit for bit; digests are checked and a
torn or corrupt step falls back; ``restore`` resumes the LeNet loop of
``examples/train_mnist.py`` (small widths) with the uninterrupted run's
losses; ``tools/ckpt_report.py`` passes on the port's directories."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
RNG = np.random.RandomState(0)
X = RNG.randn(8, 6).astype(np.float32)
Y = RNG.randn(8, 4).astype(np.float32)


def mlp(gluon, prefix="ck_"):
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gluon.nn.Dense(16, activation="relu", in_units=6),
                gluon.nn.Dense(4, in_units=16))
    return net


def _jax_trained(steps=3):
    jmx.random.seed(0)
    net = mlp(jgluon)
    net.initialize(jmx.init.Normal(0.5), ctx=jmx.cpu())
    trainer = jgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 1e-2})
    loss_fn = jgluon.loss.L2Loss()
    for _ in range(steps):
        with jag.record():
            loss = loss_fn(net(jnd.array(X)), jnd.array(Y))
        loss.backward()
        trainer.step(8)
    return net, trainer


def _port_trained(steps=3):
    net = mlp(tgluon)
    net.initialize(tmx.init.Normal(0.5), ctx=CPU)
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 1e-2})
    loss_fn = tgluon.loss.L2Loss()
    for _ in range(steps):
        with tag.record():
            loss = loss_fn(net(tnd.array(X, ctx=CPU)), tnd.array(Y, ctx=CPU))
        loss.backward()
        trainer.step(8)
    return net, trainer


def _values(net):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


def _trainer_states(trainer):
    upd = (trainer._kvstore._updater if trainer._update_on_kvstore
           else trainer._updaters[0])
    return pickle.loads(upd.get_states(dump_optimizer=False))


def _assert_states_equal(a, b):
    assert a["__counts__"] == b["__counts__"]
    assert a["__num_update__"] == b["__num_update__"]
    assert sorted(a["__states__"]) == sorted(b["__states__"])
    for i in a["__states__"]:
        for x, y in zip(a["__states__"][i], b["__states__"][i]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _write(mod, net, trainer, d, sharded):
    ck = mod.AsyncCheckpointer(d, save_every=1, keep=2, sharded=sharded)
    ck.step(net, trainer=trainer)
    ck.close()
    return d


@pytest.mark.parametrize("sharded", [False, True])
def test_port_checkpoint_loads_in_jax(sharded, tmp_path):
    tnet, ttrainer = _port_trained()
    d = _write(tckpt, tnet, ttrainer, str(tmp_path / "ck"), sharded)
    with open(os.path.join(d, "step-1", "meta.json")) as f:
        meta = json.load(f)
    assert meta.get("format", 1) == (2 if sharded else 1)
    assert os.path.exists(os.path.join(d, "step-1", "params-shard-0.nd")) \
        == sharded
    jnet = mlp(jgluon)
    jnet.initialize(jmx.init.Zero(), ctx=jmx.cpu())
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 1e-2})
    assert jckpt.restore(d, jnet, jtrainer) == 1
    want = _values(tnet)
    got = _values(jnet)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _assert_states_equal(_trainer_states(jtrainer),
                         _trainer_states(ttrainer))


def test_jax_gathered_checkpoint_loads_in_port(tmp_path):
    jnet, jtrainer = _jax_trained()
    d = _write(jckpt, jnet, jtrainer, str(tmp_path / "ck"), False)
    tnet = mlp(tgluon)
    tnet.initialize(tmx.init.Zero(), ctx=CPU)
    ttrainer = tgluon.Trainer(tnet.collect_params(), "adam",
                              {"learning_rate": 1e-2})
    assert tckpt.restore(d, tnet, ttrainer) == 1
    want = _values(jnet)
    for k, v in _values(tnet).items():
        np.testing.assert_array_equal(v, want[k])
    _assert_states_equal(_trainer_states(ttrainer),
                         _trainer_states(jtrainer))
    # the next step from the restored state equals the JAX one's
    loss_j = jgluon.loss.L2Loss()
    with jag.record():
        lj = loss_j(jnet(jnd.array(X)), jnd.array(Y))
    lj.backward()
    jtrainer.step(8)
    loss_t = tgluon.loss.L2Loss()
    with tag.record():
        lt = loss_t(tnet(tnd.array(X, ctx=CPU)), tnd.array(Y, ctx=CPU))
    lt.backward()
    ttrainer.step(8)
    np.testing.assert_allclose(lt.asnumpy(), lj.asnumpy(), rtol=1e-6)
    want = _values(jnet)
    for k, v in _values(tnet).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7)


def test_jax_sharded_checkpoint_loads_in_port(tmp_path):
    """A format-2 checkpoint of the JAX package's ``DataParallelStep`` on
    a tp=2 mesh (two shards per parameter) composes in the port."""
    from mxnet_tpu.parallel import DataParallelStep, make_mesh
    from mxnet_tpu.parallel.sharding import ShardingRules

    jmx.random.seed(0)
    jnet = mlp(jgluon)
    jnet.initialize(jmx.init.Normal(0.5))
    step = DataParallelStep(
        jnet, jgluon.loss.L2Loss(), mesh=make_mesh(tp=2), optimizer="adam",
        optimizer_params={"learning_rate": 1e-2},
        rules=ShardingRules([(r".*weight$", ("tp", None)),
                             (r".*bias$", ("tp",))]))
    d = str(tmp_path / "ck")
    ck = jckpt.AsyncCheckpointer(d, save_every=2, sharded=True)
    for _ in range(2):
        step.step(jnd.array(X), jnd.array(Y))
        ck.step(step)
    step.drain()
    ck.close()
    ref = step.state_dict()
    with open(os.path.join(d, "step-2", "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == 2
    shards = meta["manifest"]["params"]["0.weight"]["shards"]
    assert len(shards) == 2
    state = tckpt.load_checkpoint_state(d)
    assert state["step"] == 2
    assert sorted(state["params"]) == sorted(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_array_equal(state["params"][k].asnumpy(), v)
    for k, v in ref["opt_state"].items():
        np.testing.assert_array_equal(state["opt_state"][k].asnumpy(),
                                      np.asarray(v))
    # a global slice reads only what it needs
    lz = state["params"]["0.weight"]
    np.testing.assert_array_equal(
        lz.read_slice((slice(3, 11), slice(None))).numpy(),
        ref["params"]["0.weight"][3:11])
    tnet = mlp(tgluon)
    tnet.initialize(tmx.init.Zero(), ctx=CPU)
    assert tckpt.restore(d, tnet) == 2
    for k, v in _values(tnet).items():
        np.testing.assert_array_equal(v, ref["params"][k])


def test_bf16_parameters_cross_bit_for_bit(tmp_path):
    tnet, _ = _port_trained(steps=1)
    tnet.cast("bfloat16")
    for sharded in (False, True):
        d = _write(tckpt, tnet, None, str(tmp_path / f"ck{sharded}"),
                   sharded)
        state = jckpt.load_checkpoint_state(d)
        for k, p in tnet._collect_params_with_prefix().items():
            bits = p._gluon_data().view(torch.int16).numpy()
            got = np.asarray(state["params"][k].asnumpy())
            assert got.dtype.name == "bfloat16"
            np.testing.assert_array_equal(got.view(np.int16), bits)
        back = tckpt.load_checkpoint_state(d)
        for k, p in tnet._collect_params_with_prefix().items():
            t = tckpt._tensor_of(back["params"][k])
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16),
                               p._gluon_data().view(torch.int16))


def _corrupt_one_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 1)
        b = f.read(1)
        f.seek(os.path.getsize(path) - 1)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("sharded", [False, True])
def test_digest_mismatch_and_torn_files_fall_back(sharded, tmp_path):
    tnet, ttrainer = _port_trained(steps=1)
    d = str(tmp_path / "ck")
    ck = tckpt.AsyncCheckpointer(d, save_every=1, keep=3, sharded=sharded)
    for _ in range(3):
        ck.step(tnet, trainer=ttrainer)
    ck.close()
    payload = "params-shard-0.nd" if sharded else "params.nd"
    # step 3: one flipped byte (same size) — only the digest catches it
    _corrupt_one_byte(os.path.join(d, "step-3", payload))
    assert tckpt.latest_valid_step(d) == 2
    assert jckpt.latest_valid_step(d) == 2
    # step 2: truncated
    p2 = os.path.join(d, "step-2", payload)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 2)
    assert tckpt.latest_valid_step(d) == 1
    assert tckpt.load_checkpoint_state(d)["step"] == 1
    # the report tool names both bad steps
    out = subprocess.run([sys.executable, "tools/ckpt_report.py", d,
                          "--json"], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 3
    with pytest.raises(MXNetError, match="missing or corrupt"):
        tckpt.load_checkpoint_state(d, step=3)


@pytest.mark.parametrize("sharded", [False, True])
def test_ckpt_report_passes_on_port_directories(sharded, tmp_path):
    tnet, ttrainer = _port_trained(steps=1)
    d = str(tmp_path / "ck")
    ck = tckpt.AsyncCheckpointer(d, save_every=1, keep=2, sharded=sharded)
    for _ in range(3):
        ck.step(tnet, trainer=ttrainer)
    ck.close()
    assert sorted(os.listdir(d)) == ["latest", "step-2", "step-3"]
    out = subprocess.run([sys.executable, "tools/ckpt_report.py", d,
                          "--json"], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rep = json.loads(out.stdout)
    assert not rep["anomalies"]
    assert sorted(s["step"] for s in rep["steps"]) == [2, 3]


# ---------------------------------------------------------------------------
# the LeNet loop of examples/train_mnist.py, resumed from a checkpoint
# ---------------------------------------------------------------------------
def lenet(gluon):
    net = gluon.nn.HybridSequential(prefix="lenet_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(6, 5, activation="relu", in_channels=1),
                gluon.nn.MaxPool2D(2, 2),
                gluon.nn.Conv2D(8, 3, activation="relu", in_channels=6),
                gluon.nn.MaxPool2D(2, 2), gluon.nn.Flatten(),
                gluon.nn.Dense(32, activation="relu", in_units=32),
                gluon.nn.Dense(10, in_units=32))
    return net


def _mnist(n=96):
    """``synthetic_mnist`` of the example at 16 x 16."""
    rng = np.random.RandomState(0)
    x = np.zeros((n, 1, 16, 16), np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        c = y[i]
        cx, cy = 4 + (c % 4) * 2, 4 + (c // 4) * 3
        x[i, 0, cy - 2:cy + 2, cx - 2:cx + 2] = 1.0
        x[i, 0] += rng.randn(16, 16) * 0.15
    return x, y.astype(np.float32)


def _lenet_run(ckdir, steps, resume=False, stop_at=None):
    """The example's loop (Adam, softmax CE, the metric) over ``steps``
    batches of 16; checkpoints every 3 steps; returns {step: loss}."""
    x, y = _mnist()
    torch.manual_seed(42)
    net = lenet(tgluon)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.hybridize()
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.01})
    start = tckpt.restore(ckdir, net, trainer) if resume else 0
    ck = tckpt.AsyncCheckpointer(ckdir, save_every=3, keep=2)
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    metric = tmx.metric.Accuracy()
    losses = {}
    B = 16
    for s in range(start, steps):
        perm = np.random.RandomState(1000 + s // 6).permutation(len(x))
        idx = perm[(s % 6) * B:(s % 6 + 1) * B]
        data, label = tnd.array(x[idx], ctx=CPU), tnd.array(y[idx], ctx=CPU)
        with tag.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(B)
        metric.update(label, out)
        losses[s + 1] = float(loss.asnumpy().mean())
        ck.step(net, trainer=trainer)
        if stop_at is not None and s + 1 == stop_at:
            break
    ck.close()
    return losses


def test_restore_resumes_the_lenet_loop(tmp_path):
    full = _lenet_run(str(tmp_path / "full"), 12)
    d = str(tmp_path / "resume")
    first = _lenet_run(d, 12, stop_at=7)   # checkpoints at 3 and 6
    assert tckpt.latest_valid_step(d) == 6
    rest = _lenet_run(d, 12, resume=True)
    assert sorted(rest) == list(range(7, 13))
    for s in range(1, 8):
        assert first[s] == full[s]
    for s in rest:
        np.testing.assert_allclose(rest[s], full[s], rtol=1e-6)
    assert full[12] < full[1]
