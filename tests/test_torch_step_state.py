"""The port's ``DataParallelStep`` host state and step checkpoints against
the JAX step's, in one process.

A small MLP with a BatchNorm (whose running stats are Parameters the step
does not train) and a frozen bias is trained for 3 steps from the same
weights (drawn by the JAX package, carried by name) by the JAX
``DataParallelStep`` on a one-device CPU mesh and by the port's step on
the CPU: SGD with momentum, Adam, and Adam with a loss scale whose first
step overflows (so the scaler skips and Adam's ``t`` falls behind the
step count; the backoff then puts the scale far from f32's limit, where
the two packages' sums could round to different sides of it).  Held to
the JAX step:

  * ``state_dict()``: the keys exactly, each value's dtype and shape, the
    integer entries (``t``, ``amp.growth``, ``amp.skipped``) and the scale
    exactly, and every float within ``atol`` 2e-4 (the tolerance
    ``tests/test_torch_training.py`` gives the step: f32 sums in another
    order, moved by the optimizer);
  * ``layout()`` and ``shard_state_dict()["manifest"]`` key for key;
  * a JAX ``state_dict`` loaded into a fresh port step continues within
    the same tolerance of the JAX continuation;
  * a state saved from another optimizer raises, a partly missing slot
    raises, and a state with no slots zeroes them;
  * checkpoints of a step in formats 1 and 2 cross both ways with their
    optimizer slots, bit for bit;
  * a port resume from a step checkpoint continues bit for bit with the
    uninterrupted run; ``sync_to_block`` leaves a Gluon forward equal to
    the step's;
  * SIGTERM under ``install_preemption_handler`` with a step target writes
    a final checkpoint holding the last dispatched step, and exits 83.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu.precision import config as jpc

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DataParallelStep
from mxnet_tpu_torch.precision import config as tpc

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
ATOL = 2e-4
RNG = np.random.RandomState(0)
BATCHES = [(RNG.randn(8, 6).astype(np.float32),
            RNG.randn(8, 3).astype(np.float32)) for _ in range(6)]
CONFIGS = {
    "sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
            None),
    "adam": ("adam", {"learning_rate": 1e-2}, None),
    "adam_scaled": ("adam", {"learning_rate": 1e-2},
                    dict(init_scale=2.0 ** 127, backoff_factor=2.0 ** -64,
                         growth_interval=2)),
}


def _net(gluon, ctx=None):
    net = gluon.nn.HybridSequential(prefix="st_")
    with net.name_scope():
        net.add(gluon.nn.Dense(8, activation="relu", in_units=6),
                gluon.nn.BatchNorm(in_channels=8),
                gluon.nn.Dense(3, in_units=8))
    kw = {"ctx": ctx} if ctx is not None else {}
    net.initialize(**kw)
    return net


_W0 = None


def _start():
    global _W0
    if _W0 is None:
        jmx.random.seed(0)
        net = _net(jgluon)
        net.initialize(jmx.init.Normal(0.5), force_reinit=True)
        _W0 = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    return _W0


def _precision(mod, ls):
    return None if ls is None else mod.PrecisionConfig(
        loss_scale=mod.LossScaleConfig(**ls))


def _jax_step(cfg):
    opt, params, ls = CONFIGS[cfg]
    net = _net(jgluon)
    for k, p in net.collect_params().items():
        p.set_data(_start()[k])
    net.collect_params()["st_dense0_bias"].grad_req = "null"
    return JaxStep(net, jgluon.loss.L2Loss(),
                   mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                   optimizer=opt, optimizer_params=params,
                   precision=_precision(jpc, ls))


def _port_step(cfg, weights=True):
    opt, params, ls = CONFIGS[cfg]
    net = _net(tgluon, CPU)
    if weights:
        for k, p in net.collect_params().items():
            p.set_data(_start()[k])
    net.collect_params()["st_dense0_bias"].grad_req = "null"
    return DataParallelStep(net, tgluon.loss.L2Loss(), optimizer=opt,
                            optimizer_params=params, device=CPU,
                            precision=_precision(tpc, ls))


def _jax_losses(step, batches):
    return [float(np.asarray(step.step(jnd.array(x), jnd.array(y))))
            for x, y in batches]


def _port_losses(step, batches):
    return [float(step.step(x, y)) for x, y in batches]


def _host(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def _assert_states_close(tsd, jsd, exact=False):
    assert tsd["optimizer"] == jsd["optimizer"]
    for section in ("params", "opt_state"):
        assert sorted(tsd[section]) == sorted(jsd[section]), section
        for k, jv in jsd[section].items():
            tv = tsd[section][k]
            assert np.shape(tv) == np.shape(jv), k
            assert str(np.asarray(jv).dtype) == str(_host(tv).dtype), k
            if exact or np.asarray(jv).dtype.kind == "i" \
                    or k == "amp.scale":
                np.testing.assert_array_equal(_host(tv), np.asarray(jv),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(_host(tv), np.asarray(jv),
                                           rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_state_dict_and_layout_match_jax(cfg):
    jstep, tstep = _jax_step(cfg), _port_step(cfg)
    jl = _jax_losses(jstep, BATCHES[:3])
    tl = _port_losses(tstep, BATCHES[:3])
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    jsd, tsd = jstep.state_dict(), tstep.state_dict()
    _assert_states_close(tsd, jsd)
    assert any(k.startswith("running_mean") or "running_mean" in k
               for k in tsd["params"])
    if cfg == "adam_scaled":
        assert int(tsd["opt_state"]["amp.skipped"]) >= 1
        assert int(tsd["opt_state"]["t"]) < tstep.num_update
    assert tstep.layout() == jstep.layout()
    assert tstep.shard_state_dict()["manifest"] == \
        jstep.shard_state_dict()["manifest"]
    assert tstep.snapshot_requires_collective() is \
        jstep.snapshot_requires_collective() is False
    shard = tstep.shard_state_dict()
    assert (shard["rank"], shard["nprocs"], shard["optimizer"]) == \
        (0, 1, jsd["optimizer"])
    for section in ("params", "opt_state"):
        for k, [(j, v)] in shard[section].items():
            assert j == 0
            np.testing.assert_array_equal(_host(v), _host(tsd[section][k]))


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_jax_state_continues_in_the_port(cfg):
    jstep = _jax_step(cfg)
    _jax_losses(jstep, BATCHES[:3])
    jsd = jstep.state_dict()
    tstep = _port_step(cfg, weights=False)
    info = tstep.load_state_dict(jsd, saved_layout=jstep.layout())
    assert info == {"resharded": False, "old_world": 1, "new_world": 1,
                    "n_params": len(jsd["params"])}
    _assert_states_close(tstep.state_dict(), jsd, exact=True)
    jl = _jax_losses(jstep, BATCHES[3:5])
    tl = _port_losses(tstep, BATCHES[3:5])
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    _assert_states_close(tstep.state_dict(), jstep.state_dict())


def test_port_resume_from_state_is_bitwise():
    for cfg in sorted(CONFIGS):
        whole = _port_step(cfg)
        _port_losses(whole, BATCHES[:3])
        saved = whole.state_dict()
        rest = _port_losses(whole, BATCHES[3:])
        fresh = _port_step(cfg, weights=False)
        fresh.load_state_dict(saved, saved_layout=whole.layout())
        assert _port_losses(fresh, BATCHES[3:]) == rest, cfg
        _assert_states_close(fresh.state_dict(), whole.state_dict(),
                             exact=True)


def test_load_state_dict_refuses_mismatches(caplog):
    sgd, adam = _port_step("sgd"), _port_step("adam")
    _port_losses(adam, BATCHES[:1])
    state = adam.state_dict()
    with pytest.raises(MXNetError, match="saved from a 'adam' step"):
        sgd.load_state_dict(state)
    with pytest.raises(MXNetError, match="saved from a 'adam' step"):
        sgd.load_state_dict({"params": state["params"]},
                            saved_layout={"optimizer": "adam"})
    partial = dict(state, opt_state=dict(state["opt_state"]))
    partial["opt_state"].pop(next(k for k in partial["opt_state"]
                                  if k.startswith("var.")))
    with pytest.raises(MXNetError, match="missing slot"):
        _port_step("adam").load_state_dict(partial)
    missing = {"params": dict(state["params"])}
    missing["params"].pop(next(iter(missing["params"])))
    with pytest.raises(MXNetError, match="missing parameter"):
        _port_step("adam").load_state_dict(missing)
    fresh = _port_step("adam", weights=False)
    fresh.load_state_dict({"params": state["params"]})
    assert "FRESH (zeroed)" in caplog.text
    got = fresh.state_dict()
    assert all(not np.any(_host(v)) for k, v in got["opt_state"].items())
    for k, v in state["params"].items():
        np.testing.assert_array_equal(_host(got["params"][k]), _host(v))


def test_sync_to_block_gluon_forward_equals_the_step():
    step = _port_step("adam")
    _port_losses(step, BATCHES[:3])
    step.sync_to_block()
    assert step.inflight_depth == 0
    x = BATCHES[0][0]
    with torch.no_grad():
        step.block.eval()
        want = step.block(torch.from_numpy(x))
    got = step.block(tnd.array(x, ctx=CPU))
    np.testing.assert_array_equal(got.asnumpy(), want.numpy())


def _saved_step(pkg, cfg, root, sharded):
    """3 steps under a checkpointer with ``save_every=3`` in ``pkg``."""
    if pkg == "jax":
        step, ck, run = _jax_step(cfg), jckpt, _jax_losses
    else:
        step, ck, run = _port_step(cfg), tckpt, _port_losses
    ckpt = ck.AsyncCheckpointer(root, save_every=3, keep=1, sharded=sharded)
    for batch in BATCHES[:3]:
        run(step, [batch])
        ckpt.step(step)
    ckpt.close()
    return step


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("cfg", ["sgd", "adam_scaled"])
def test_step_checkpoints_cross_both_ways(tmp_path, cfg, sharded):
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    tstep = _saved_step("torch", cfg, troot, sharded)
    jstep = _saved_step("jax", cfg, jroot, sharded)
    names = sorted(os.listdir(os.path.join(troot, "step-3")))
    assert names == sorted(os.listdir(os.path.join(jroot, "step-3")))
    assert ("opt_state.nd" in names) is not sharded
    jload = _jax_step(cfg)
    assert jckpt.restore(troot, jload) == 3
    _assert_states_close(tstep.state_dict(), jload.state_dict(), exact=True)
    tload = _port_step(cfg, weights=False)
    assert tckpt.restore(jroot, tload) == 3
    _assert_states_close(tload.state_dict(), jstep.state_dict(), exact=True)


@pytest.mark.parametrize("sharded", [False, True])
def test_port_resume_from_checkpoint_is_bitwise(tmp_path, sharded):
    root = str(tmp_path / "ck")
    whole = _saved_step("torch", "adam", root, sharded)
    rest = _port_losses(whole, BATCHES[3:])
    fresh = _port_step("adam", weights=False)
    assert tckpt.restore(root, fresh) == 3
    assert _port_losses(fresh, BATCHES[3:]) == rest
    _assert_states_close(fresh.state_dict(), whole.state_dict(), exact=True)


_WORKER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    sys.path.insert(0, {repo!r})
    os.environ["MX_ASYNC_INFLIGHT"] = "2"
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, fault, gluon
    from mxnet_tpu_torch.parallel import DataParallelStep

    ckdir = sys.argv[1]
    rng = np.random.RandomState(0)
    net = gluon.nn.Dense(1, in_units=4)
    net.initialize(mx.init.Normal(0.5), ctx=mx.cpu())
    step = DataParallelStep(net, gluon.loss.L2Loss(), optimizer="sgd",
                            optimizer_params={{"learning_rate": 0.05}},
                            device="cpu")
    X = rng.randn(8, 4).astype(np.float32)
    Y = rng.randn(8, 1).astype(np.float32)
    ckpt = checkpoint.AsyncCheckpointer(ckdir, save_every=3, keep=3)
    fault.install_preemption_handler(ckpt, step)
    for i in range(12):
        step.step(X, Y)
        ckpt.step(step)
        if i == 9:
            ckpt.wait()
            np.save(os.path.join(ckdir, "w.npy"),
                    net.weight.detach().numpy())
            print("depth", step.inflight_depth, flush=True)
            open(os.path.join(ckdir, "ready"), "w").close()
            while True:
                time.sleep(0.05)
""")


def test_sigterm_on_a_step_writes_its_last_dispatched_step(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=_REPO))
    ckdir = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MX_FAULT_SPEC", "MX_TELEMETRY_DIR",
                        "MX_METRICS_PORT")}
    proc = subprocess.Popen([sys.executable, str(script), str(ckdir)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 240
    while not (ckdir / "ready").exists():
        assert proc.poll() is None, proc.communicate()
        assert time.monotonic() < deadline, "worker never became ready"
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == tfault.EXIT_PREEMPTED, (out, err[-2000:])
    assert "depth 2" in out and "final checkpoint at step 10" in out
    assert tckpt.latest_valid_step(str(ckdir)) == 10
    state = tckpt.load_checkpoint_state(str(ckdir))
    assert state["step"] == 10 and state["layout"]["optimizer"] == "sgd"
    assert sorted(state["opt_state"]) == ["mom.bias", "mom.weight"]
    np.testing.assert_array_equal(state["params"]["weight"].asnumpy(),
                                  np.load(ckdir / "w.npy"))
    jstate = jckpt.load_checkpoint_state(str(ckdir))
    assert jstate["step"] == 10 and sorted(jstate["opt_state"]) == \
        ["mom.bias", "mom.weight"]
