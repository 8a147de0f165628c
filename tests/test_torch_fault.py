"""The port's fault injection and preemption handling against the JAX
package's: the ``MX_FAULT_SPEC`` grammar, a torn write falling back in
both packages' readers, and SIGTERM turning into a final checkpoint and
exit 83 in a CPU subprocess.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import fault as jfault
from mxnet_tpu.base import MXNetError as JaxMXNetError
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.base import MXNetError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    "crash:step=30:rank=1:if-restart=0; slow-write:ms=500;"
    "torn-write:step=20:file=meta",
    "oom:step=3:rank=1",
    "torn-write:step=4:shard=1",
    "crash-rendezvous:rank=2:if-world=3",
    "crash-write:step=6",
    "",
    " ; ",
    # each of these is refused
    "explode:step=1",
    "crash:at=3",
    "crash:step=soon",
    "crash",
    "slow-write:step=3",
    "torn-write:step=3:file=rng",
    "oom",
    "oom:ms=5",
    "crash:step=3:shard=1",
    "crash-rendezvous:step=2",
    "crash:step",
]


def _parsed(mod, err, text):
    try:
        return [repr(f) for f in mod.parse_spec(text)]
    except err as e:
        return ("error", str(e))


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_agrees_with_jax(text):
    got = _parsed(tfault, MXNetError, text)
    want = _parsed(jfault, JaxMXNetError, text)
    assert got == want
    if isinstance(got, tuple):
        assert "MX_FAULT_SPEC" in got[1]


def test_qualifiers_gate_like_jax(monkeypatch):
    monkeypatch.setenv("MX_PROC_ID", "1")
    monkeypatch.setenv("MX_RESTART_COUNT", "0")
    monkeypatch.setenv("MX_NUM_PROCS", "3")
    for text in ("crash:step=3:rank=1", "crash:step=3:rank=0",
                 "crash:step=3:if-restart=1", "crash:step=3:if-world=3",
                 "crash:step=3:if-world=2"):
        t = tfault.parse_spec(text)[0].applies_here()
        j = jfault.parse_spec(text)[0].applies_here()
        assert t == j, text
    assert tfault.EXIT_PREEMPTED == jfault.EXIT_PREEMPTED == 83
    assert tfault.EXIT_INJECTED_CRASH == jfault.EXIT_INJECTED_CRASH


def test_injected_oom_reads_as_resource_exhausted(monkeypatch):
    from mxnet_tpu_torch import memwatch

    monkeypatch.setenv("MX_FAULT_SPEC", "oom:step=2")
    tfault.on_dispatch(1)
    with pytest.raises(MXNetError) as ei:
        tfault.on_dispatch(2)
    assert memwatch.is_resource_exhausted(ei.value)


def _jax_net():
    from mxnet_tpu import gluon

    mx.random.seed(0)
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(mx.init.Normal(0.5))
    return net


def _torch_net():
    from mxnet_tpu_torch import gluon

    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(tmx.init.Normal(0.5), ctx=tmx.cpu())
    return net


def test_torn_write_falls_back_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("MX_FAULT_SPEC", "torn-write:step=2")
    dirs = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    for mod, net, d in ((jckpt, _jax_net(), dirs["jax"]),
                        (tckpt, _torch_net(), dirs["torch"])):
        ck = mod.AsyncCheckpointer(d, save_every=1, keep=3)
        ck.step(net)
        ck.step(net)
        ck.close()
    monkeypatch.delenv("MX_FAULT_SPEC")
    for d in dirs.values():
        # the newest step is torn: each package's reader falls back
        assert os.path.exists(os.path.join(d, "step-2"))
        assert tckpt.latest_valid_step(d) == 1
        assert jckpt.latest_valid_step(d) == 1
        assert tckpt.load_checkpoint_state(d)["step"] == 1
        assert jckpt.load_checkpoint_state(d)["step"] == 1
        with pytest.raises(MXNetError, match="missing or corrupt"):
            tckpt.load_checkpoint_state(d, step=2)


_WORKER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    sys.path.insert(0, {repo!r})
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, checkpoint, fault, gluon, nd

    ckdir = sys.argv[1]
    np.random.seed(0)
    net = gluon.nn.Dense(1, in_units=4)
    net.initialize(mx.init.Normal(0.5), ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {{"learning_rate": 0.05, "momentum": 0.9}})
    loss_fn = gluon.loss.L2Loss()
    X = nd.array(np.random.randn(8, 4), ctx=mx.cpu())
    Y = nd.array(np.random.randn(8, 1), ctx=mx.cpu())
    ckpt = checkpoint.AsyncCheckpointer(ckdir, save_every=3, keep=3)
    fault.install_preemption_handler(ckpt, net, trainer=trainer)
    for i in range(12):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(8)
        ckpt.step(net, trainer=trainer)
        if i == 9:
            ckpt.wait()
            open(os.path.join(ckdir, "ready"), "w").close()
            while True:
                time.sleep(0.05)
""")


def test_sigterm_writes_final_checkpoint_and_exits_83(tmp_path):
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
    assert "final checkpoint at step 10" in out
    # step 10 is not a multiple of save_every=3: only save_now wrote it
    assert tckpt.latest_valid_step(str(ckdir)) == 10
    state = tckpt.load_checkpoint_state(str(ckdir))
    assert state["step"] == 10 and state["trainer"] is not None
    # and the JAX package reads the same directory
    assert jckpt.load_checkpoint_state(str(ckdir))["step"] == 10
