"""BatchNorm over the global batch in the port's step over several
processes, against the JAX step's (whose statistics are the global
batch's: ``tests/test_syncbn.py``).

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py syncbn``)
trains Conv2D(8) + BatchNorm + relu + global pooling + Dense(5) for 2 SGD
steps (lr 0.1, momentum 0.9) on a 16-image NCHW batch whose four blocks
each have their own scale and offset, so per-process statistics would
differ strongly: on dp4 with ``BatchNorm`` and with ``SyncBatchNorm``, and
on dp2 x sp2 (the NCHW batch split over dp x sp).  The JAX side is its
``DataParallelStep`` on ``make_mesh`` dp4 over 4 virtual CPU devices and
on one device with the whole batch, from the same weights.  Losses agree
within 1e-5 relative; every parameter and running mean and variance
within 1e-5 of the largest |JAX| parameter, every momentum within 1e-5
of the largest |JAX| momentum.  The group also trains a plain
torch module with ``torch.nn.BatchNorm2d`` on dp4, against the port's
one-process step on the whole batch; and the autograd function itself is
held against torch's BatchNorm over one process.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import local_mesh, make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOL = 1e-5
PORT_RUNS = ("dp4", "dp4_sync", "dp2sp2")


def _jax_net():
    mx.random.seed(7)
    net = gluon.nn.HybridSequential(prefix="sbn_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(8, 3, padding=1, in_channels=3),
                gluon.nn.BatchNorm(in_channels=8),
                gluon.nn.Activation("relu"), gluon.nn.GlobalAvgPool2D(),
                gluon.nn.Flatten(), gluon.nn.Dense(5, in_units=8))
    net.initialize(mx.init.Xavier())
    return net


def _jax_run(start, devices):
    net = _jax_net()
    for k, p in net.collect_params().items():
        p.set_data(start[k])
    x, y = cases.syncbn_batch()
    mesh = (jax_make_mesh(devices=devices) if len(devices) > 1
            else local_mesh(devices=devices))
    step = JaxStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                   optimizer="sgd",
                   optimizer_params={"learning_rate": cases.SYNCBN_LR,
                                     "momentum": 0.9})
    losses = [float(np.asarray(step.step(nd.array(x), nd.array(y))))
              for _ in range(cases.SYNCBN_STEPS)]
    return np.array(losses), step.state_dict()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("syncbn")
    net = _jax_net()
    net(nd.array(cases.syncbn_batch()[0]))
    start = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    np.savez(out / "syncbn_start.npz", **start)
    wait = cases.start_group(out, 4, "syncbn")
    devs = jax.devices("cpu")
    jax_ref = {"dp4": _jax_run(start, devs[:4]),
               "single": _jax_run(start, devs[:1])}
    torch_one = cases.syncbn_run(cases.torch_bn_net())
    assert wait() == 0
    return dict(np.load(out / "syncbn-0.npz")), jax_ref, torch_one


def _section(got, tag):
    key = f"{tag}:"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


def _close(got, tag, losses, state):
    np.testing.assert_allclose(got[f"{tag}:losses"], losses, rtol=TOL, atol=0)
    mine = _section(got, tag)
    want = {f"{sec}/{k}": np.asarray(v, dtype=np.float64)
            for sec in ("params", "opt_state") for k, v in state[sec].items()}
    mine.pop("losses")
    assert set(mine) == set(want)
    # each section's tensors within TOL of the largest |value| of the
    # section (the conv bias before the BatchNorm has a zero gradient, so
    # its values are rounding noise)
    scale = {sec: max(float(np.abs(v).max()) for k, v in want.items()
                      if k.startswith(sec + "/"))
             for sec in ("params", "opt_state")}
    for k, ref in want.items():
        err = float(np.abs(mine[k] - ref).max())
        assert err <= TOL * scale[k.split("/")[0]], (k, err)


@pytest.mark.parametrize("ref", ["dp4", "single"])
@pytest.mark.parametrize("run", PORT_RUNS)
def test_global_batch_statistics_match_the_jax_step(results, run, ref):
    got, jax_ref, _ = results
    losses, state = jax_ref[ref]
    _close(got, run, losses, state)
    stats = [k for k in state["params"] if "running_" in k]
    assert len(stats) == 2
    # the comparison is not vacuous: the statistics moved from their init
    assert not np.allclose(state["params"][stats[0]], 0.0)


def test_sync_batch_norm_equals_batch_norm(results):
    got = results[0]
    a, b = _section(got, "dp4"), _section(got, "dp4_sync")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_batch_norm_modules_on_dp4(results):
    """``torch.nn.BatchNorm2d`` (running variance unbiased, torch's
    momentum) on dp4 against the port's one-process step."""
    got, _, (losses, state) = results
    _close(got, "torch_bn", losses, state)
    assert {"1.running_mean", "1.running_var"} <= set(state["params"])


@pytest.mark.parametrize("layout", ["NCHW", "NHWC_bf16"])
def test_sync_function_matches_batch_norm_over_one_process(monkeypatch,
                                                           layout):
    """The autograd function over a group of one (its collectives the
    identity): the output, the statistics and every gradient of torch's
    BatchNorm; bf16 NHWC keeps its statistics in f32."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel.sync_batch_norm import sync_batch_norm

    monkeypatch.setattr(tdist, "all_gather_into_tensor",
                        lambda out, t, group=None: out.copy_(t))
    monkeypatch.setattr(tdist, "all_reduce", lambda t, group=None: t)
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(6, 5, 4, 3).astype(np.float32) * 3 + 1)
    w = torch.tensor(rng.rand(5).astype(np.float32) + 0.5)
    b = torch.tensor(rng.randn(5).astype(np.float32))
    dy = torch.tensor(rng.randn(6, 5, 4, 3).astype(np.float32))
    axis, dtype = 1, torch.float32
    if layout == "NHWC_bf16":
        x, dy, axis, dtype = (x.permute(0, 2, 3, 1).contiguous(),
                              dy.permute(0, 2, 3, 1).contiguous(), 3,
                              torch.bfloat16)
    leaves = [x.to(dtype).clone().requires_grad_(), w.clone().requires_grad_(),
              b.clone().requires_grad_()]
    out, mean, var, count = sync_batch_norm(*leaves, 1e-5, axis,
                                            (None, 1))
    out.backward(dy.to(dtype))
    ref_leaves = [x.double().requires_grad_(), w.double().requires_grad_(),
                  b.double().requires_grad_()]
    xr = ref_leaves[0].movedim(axis, 1)
    ref = torch.nn.functional.batch_norm(xr, None, None, ref_leaves[1],
                                         ref_leaves[2], True, 0.0, 1e-5)
    ref.movedim(1, axis).backward(dy.double())
    dims = [d for d in range(4) if d != axis]
    xd = leaves[0].detach().double()
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), xd.mean(dims).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), xd.var(dims, unbiased=False)
                               .numpy(), rtol=1e-5, atol=1e-6)
    assert float(count[0]) == x.numel() / 5
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.detach().double().numpy(),
                               ref.movedim(1, axis).detach().numpy(),
                               rtol=tol, atol=tol)
    for got, want in zip(leaves, ref_leaves):
        np.testing.assert_allclose(got.grad.double().numpy(),
                                   want.grad.numpy(), rtol=tol,
                                   atol=tol * float(want.grad.abs().max()))
