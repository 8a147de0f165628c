"""bf16 training in the port vs the JAX package's ``DataParallelStep``, as
``bench.py`` runs it: the net cast to bf16 (``gluon.block.cast`` against
``Block.cast``), bf16 inputs, and the update in f32 rounded once a step.

- A narrow ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128,
  256], classes=10, stride_in_1x1=False)`` takes 3 SGD steps (lr 0.1,
  momentum 0.9, wd 1e-4, ``bench.py:781``) on 16 seeded images of 32 x
  32, from the JAX net's ``mx.init.Xavier()`` weights carried by name:
  in f32 NCHW and in bf16 NHWC.  Batch 16, so that the last stage's
  BatchNorm normalizes over 16 values a channel: at batch 4 (4 values)
  the port's own f32 trajectory leaves its float64 one by 1e-3 of the
  loss within 3 steps, and no f32 tolerance could separate the two
  packages from that.
- ``bert_small(dropout=0.0)`` cast to bf16 takes 3 Adam steps (lr 1e-3)
  against the JAX step.
- Each bf16 check is shown to fail a planted fault: a ResNet step that
  never updates, a BERT step that leaves every other parameter where it
  was.
- The 16-bit update rule against ``_sgd_tree_update`` and
  ``_adam_tree_update`` on the same bf16 weights and gradients: exact,
  both compute in f32 and round once.
- The bf16 carry of ``convert``: bit for bit.
- ``SoftmaxCrossEntropyLoss`` on bf16 logits against the JAX loss.

f32 ResNet: the port runs its own 3 steps; losses rtol 1e-4 and
parameters atol 2e-3 after 3 steps (sums in another order; the three
updates amplify the gradients' differences).

bf16 ResNet.  This net's bf16 gradient is far from its f32 one in both
packages: from the same bf16 weights, the JAX step's bf16 momentum after
one step (its f32 update, -lr g) is 30% of its norm (median over the
tensors; up to 53%) away from the JAX step's f32 one, and the port's
bf16 and f32 steps differ as much (the rounding of each bf16 forward and
backward operation, grown through the BatchNorm backward).  At lr 0.1
that sends two bf16 runs apart within one step: free-running, the
losses of step 3 differ by 40%, and no bound on a free run could tell a
wrong step from a right one.  So each of the 3 steps starts from the
JAX step's own state before it (weights, running stats, momenta; the
JAX trajectory is run once), and the port's step is held to the JAX
step's outcome:

- the loss (a forward of the same bf16 weights) within 2^-6 relative
  (four bf16 units; the packages round in other places, XLA's bf16
  convolution against torch's, BatchNorm's output rounded after each
  of four operations in JAX and once here);
- the momenta: the port's distance from the JAX step's, summed in
  squares over the tensors, within 2x the distance of the port's f32
  step from the same state (two roundings of the same size differ by
  about sqrt(2) times one; 0.95x-1.04x on a CPU), and each
  tensor's within 3x (up to 2.6x on a CPU);
- each weight element within its momentum's distance plus one bf16
  spacing at its value (both round w + m to bf16 once);
- each running stat within 8 bf16 units at its tensor's scale.

A step that never updates is 3.2x-4.5x off in the summed momenta.

bf16 BERT (Adam's first steps move each weight by about lr, the sign of
its gradient, so the runs stay together): losses within 2^-6 relative
and falling; each tensor that the JAX step moved lies within a quarter
of the JAX step's movement of it (up to 9% on a CPU: the sign of a
gradient near 0 is rounding's), and each it left (LayerNorm's gamma at
1, whose Adam update is below half a bf16 unit there; the pooler, which
the loss does not reach) stays exactly.  A step that leaves every other
parameter is 100% off in those.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon, nd
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JaxBottleneck
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1 as JaxResNetV1
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu.parallel import DataParallelStep as JaxDataParallelStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu.parallel.data_parallel import (_adam_tree_update,
                                              _sgd_tree_update)
from mxnet_tpu_torch.base import tensor_from_numpy
from mxnet_tpu_torch.convert import (from_gluon_layout, from_mxnet_tpu_params,
                                     gluon_name)
from mxnet_tpu_torch.gluon.block import cast
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models.bert import bert_small
from mxnet_tpu_torch.models.resnet import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import DataParallelStep

BF16_UNIT = 2.0 ** -8  # half the spacing of bf16 values in [1, 2)
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, stride_in_1x1=False)
BATCH, RES = 16, 32


def _mesh():
    return local_mesh(devices=[jax.devices("cpu")[0]])


def _images(layout):
    shape = ((BATCH, 3, RES, RES) if layout == "NCHW"
             else (BATCH, RES, RES, 3))
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 10, BATCH).astype(np.float32)
    return x, y


def _jax_resnet(layout, dtype):
    mx.random.seed(0)
    np.random.seed(0)
    net = JaxResNetV1(JaxBottleneck, layout=layout, **NARROW)
    net.initialize(mx.init.Xavier())
    with jautograd.pause():
        net(nd.zeros((1, 3, RES, RES) if layout == "NCHW"
                     else (1, RES, RES, 3)))
    if dtype == "bfloat16":
        net.cast("bfloat16")
    return net


def _port_resnet(layout, dtype, start, prefix):
    net = ResNetV1(BottleneckV1, layout=layout, device="cpu", **NARROW)
    if dtype == "bfloat16":
        cast(net, "bfloat16")
    from_mxnet_tpu_params(net, start, prefix)
    return net


def _by_gluon_name(net, prefix, layout):
    """The port's state in the JAX package's names and layouts, as f32
    numpy."""
    out = {}
    for k, v in net.state_dict().items():
        v = v.float()
        if layout == "NHWC" and v.dim() == 4:
            v = v.permute(0, 2, 3, 1)
        out[prefix + gluon_name(net, k)] = v.numpy()
    return out


def _jax_trajectory(layout, dtype, steps=3):
    """The JAX step's losses, and its state before every step and after
    the last: (params, momenta), numpy, by Gluon name."""
    jnet = _jax_resnet(layout, dtype)
    x, y = _images(layout)
    xj = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    jstep = JaxDataParallelStep(
        jnet, gluon.loss.SoftmaxCrossEntropyLoss(), mesh=_mesh(),
        optimizer="sgd", optimizer_params=SGD)
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    states = [(params, {k: np.zeros(v.shape, np.float32)
                        for k, v in params.items()})]
    losses = []
    for _ in range(steps):
        losses.append(float(np.asarray(
            jstep.step(nd.array(xj, dtype=xj.dtype), nd.array(y)))))
        states.append(({k: np.array(v) for k, v in jstep.params.items()},
                       {k: np.array(v) for k, v in jstep.opt_state.items()}))
    return jnet.prefix, xj, y, losses, states


_TRAJECTORIES = {}


def _trajectory(layout, dtype):
    """:func:`_jax_trajectory`, once per module (the frozen-step test
    replays the bf16 one)."""
    if (layout, dtype) not in _TRAJECTORIES:
        _TRAJECTORIES[layout, dtype] = _jax_trajectory(layout, dtype)
    return _TRAJECTORIES[layout, dtype]


def _port_state(net, step, prefix, layout):
    """The port's parameters, running stats and momenta in the JAX
    package's names and layouts, as f32 numpy."""
    params = _by_gluon_name(net, prefix, layout)
    keys = {id(p): k for k, p in net.named_parameters()}
    moms = {}
    for p, m in zip(step.params, step.opt_state[0]):
        m = m.detach()
        if layout == "NHWC" and m.dim() == 4:
            m = m.permute(0, 2, 3, 1)
        moms[prefix + gluon_name(net, keys[id(p)])] = m.numpy().copy()
    return params, moms


def _set_port_state(net, step, prefix, params, moms):
    """Load a JAX (params, momenta) state into the port's net and step."""
    from_mxnet_tpu_params(net, params, prefix)
    keys = {id(p): k for k, p in net.named_parameters()}
    with torch.no_grad():
        for p, m in zip(step.params, step.opt_state[0]):
            key = keys[id(p)]
            m.copy_(from_gluon_layout(net, key, torch.from_numpy(
                moms[prefix + gluon_name(net, key)])))


def _bf16_ulp(x):
    """The spacing of bf16 values at each element of ``x`` (f32)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _port_replay(layout, dtype, traj, frozen=False):
    """The port's step from each of the JAX step's states in turn: the
    losses, and the state after each step (``frozen`` skips the
    update, the fault the bf16 checks must catch)."""
    prefix, xj, y, _, states = traj
    net = _port_resnet(layout, dtype, states[0][0], prefix)
    step = DataParallelStep(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                            optimizer_params=SGD, device="cpu")
    if frozen:
        step._update = lambda grads: None
    x = tensor_from_numpy(xj).to(getattr(torch, dtype))
    losses, after = [], []
    for params, moms in states[:-1]:
        _set_port_state(net, step, prefix, params, moms)
        losses.append(float(step.step(x, torch.from_numpy(y))))
        after.append(_port_state(net, step, prefix, layout))
    return losses, after


def _bf16_step_faults(traj, port, probe):
    """What the bf16 checks find wrong in the port's ``port`` replay of
    the JAX trajectory, with ``probe`` the f32 replay from the same bf16
    states (see the module's docstring); an empty list when it holds."""
    _, _, _, jlosses, states = traj
    faults = []
    for k, (tloss, (tparams, tmoms), (_, fmoms)) in enumerate(
            zip(port[0], port[1], probe[1])):
        jparams, jmoms = states[k + 1]
        if not abs(tloss - jlosses[k]) <= 2.0 ** -6 * abs(jlosses[k]):
            faults.append(f"step {k + 1} loss {tloss} vs {jlosses[k]}")
        off = floor = 0.0
        for name, m in tmoms.items():
            want = jmoms[name]
            d, f = np.linalg.norm(m - want), np.linalg.norm(fmoms[name] - want)
            off, floor = off + d * d, floor + f * f
            if not d <= 3 * f:
                faults.append(f"step {k + 1} momentum {name}: {d} vs the "
                              f"f32 step's {f}")
            w, jw = tparams[name], jparams[name].astype(np.float32)
            allow = (np.abs(m - want) + _bf16_ulp(np.maximum(np.abs(w),
                                                             np.abs(jw)))
                     + 2.0 ** -23 * np.abs(jw))
            if not np.all(np.abs(w - jw) <= allow):
                faults.append(f"step {k + 1} weight {name}")
        if not off <= 4 * floor:
            faults.append(f"step {k + 1} momenta: {off ** 0.5} vs the f32 "
                          f"step's {floor ** 0.5}")
        for name, want in jparams.items():
            if name.endswith(("running_mean", "running_var")):
                want = want.astype(np.float32)
                scale = float(np.abs(want).max())
                if not (np.abs(tparams[name] - want).max()
                        <= 8 * BF16_UNIT * scale):
                    faults.append(f"step {k + 1} {name}")
    return faults


@pytest.mark.parametrize("layout,dtype", [("NCHW", "float32"),
                                          ("NHWC", "bfloat16")])
def test_resnet_sgd_steps_match_jax(layout, dtype):
    traj = _trajectory(layout, dtype)
    prefix, xj, y, jlosses, states = traj
    if dtype == "bfloat16":
        probe = _port_replay(layout, "float32", traj)
        port = _port_replay(layout, dtype, traj)
        assert all(np.isfinite(jlosses + port[0]))
        assert _bf16_step_faults(traj, port, probe) == []
        return
    # f32: three steps of the port's own, from the same start
    tnet = _port_resnet(layout, dtype, states[0][0], prefix)
    tstep = DataParallelStep(tnet, SoftmaxCrossEntropyLoss(),
                             optimizer="sgd", optimizer_params=SGD,
                             device="cpu")
    tlosses = [float(tstep.step(xj, y)) for _ in range(3)]
    assert all(np.isfinite(jlosses + tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    final = _by_gluon_name(tnet, prefix, layout)
    assert set(final) == set(states[-1][0])
    for name, value in final.items():
        np.testing.assert_allclose(value, states[-1][0][name], rtol=0,
                                   atol=2e-3, err_msg=name)


def test_resnet_bf16_checks_catch_a_frozen_step():
    """The bf16 checks of ``test_resnet_sgd_steps_match_jax`` fail a
    port step that computes the loss and never updates."""
    traj = _trajectory("NHWC", "bfloat16")
    probe = _port_replay("NHWC", "float32", traj)
    frozen = _port_replay("NHWC", "bfloat16", traj, frozen=True)
    faults = _bf16_step_faults(traj, frozen, probe)
    for k in (1, 2, 3):
        assert any(f.startswith(f"step {k} momenta") for f in faults)


BERT_TOKENS = np.random.RandomState(0).randint(0, 512, (4, 16)).astype(
    np.int32)
ADAM = {"learning_rate": 1e-3}
_BERT = {}


def _bert_jax():
    """``bert_small`` cast to bf16: its Gluon prefix, its start and the
    JAX step's losses and parameters after 3 Adam steps (once per
    module)."""
    if not _BERT:
        mx.random.seed(0)
        np.random.seed(0)
        jnet = jax_bert_small(dropout=0.0)
        jnet.initialize(mx.init.Normal(0.02))
        jnet(nd.array(BERT_TOKENS, dtype="int32"))
        jnet.cast("bfloat16")
        start = {k: p.data().asnumpy()
                 for k, p in jnet.collect_params().items()}
        assert all(v.dtype.name == "bfloat16" for v in start.values())
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        jstep = JaxDataParallelStep(
            jnet, lambda lg, lb: loss_fn(lg.reshape(-1, lg.shape[-1]),
                                         lb.reshape(-1)),
            mesh=_mesh(), optimizer="adam", optimizer_params=ADAM)
        losses = [float(np.asarray(jstep.step(
            nd.array(BERT_TOKENS, dtype="int32"),
            nd.array(BERT_TOKENS.astype(np.float32))))) for _ in range(3)]
        _BERT.update(prefix=jnet.prefix, start=start, losses=losses,
                     final={k: np.asarray(v).astype(np.float32)
                            for k, v in jstep.params.items()})
    return _BERT


def _bert_port(stuck_half=False):
    """The port's 3 Adam steps from the JAX start: losses and final
    parameters (``stuck_half`` puts every other parameter back after
    each update, the fault the checks must catch)."""
    jax_run = _bert_jax()
    tnet = cast(bert_small(dropout=0.0, device="cpu"), "bfloat16")
    from_mxnet_tpu_params(tnet, jax_run["start"], jax_run["prefix"])
    tloss = SoftmaxCrossEntropyLoss()
    tstep = DataParallelStep(
        tnet, lambda lg, lb: tloss(lg.reshape(-1, lg.shape[-1]),
                                   lb.reshape(-1)),
        optimizer="adam", optimizer_params=ADAM, device="cpu")
    if stuck_half:
        update = tstep._update

        def _update(grads):
            kept = [p.detach().clone() for p in tstep.params[1::2]]
            update(grads)
            for p, k in zip(tstep.params[1::2], kept):
                p.copy_(k)
        tstep._update = _update
    losses = [float(tstep.step(BERT_TOKENS, BERT_TOKENS.astype(np.float32)))
              for _ in range(3)]
    assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
    return losses, _by_gluon_name(tnet, jax_run["prefix"], "NCHW")


def _bert_faults(losses, final):
    """What the checks find wrong in the port's 3 Adam steps (see the
    module's docstring); an empty list when they hold."""
    jax_run = _bert_jax()
    faults = []
    if not all(np.isfinite(losses + jax_run["losses"])):
        faults.append("a loss is not finite")
    if not np.allclose(losses, jax_run["losses"], rtol=2.0 ** -6, atol=0):
        faults.append(f"losses {losses} vs {jax_run['losses']}")
    if not losses[-1] < losses[0]:
        faults.append("the loss did not fall")
    for name, value in final.items():
        want = jax_run["final"][name]
        moved = np.linalg.norm(want - jax_run["start"][name].astype(
            np.float32))
        off = np.linalg.norm(value - want)
        if not (off <= 0.25 * moved if moved > 0 else off == 0):
            faults.append(f"{name}: {off} off, the JAX step moved it "
                          f"{moved}")
    return faults


def test_bert_small_bf16_adam_steps_match_jax():
    assert all(np.isfinite(_bert_jax()["losses"]))
    assert _bert_jax()["losses"][-1] < _bert_jax()["losses"][0]
    assert _bert_faults(*_bert_port()) == []


def test_bert_bf16_checks_catch_half_the_parameters_stuck():
    """The checks of ``test_bert_small_bf16_adam_steps_match_jax`` fail a
    step that leaves every other parameter where it was."""
    faults = _bert_faults(*_bert_port(stuck_half=True))
    stuck = [f for f in faults if " off, the JAX step moved it " in f]
    assert len(stuck) >= 20


def _bf16_tree(seed, shapes):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(ml_dtypes.bfloat16)
            for n, s in shapes.items()}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_16bit_update_rule_matches_the_jax_tree_updates(optimizer):
    """One step from the same bf16 weights and gradients (and momentum /
    moments carried from a first step) gives the JAX update's bits: the
    terms in f32, the weight rounded once."""
    import jax.numpy as jnp

    shapes = {"a_weight": (7, 5), "b_bias": (5,), "c_gamma": (3, 2, 4)}
    params = _bf16_tree(0, shapes)
    grads = [_bf16_tree(s, shapes) for s in (1, 2)]
    hp = dict(learning_rate=0.05, momentum=0.9, wd=1e-2, rescale_grad=0.5,
              clip_gradient=1.5, beta1=0.8, beta2=0.95, epsilon=1e-6)
    # the JAX trees
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    zeros = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    state = (zeros,) if optimizer == "sgd" else (zeros, dict(zeros), 0)
    for g in grads:
        jg = {n: jnp.asarray(v) for n, v in g.items()}
        if optimizer == "sgd":
            jp, mom = _sgd_tree_update(jp, jg, state[0], hp["learning_rate"],
                                       hp["momentum"], hp["wd"],
                                       hp["rescale_grad"], {},
                                       hp["clip_gradient"])
            state = (mom,)
        else:
            jp, state = _adam_tree_update(
                jp, jg, state, hp["learning_rate"], hp["beta1"],
                hp["beta2"], hp["epsilon"], hp["wd"], hp["rescale_grad"], {},
                hp["clip_gradient"])
    # the port's step, fed the same gradients through a module
    module = torch.nn.Module()
    for n, v in params.items():
        module.register_parameter(n, torch.nn.Parameter(
            tensor_from_numpy(v)))
    step = DataParallelStep(module, None, optimizer=optimizer,
                            optimizer_params=hp, device="cpu")
    for g in grads:
        with torch.no_grad():
            step._update([tensor_from_numpy(g[n]) for n in shapes])
        step.num_update += 1
    for n, p in module.named_parameters():
        assert p.dtype == torch.bfloat16
        want = tensor_from_numpy(np.asarray(jp[n]))
        assert torch.equal(p.detach(), want), n


def test_bf16_carry_is_bit_exact():
    """``net.cast("bfloat16")`` leaves ml_dtypes bfloat16 arrays; the port
    reads them through their bits, into bf16 tensors and, upcast
    exactly, into f32 ones."""
    raw = np.random.RandomState(3).randn(6, 9).astype(np.float32)
    raw[0, :4] = [0.0, -0.0, np.inf, 1e-40]  # signed zero, inf, subnormal
    b = raw.astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(b)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), b.view(np.int16))
    mx.random.seed(0)
    np.random.seed(0)
    jnet = jax_bert_small(dropout=0.0)
    jnet.initialize(mx.init.Normal(0.02))
    jnet(nd.array(np.zeros((1, 4), np.int32), dtype="int32"))
    jnet.cast("bfloat16")
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for dtype in ("bfloat16", "float32"):
        net = bert_small(dropout=0.0, device="cpu")
        if dtype == "bfloat16":
            cast(net, dtype)
        from_mxnet_tpu_params(net, params, jnet.prefix)
        for k, v in net.state_dict().items():
            want = params[jnet.prefix + gluon_name(net, k)]
            got = v.to(torch.bfloat16).view(torch.int16).numpy()
            assert v.dtype == getattr(torch, dtype)
            assert np.array_equal(got, want.view(np.int16)), k


def test_softmax_cross_entropy_loss_on_bf16_logits_matches_jax():
    """The JAX loss takes log_softmax in the logits' dtype; the port
    rounds at the same places: bit for bit on these logits."""
    logits = (np.random.RandomState(4).randn(32, 50) * 4).astype(
        ml_dtypes.bfloat16)
    labels = np.random.RandomState(5).randint(0, 50, 32).astype(np.float32)
    want = np.asarray(gluon.loss.SoftmaxCrossEntropyLoss()(
        nd.array(logits, dtype=logits.dtype), nd.array(labels))._data)
    got = SoftmaxCrossEntropyLoss()(tensor_from_numpy(logits),
                                    torch.from_numpy(labels))
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
