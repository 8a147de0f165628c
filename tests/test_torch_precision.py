"""The port's precision subsystem against the JAX package's, case for case
with tests/test_precision.py: the cast policy at the op call sites and the
registry, the config and its env surface, the AMP training step and
dynamic loss scaling in ``DataParallelStep``.

Inputs are drawn with numpy from fixed seeds and weights are carried by
Gluon name (``convert.from_mxnet_tpu_params``); dropout is off.  Both
packages run in this process on the CPU, the JAX step on a one-device CPU
mesh.  Tolerances, stated before the first run:

  * ``cast_inputs``: the same dtype per op class, input dtype and policy;
    configs, signatures, JSON and ``from_env`` results: equal;
  * bf16 AMP BERT (2 layers, units 64, 2 heads), 3 steps: losses within
    rtol 1e-2 of the JAX AMP step's (bf16 keeps 8 bits, 2^-8 = 3.9e-3 per
    rounding); parameters within atol 2e-3 after SGD (lr 0.1, momentum
    0.9) and within atol 6e-3 = 2 * lr * steps after Adam (lr 1e-3: each
    Adam step moves an element by at most about lr, so two runs whose
    rounding differs part by at most that), and Adam's mean absolute
    parameter difference within 2e-4;
  * intermediate dtypes (every Gluon block's output under the policy):
    equal to the JAX package's, block by block;
  * AMP off: bit for bit the f32 step (losses and parameters);
  * fp16 with dynamic scaling: losses finite and falling, no skip, and
    within atol 2e-2 of the JAX fp16 step's (fp16 keeps 11 bits);
  * a non-finite step: parameters, optimizer state, Adam's ``t`` and
    BatchNorm's running stats held bit for bit; the (scale, growth,
    skipped) trajectory EQUAL to the JAX step's, step by step;
  * a static scale: never moves, still skips (trajectory equal to JAX's);
  * scaling with ``clip_global_norm``: losses within rtol 2e-6 and
    parameters within rtol 2e-5, atol 1e-7 of the unscaled step (the JAX
    test's bounds);
  * the overflow flag: a 0-d device bool tensor, True exactly when some
    element is infinite or NaN.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu.precision import AmpPolicy as JAmp
from mxnet_tpu.precision import LossScaleConfig as JLS
from mxnet_tpu.precision import PrecisionConfig as JPC
from mxnet_tpu.precision import amp_scope as jamp_scope
from mxnet_tpu.precision import runtime as jrt
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models.bert import bert_small
from mxnet_tpu_torch.parallel import DataParallelStep
from mxnet_tpu_torch.precision import (DEFAULT_LOW_OPS, DEFAULT_WIDEN_OPS,
                                       AmpPolicy, LossScaleConfig,
                                       PrecisionConfig, amp_scope,
                                       loss_scale)
from mxnet_tpu_torch.precision import runtime

CPU = tmx.cpu()
TOKENS = np.random.RandomState(0).randint(0, 512, (4, 16)).astype(np.int32)
LS = dict(init_scale=16.0, growth_interval=4)


def _name(dt):
    """A dtype's name in either package."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return dt if isinstance(dt, str) else np.dtype(dt).name


# ---------------------------------------------------------------------------
# the cast policy
# ---------------------------------------------------------------------------
_IN = {"float32": (np.float32, torch.float32),
       "bfloat16": ("bfloat16", torch.bfloat16),
       "float16": (np.float16, torch.float16),
       "int32": (np.int32, torch.int32)}


@pytest.mark.parametrize("policy_dtype", ["bfloat16", "float16"])
def test_cast_inputs_same_dtypes_per_op_class(policy_dtype):
    ops = DEFAULT_LOW_OPS + DEFAULT_WIDEN_OPS + ("Activation",
                                                  "elemwise_add")
    from mxnet_tpu.precision import config as jconfig

    assert (DEFAULT_LOW_OPS, DEFAULT_WIDEN_OPS) == (
        jconfig.DEFAULT_LOW_OPS, jconfig.DEFAULT_WIDEN_OPS)
    got, want = {}, {}
    with amp_scope(AmpPolicy(dtype=policy_dtype)):
        for op in ops:
            for name, (_jdt, tdt) in _IN.items():
                t = torch.ones(2, 2, dtype=tdt)
                got[op, name] = _name(runtime.cast_inputs(op, t)[0].dtype)
    with jamp_scope(JAmp(dtype=policy_dtype)):
        for op in ops:
            for name, (jdt, _tdt) in _IN.items():
                a = jnd.array(np.ones((2, 2), np.float32), dtype=jdt)
                want[op, name] = _name(jrt.cast_inputs(op, [a])[0].dtype)
    assert got == want
    assert got["FullyConnected", "float32"] == policy_dtype
    assert got["LayerNorm", policy_dtype] == "float32"
    # no policy: the same tensors back, one global read
    t = torch.ones(1)
    assert runtime.cast_inputs("FullyConnected", t)[0] is t
    assert not runtime.amp_active()


def test_nd_dispatch_follows_the_policy():
    a = np.ones((4, 4), np.float32)
    out = {}
    for tag, ndm, scope, pol, kw in (
            ("torch", nd, amp_scope, AmpPolicy, {"ctx": CPU}),
            ("jax", jnd, jamp_scope, JAmp, {})):
        x = ndm.array(a, **kw)
        with scope(pol()):
            low = ndm.FullyConnected(x, x, num_hidden=4, no_bias=True)
            wide = low.softmax(axis=-1)
        off = ndm.FullyConnected(x, x, num_hidden=4, no_bias=True)
        out[tag] = [_name(v.dtype) for v in (low, wide, off)]
    assert out["torch"] == out["jax"] == ["bfloat16", "float32", "float32"]


def test_policy_validation_and_config_json():
    with pytest.raises(MXNetError, match="ONE disposition"):
        AmpPolicy(low=("dot",), widen=("dot",))
    with pytest.raises(MXNetError, match="dtype"):
        AmpPolicy(dtype="int8")
    pol = AmpPolicy(low=("dot",), widen=())
    assert pol.op_class("dot") == "low"
    assert pol.op_class("FullyConnected") is None
    for bad in (dict(init_scale=0), dict(growth_factor=1.0),
                dict(backoff_factor=1.0), dict(growth_interval=0)):
        with pytest.raises(MXNetError):
            LossScaleConfig(**bad)
    cfg = PrecisionConfig(amp=AmpPolicy(), loss_scale=LossScaleConfig(**LS))
    jcfg = JPC(amp=JAmp(), loss_scale=JLS(**LS))
    assert cfg.signature() == jcfg.signature()
    assert cfg.to_json() == jcfg.to_json()
    assert PrecisionConfig.from_json(jcfg.to_json()) == cfg
    assert PrecisionConfig.from_json(None) is None


ENVS = [{}, {"MX_AMP": "bf16"}, {"MX_AMP": "1"}, {"MX_AMP": "fp16"},
        {"MX_AMP": "float16", "MX_LOSS_SCALE": "128.0"},
        {"MX_AMP": "fp16", "MX_LOSS_SCALE": "off"},
        {"MX_AMP": "bf16", "MX_LOSS_SCALE": "dynamic"},
        {"MX_AMP": "bf16", "MX_AMP_POLICY": '{"low": ["dot"], "widen": []}'},
        {"MX_AMP": "0"}, {"MX_AMP": "int4"},
        {"MX_AMP": "bf16", "MX_AMP_POLICY": "{not json"},
        {"MX_AMP": "fp16", "MX_LOSS_SCALE": "lots"}]


@pytest.mark.parametrize("environ", ENVS)
def test_from_env_equals_jax(environ):
    def parse(cls):
        try:
            cfg = cls.from_env(environ)
        except Exception as e:  # noqa: BLE001 - both must raise alike
            return ("raises", type(e).__name__)
        return None if cfg is None else cfg.to_json()

    assert parse(PrecisionConfig) == parse(JPC)


# ---------------------------------------------------------------------------
# the AMP step on BERT
# ---------------------------------------------------------------------------
def _jax_bert():
    mx.random.seed(0)
    np.random.seed(0)
    net = jax_bert_small(dropout=0.0, num_heads=2)
    net.initialize(mx.init.Normal(0.02))
    net(jnd.array(TOKENS, dtype="int32"))  # resolves deferred init
    return net


def _port_bert(jnet):
    tnet = bert_small(dropout=0.0, num_heads=2, device="cpu")
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, jnet.prefix)
    return tnet


def _mlm(loss_cls):
    loss_fn = loss_cls()
    return lambda lo, la: loss_fn(lo.reshape(-1, lo.shape[-1]),
                                  la.reshape(-1))


def _bert_runs(optimizer, params, steps, tprec, jprec):
    jnet = _jax_bert()
    tnet = _port_bert(jnet)
    jstep = JaxStep(jnet, _mlm(jgluon.loss.SoftmaxCrossEntropyLoss),
                    mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                    optimizer=optimizer, optimizer_params=params,
                    precision=jprec)
    jl = [float(np.asarray(jstep.step(jnd.array(TOKENS, dtype="int32"),
                                      jnd.array(TOKENS.astype(np.float32)))))
          for _ in range(steps)]
    tstep = DataParallelStep(tnet, _mlm(SoftmaxCrossEntropyLoss),
                             optimizer=optimizer, optimizer_params=params,
                             device="cpu", precision=tprec)
    tl = [float(tstep.step(TOKENS, TOKENS.astype(np.float32)))
          for _ in range(steps)]
    final = {jnet.prefix + gluon_name(tnet, k): v.numpy()
             for k, v in tnet.state_dict().items()}
    jfinal = {k: np.asarray(v) for k, v in jstep.params.items()}
    return tl, jl, final, jfinal, tnet


@pytest.mark.parametrize("optimizer,params,atol", [
    ("adam", {"learning_rate": 1e-3}, 6e-3),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2e-3),
])
def test_amp_bf16_bert_step_matches_jax(optimizer, params, atol):
    tl, jl, final, jfinal, tnet = _bert_runs(
        optimizer, params, 3, PrecisionConfig(amp=AmpPolicy()),
        JPC(amp=JAmp()))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert tl[-1] < tl[0]
    assert set(final) == set(jfinal)
    diffs = []
    for name, value in final.items():
        assert value.dtype == np.float32, name  # f32 masters
        np.testing.assert_allclose(value, jfinal[name], rtol=0, atol=atol,
                                   err_msg=name)
        diffs.append(np.abs(value - jfinal[name]).ravel())
    if optimizer == "adam":
        assert float(np.concatenate(diffs).mean()) <= 2e-4


def _block_dtypes(net, jax_side):
    """{Gluon block name without the net's prefix (each package counts its
    own name scopes): dtype of the block's (first) output} over one
    forward under the bf16 policy."""
    seen = {}
    cut = len(net.prefix)

    def hook(block, _args, out):
        first = out[0] if isinstance(out, (tuple, list)) else out
        seen[block.name[cut:]] = _name(first.dtype)

    if jax_side:
        stack = [net]
        while stack:
            b = stack.pop()
            b.register_forward_hook(hook)
            stack.extend(b._children.values())
        with jamp_scope(JAmp()):
            net(jnd.array(TOKENS, dtype="int32"))
    else:
        handles = [m.register_forward_hook(hook) for m in net.modules()
                   if hasattr(m, "_reg_params")]
        with amp_scope(AmpPolicy()), torch.no_grad():
            net(torch.from_numpy(TOKENS))
        for h in handles:
            h.remove()
    return seen


@pytest.fixture(scope="module")
def bert_pair():
    jnet = _jax_bert()
    return jnet, _port_bert(jnet)


def test_amp_intermediate_dtypes_equal_jax(bert_pair):
    jnet, tnet = bert_pair
    got = _block_dtypes(tnet, False)
    want = _block_dtypes(jnet, True)
    common = set(got) & set(want)
    assert len(common) >= 20, sorted(common)
    assert {n: got[n] for n in common} == {n: want[n] for n in common}
    assert got["bert_encoder_layer0_attn_qkv"] == "bfloat16"
    assert got["bert_encoder_layer0_ln1"] == "float32"
    assert got["decoder"] == "bfloat16"


def test_a_missed_cast_site_shows_in_the_dtypes(bert_pair, monkeypatch):
    """A planted fault: LayerNorm's call site skips the policy (its
    widen); the comparison above then fails."""
    from mxnet_tpu_torch.gluon.nn import basic_layers

    class NoCasts:
        cast_inputs = staticmethod(
            lambda op, *t: t if op == "LayerNorm"
            else runtime.cast_inputs(op, *t))
        quant_entry = staticmethod(runtime.quant_entry)

    jnet, tnet = bert_pair
    monkeypatch.setattr(basic_layers, "_prec", NoCasts)
    got = _block_dtypes(tnet, False)
    want = _block_dtypes(jnet, True)
    assert {n: got[n] for n in want if n in got} != {
        n: want[n] for n in want if n in got}


def test_amp_off_is_bitwise_f32(monkeypatch):
    monkeypatch.delenv("MX_AMP", raising=False)
    jnet = _jax_bert()
    runs = []
    for prec in (None, PrecisionConfig(), "env0"):
        if prec == "env0":
            monkeypatch.setenv("MX_AMP", "0")
            prec = None
        tnet = _port_bert(jnet)
        step = DataParallelStep(tnet, _mlm(SoftmaxCrossEntropyLoss),
                                optimizer="adam", device="cpu",
                                optimizer_params={"learning_rate": 1e-3},
                                precision=prec)
        assert step.scaler_state is None
        assert step._pipeline.names() == []
        losses = [float(step.step(TOKENS, TOKENS.astype(np.float32)))
                  for _ in range(3)]
        runs.append((losses, {k: v.clone() for k, v in
                              tnet.state_dict().items()}))
    for losses, state in runs[1:]:
        assert losses == runs[0][0]
        for k, v in state.items():
            assert v.dtype == torch.float32
            assert torch.equal(v, runs[0][1][k]), k


def test_amp_env_default_attaches_to_the_step(monkeypatch):
    monkeypatch.setenv("MX_AMP", "bf16")
    step = _mlp_step(None)[0]
    assert step.precision.amp.dtype == "bfloat16"
    assert step.precision.loss_scale is None and step.scaler_state is None
    assert step._pipeline.names() == ["amp"]
    x, y = _data()
    assert np.isfinite(float(step.step(x, y)))
    monkeypatch.setenv("MX_AMP", "fp16")
    step = _mlp_step(None)[0]
    assert step.precision.loss_scale == LossScaleConfig()
    assert float(step.scaler_state["scale"]) == 2.0 ** 15


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------
def _data(n=16, d=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, d).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _mlp(pkg, bn):
    net = pkg.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.nn.Dense(16, in_units=8))
        if bn:
            net.add(pkg.nn.BatchNorm(in_channels=16))
        net.add(pkg.nn.Activation("relu"), pkg.nn.Dense(4, in_units=16))
    return net


def _mlp_step(tprec, jprec=None, optimizer="sgd", lr=0.1, bn=False,
              clip_global=None, seed=0):
    """The port's step over the JAX test's MLP (optionally with a
    BatchNorm) and, with ``jprec``, the JAX step from the same
    weights."""
    mx.random.seed(seed)
    jnet = _mlp(jgluon, bn)
    jnet.initialize(mx.init.Xavier())
    tnet = _mlp(gluon, bn)
    tnet.initialize(ctx=CPU)
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, "mlp_")
    tloss = SoftmaxCrossEntropyLoss()
    tstep = DataParallelStep(tnet, lambda o, lab: tloss(o, lab),
                             optimizer=optimizer, device="cpu",
                             optimizer_params={"learning_rate": lr},
                             clip_global_norm=clip_global, precision=tprec)
    jstep = None
    if jprec is not None:
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
        jstep = JaxStep(jnet, lambda o, lab: jloss(o, lab),
                        mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                        optimizer=optimizer,
                        optimizer_params={"learning_rate": lr},
                        clip_global_norm=clip_global,
                        precision=None if jprec == "none" else jprec)
    return tstep, jstep, tnet


def _scaler(state):
    return (float(np.asarray(state["scale"])), int(np.asarray(
        state["growth"])), int(np.asarray(state["skipped"])))


def _jstep(jstep, x, y):
    return float(np.asarray(jstep.step(jnd.array(x), jnd.array(y))))


def test_fp16_amp_with_dynamic_scaling_trains():
    tp = PrecisionConfig(amp=AmpPolicy(dtype="float16"),
                         loss_scale=LossScaleConfig(init_scale=2.0 ** 8,
                                                    growth_interval=50))
    jp = JPC(amp=JAmp(dtype="float16"),
             loss_scale=JLS(init_scale=2.0 ** 8, growth_interval=50))
    tstep, jstep, _ = _mlp_step(tp, jp, lr=0.05)
    x, y = _data()
    tl = [float(tstep.step(x, y)) for _ in range(15)]
    jl = [_jstep(jstep, x, y) for _ in range(15)]
    assert all(np.isfinite(v) for v in tl) and tl[-1] < tl[0]
    assert _scaler(tstep.scaler_state) == _scaler(jstep.scaler_state) == (
        256.0, 15, 0)
    np.testing.assert_allclose(tl, jl, atol=2e-2)


def _held(step, net):
    return ([p.detach().clone() for p in step.params]
            + [t.clone() for s in step.opt_state for t in s]
            + [b.clone() for b in net.buffers()] + [step._t.clone()])


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_skip_step_holds_state_halves_scale_then_regrows(optimizer):
    tstep, jstep, tnet = _mlp_step(
        PrecisionConfig(amp=AmpPolicy(), loss_scale=LossScaleConfig(**LS)),
        JPC(amp=JAmp(), loss_scale=JLS(**LS)), optimizer=optimizer,
        lr=0.01, bn=True)
    x, y = _data()
    bad = x.copy()
    bad[0, 0] = np.inf  # a non-finite forward: non-finite gradients
    traj, jtraj = [], []
    for i, batch in enumerate([x, bad, x, x, x, x, x]):
        if i == 1:
            before = _held(tstep, tnet)
        tv = float(tstep.step(batch, y))
        jv = _jstep(jstep, batch, y)
        if i == 1:
            # weights, optimizer state, Adam's t and the BatchNorm stats
            # hold, bit for bit
            after = _held(tstep, tnet)
            assert len(after) == len(before)
            for a, b in zip(after, before):
                assert torch.equal(a, b)
        else:
            assert np.isfinite(tv) and np.isfinite(jv)
        traj.append(_scaler(tstep.scaler_state))
        jtraj.append(_scaler(jstep.scaler_state))
    assert traj == jtraj
    assert traj[1] == (8.0, 0, 1)          # halved, counter reset
    assert traj[5] == (16.0, 0, 1)         # regrown after 4 finite steps
    assert isinstance(tstep.scaler_state["scale"], torch.Tensor)


def test_static_scale_never_moves_but_still_skips():
    tstep, jstep, _ = _mlp_step(
        PrecisionConfig(amp=AmpPolicy(), loss_scale=LossScaleConfig(
            init_scale=32.0, dynamic=False)),
        JPC(amp=JAmp(), loss_scale=JLS(init_scale=32.0, dynamic=False)))
    x, y = _data()
    bad = x.copy()
    bad[0, 0] = np.nan
    tstep.step(x, y)
    _jstep(jstep, x, y)
    w0 = [p.detach().clone() for p in tstep.params]
    traj = []
    for batch in (bad, x, x, x, x, x):
        tstep.step(batch, y)
        _jstep(jstep, batch, y)
        traj.append((_scaler(tstep.scaler_state),
                     _scaler(jstep.scaler_state)))
        if len(traj) == 1:
            for a, b in zip(tstep.params, w0):
                assert torch.equal(a, b)
    assert [t for t, _ in traj] == [j for _, j in traj] == [
        (32.0, 0, 1)] * 6


def test_loss_scale_composes_with_clip_global_norm():
    """The un-scale folds into the rescale before the global-norm clip, so
    the clipped update matches the unscaled step's."""
    x, y = _data()
    a = _mlp_step(None, clip_global=0.5)[0]
    b = _mlp_step(PrecisionConfig(loss_scale=LossScaleConfig(
        init_scale=64.0, dynamic=False)), clip_global=0.5)[0]
    for _ in range(5):
        np.testing.assert_allclose(float(a.step(x, y)), float(b.step(x, y)),
                                   rtol=2e-6)
    for pa, pb in zip(a.params, b.params):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=2e-5, atol=1e-7)


def test_overflow_flag_is_a_tensor():
    arrs = [torch.ones(4), torch.ones(2, 2)]
    flag = loss_scale.overflow_flag(arrs)
    assert isinstance(flag, torch.Tensor) and flag.dim() == 0
    assert flag.dtype == torch.bool and bool(flag) is False
    for bad in (float("nan"), float("inf"), -float("inf")):
        arrs[0] = torch.tensor([1.0, bad, 2.0, 3.0])
        assert bool(loss_scale.overflow_flag(arrs)) is True
    big = torch.full((3,), 3.0e38)  # finite, its sum of squares is not
    assert bool(loss_scale.overflow_flag([big])) is False
    assert bool(loss_scale.grads_finite([big]))
