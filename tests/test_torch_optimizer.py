"""The port's optimizer layer vs the JAX package's.

Checked on the CPU, with the same numpy weights and gradients on both
sides:
  * every lr scheduler's lr at updates 0..50 (rtol 1e-12: the same host
    arithmetic);
  * each of the 11 optimizer classes through ``get_updater`` for 3
    updates of 3 weights (one at ``lr_mult`` 0.5), with ``rescale_grad``,
    ``clip_gradient``, ``wd`` and an lr scheduler, in f32 (weights and
    states within rtol 1e-6, atol 1e-6: f32 element-wise formulas in the
    same order, LAMB's norms summed in another) and in bf16 with
    ``multi_precision`` (the bf16 weights within one bf16 unit, 2^-8
    relative, of the JAX ones, since their f32 masters agree to rounding);
  * the fused updater against the per-parameter one (rtol 1e-6, atol
    1e-7, the JAX test's tolerance, ``tests/test_fused_optimizer.py``),
    ``MX_FUSED_UPDATE=0``, and the fallback of classes without a spec;
  * ``get_states`` / ``set_states`` round trips;
  * ``gluon.utils.clip_global_norm``, ``split_data`` and
    ``split_and_load`` against the JAX functions;
  * ``foreach.axpy_`` (shared by the fused updater and the training
    step): one multi-tensor call per distinct scalar.
Planted faults (``lr_mult`` ignored, the fused path ignoring ``wd_mult``)
show that the checks fail on a broken update.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu.optimizer as jopt
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu.optimizer import lr_scheduler as jsched
from mxnet_tpu_torch import MXNetError, cpu
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import utils as tutils
from mxnet_tpu_torch.ndarray import NDArray, array
from mxnet_tpu_torch.optimizer import FusedUpdater, Updater
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

SCHEDULERS = {
    "warmup_linear": ("LRScheduler", dict(base_lr=0.1, warmup_steps=51,
                                          warmup_begin_lr=0.01)),
    "warmup_constant": ("LRScheduler", dict(base_lr=0.1, warmup_steps=51,
                                            warmup_begin_lr=0.01,
                                            warmup_mode="constant")),
    "factor": ("FactorScheduler", dict(step=7, factor=0.5,
                                       stop_factor_lr=1e-3, base_lr=0.1,
                                       warmup_steps=3, warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[5, 12, 30],
                                                 factor=0.3, base_lr=0.1)),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                                   final_lr=1e-3, warmup_steps=5,
                                   warmup_mode="constant",
                                   warmup_begin_lr=0.02)),
    "cosine": ("CosineScheduler", dict(max_update=40, base_lr=0.1,
                                       final_lr=1e-3, warmup_steps=5,
                                       warmup_begin_lr=0.0)),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_schedulers_match_jax(name):
    cls, kw = SCHEDULERS[name]
    j, t = getattr(jsched, cls)(**kw), getattr(tsched, cls)(**kw)
    if cls == "LRScheduler":
        got = [t.get_warmup_lr(n) for n in range(51)]
        want = [j.get_warmup_lr(n) for n in range(51)]
    else:
        got, want = [t(n) for n in range(51)], [j(n) for n in range(51)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1 or kw.get("warmup_mode") == "constant"


def test_scheduler_arguments_are_checked():
    with pytest.raises(MXNetError):
        tsched.FactorScheduler(step=0)
    with pytest.raises(MXNetError):
        tsched.MultiFactorScheduler(step=[5, 3])
    with pytest.raises(MXNetError):
        tsched.LRScheduler(warmup_mode="cubic")


# -- the 11 classes ------------------------------------------------------------
CLASSES = {
    "sgd": dict(momentum=0.9), "nag": dict(momentum=0.9), "adam": {},
    "adamax": {}, "nadam": {}, "adagrad": {}, "adadelta": {},
    "rmsprop": dict(centered=True), "ftrl": {}, "signum": dict(wd_lh=1e-3),
    "lamb": {},
}
SHAPES = [(7, 5), (5,), (3, 4)]


def _weights_and_grads(seed=0, steps=3):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _kwargs(name, dtype):
    return dict(CLASSES[name], rescale_grad=0.5, clip_gradient=0.8,
                learning_rate=0.01, wd=1e-3,
                multi_precision=dtype == "bfloat16")


def _run_jax(name, dtype):
    ws, gs = _weights_and_grads()
    opt = jopt.create(name, lr_scheduler=jsched.FactorScheduler(
        step=1, factor=0.9), **_kwargs(name, dtype))
    opt.set_lr_mult({1: 0.5})
    upd = jopt.get_updater(opt)
    w = [jnd.array(x).astype(dtype) for x in ws]
    for g in gs:
        for i, gi in enumerate(g):
            upd(i, jnd.array(gi).astype(dtype), w[i])
    states = pickle.loads(upd.get_states())["__states__"]
    return [np.asarray(x.asnumpy(), np.float32) for x in w], states


def _run_port(name, dtype, ignore_lr_mult=False):
    ws, gs = _weights_and_grads()
    opt = topt.create(name, lr_scheduler=tsched.FactorScheduler(
        step=1, factor=0.9), **_kwargs(name, dtype))
    opt.set_lr_mult({} if ignore_lr_mult else {1: 0.5})
    upd = topt.get_updater(opt)
    w = [array(x, ctx=cpu(), dtype=dtype) for x in ws]
    for g in gs:
        for i, gi in enumerate(g):
            upd(i, array(gi, ctx=cpu(), dtype=dtype), w[i])
    states = pickle.loads(upd.get_states())["__states__"]
    return [x.asnumpy() for x in w], states


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [a for x in s for a in _flat(x)]
    return [np.asarray(s, np.float32)]


def _class_faults(name, dtype, got):
    """What disagrees with the JAX run; empty when the port holds."""
    want_w, want_s = _run_jax(name, dtype)
    got_w, got_s = got
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    faults = [f"weight {i}" for i, (a, b) in enumerate(zip(got_w, want_w))
              if not np.allclose(a, b, rtol=rtol, atol=1e-6)]
    for i in want_s:
        fa, fb = _flat(got_s[i]), _flat(want_s[i])
        if len(fa) != len(fb) or not all(
                np.allclose(a, b, rtol=1e-6, atol=1e-6)
                for a, b in zip(fa, fb)):
            faults.append(f"state {i}")
    return faults


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_optimizer_classes_match_jax_get_updater(name, dtype):
    assert _class_faults(name, dtype, _run_port(name, dtype)) == []


def test_planted_fault_lr_mult_ignored_is_caught():
    faults = _class_faults("adam", "float32",
                           _run_port("adam", "float32", ignore_lr_mult=True))
    assert faults and faults[0] == "weight 1"


def test_create_registry_and_learning_rate():
    opt = topt.create("SGD", learning_rate=0.2)
    assert isinstance(opt, topt.SGD) and opt.learning_rate == 0.2
    assert topt.create(opt) is opt
    with pytest.raises(MXNetError, match="unknown optimizer"):
        topt.create("nope")
    sch = topt.create("adam", learning_rate=0.3,
                      lr_scheduler=tsched.FactorScheduler(step=2))
    assert sch.lr_scheduler.base_lr == 0.3
    with pytest.raises(MXNetError):
        sch.set_learning_rate(0.1)
    named = topt.create("sgd", learning_rate=1.0,
                        param_idx2name={0: "fc_weight"})
    named.set_lr_mult({"fc_weight": 0.25})
    named.set_wd_mult({"fc_weight": 0.0})
    assert named._get_lr(0) == 0.25 and named._get_wd(0) == 0.0


def test_sparse_gradient_raises():
    w = array(np.ones((4, 3), np.float32), ctx=cpu())
    g = NDArray(torch.ones(4, 3).to_sparse())
    with pytest.raises(MXNetError, match="A.7"):
        topt.get_updater(topt.create("sgd"))(0, g, w)


# -- the fused updater ---------------------------------------------------------
FUSED = [("sgd", dict(learning_rate=0.1)),
         ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
         ("sgd", dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.01)),
         ("adam", dict(learning_rate=0.01, wd=1e-4)),
         ("rmsprop", dict(learning_rate=0.01)),
         ("rmsprop", dict(learning_rate=0.01, centered=True,
                          clip_weights=0.9))]


def _apply_run(name, kw, fused, dtype="float32", wd_mult_fault=False):
    ws, gs = _weights_and_grads(seed=2, steps=4)
    opt = topt.create(name, lr_scheduler=tsched.CosineScheduler(
        max_update=10, warmup_steps=2), rescale_grad=0.5,
        multi_precision=dtype == "bfloat16", **kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({2: 3.0})
    upd = FusedUpdater(opt) if fused else Updater(opt)
    if wd_mult_fault:
        opt.set_wd_mult({})
    w = [array(x, ctx=cpu(), dtype=dtype) for x in ws]
    for g in gs:
        entries = [(i, array(gi, ctx=cpu(), dtype=dtype), w[i])
                   for i, gi in enumerate(g)]
        if fused:
            info = upd.apply(entries)
        else:
            for i, gi, wi in entries:
                upd(i, gi, wi)
    return [x.asnumpy() for x in w], (info if fused else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", FUSED)
def test_fused_matches_per_param(name, kw, dtype):
    w_fused, info = _apply_run(name, kw, True, dtype)
    w_ref, _ = _apply_run(name, kw, False, dtype)
    for a, b in zip(w_fused, w_ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert info == {"n_params": 3, "n_fused": 3, "n_fallback": 0,
                    "n_groups": 1}


def test_planted_fault_fused_ignoring_wd_mult_is_caught():
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-2)
    w_fused, _ = _apply_run("sgd", kw, True, wd_mult_fault=True)
    w_ref, _ = _apply_run("sgd", kw, False)
    assert not np.allclose(w_fused[2], w_ref[2], rtol=1e-6, atol=1e-7)


def test_fused_falls_back_without_a_spec_and_switch_pins_per_param(
        monkeypatch):
    w_fused, info = _apply_run("nadam", {}, True)
    w_ref, _ = _apply_run("nadam", {}, False)
    for a, b in zip(w_fused, w_ref):
        np.testing.assert_array_equal(a, b)
    assert info["n_fallback"] == 3 and info["n_fused"] == 0
    monkeypatch.setenv("MX_FUSED_UPDATE", "1")
    assert isinstance(topt.get_updater(topt.create("sgd")), FusedUpdater)
    monkeypatch.setenv("MX_FUSED_UPDATE", "0")
    upd = topt.get_updater(topt.create("sgd"))
    assert isinstance(upd, Updater) and not isinstance(upd, FusedUpdater)


# -- state round trips ---------------------------------------------------------
@pytest.mark.parametrize("dump_optimizer", [False, True])
def test_get_states_set_states_round_trip(dump_optimizer):
    ws, gs = _weights_and_grads(seed=4, steps=3)

    def fresh():
        return topt.get_updater(topt.create("adam", learning_rate=0.01))

    a = fresh()
    wa = [array(x, ctx=cpu()) for x in ws]
    for g in gs[:2]:
        for i, gi in enumerate(g):
            a(i, array(gi, ctx=cpu()), wa[i])
    blob = a.get_states(dump_optimizer=dump_optimizer)
    b = fresh()
    b.set_states(blob)
    wb = [array(x.asnumpy(), ctx=cpu()) for x in wa]
    for i, gi in enumerate(gs[2]):
        a(i, array(gi, ctx=cpu()), wa[i])
        b(i, array(gi, ctx=cpu()), wb[i])
    for x, y in zip(wa, wb):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
    assert b.optimizer._index_update_count == {0: 3, 1: 3, 2: 3}


# -- gluon.utils -----------------------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(6)
    xs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jarrs = [jnd.array(x) for x in xs]
    tarrs = [array(x, ctx=cpu()) for x in xs]
    jn = jutils.clip_global_norm(jarrs, max_norm)
    tn = tutils.clip_global_norm(tarrs, max_norm)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(tarrs, jarrs):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(MXNetError):
        tutils.clip_global_norm([], 1.0)
    with pytest.warns(UserWarning, match="nan or inf"):
        tutils.clip_global_norm([array(np.array([np.inf], np.float32),
                                       ctx=cpu())], 1.0)


@pytest.mark.parametrize("size,n,even,axis", [(8, 4, True, 0), (7, 3, False, 0),
                                              (6, 3, True, 1)])
def test_split_data_matches_jax(size, n, even, axis):
    shape = (size, 5) if axis == 0 else (2, size)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = jutils.split_data(jnd.array(x), n, batch_axis=axis,
                             even_split=even)
    got = tutils.split_data(array(x, ctx=cpu()), n, batch_axis=axis,
                            even_split=even)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    loaded = tutils.split_and_load(x, [cpu(), cpu()] if size % 2 == 0
                                   else [cpu()], batch_axis=axis)
    np.testing.assert_array_equal(
        np.concatenate([p.asnumpy() for p in loaded], axis=axis), x)


def test_split_data_refuses_uneven_and_too_many_slices():
    x = array(np.zeros((5, 2), np.float32), ctx=cpu())
    with pytest.raises(MXNetError, match="evenly"):
        tutils.split_data(x, 2)
    with pytest.raises(MXNetError, match="Too many slices"):
        tutils.split_data(x, 6)


# -- the shared multi-tensor helpers ---------------------------------------------
def test_axpy_makes_one_call_per_distinct_alpha(monkeypatch):
    from mxnet_tpu_torch.optimizer import foreach

    rng = np.random.RandomState(7)
    ys = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SHAPES]
    xs = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SHAPES]
    alphas = [0.5, 0.0, 0.5]  # e.g. wd_mult 0 on a bias
    want = [y + a * x for y, x, a in zip(ys, xs, alphas)]
    calls = []
    add = torch._foreach_add_
    monkeypatch.setattr(torch, "_foreach_add_",
                        lambda *a, **k: calls.append(k) or add(*a, **k))
    foreach.axpy_(ys, xs, alphas)
    assert sorted(k["alpha"] for k in calls) == [0.0, 0.5]
    for got, w in zip(ys, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
