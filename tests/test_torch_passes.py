"""The port's pass pipeline, fused-kernel registry and dispatch hook vs
the JAX package's, and the imperative slice end to end.

Pipelines built alike in both packages have the same ``signature()`` and
``fingerprint()``, and each package reads the other's ``to_json``.  The
port's kernel registry holds exactly the JAX one's op-classes.  A spy on
the registry shows that dispatch substitutes the kernel while the pass's
scope is active and never without it.  The whole imperative path
(add + LayerNorm, LayerNorm, flash attention, FullyConnected, the
softmax_cross_entropy op, backward) agrees with ``mxnet_tpu.nd`` at rtol
= atol = 1e-5, with the pass on and off.
"""
import json

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu import passes as jp
from mxnet_tpu.ops.pallas import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import passes as tp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import registry as treg

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)

# pipelines built alike in both packages
PIPELINES = {
    "empty": lambda m: m.PassPipeline([]),
    "fused": lambda m: m.PassPipeline([m.FusedKernelPass()]),
    "fused_off": lambda m: m.PassPipeline([m.FusedKernelPass(enabled=False)]),
    "fused_ln_only": lambda m: m.PassPipeline(
        [m.FusedKernelPass(ops=("LayerNorm",))]),
    "fused_no_ops": lambda m: m.PassPipeline([m.FusedKernelPass(ops=())]),
}


def test_registry_catalog_matches_jax():
    assert treg.registered_ops() == jreg.registered_ops() == [
        "LayerNorm", "_contrib_add_layer_norm", "_contrib_flash_attention"]
    for op in treg.registered_ops():
        assert treg.substitution(op, "cpu") is not None
        assert treg.substitution(op, "cuda") is not None
        assert treg.substitution(op, "meta") is None
    assert treg.substitution("FullyConnected", "cuda") is None
    with pytest.raises(MXNetError, match="registered twice"):
        treg.register_kernel("LayerNorm")(lambda *a: None)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_signature_and_fingerprint_match_jax(name):
    port, ref = PIPELINES[name](tp), PIPELINES[name](jp)
    assert port.signature() == ref.signature()
    assert port.fingerprint() == ref.fingerprint()
    assert port.to_json() == ref.to_json()


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_json_crosses_packages(name):
    ref = PIPELINES[name](jp)
    back = tp.PassPipeline.from_json(json.loads(json.dumps(ref.to_json())))
    assert back.fingerprint() == ref.fingerprint()
    assert back.names() == ref.names()
    there = jp.PassPipeline.from_json(
        json.loads(json.dumps(PIPELINES[name](tp).to_json())))
    assert there.fingerprint() == ref.fingerprint()


def test_fingerprints_split_and_disabled_pass_is_absent():
    fps = {n: mk(tp).fingerprint() for n, mk in PIPELINES.items()}
    assert fps["fused_off"] == fps["empty"]
    assert len({fps[n] for n in ("empty", "fused", "fused_ln_only",
                                 "fused_no_ops")}) == 4
    on = tp.PassPipeline([tp.FusedKernelPass(enabled=False)]).set_enabled(
        "fused_kernels", True)
    assert on.signature() == PIPELINES["fused"](tp).signature()
    with pytest.raises(MXNetError, match="no pass named"):
        on.set_enabled("amp", False)

    def f(params, key, x):
        return x

    assert tp.PassPipeline([]).wrap_apply(f) is f
    assert PIPELINES["fused_off"](tp).wrap_apply(f) is f
    wrapped = PIPELINES["fused"](tp).wrap_apply(
        lambda p, k, x: tp.hooks.active())
    assert wrapped(None, None, 0) is True and not tp.hooks.active()


def test_registered_passes_and_unknown_names_raise():
    assert tp.available_passes() == ["fused_kernels"]
    with pytest.raises(MXNetError, match="registered passes are"):
        tp.resolve_pass_type("amp")
    with pytest.raises(MXNetError, match="unknown graph pass"):
        tp.PassPipeline.from_json([{"pass": "nope", "config": {}}])
    with pytest.raises(MXNetError, match="unknown graph pass"):
        tp.apply_env_toggles(tp.PassPipeline(), {"MX_PASSES": "-nope"})
    with pytest.raises(MXNetError, match="duplicate pass"):
        tp.PassPipeline([tp.FusedKernelPass(), tp.FusedKernelPass()])
    with pytest.raises(MXNetError, match="not a GraphPass"):
        tp.PassPipeline([object()])


def test_mx_passes_toggles():
    pipe = tp.PassPipeline([tp.FusedKernelPass()])
    tp.apply_env_toggles(pipe, {"MX_PASSES": "fused_kernels"})
    assert pipe.get("fused_kernels").enabled is True
    tp.apply_env_toggles(pipe, {"MX_PASSES": " -fused_kernels, "})
    assert pipe.get("fused_kernels").enabled is False
    assert pipe.signature() == ("passes",)


def test_mx_pallas_fused_env_semantics():
    for off in ("0", "off", "false"):
        assert tp.fused_kernels_from_env({"MX_PALLAS_FUSED": off}) is None
    forced = tp.fused_kernels_from_env({"MX_PALLAS_FUSED": "1"})
    assert isinstance(forced, tp.FusedKernelPass)
    assert "_contrib_add_layer_norm" in forced._ops
    with pytest.raises(MXNetError, match="MX_PALLAS_FUSED"):
        tp.fused_kernels_from_env({"MX_PALLAS_FUSED": "sometimes"})
    # auto: on exactly where the kernels run natively, on a CUDA card
    auto = tp.fused_kernels_from_env({})
    assert (auto is not None) == torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert jp.fused_kernels_from_env({}) is None  # as the JAX package


def test_pipeline_factories():
    assert tp.pipeline_for_training(None, {}).names() == (
        ["fused_kernels"] if torch.cuda.is_available() else [])
    env = {"MX_PALLAS_FUSED": "1"}
    assert tp.pipeline_for_training(None, env).names() == ["fused_kernels"]
    vetoed = tp.pipeline_for_training(
        None, dict(env, MX_PASSES="-fused_kernels"))
    assert vetoed.get("fused_kernels").enabled is False
    assert (tp.pipeline_for_serving(None, env).fingerprint()
            == jp.pipeline_for_serving(None, env).fingerprint())

    class Prec:
        amp = object()

    with pytest.raises(MXNetError, match="amp pass is not ported"):
        tp.pipeline_for_training(Prec(), env)


def test_op_hook_nesting_restores():
    class H(tp.hooks.OpHook):
        pass

    a, b = H(), H()
    assert not tp.hooks.active()
    with tp.hooks.op_hook(a):
        with tp.hooks.op_hook(b):
            assert tp.hooks._OP_HOOKS == (a, b)
        assert tp.hooks._OP_HOOKS == (a,)
    assert not tp.hooks.active()
    with pytest.raises(RuntimeError):
        with tp.hooks.op_hook(a):
            raise RuntimeError("boom")
    assert not tp.hooks.active()


def _aln_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((4, 3, 8), (4, 3, 8), (8,), (8,))]


@pytest.fixture
def spy(monkeypatch):
    """Count calls of the registry's add + LayerNorm substitute and the
    platform each dispatch asked for."""
    entry = treg._KERNELS["_contrib_add_layer_norm"]
    calls = []
    real = entry.fn

    def counted(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(entry, "fn", counted)
    return calls


def test_substitution_runs_under_the_pass_only(spy):
    arrays = [tnd.array(a, ctx=CPU) for a in _aln_inputs()]
    stock = tnd.contrib.add_layer_norm(*arrays).asnumpy()
    assert spy == []
    for name in ("empty", "fused_off", "fused_ln_only"):
        with PIPELINES[name](tp).scope():
            tnd.contrib.add_layer_norm(*arrays)
    assert spy == []
    with PIPELINES["fused"](tp).scope():
        fused = tnd.contrib.add_layer_norm(*arrays).asnumpy()
    assert spy == ["cpu"]
    assert not tp.hooks.active()
    np.testing.assert_allclose(fused, stock, **TOL)


def test_substitute_asks_for_the_inputs_platform(monkeypatch):
    asked = []

    def record(op_name, platform=None):
        asked.append((op_name, platform))
        return None

    monkeypatch.setattr(treg, "substitution", record)
    x = tnd.array(np.ones((2, 4), np.float32), ctx=CPU)
    g = tnd.ones((4,), ctx=CPU)
    with PIPELINES["fused"](tp).scope():
        tnd.LayerNorm(x, g, g)
        tnd.FullyConnected(x, x, num_hidden=2, no_bias=True)
    assert asked == [("LayerNorm", "cpu")]


def test_fused_output_matches_jax_traced_pallas_kernel():
    """The port under the pass against the JAX package's trace under the
    same pass, where its registry swaps in the Pallas kernel."""
    import jax

    import mxnet_tpu as jmx
    from mxnet_tpu.ndarray import NDArray

    x, r, g, b = _aln_inputs(1)

    def traced(xx, rr):
        with jp.PassPipeline([jp.FusedKernelPass()]).scope():
            out = jnd.contrib.add_layer_norm(
                NDArray(xx, ctx=jmx.cpu()), NDArray(rr, ctx=jmx.cpu()),
                jnd.array(g), jnd.array(b))
        return out._data

    want = np.asarray(jax.jit(traced)(x, r))
    with PIPELINES["fused"](tp).scope():
        got = tnd.contrib.add_layer_norm(
            *[tnd.array(a, ctx=CPU) for a in (x, r, g, b)]).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the imperative slice end to end
# ---------------------------------------------------------------------------
B, L, H, HD, VOCAB = 2, 8, 2, 8, 24


def _slice_inputs():
    rng = np.random.RandomState(7)
    C = H * HD

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    arrays = {"x": f(B * L, C), "r": f(B * L, C),
              "gamma1": 1 + f(C, scale=0.1), "beta1": f(C, scale=0.1),
              "gamma2": 1 + f(C, scale=0.1), "beta2": f(C, scale=0.1),
              "k": f(B * H, L, HD), "v": f(B * H, L, HD),
              "weight": f(VOCAB, C, scale=0.3), "bias": f(VOCAB, scale=0.1)}
    labels = rng.randint(0, VOCAB, B * L).astype(np.float32)
    return arrays, labels


def _slice(ns, ag, scope, arrays, labels, **kw):
    arrs = {k: ns.array(v, **kw) for k, v in arrays.items()}
    for a in arrs.values():
        a.attach_grad()
    lab = ns.array(labels, **kw)
    with scope, ag.record():
        y = ns.contrib.add_layer_norm(arrs["x"], arrs["r"], arrs["gamma1"],
                                      arrs["beta1"])
        h = ns.LayerNorm(y, arrs["gamma2"], arrs["beta2"])
        att = ns.contrib.flash_attention(h.reshape((B * H, L, HD)),
                                         arrs["k"], arrs["v"])
        logits = ns.FullyConnected(att.reshape((B * L, H * HD)),
                                   arrs["weight"], arrs["bias"],
                                   num_hidden=VOCAB)
        loss = ns.softmax_cross_entropy(logits, lab)
    loss.backward()
    return float(loss.asscalar()), {k: a.grad.asnumpy()
                                    for k, a in arrs.items()}


@pytest.mark.parametrize("pipeline", ["fused", "empty"])
def test_imperative_slice_matches_jax(pipeline, spy):
    arrays, labels = _slice_inputs()
    loss_j, grads_j = _slice(jnd, jag, PIPELINES[pipeline](jp).scope(),
                             arrays, labels)
    loss_t, grads_t = _slice(tnd, tag, PIPELINES[pipeline](tp).scope(),
                             arrays, labels, ctx=CPU)
    assert spy == (["cpu"] if pipeline == "fused" else [])
    np.testing.assert_allclose(loss_t, loss_j, **TOL)
    assert sorted(grads_t) == sorted(grads_j)
    for k in grads_j:
        np.testing.assert_allclose(grads_t[k], grads_j[k], err_msg=k, **TOL)
