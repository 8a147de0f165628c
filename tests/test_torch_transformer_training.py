"""Transformer training in the port vs the JAX package's ``DataParallelStep``.

Both train a narrow Transformer with Transformer-big's head layout
(units 64, 4 heads, 2 + 2 layers, vocabulary 97, dropout 0) from the same
weights (the JAX package's ``mx.init.Xavier()``, carried by Gluon name)
on the same padded batch: sources (4, 12) and targets (4, 13) from
``RandomState(0)`` with pad id 0 in the tails, label-smoothed cross
entropy (smoothing 0.1) on float labels, as ``bench.py:706-751`` trains
BASELINE config 4.  The JAX side is ``DataParallelStep`` on a one-device
CPU mesh.  The cases cover Adam and SGD, tied and untied output
projections, post-norm and pre-norm cells, the lr schedulers (Factor,
Poly, Cosine with warmup), ``lr_mult`` / ``wd_mult`` and a frozen
parameter, ``clip_global_norm`` with the per-element clip,
``accum_steps=2`` and ``remat``.  The JAX ``Transformer`` takes no
``pre_norm``: its cells are switched to their pre-norm branch by their
``_pre_norm`` attribute before the first trace.

The key third of an attention bias has a gradient that is zero but for
rounding (a softmax does not see a shift shared by all its scores), and
so do the position embeddings past the batch's length; Adam turns that
noise into steps of lr whose signs two implementations need not share.
So in the Adam cases the parameter check leaves out the elements whose
JAX gradient at the start is zero to within rounding, by a rule on that
gradient: |g| below 1e-6 of the largest |g| of the model.  Every other
element is checked, and the losses at every step.

Losses agree within rtol 2e-4 at every step and every parameter within
atol 2e-4 at the end (the tolerances of ``tests/test_torch_training.py``:
f32 on both sides, sums in another order).  Beside each check a planted
fault shows that it fails: ``lr_mult`` ignored, microbatches as
contiguous blocks instead of strided rows, and the global-norm clip taken
after the per-element clip.

``label_smoothed_ce`` is checked alone against the JAX function on f32
and bf16 logits with float labels, and the K1 launches of a step (the
LayerNorm wrapper's plain version counts on the CPU) are counted: 10 a
forward for 2 + 2 layers, twice that under ``remat``.
"""
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.models.transformer import Transformer as JaxTransformer
from mxnet_tpu.models.transformer import \
    label_smoothed_ce as jax_label_smoothed_ce
from mxnet_tpu.optimizer import lr_scheduler as jax_sched
from mxnet_tpu.parallel import DataParallelStep as JaxDataParallelStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.models.transformer import Transformer, label_smoothed_ce
from mxnet_tpu_torch.optimizer import lr_scheduler as sched
from mxnet_tpu_torch.parallel import DataParallelStep

# the module (the package exports its function of the same name)
ln_module = importlib.import_module("mxnet_tpu_torch.ops.kernels.layer_norm")
VOCAB = 97
CFG = dict(units=64, hidden_size=128, num_heads=4, num_layers=2,
           max_length=32, dropout=0.0)
STEPS = 3


def _batch():
    rng = np.random.RandomState(0)
    src = rng.randint(3, VOCAB, (4, 12)).astype(np.int32)
    src[1, 9:] = 0
    src[3, 5:] = 0
    tgt = rng.randint(3, VOCAB, (4, 12)).astype(np.int32)
    tgt[2, 7:] = 0
    tgt_in = np.concatenate([np.ones((4, 1), np.int32), tgt], axis=1)
    tgt_out = np.concatenate([tgt, np.full((4, 1), 2, np.int32)], axis=1)
    tgt_out[2, 8:] = 0
    return src, tgt_in, tgt_out.astype(np.float32)


SRC, TGT_IN, LABEL = _batch()

# name -> (optimizer, optimizer_params, model and step options, scheduler)
CASES = {
    "adam_tied_post": ("adam", {"learning_rate": 1e-3}, {}, None),
    "sgd_untied": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                           "wd": 1e-4}, {"tie_embeddings": False}, None),
    "adam_pre_norm_cosine": (
        "adam", {"learning_rate": 2e-3}, {"pre_norm": True},
        ("CosineScheduler", dict(max_update=6, final_lr=1e-4,
                                 warmup_steps=2, warmup_begin_lr=1e-4))),
    "sgd_factor_mults_frozen": (
        "sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-2},
        {"mults": True}, ("FactorScheduler", dict(step=1, factor=0.7))),
    "adam_poly_clip_accum_remat": (
        "adam", {"learning_rate": 1e-3, "clip_gradient": 0.02,
                 "wd": 1e-3},
        {"clip_global_norm": 0.5, "accum_steps": 2, "remat": True},
        ("PolyScheduler", dict(max_update=8, pwr=2, warmup_steps=1))),
}
# the lr_mult / wd_mult case: gluon name -> (lr_mult, wd_mult); and the
# frozen parameter
MULTS = {"enc_layer0_attn_qkv_weight": (0.5, 2.0),
         "dec_layer1_ffn_ffn1_weight": (0.25, 0.0)}
FROZEN = "pos_weight"


def _jax_net(tie_embeddings=True, pre_norm=False):
    mx.random.seed(0)
    np.random.seed(0)
    net = JaxTransformer(VOCAB, tie_embeddings=tie_embeddings, **CFG)
    net.initialize(mx.init.Xavier())
    net(nd.array(SRC[:1], dtype="int32"), nd.array(TGT_IN[:1], dtype="int32"))
    if pre_norm:
        for cell in list(net.encoder.layers) + list(net.decoder.layers):
            cell._pre_norm = True
    return net


def _jax_loss(logits, labels):
    return jax_label_smoothed_ce(logits, labels, smoothing=0.1)


def _loss(logits, labels):
    return label_smoothed_ce(logits, labels, smoothing=0.1)


def _split(opts):
    model = {k: opts[k] for k in ("tie_embeddings",) if k in opts}
    step = {k: opts[k] for k in ("clip_global_norm", "accum_steps", "remat")
            if k in opts}
    return model, step


def _rounding_zero(jnet):
    """Gluon name -> mask of the elements whose gradient of the loss at
    the start is zero to within rounding (|g| below 1e-6 of the largest
    |g| of the model)."""
    with autograd.record():
        loss = _jax_loss(jnet(nd.array(SRC, dtype="int32"),
                              nd.array(TGT_IN, dtype="int32")),
                         nd.array(LABEL))
    loss.backward()
    grads = {k: np.abs(p.grad().asnumpy())
             for k, p in jnet.collect_params().items()}
    top = max(g.max() for g in grads.values())
    return {k: g < 1e-6 * top for k, g in grads.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    optimizer, hp, opts, sch = CASES[case]
    model_kw, step_kw = _split(opts)
    jnet = _jax_net(pre_norm=opts.get("pre_norm", False), **model_kw)
    start = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    # Adam's step does not shrink with its gradient: leave out the
    # elements whose gradient is rounding noise
    skip = _rounding_zero(jnet) if optimizer == "adam" else {}
    if opts.get("mults"):
        for name, p in jnet.collect_params().items():
            short = name[len(jnet.prefix):]
            if short in MULTS:
                p.lr_mult, p.wd_mult = MULTS[short]
            if short == FROZEN:
                p.grad_req = "null"
    hp = dict(hp)
    if sch is not None:
        hp["lr_scheduler"] = getattr(jax_sched, sch[0])(**sch[1])
    jstep = JaxDataParallelStep(
        jnet, _jax_loss, mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
        optimizer=optimizer, optimizer_params=hp, **step_kw)
    losses = [float(np.asarray(jstep.step(
        (nd.array(SRC, dtype="int32"), nd.array(TGT_IN, dtype="int32")),
        nd.array(LABEL)))) for _ in range(STEPS)]
    final = {k: np.asarray(v) for k, v in jstep.params.items()}
    return start, jnet.prefix, losses, final, skip


def _port_run(case, step_cls=DataParallelStep, ignore_lr_mult=False):
    optimizer, hp, opts, sch = CASES[case]
    model_kw, step_kw = _split(opts)
    start, prefix, *_ = _jax_run(case)
    net = Transformer(VOCAB, device="cpu", **model_kw, **CFG)
    if opts.get("pre_norm"):
        for cell in list(net.encoder.layers) + list(net.decoder.layers):
            cell.pre_norm = True
    from_mxnet_tpu_params(net, start, prefix)
    if opts.get("mults"):
        for key, p in net.named_parameters():
            name = gluon_name(net, key)
            if name in MULTS:
                p.lr_mult, p.wd_mult = MULTS[name]
            if name == FROZEN:
                p.requires_grad_(False)
    hp = dict(hp)
    if sch is not None:
        hp["lr_scheduler"] = getattr(sched, sch[0])(**sch[1])
    step = step_cls(net, _loss, optimizer=optimizer, optimizer_params=hp,
                    device="cpu", **step_kw)
    if ignore_lr_mult:
        step._lr_mults = [1.0] * len(step._lr_mults)
    losses = [float(step.step((SRC, TGT_IN), LABEL)) for _ in range(STEPS)]
    final = {prefix + gluon_name(net, k): v.numpy()
             for k, v in net.state_dict().items()}
    return losses, final


def _faults(case, losses, final):
    """What disagrees with the JAX run of ``case``; empty when the port
    holds."""
    _, _, jlosses, jfinal, skip = _jax_run(case)
    faults = []
    if not np.allclose(losses, jlosses, rtol=2e-4, atol=0):
        faults.append(f"losses {losses} vs {jlosses}")
    if set(final) != set(jfinal):
        faults.append("parameter names differ")
        return faults
    for name, value in final.items():
        keep = ~skip.get(name, np.zeros(value.shape, bool))
        if not np.allclose(value[keep], jfinal[name][keep], rtol=0,
                           atol=2e-4):
            faults.append(name)
    return faults


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax_data_parallel_step(case):
    losses, final = _port_run(case)
    assert all(np.isfinite(losses))
    assert _faults(case, losses, final) == []
    assert losses[-1] < losses[0], "a fixed batch is being memorised"


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "adam"])
def test_rounding_zero_rule_leaves_out_only_the_noise(case):
    """The Adam cases' parameter check leaves out under 1% of the model:
    the key third of every attention bias (the first half of a cross
    attention's kv bias), the position rows past the batch's length, and
    a few lone weights, and nothing of a LayerNorm or an embedding."""
    start, prefix, *_, skip = _jax_run(case)
    total = sum(v.size for v in start.values())
    assert sum(m.sum() for m in skip.values()) < 0.01 * total
    units, n = CFG["units"], 0
    for name, mask in skip.items():
        short = name[len(prefix):]
        if short.endswith("qkv_bias") or short.endswith("kv_bias"):
            key = slice(units, 2 * units) if "qkv" in short else \
                slice(0, units)
            assert mask[key].all() and mask.sum() == units, short
            n += 1
        assert not ("_ln" in short or short == "embed_weight") or \
            not mask.any(), short
    assert n == 3 * CFG["num_layers"]
    assert skip[prefix + "pos_weight"][:SRC.shape[1] + 1].sum() == 0


def test_frozen_parameter_stays_and_mults_move_it_less():
    losses, final = _port_run("sgd_factor_mults_frozen")
    start, prefix, *_ = _jax_run("sgd_factor_mults_frozen")
    assert np.array_equal(final[prefix + FROZEN], start[prefix + FROZEN])


# -- planted faults: each check fails on a broken step ------------------------
def test_planted_fault_lr_mult_ignored_is_caught():
    losses, final = _port_run("sgd_factor_mults_frozen", ignore_lr_mult=True)
    faults = _faults("sgd_factor_mults_frozen", losses, final)
    assert any("enc_layer0_attn_qkv_weight" in f for f in faults), faults


class _ContiguousMicrobatches(DataParallelStep):
    @staticmethod
    def _microbatch(a, i, k):
        n = a.shape[0] // k
        return a[i * n:(i + 1) * n] if k > 1 else a


class _ClipAfterElementClip(DataParallelStep):
    def _grad_terms(self, grads, w):
        torch._foreach_mul_(grads, self._rescale)
        torch._foreach_clamp_min_(grads, -float(self._clip))
        torch._foreach_clamp_max_(grads, float(self._clip))
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.clamp(
            self.clip_global_norm / (norm + 1e-12), max=1.0))
        torch._foreach_add_(grads, w, alpha=self._wd)
        return grads


@pytest.mark.parametrize("step_cls", [_ContiguousMicrobatches,
                                      _ClipAfterElementClip])
def test_planted_fault_accum_or_clip_order_is_caught(step_cls):
    case = "adam_poly_clip_accum_remat"
    losses, final = _port_run(case, step_cls=step_cls)
    assert _faults(case, losses, final) != []


# -- the step's own rules ------------------------------------------------------
def test_accum_steps_needs_a_divisible_batch_and_lr_follows_schedule():
    net = Transformer(VOCAB, device="cpu", **CFG)
    step = DataParallelStep(
        net, _loss, optimizer="adam", device="cpu", accum_steps=3,
        optimizer_params={"learning_rate": 0.1, "lr_scheduler":
                          sched.FactorScheduler(step=1, factor=0.5)})
    assert step.learning_rate == 0.1  # the first decay is at update 2
    with pytest.raises(MXNetError, match="accum_steps=3"):
        step.step((SRC, TGT_IN), LABEL)
    with pytest.raises(MXNetError, match="lr_scheduler"):
        step.set_learning_rate(0.2)
    plain = DataParallelStep(net, _loss, device="cpu",
                             optimizer_params={"learning_rate": 0.1})
    plain.learning_rate = 0.3
    assert plain.learning_rate == 0.3


@pytest.mark.parametrize("opts,per_step", [
    ({}, 10), ({"remat": True}, 20), ({"accum_steps": 2}, 20),
    ({"accum_steps": 2, "remat": True}, 40)])
def test_layer_norm_launches_per_step(monkeypatch, opts, per_step):
    """K1's launches on the main path: 2 + 3 LayerNorms a layer pair,
    10 a forward here; once more per forward under remat, whose backward
    recomputes the block; once per microbatch."""
    calls = []
    ref = ln_module.layer_norm_ref
    monkeypatch.setattr(ln_module, "layer_norm_ref",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    net = Transformer(VOCAB, device="cpu", **CFG)
    step = DataParallelStep(net, _loss, optimizer="adam", device="cpu",
                            **opts)
    step.step((SRC, TGT_IN), LABEL)
    assert len(calls) == per_step


# -- label_smoothed_ce alone ---------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_smoothed_ce_matches_jax(dtype):
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 7, VOCAB) * 3).astype(np.float32)
    labels = rng.randint(0, VOCAB, (3, 7)).astype(np.float32)
    labels[1, 4:] = 0
    want = jax_label_smoothed_ce(nd.array(logits).astype(dtype),
                                 nd.array(labels), smoothing=0.1)
    got = label_smoothed_ce(torch.from_numpy(logits).to(getattr(torch,
                                                                dtype)),
                            torch.from_numpy(labels), smoothing=0.1)
    assert got.dtype == torch.float32  # float labels promote, as in jnp
    np.testing.assert_allclose(float(got), float(want.asnumpy()), rtol=1e-6)


def test_label_smoothed_ce_ignores_pad_and_smooths():
    logits = torch.zeros(1, 3, 4)
    loss = label_smoothed_ce(logits, torch.tensor([[1.0, 0.0, 0.0]]),
                             smoothing=0.1)
    np.testing.assert_allclose(float(loss), np.log(4.0), rtol=1e-6)
    assert float(label_smoothed_ce(logits, torch.zeros(1, 3))) == 0.0
