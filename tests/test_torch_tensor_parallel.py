"""Tensor parallelism of the port's ``DataParallelStep`` over a mesh of
processes vs the JAX package's over a mesh of devices.

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py tp``,
through the port's launcher) trains ``bert_small(dropout=0.0)`` (2 layers,
B 8, T 16) for 2 Adam steps at lr 1e-3 with ``bert_sharding_rules`` on
dp2 x tp2 and tp4, from the JAX net's weights carried by name.  The JAX
side is its ``DataParallelStep`` with the same rules on ``make_mesh`` of
the same shapes over 4 of the 8 virtual CPU devices.  Losses agree within
1e-5 relative, every gathered parameter within 1e-5 of the largest |JAX|
parameter and every Adam moment within 1e-4 of its own max |JAX|; the
gathered ``state_dict()`` has the JAX step's
keys and shapes (the fused qkv weight in the JAX order: q, k and v rows
whole) and ``layout()`` the JAX step's mesh axes, device ids and specs.

A vocabulary of 510 does not divide by tp4: the port cuts the embedding
and the decoder into blocks of 128, 128, 128 and 126 rows (as GSPMD pads
them), while the JAX step refuses the layout (``device_put`` asks that
the dimension divide by 4).  That case is held against the JAX step on
dp4 at vocabulary 510 instead, within the same tolerances.  dp2 x tp2
with ``clip_global_norm=0.5`` (a norm of sharded and replicated
gradients, each counted once) is held against the port's one-process
step on the global batch, which the dp tests hold against the JAX step.
"""
import ast
import os
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu.models.bert import bert_sharding_rules as jax_rules
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOKENS = np.random.RandomState(0).randint(0, 510, (8, 16)).astype(np.int32)
TOL = 1e-5


def _start(vocab):
    mx.random.seed(0)
    net = jax_bert_small(vocab_size=vocab, dropout=0.0)
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(TOKENS, dtype="int32"))
    return net.prefix, {k: p.data().asnumpy()
                        for k, p in net.collect_params().items()}


def _jax_run(start, prefix, vocab, axes, rules):
    net = jax_bert_small(vocab_size=vocab, dropout=0.0)
    net.initialize(mx.init.Zero())
    net(nd.array(TOKENS, dtype="int32"))
    for k, p in net.collect_params().items():
        p.set_data(start[prefix + k[len(net.prefix):]])
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    step = JaxStep(net, cases._mlm(loss),
                   mesh=jax_make_mesh(devices=jax.devices("cpu")[:4], **axes),
                   optimizer="adam", rules=rules,
                   optimizer_params={"learning_rate": cases.STEP_LR})
    losses = [float(np.asarray(step.step(
        nd.array(TOKENS, dtype="int32"), nd.array(TOKENS.astype(np.float32)))))
        for _ in range(cases.STEPS)]
    return np.array(losses), step.state_dict(), step.layout()


def _port_one_process(start, prefix, clip):
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.bert import bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep

    net = bert_small(dropout=0.0, device="cpu", init_weights=False)
    from_mxnet_tpu_params(net, start, prefix)
    step = DataParallelStep(net, cases._mlm(SoftmaxCrossEntropyLoss()),
                            optimizer="adam", device="cpu",
                            clip_global_norm=clip,
                            optimizer_params={"learning_rate": cases.STEP_LR})
    losses = [float(step.step(TOKENS, TOKENS.astype(np.float32)))
              for _ in range(cases.STEPS)]
    return np.array(losses), step.state_dict()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_tp")
    starts = {}
    for vocab in (512, 510):
        prefix, start = _start(vocab)
        starts[vocab] = (prefix, start)
        np.savez(out / f"start{vocab}.npz", prefix=np.array(prefix),
                 tokens=TOKENS, **start)
    wait = cases.start_group(out, 4, "tp", "bert_pretrain_tp")
    jax_ref = {
        "dp2tp2": _jax_run(*starts[512][::-1], 512, {"tp": 2}, jax_rules()),
        "tp4": _jax_run(*starts[512][::-1], 512, {"tp": 4}, jax_rules()),
        "tp4_v510": _jax_run(*starts[510][::-1], 510, {}, jax_rules()),
    }
    one = _port_one_process(*starts[512][::-1], clip=0.5)
    assert wait() == 0
    got = dict(np.load(out / "tp-0.npz"))
    got["bert_pretrain_tp"] = (out / "bert_pretrain_tp-0.txt").read_text()
    return got, jax_ref, one


def _section(got, name, sec):
    key = f"{name}:{sec}/"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


def _close(losses, params, ref_losses, ref_params):
    """Losses within TOL relative; every tensor within TOL of its own max
    |reference| (a slot's too)."""
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=0)
    assert set(params) == set(ref_params)
    errs = {k: float(np.abs(v - np.asarray(ref_params[k])).max())
            / max(float(np.abs(np.asarray(ref_params[k])).max()), 1e-30)
            for k, v in params.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", ["dp2tp2", "tp4", "tp4_v510"])
def test_tensor_parallel_step_matches_jax_step(results, name):
    """Losses, gathered parameters and Adam moments of the JAX step (whose
    parameters are held to the largest |value| over all of them, as the
    dp tests hold them; the moments each to its own max)."""
    got, jax_ref, _ = results
    ref_losses, ref_state, _ = jax_ref[name]
    params = _section(got, name, "params")
    scale = max(float(np.abs(v).max()) for v in ref_state["params"].values())
    np.testing.assert_allclose(got[f"{name}:losses"], ref_losses, rtol=TOL,
                               atol=0)
    assert set(params) == set(ref_state["params"])
    for k, v in params.items():
        ref = np.asarray(ref_state["params"][k])
        assert v.shape == ref.shape, k
        assert float(np.abs(v - ref).max()) / scale <= TOL, k
    opt = _section(got, name, "opt_state")
    assert set(opt) == set(ref_state["opt_state"])
    assert int(opt["t"]) == int(np.asarray(ref_state["opt_state"]["t"]))
    for k, v in opt.items():
        if k == "t":
            continue
        ref = np.asarray(ref_state["opt_state"][k])
        assert v.shape == ref.shape, k
        # a moment's own max: the variance of a near-zero gradient is
        # tiny, so the slot tolerance is a relative one of 1e-4
        assert float(np.abs(v - ref).max()) <= 1e-4 * max(
            float(np.abs(ref).max()), 1e-30), k


@pytest.mark.parametrize("name", ["dp2tp2", "tp4"])
def test_tensor_parallel_layout_matches_jax(results, name):
    got, jax_ref, _ = results
    mine = ast.literal_eval(str(got[f"{name}:layout"]))
    theirs = jax_ref[name][2]
    assert mine["mesh_axes"] == theirs["mesh_axes"]
    assert mine["device_ids"] == [d - jax.devices("cpu")[0].id
                                  for d in theirs["device_ids"]]
    assert mine["specs"] == theirs["specs"]
    assert mine["plan"]["rules"] == theirs["plan"]["rules"]
    assert mine["plan"]["strategy"] == theirs["plan"]["strategy"] == (
        "dp+tp" if name == "dp2tp2" else "tp")
    qkv = [k for k in mine["specs"] if k.endswith("qkv.weight")]
    assert qkv and all(mine["specs"][k] == ["tp", None] for k in qkv)
    assert bool(got[f"{name}:collective"])


def test_uneven_vocabulary_blocks_and_refusal():
    """510 rows over tp4: GSPMD's blocks (128, 128, 128, 126); the JAX
    step refuses the layout, so the parity case above holds the port
    against its dp4 step."""
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.tensor_parallel import ParamShard

    mesh = make_mesh(tp=4, devices=range(4))
    sh = ParamShard(mesh, ("tp", None), (510, 64))
    assert [sh.local_shape(r) for r in range(4)] == [
        (128, 64), (128, 64), (128, 64), (126, 64)]
    qkv = ParamShard(mesh, ("tp", None), (192, 64), fused=3)
    rows = [[s.start for s in (g[0] for g, _ in qkv.blocks(r))]
            for r in range(4)]
    assert rows == [[0, 64, 128], [16, 80, 144], [32, 96, 160],
                    [48, 112, 176]]
    prefix, start = _start(510)
    with pytest.raises(ValueError, match="divisible by 4"):
        _jax_run(start, prefix, 510, {"tp": 4}, jax_rules())


def test_clip_global_norm_counts_each_gradient_once(results):
    got, _, (losses, state) = results
    _close(got["dp2tp2_clip:losses"], _section(got, "dp2tp2_clip", "params"),
           losses, state["params"])


def _first_loss(text):
    import re

    return float(re.search(r"step 0: loss=([0-9.]+)", text).group(1))


def test_bert_pretrain_example_on_dp2_tp2(results):
    """``examples.bert_pretrain --dp 2 --tp 2`` (bert_small with
    ``bert_sharding_rules``) trains, and its first loss is the one-process
    example's, to the 4 decimals it prints."""
    import contextlib
    import io

    from mxnet_tpu_torch.examples import bert_pretrain

    text = results[0]["bert_pretrain_tp"]
    assert "on mesh dp2xsp1xpp1xtp2" in text
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        bert_pretrain.main(cases.BERT_PRETRAIN_ARGS)
    assert _first_loss(text) == _first_loss(one.getvalue())


def _refusal(case):
    import torch

    from mxnet_tpu_torch.models.bert import bert_sharding_rules, bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh
    from mxnet_tpu_torch.parallel.sharding import ShardingRules
    from mxnet_tpu_torch.parallel.tensor_parallel import shard_parameters

    lin = torch.nn.Linear(4, 2)
    loss = lambda out, y: (out - y) ** 2  # noqa: E731
    if case == "sp_with_tp":
        DataParallelStep(lin, loss, device="cpu",
                         mesh=make_mesh(sp=2, tp=2, devices=range(4)))
    elif case == "remat_with_pp":
        DataParallelStep(lin, loss, device="cpu", remat=True,
                         mesh=make_mesh(pp=2, devices=range(2)))
    elif case == "no_form":
        net = bert_small(dropout=0.0, device="cpu")
        rules = ShardingRules([(r".*pooler_weight$", ("tp", None))]
                              + bert_sharding_rules().to_json())
        shard_parameters(net, make_mesh(tp=2, devices=range(2)), rules,
                         [(n, p._tensor())
                          for n, p in net.collect_params().items()])
    else:  # a data axis on a parameter
        shard_parameters(lin, make_mesh(dp=2, devices=range(2)),
                         ShardingRules([(r"weight", ("dp", None))]),
                         list(lin.named_parameters()))


@pytest.mark.parametrize("case", ["sp_with_tp", "remat_with_pp", "no_form",
                                  "data_axis"])
def test_what_the_port_cannot_run_names_a93(case):
    """sp with tp, remat with pp, a rule on a layer with no tensor-parallel
    form (the pooler) and a rule over a data axis raise, naming ROADMAP A.9
    part 4 (and the parameter and rule where there is one).  A BatchNorm
    in a step over several processes runs since A.9 part 3
    (``tests/test_torch_syncbn.py``)."""
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(MXNetError, match="A.9 part 4") as err:
        _refusal(case)
    if case == "no_form":
        assert "pooler_weight" in str(err.value)
        assert "'.*pooler_weight$'" in str(err.value)
