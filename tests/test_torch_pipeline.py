"""Pipeline parallelism of the port (``parallel/pipeline.py``,
``models/bert_pp.py``) over a mesh of processes vs the JAX package's.

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py pp``,
through the port's launcher) trains ``bert_pp_small(dropout=0.0)`` (4
stacked layers, B 8, T 16, 2 microbatches) for 2 Adam steps at lr 1e-3
with ``bert_pp_sharding_rules`` on dp2 x pp2, pp4 and pp2 x tp2, from the
JAX net's weights carried by name.  The JAX side is its
``DataParallelStep`` with the same rules and microbatches on ``make_mesh``
of the same shapes over 4 of the 8 virtual CPU devices (the GPipe
``lax.scan`` over ``ppermute``).  Every rank's losses agree within 1e-5
relative and its gathered parameters within 1e-5 of the largest |JAX|
value, and ``layout()`` gives the JAX step's specs.  The group also runs
``pipeline_apply`` on pp4 (one layer a stage) with the whole stack on
every process against the loop over the same stack (output, input
gradient and each stage's rows of the stack's gradients, within 1e-6),
and the stacked encoder's two microbatch errors, which are the JAX
step's messages.
"""
import ast
import os
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu.models import bert_pp_small as jax_bert_pp_small
from mxnet_tpu.models.bert_pp import bert_pp_sharding_rules as jax_rules
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOKENS = np.random.RandomState(0).randint(0, 512, (8, 16)).astype(np.int32)
TOL = 1e-5


def _jax_net(start=None, prefix=None):
    net = jax_bert_pp_small(dropout=0.0)
    net.initialize(mx.init.Normal(0.02) if start is None else mx.init.Zero())
    net(nd.array(TOKENS, dtype="int32"))
    if start is not None:
        for k, p in net.collect_params().items():
            p.set_data(start[prefix + k[len(net.prefix):]])
    return net


def _jax_step(net, axes, microbatches):
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    return JaxStep(net, cases._mlm(loss),
                   mesh=jax_make_mesh(devices=jax.devices("cpu")[:4], **axes),
                   optimizer="adam", rules=jax_rules(),
                   pp_microbatches=microbatches,
                   optimizer_params={"learning_rate": cases.STEP_LR})


def _jax_run(start, prefix, axes):
    step = _jax_step(_jax_net(start, prefix), axes, cases.PP_MICROBATCHES)
    losses = [float(np.asarray(step.step(
        nd.array(TOKENS, dtype="int32"), nd.array(TOKENS.astype(np.float32)))))
        for _ in range(cases.STEPS)]
    return np.array(losses), step.state_dict(), step.layout()


def _jax_error(start, prefix, axes, microbatches):
    step = _jax_step(_jax_net(start, prefix), axes, microbatches)
    with pytest.raises(mx.MXNetError) as err:
        step.step(nd.array(TOKENS, dtype="int32"),
                  nd.array(TOKENS.astype(np.float32)))
    return str(err.value)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_pp")
    mx.random.seed(0)
    net = _jax_net()
    start = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    np.savez(out / "start_pp.npz", prefix=np.array(net.prefix),
             tokens=TOKENS, **start)
    wait = cases.start_group(out, 4, "pp", "bert_pretrain_pp")
    jax_ref = {name: _jax_run(start, net.prefix, axes)
               for name, axes in cases.PP_LAYOUTS.items()}
    errors = {"err-micro": _jax_error(start, net.prefix, {"pp": 4}, 3),
              "err-dp": _jax_error(start, net.prefix, {"dp": 2, "pp": 2},
                                   8)}
    assert wait() == 0
    ranks = [dict(np.load(out / f"pp-{r}.npz")) for r in range(4)]
    ranks[0]["bert_pretrain_pp"] = (out / "bert_pretrain_pp-0.txt"
                                    ).read_text()
    return ranks, jax_ref, errors


def _section(got, name, sec):
    key = f"{name}:{sec}/"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("name", list(cases.PP_LAYOUTS))
def test_pipeline_step_matches_jax_step(results, name, rank):
    ranks, jax_ref, _ = results
    got = ranks[rank]
    ref_losses, ref_state, _ = jax_ref[name]
    np.testing.assert_allclose(got[f"{name}:losses"], ref_losses, rtol=TOL,
                               atol=0)
    params = _section(got, name, "params")
    assert set(params) == set(ref_state["params"])
    scale = max(float(np.abs(v).max()) for v in ref_state["params"].values())
    errs = {k: float(np.abs(v - np.asarray(ref_state["params"][k])).max())
            / scale for k, v in params.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", list(cases.PP_LAYOUTS))
def test_pipeline_layout_matches_jax(results, name):
    ranks, jax_ref, _ = results
    mine = ast.literal_eval(str(ranks[0][f"{name}:layout"]))
    theirs = jax_ref[name][2]
    assert mine["mesh_axes"] == theirs["mesh_axes"]
    assert mine["specs"] == theirs["specs"]
    assert mine["plan"]["strategy"] == theirs["plan"]["strategy"]
    assert mine["plan"]["pp_microbatches"] == cases.PP_MICROBATCHES
    assert mine["specs"]["encoder.qkv_weight"] == (
        ["pp", None, "tp", None])


@pytest.mark.parametrize("rank", range(4))
def test_pipeline_apply_matches_the_loop(results, rank):
    got = results[0][rank]
    keys = [k[len("loop-"):] for k in got if k.startswith("loop-")]
    assert {"out", "dx", "dqkv_weight", "dln2_beta"} <= set(keys)
    for k in keys:
        ref = got[f"loop-{k}"]
        err = float(np.abs(got[f"pipe-{k}"] - ref).max())
        assert err <= 1e-6 * max(float(np.abs(ref).max()), 1.0), (k, err)


@pytest.mark.parametrize("tag", ["err-micro", "err-dp"])
def test_microbatch_errors_are_the_jax_messages(results, tag):
    ranks, _, errors = results
    assert str(ranks[0][tag]) == errors[tag]
    assert "divisible" in errors[tag]


def test_bert_pretrain_example_on_dp2_pp2(results):
    """``examples.bert_pretrain --dp 2 --pp 2`` takes ``bert_pp_small``
    with ``bert_pp_sharding_rules`` and 2 microbatches and trains to a
    finite loss."""
    import re

    text = results[0][0]["bert_pretrain_pp"]
    assert "on mesh dp2xsp1xpp2xtp1" in text
    losses = [float(v) for v in re.findall(r"loss[= ]([0-9.]+)", text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
