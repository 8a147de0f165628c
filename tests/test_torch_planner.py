"""The port's planner (``parallel/planner.py``) vs the JAX package's.

For the JAX tests' fixture signatures, a random sweep of signatures and
BERT's own (``signature_of`` the port's ``bert_small`` and the JAX net,
with ``bert_sharding_rules``, and of the pipelined BERT), the port's
``enumerate_plans`` gives the JAX ranking (each plan's JSON) with the
same cost breakdown, ``plan_cost`` the same terms, and ``plan_for`` the
same plan and ``predicted`` for every ``MX_PLAN`` value and the same
errors.  ``compile_step_with_plan`` records the planner's ``predicted``
in its ``plan`` event.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.parallel import planner as jplanner
from mxnet_tpu.parallel.sharding import ShardingRules as JRules
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import planner
from mxnet_tpu_torch.parallel.sharding import ShardingRules

_HW = dict(flops_per_device=1e12, ici_bw=1e11, opt_slots=2.0)


def _pair(rules=None, **kw):
    """The same signature in both packages."""
    jr = None if rules is None else JRules(rules)
    pr = None if rules is None else ShardingRules(rules)
    return (planner.ModelSignature(rules=pr, **kw),
            jplanner.ModelSignature(rules=jr, **kw))


def _norm(cost):
    return json.loads(json.dumps(cost, default=float))


def _same_ranking(mine, theirs):
    assert [c.plan.to_json() for c in mine] == [
        c.plan.to_json() for c in theirs]
    for a, b in zip(mine, theirs):
        assert _norm(a.cost) == _norm(b.cost)


SIGS = {
    "dp_wins": dict(param_shapes={"w": (16, 16)}, batch_shape=(64, 8),
                    flops_per_step=1e9, act_bytes=1e6),
    "tp_wins": dict(rules=[(r"w", (None, "tp"))],
                    param_shapes={"w": (4096, 4096)}, batch_shape=(8,),
                    flops_per_step=1e9, act_bytes=1024.0),
    "memory": dict(rules=[(r"w", (None, "tp"))],
                   param_shapes={"w": (1024, 1024)}, batch_shape=(8,),
                   flops_per_step=1e12, act_bytes=float(1024 * 1024 * 4)),
    "pp": dict(param_shapes={"w": (64, 64)}, batch_shape=(16,),
               stacked_layers=4, flops_per_step=1e9, act_bytes=1e3),
    "override": dict(rules=[(r"w", (None, "tp"))],
                     param_shapes={"w": (64, 64)}, batch_shape=(16, 8),
                     stacked_layers=2, flops_per_step=1e9, act_bytes=1e6),
}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(SIGS))
def test_enumerate_plans_matches_jax(name, n):
    mine, theirs = _pair(**SIGS[name])
    hw_kw = dict(_HW, mem_per_device=3.2 * 1024 * 1024 * 4) \
        if name == "memory" else _HW
    ranked = planner.enumerate_plans(mine, n, hw=planner.Hardware(**hw_kw))
    _same_ranking(ranked, jplanner.enumerate_plans(
        theirs, n, hw=jplanner.Hardware(**hw_kw)))
    assert ranked
    for c in ranked:  # plan_cost is the ranking's breakdown
        assert _norm(planner.plan_cost(mine, c.plan,
                                       planner.Hardware(**hw_kw))) == \
            _norm(c.cost)


def test_random_signatures_match_jax():
    rng = np.random.RandomState(7)
    for _ in range(12):
        n = int(rng.choice([2, 4, 6, 8, 12]))
        batch = int(rng.choice([4, 6, 8, 16, 24]))
        seq = int(rng.choice([0, 4, 8, 12]))
        layers = int(rng.choice([0, 2, 3, 4, 8]))
        dim = int(rng.choice([8, 12, 16]))
        rules = ([(r".*w.*", (None, "tp"))] if rng.rand() < 0.7 else None)
        kw = dict(param_shapes={"w1": (dim, dim), "w2": (dim, dim),
                                "b": (dim,)},
                  batch_shape=(batch, seq) if seq else (batch,),
                  stacked_layers=layers or None)
        mine, theirs = _pair(rules=rules, **kw)
        for micro in (1, 2, 4):
            _same_ranking(
                planner.enumerate_plans(mine, n, microbatches=micro),
                jplanner.enumerate_plans(theirs, n, microbatches=micro))


@pytest.mark.parametrize("strategy", ["auto", "dp", "tp", "pp", "sp",
                                      "ring", "ulysses", "bogus"])
def test_plan_for_and_mx_plan_match_jax(monkeypatch, strategy):
    mine, theirs = _pair(**SIGS["override"])
    monkeypatch.setenv("MX_PLAN", strategy)
    try:
        want = jplanner.plan_for(theirs, 4, hw=jplanner.Hardware(**_HW),
                                 microbatches=2)
    except jmx.MXNetError as e:
        with pytest.raises(MXNetError) as err:
            planner.plan_for(mine, 4, hw=planner.Hardware(**_HW),
                             microbatches=2)
        assert str(err.value) == str(e)
        return
    got = planner.plan_for(mine, 4, hw=planner.Hardware(**_HW),
                           microbatches=2)
    assert got.to_json() == want.to_json()
    assert _norm(got.predicted) == _norm(want.predicted)
    assert got.predicted["override"] == strategy
    # the argument beats the environment
    monkeypatch.setenv("MX_PLAN", "dp")
    assert planner.plan_for(mine, 4, hw=planner.Hardware(**_HW),
                            strategy=strategy,
                            microbatches=2).to_json() == want.to_json()


def test_no_legal_layout_raises_the_jax_error():
    mine, theirs = _pair(param_shapes={"w": (64, 64)}, batch_shape=(5,),
                         flops_per_step=1e9, act_bytes=1e3)
    with pytest.raises(jmx.MXNetError) as e:
        jplanner.plan_for(theirs, 4, hw=jplanner.Hardware(**_HW))
    with pytest.raises(MXNetError) as err:
        planner.plan_for(mine, 4, hw=planner.Hardware(**_HW))
    assert str(err.value) == str(e.value)


@pytest.mark.parametrize("model", ["bert_small", "bert_pp_small"])
def test_signature_of_bert_matches_jax(model):
    """BERT's signature from the port's net and the JAX net (shapes
    materialized by one forward), with its rules, over 4 and 8 devices
    and an H100-like ``Hardware``."""
    from mxnet_tpu import nd
    from mxnet_tpu.models import bert as jbert
    from mxnet_tpu.models import bert_pp as jbert_pp
    from mxnet_tpu_torch.models import bert as pbert
    from mxnet_tpu_torch.models import bert_pp as pbert_pp

    jmod, pmod = ((jbert, pbert) if model == "bert_small"
                  else (jbert_pp, pbert_pp))
    jrules = (jbert.bert_sharding_rules() if model == "bert_small"
              else jbert_pp.bert_pp_sharding_rules())
    prules = ShardingRules(jrules.to_json())
    jnet = getattr(jmod, model)(dropout=0.0)
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(nd.array(np.zeros((8, 16), np.int32), dtype="int32"))
    pnet = getattr(pmod, model)(dropout=0.0, device="cpu")
    shape = (8, 16)
    mine = planner.signature_of(pnet, shape, rules=prules,
                                stacked_layers=getattr(
                                    getattr(pnet, "encoder", None), "_L",
                                    None))
    theirs = jplanner.signature_of(jnet, shape, rules=jrules,
                                   stacked_layers=getattr(
                                       getattr(jnet, "encoder", None), "_L",
                                       None))
    strip = lambda sig, net: {k[len(net.prefix):]: v  # noqa: E731
                              for k, v in sig.param_shapes.items()}
    assert strip(mine, pnet) == strip(theirs, jnet)
    assert (mine.flops_per_step, mine.act_bytes, mine.stacked_layers) == (
        theirs.flops_per_step, theirs.act_bytes, theirs.stacked_layers)
    hw = dict(flops_per_device=989e12, ici_bw=1e11, mem_per_device=80e9)
    for n in (4, 8):
        _same_ranking(planner.enumerate_plans(mine, n,
                                              hw=planner.Hardware(**hw)),
                      jplanner.enumerate_plans(theirs, n,
                                               hw=jplanner.Hardware(**hw)))


def test_compile_step_with_plan_records_predicted(monkeypatch):
    import torch

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import compile_step_with_plan

    sig, _ = _pair(param_shapes={"w": (16, 16)}, batch_shape=(8, 4),
                   flops_per_step=1e9, act_bytes=1e3)
    plan = planner.plan_for(sig, 1, hw=planner.Hardware(**_HW))
    seen = []
    monkeypatch.setattr(telemetry, "enabled", lambda: True)
    monkeypatch.setattr(telemetry, "record",
                        lambda kind, **kw: seen.append((kind, kw)))
    compile_step_with_plan(torch.nn.Linear(4, 2),
                           lambda out, y: (out - y) ** 2, plan,
                           optimizer="sgd", device="cpu")
    events = [kw for kind, kw in seen if kind == "plan"]
    assert len(events) == 1
    assert events[0]["strategy"] == plan.strategy == "dp"
    assert events[0]["predicted"]["step_s"] > 0
    assert events[0]["predicted"]["ranking"][0]["strategy"] == "dp"
