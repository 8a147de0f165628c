"""The port's plans, meshes, sharding rules and placements vs the JAX
package's, with no processes.

``Plan`` and its five shims serialize to the JAX ``Plan.to_json()`` and
round-trip; ``validate`` raises the JAX messages; ``make_mesh`` over 8
ranks gives the JAX mesh's axis sizes over 8 virtual devices, ``dp=0``
included; ``ShardingRules.spec_for`` gives the JAX specs for BERT's rules
(``mxnet_tpu/models/bert.py:90``); a placement's block of a global array
is the JAX ``NamedSharding``'s index for the same device.  A tp or pp
step without a process group raises as a dp one does, a plan given with
strategy keywords raises, and the launcher's variables are honored.
"""
import jax
import numpy as np
import pytest

from mxnet_tpu.models.bert import bert_sharding_rules
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu.parallel import plan as jplan
from mxnet_tpu.parallel import sharding as jsharding
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import make_mesh, plan, sharding

CPUS = jax.devices("cpu")[:8]

SHIMS = [
    ("dp_plan", (), {"n_devices": 8}),
    ("dp_plan", (4,), {"accum_steps": 2}),
    ("ring_plan", (2,), {"n_devices": 8}),
    ("ulysses_plan", (4,), {"dp": 2}),
    ("pipeline_plan", (2,), {"microbatches": 8, "n_devices": 8}),
    ("tensor_parallel_plan", None, {"tp": 2, "n_devices": 8}),
]


def _rules(mod):
    return mod.ShardingRules(bert_sharding_rules().to_json()) \
        if mod is sharding else bert_sharding_rules()


@pytest.mark.parametrize("name,args,kwargs", SHIMS)
def test_shim_plans_serialize_as_jax(name, args, kwargs):
    if args is None:  # tensor_parallel_plan(rules, tp, ...)
        mine = plan.tensor_parallel_plan(_rules(sharding), **kwargs)
        theirs = jplan.tensor_parallel_plan(bert_sharding_rules(), **kwargs)
    else:
        mine = getattr(plan, name)(*args, **kwargs)
        theirs = getattr(jplan, name)(*args, **kwargs)
    assert mine.to_json() == theirs.to_json()
    assert plan.Plan.from_json(mine.to_json()) == mine
    assert plan.Plan.from_json(theirs.to_json()).to_json() == mine.to_json()
    assert (mine.strategy, mine.n_devices, mine.describe()) == (
        theirs.strategy, theirs.n_devices, theirs.describe())


@pytest.mark.parametrize("kwargs", [
    {"mesh_axes": (("dp", 2), ("dp", 2))},
    {"mesh_axes": (("dp", 0),)},
    {"mesh_axes": (("dp", 2),), "batch_axes": ("sp",)},
    {"mesh_axes": (("dp", 2),), "seq_axis": 2},
    {"mesh_axes": (("dp", 2),), "sp_attention": "flash"},
    {"mesh_axes": (("dp", 2),), "pp_microbatches": 0},
    {"mesh_axes": (("dp", 2),), "accum_steps": 0},
    {"mesh_axes": (("dp", 2), ("sp", 1)), "sp_attention": "ring"},
])
def test_validate_raises_the_jax_errors(kwargs):
    import mxnet_tpu as jmx

    with pytest.raises(jmx.MXNetError) as theirs:
        jplan.Plan(**kwargs)
    with pytest.raises(MXNetError) as mine:
        plan.Plan(**kwargs)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("axes", [{}, {"sp": 2}, {"tp": 2, "sp": 2},
                                  {"dp": 4, "pp": 2}, {"dp": 0, "sp": 4},
                                  {"ep": 2}])
def test_make_mesh_sizes_match_jax(axes):
    mine = make_mesh(devices=range(8), **axes)
    theirs = jax_make_mesh(devices=CPUS, **axes)
    assert dict(mine.shape) == dict(theirs.shape)
    assert mine.axis_names == theirs.axis_names
    assert [d.id for d in mine.devices.flat] == [
        d.id - CPUS[0].id for d in theirs.devices.flat]
    p = plan.Plan(mesh_axes=tuple(mine.shape.items()))
    assert p.matches_mesh(mine) and p.build_mesh(range(8)) == mine


def test_make_mesh_refuses_what_jax_refuses():
    import mxnet_tpu as jmx

    with pytest.raises(jmx.MXNetError) as theirs:
        jax_make_mesh(sp=3, devices=CPUS)
    with pytest.raises(MXNetError) as mine:
        make_mesh(sp=3, devices=range(8))
    assert str(mine.value) == str(theirs.value)


NAMES = ["bertformlm0_bert_encoder_layer0_attn_qkv_weight",
         "bertformlm0_bert_encoder_layer1_attn_qkv_bias",
         "bertformlm0_bert_encoder_layer0_attn_proj_weight",
         "bertformlm0_bert_encoder_layer0_ffn_ffn1_weight",
         "bertformlm0_bert_encoder_layer0_ffn_ffn2_weight",
         "bertformlm0_bert_word_embed_weight",
         "bertformlm0_decoder_bias", "bertformlm0_bert_embed_ln_gamma"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_spec_for_bert_rules_matches_jax(name, ndim):
    mine = _rules(sharding)
    theirs = bert_sharding_rules()
    assert mine == sharding.ShardingRules.from_json(theirs.to_json())
    assert mine.spec_for(name, ndim) == tuple(theirs.spec_for(name, ndim))


@pytest.mark.parametrize("axes,which,shape", [
    ({"sp": 2}, "seq", (8, 16)), ({"sp": 2}, "seq", (8, 16, 4)),
    ({"sp": 2}, ("dp", "sp"), (8, 3, 6, 6)), ({}, ("dp",), (8, 16)),
    ({"sp": 4}, ("dp",), (8,)), ({"dp": 2, "sp": 2}, ("dp", "sp"), (8,))])
def test_placement_blocks_match_jax_shardings(axes, which, shape):
    mine = make_mesh(devices=range(4), **axes)
    theirs = jax_make_mesh(devices=CPUS[:4], **axes)
    if which == "seq":
        pl = sharding.shard_batch_seq(mine, len(shape))
        js = jsharding.shard_batch_seq(theirs, len(shape))
    else:
        pl = sharding.shard_batch(mine, which, len(shape))
        js = jsharding.shard_batch(theirs, which, len(shape))
    assert pl.spec == tuple(js.spec) + (None,) * (len(shape) - len(js.spec))
    for dev, idx in js.devices_indices_map(shape).items():
        rank = dev.id - CPUS[0].id
        want = tuple(slice(0 if s.start is None else s.start,
                           n if s.stop is None else s.stop)
                     for s, n in zip(idx, shape))
        assert pl.local(shape, rank) == want


def _tiny_step(**kwargs):
    import torch

    from mxnet_tpu_torch.parallel import DataParallelStep

    net = torch.nn.Linear(4, 2)
    return DataParallelStep(net, lambda out, y: (out - y) ** 2,
                            device="cpu", **kwargs)


@pytest.mark.parametrize("axes", [{"tp": 2}, {"pp": 2}])
def test_step_refuses_tensor_and_pipeline_parallelism(axes):
    """tp2 and pp2 steps run over a process group (the gloo tests of
    test_torch_tensor_parallel.py and test_torch_pipeline.py); without one
    they raise as a dp2 step does."""
    with pytest.raises(MXNetError, match="needs a process group") as dp:
        _tiny_step(mesh=make_mesh(devices=range(2)))
    with pytest.raises(MXNetError, match="needs a process group") as err:
        _tiny_step(mesh=make_mesh(devices=range(2), **axes))
    assert str(err.value).split(": start")[1] == str(dp.value).split(
        ": start")[1]


def test_step_refuses_a_plan_with_strategy_keywords():
    p = plan.dp_plan(1)
    with pytest.raises(MXNetError, match="plan= and strategy kwargs"):
        _tiny_step(plan=p, accum_steps=2)
    with pytest.raises(MXNetError, match="ring_attention must be"):
        _tiny_step(mesh=make_mesh(devices=[0]), ring_attention="flash")


def test_one_rank_mesh_step_and_layout():
    import torch

    step = _tiny_step(mesh=make_mesh(devices=[0]), ring_attention=True)
    assert step.plan.sp_attention == "gspmd"  # no sp axis: inert, as JAX
    x = np.ones((4, 4), np.float32)
    assert np.isfinite(float(step.step(x, np.zeros((4, 2), np.float32))))
    layout = step.layout()
    assert layout["world_size"] == 1 and layout["device_ids"] == [0]
    assert layout["plan"] == plan.Plan(
        mesh_axes=tuple(make_mesh(devices=[0]).shape.items())).to_json()
    single = _tiny_step()
    assert single.layout()["plan"] == jplan.Plan(
        mesh_axes=(("dp", 1),), batch_axes=("dp",)).to_json()
    assert isinstance(step.block.weight, torch.nn.Parameter)


def test_scope_refuses_an_unknown_mode():
    from mxnet_tpu_torch.parallel import ring_attention_scope

    with pytest.raises(MXNetError, match="unknown SP attention mode"):
        with ring_attention_scope(make_mesh(devices=[0]), mode="flash"):
            pass


@pytest.mark.parametrize("name", ["MX_COORDINATOR", "MX_RENDEZVOUS_TIMEOUT",
                                  "MX_FORCE_CPU", "DMLC_PS_ROOT_URI",
                                  "DMLC_PS_ROOT_PORT", "MX_LOCAL_RANK",
                                  "MX_ALLREDUCE_BUCKET_MB"])
def test_rendezvous_variables_are_honored(name):
    from mxnet_tpu_torch.env_vars import ENV_VARS

    assert ENV_VARS[name][0] == "honored"
