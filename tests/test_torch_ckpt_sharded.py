"""Format-2 checkpoints sharded across the port's processes, against the
JAX package's.

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py
ckpt_sharded``, through the port's launcher) trains ``bert_small``
(vocabulary 512, 2 layers, B 8, T 16) with ``bert_sharding_rules`` on
dp2 x tp2 for 2 Adam steps, each saved in format 2 (rank 0 the leader),
then restores a format-2 directory the JAX step wrote on its own dp2 x tp2
mesh (4 virtual CPU devices, the same weights and batch) onto dp4 and tp4.

Checked: every rank derives the same manifest, owns the blocks the
lowest-rank rule gives it and writes only those (a tp-sharded array is
cut in two, the fused qkv weight is three shards a rank, each its own
slice of the JAX layout), ``shard_state_dict`` calls no collective, the
digests verify; the port's directory restores in the JAX step on dp2 x
tp2 bit for bit against the port's gathered state, the JAX directory in
the port on dp4 and tp4 bit for bit against the JAX gathered state; a
corrupt shard falls back a step and a missing marker invalidates the
step, as in ``tests/test_ckpt_sharded.py``.
"""
import hashlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jax_checkpoint
from mxnet_tpu import gluon, nd
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu.models.bert import bert_sharding_rules as jax_rules
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOKENS = np.random.RandomState(0).randint(0, 512, (8, 16)).astype(np.int32)


def _start():
    mx.random.seed(0)
    net = jax_bert_small(vocab_size=512, dropout=0.0)
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(TOKENS, dtype="int32"))
    return net.prefix, {k: p.data().asnumpy()
                        for k, p in net.collect_params().items()}


def _jax_step(start, prefix, axes):
    net = jax_bert_small(vocab_size=512, dropout=0.0)
    net.initialize(mx.init.Zero())
    net(nd.array(TOKENS, dtype="int32"))
    if start is not None:
        for k, p in net.collect_params().items():
            p.set_data(start[prefix + k[len(net.prefix):]])
    return JaxStep(net, cases._mlm(gluon.loss.SoftmaxCrossEntropyLoss()),
                   mesh=jax_make_mesh(devices=jax.devices("cpu")[:4], **axes),
                   optimizer="adam", rules=jax_rules(),
                   optimizer_params={"learning_rate": cases.STEP_LR})


def _jax_saved(start, prefix, ckdir):
    """The JAX step on dp2 x tp2, STEPS steps, format 2 at the last ->
    its gathered state."""
    step = _jax_step(start, prefix, {"tp": 2})
    ck = jax_checkpoint.AsyncCheckpointer(ckdir, save_every=cases.STEPS,
                                          sharded=True)
    for _ in range(cases.STEPS):
        step.step(nd.array(TOKENS, dtype="int32"),
                  nd.array(TOKENS.astype(np.float32)))
        ck.step(step)
    ck.close()
    return step.state_dict()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_sharded")
    prefix, start = _start()
    np.savez(out / "start512.npz", prefix=np.array(prefix), tokens=TOKENS,
             **start)
    jax_state = _jax_saved(start, prefix, str(out / "jax_ckpt"))
    wait = cases.start_group(out, 4, "ckpt_sharded")
    assert wait() == 0
    ranks = [dict(np.load(out / f"ckpt_sharded-{r}.npz")) for r in range(4)]
    return {"dir": out, "ranks": ranks, "jax": jax_state, "start": start,
            "prefix": prefix}


def _section(got, tag):
    key = f"{tag}:"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


def _assert_state_equal(flat, state):
    """``flat`` ({"params/k": v, "opt_state/k": v}) equals ``state`` bit
    for bit, key for key."""
    want = {f"{sec}/{k}": np.asarray(v)
            for sec in ("params", "opt_state") for k, v in state[sec].items()}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_every_rank_derives_one_manifest_and_calls_no_collective(run):
    manifests = [json.loads(str(r["manifest"])) for r in run["ranks"]]
    assert all(m == manifests[0] for m in manifests)
    for rank, got in enumerate(run["ranks"]):
        assert int(got["shard_collectives"]) == 0
        assert (int(got["shard_rank"]), int(got["shard_nprocs"])) == (rank, 4)
    man = manifests[0]
    saved = _section(run["ranks"][0], "saved")
    for sec in ("params", "opt_state"):
        for k, ent in man[sec].items():
            assert list(ent["shape"]) == list(saved[f"{sec}/{k}"].shape)


def test_owners_and_qkv_shards_in_the_jax_layout(run):
    """dp2 x tp2 (ranks [[0, 1], [2, 3]]): a tp-sharded array is cut in
    two and owned by ranks 0 and 1 (the lowest of each block's replicas);
    the fused qkv weight is three shards a rank, q, k and v rows of its
    heads; a replicated array and Adam's t are rank 0's, whole."""
    man = json.loads(str(run["ranks"][0]["manifest"]))
    params = man["params"]
    qkv = [k for k in params if k.endswith("qkv.weight")]
    assert qkv
    for k in qkv:
        rows, width = params[k]["shape"]
        third = rows // 3
        shards = params[k]["shards"]
        assert len(shards) == 6
        for r in (0, 1):
            mine = [s for s in shards if s["rank"] == r]
            assert [s["j"] for s in mine] == [0, 1, 2]
            half = third // 2
            assert [s["slice"] for s in mine] == [
                [[f * third + r * half, f * third + (r + 1) * half],
                 [0, width]] for f in range(3)]
    embed = [k for k in params if k.endswith("word_embed.weight")][0]
    assert [(s["rank"], s["slice"][0]) for s in params[embed]["shards"]] \
        == [(0, [0, 256]), (1, [256, 512])]
    ln = [k for k in params if k.endswith("ln.gamma")
          or k.endswith("ln1.gamma")][0]
    assert params[ln]["shards"] == [
        {"rank": 0, "j": 0, "slice": [[0, params[ln]["shape"][0]]]}]
    t = man["opt_state"]["t"]
    assert t["shape"] == [] and t["shards"] == [
        {"rank": 0, "j": 0, "slice": []}]
    # the Adam slots follow their parameter's blocks
    assert man["opt_state"][f"mean.{qkv[0]}"]["shards"] == \
        params[qkv[0]]["shards"]


def test_each_rank_writes_only_its_blocks(run):
    """Ranks 2 and 3 own nothing (their blocks are ranks 0 and 1's); each
    payload equals its slice of the gathered state; a tp-sharded array's
    bytes on a rank are half of the whole."""
    man = json.loads(str(run["ranks"][0]["manifest"]))
    saved = _section(run["ranks"][0], "saved")
    for rank, got in enumerate(run["ranks"]):
        payloads = {k[len("payload/"):]: v for k, v in got.items()
                    if k.startswith("payload/")}
        owned = {f"{sec}/{k}#{sh['j']}": (f"{sec}/{k}", sh["slice"])
                 for sec in ("params", "opt_state")
                 for k, ent in man[sec].items() for sh in ent["shards"]
                 if sh["rank"] == rank}
        assert set(payloads) == set(owned)
        assert bool(owned) == (rank < 2)
        for key, (name, sl) in owned.items():
            idx = tuple(slice(a, b) for a, b in sl)
            np.testing.assert_array_equal(payloads[key], saved[name][idx],
                                          err_msg=key)
    d = run["dir"] / "port_ckpt" / f"step-{cases.STEPS}"
    sizes = [os.path.getsize(d / f"params-shard-{r}.nd") for r in (0, 1)]
    assert not (d / "params-shard-2.nd").exists()
    assert abs(sizes[0] - sizes[1]) / sizes[0] < 0.2


def test_digests_verify(run):
    d = run["dir"] / "port_ckpt" / f"step-{cases.STEPS}"
    meta = json.load(open(d / "meta.json"))
    assert meta["format"] == 2 and meta["world_size"] == 4
    assert meta["layout"]["optimizer"] == "adam"
    assert {a: n for a, n in meta["layout"]["mesh_axes"] if n > 1} == {
        "dp": 2, "tp": 2}
    for r in (0, 1):
        marker = json.load(open(d / f"shard-{r}.json"))
        assert marker["rank"] == r and marker["step"] == cases.STEPS
        for fname, want in marker["digests"].items():
            assert hashlib.sha256(open(d / fname, "rb").read()
                                  ).hexdigest() == want, fname
    assert jax_checkpoint.latest_valid_step(str(run["dir"] / "port_ckpt")) \
        == cases.STEPS


def test_port_directory_restores_in_the_jax_step(run):
    step = _jax_step(None, None, {"tp": 2})
    got = jax_checkpoint.restore(str(run["dir"] / "port_ckpt"), step)
    assert got == cases.STEPS
    _assert_state_equal(_section(run["ranks"][0], "saved"), step.state_dict())


@pytest.mark.parametrize("layout", ["dp4", "tp4"])
def test_jax_directory_restores_in_the_port(run, layout):
    got = run["ranks"][0]
    assert int(got[f"restored_step:{layout}"]) == cases.STEPS
    _assert_state_equal(_section(got, layout), run["jax"])


@pytest.mark.parametrize("name,fmt,step", [
    ("port_f1", 1, cases.STEPS + 1), ("port_pre", 2, cases.STEPS)])
def test_gathered_and_preemption_saves_of_a_sharded_step(run, name, fmt,
                                                         step):
    """Format 1 of the dp2 x tp2 step (every rank joins the gather, rank 0
    writes) and the preemption path's ``save_now`` (no gather: format 2
    whatever the checkpointer's format) both restore the saved state."""
    from mxnet_tpu_torch import checkpoint

    d = str(run["dir"] / name)
    meta = json.load(open(os.path.join(d, f"step-{step}", "meta.json")))
    assert int(meta.get("format", 1)) == fmt
    if name == "port_pre":
        assert int(run["ranks"][0]["save_now"]) == step
    state = checkpoint.load_checkpoint_state(d, step=step)
    saved = _section(run["ranks"][0], "saved")
    for sec in ("params", "opt_state"):
        for k, v in state[sec].items():
            got = v.tensor() if hasattr(v, "tensor") else v._data
            np.testing.assert_array_equal(got.float().numpy(),
                                          saved[f"{sec}/{k}"], err_msg=k)


def test_uneven_blocks_keep_their_sizes_in_the_manifest():
    """510 rows over tp4 (blocks of 128, the last 126, GSPMD's ceil cut) on
    dp2 x tp4: the manifest every rank derives from the placement alone
    has those four slices, each owned by the lowest rank of its dp
    replicas, and each owner's payload is its rows."""
    import torch

    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.data_parallel import _owned_blocks
    from mxnet_tpu_torch.parallel.tensor_parallel import ParamShard

    mesh = make_mesh(dp=2, tp=4, devices=range(8))
    sh = ParamShard(mesh, ("tp", None), (510, 8))
    whole = torch.arange(510 * 8, dtype=torch.float32).reshape(510, 8)
    manifests = []
    for r in range(8):
        local = torch.cat([whole[g] for g, _ in sh.blocks(r)])
        shards, payloads = _owned_blocks(sh, local, r)
        manifests.append(shards)
        for j, v in payloads:
            sl = next(s["slice"] for s in shards
                      if s["rank"] == r and s["j"] == j)
            np.testing.assert_array_equal(v, whole[sl[0][0]:sl[0][1]])
        assert bool(payloads) == (r < 4)
    assert all(m == manifests[0] for m in manifests)
    assert [(s["rank"], s["slice"][0]) for s in manifests[0]] == [
        (0, [0, 128]), (1, [128, 256]), (2, [256, 384]), (3, [384, 510])]


def _port_one_process():
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.bert import bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep

    net = bert_small(vocab_size=512, dropout=0.0, device="cpu")
    return DataParallelStep(net, cases._mlm(SoftmaxCrossEntropyLoss()),
                            optimizer="adam", device="cpu")


def _corrupt(path):
    with open(path, "r+b") as f:
        f.truncate(max(os.path.getsize(path) // 2, 16))


def test_corrupt_shard_falls_back_a_step(run, tmp_path):
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.base import MXNetError

    d = str(tmp_path / "c")
    shutil.copytree(run["dir"] / "port_ckpt", d)
    _corrupt(os.path.join(d, f"step-{cases.STEPS}", "params-shard-1.nd"))
    assert checkpoint.latest_valid_step(d) == cases.STEPS - 1
    step = _port_one_process()
    assert checkpoint.restore(d, step) == cases.STEPS - 1
    with pytest.raises(MXNetError):
        checkpoint.restore(d, step, step=cases.STEPS)


def test_missing_marker_invalidates_the_step(run, tmp_path):
    from mxnet_tpu_torch import checkpoint

    d = str(tmp_path / "m")
    shutil.copytree(run["dir"] / "port_ckpt", d)
    os.unlink(os.path.join(d, f"step-{cases.STEPS}", "shard-1.json"))
    assert checkpoint.latest_valid_step(d) == cases.STEPS - 1
    assert jax_checkpoint.latest_valid_step(d) == cases.STEPS - 1


def test_one_process_restore_of_the_sharded_directory(run):
    """The 4-rank directory restored whole into a one-process step (each
    lazy array composed): the gathered state, bit for bit."""
    from mxnet_tpu_torch import checkpoint

    step = _port_one_process()
    assert checkpoint.restore(str(run["dir"] / "port_ckpt"), step) \
        == cases.STEPS
    state = step.state_dict()
    flat = {f"{sec}/{k}": (v.float().numpy() if hasattr(v, "float")
                           and not isinstance(v, np.ndarray) else v)
            for sec in ("params", "opt_state") for k, v in state[sec].items()}
    saved = _section(run["ranks"][0], "saved")
    assert set(flat) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
