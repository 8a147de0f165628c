"""The port's ``DataParallelStep`` over a mesh of processes vs the JAX
package's over a mesh of devices.

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py step``,
through the port's launcher) trains ``bert_small(dropout=0.0)`` (2 layers,
B 8, T 16, V 512, as ``dryrun_multichip`` sizes it) for 2 Adam steps at lr
1e-3 on dp4 and on dp2 x sp2 with the ring, Ulysses and K/V-gather
attention routes, from the JAX net's weights carried by name.  The JAX
side is its ``DataParallelStep`` on ``make_mesh`` of the same shapes over
4 of the 8 virtual CPU devices.  Losses agree within 1e-5 relative and
every parameter within 1e-5 of its tensor's max |JAX|; dp2 x sp2 agrees
with the port's own one-process step on the global batch within 1e-5
too.  The group also runs an NCHW batch on dp2 x sp2, which falls back to
splitting the batch over dp x sp, and the tiny Transformer of train_wmt
(padded sources, cross-attention, label-smoothed cross entropy over the
non-pad tokens) on dp2 x sp2, each against one process.
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
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOKENS = np.random.RandomState(0).randint(0, 512, (8, 16)).astype(np.int32)
TOL = 1e-5


def _jax_run(start, prefix, axes, ring):
    net = jax_bert_small(dropout=0.0)
    net.initialize(mx.init.Zero())
    net(nd.array(TOKENS, dtype="int32"))
    for k, p in net.collect_params().items():
        p.set_data(start[prefix + k[len(net.prefix):]])
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    step = JaxStep(net, cases._mlm(loss),
                   mesh=jax_make_mesh(devices=jax.devices("cpu")[:4], **axes),
                   optimizer="adam", ring_attention=ring,
                   optimizer_params={"learning_rate": cases.STEP_LR})
    losses = [float(np.asarray(step.step(
        nd.array(TOKENS, dtype="int32"), nd.array(TOKENS.astype(np.float32)))))
        for _ in range(cases.STEPS)]
    return np.array(losses), {prefix + k[len(net.prefix):]: np.asarray(v)
                              for k, v in step.params.items()}


def _port_one_process(start, prefix):
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.bert import bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep

    net = bert_small(dropout=0.0, device="cpu", init_weights=False)
    from_mxnet_tpu_params(net, start, prefix)
    step = DataParallelStep(net, cases._mlm(SoftmaxCrossEntropyLoss()),
                            optimizer="adam", device="cpu",
                            optimizer_params={"learning_rate": cases.STEP_LR})
    losses = [float(step.step(TOKENS, TOKENS.astype(np.float32)))
              for _ in range(cases.STEPS)]
    return np.array(losses), {prefix + gluon_name(net, k): v.numpy()
                              for k, v in net.state_dict().items()}


def _image_one_process():
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import DataParallelStep

    net = cases.image_net()
    x, y = cases.image_batch()
    step = DataParallelStep(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            device="cpu")
    loss = float(step.step(x, y))
    return loss, {k: v.numpy() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_step")
    mx.random.seed(0)
    net = jax_bert_small(dropout=0.0)
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(TOKENS, dtype="int32"))
    start = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    np.savez(out / "start.npz", prefix=np.array(net.prefix), tokens=TOKENS,
             **start)
    wait = cases.start_group(out, 4, "step")
    jax_ref = {name: _jax_run(start, net.prefix, axes, ring)
               for name, (axes, ring) in cases.STEP_MESHES.items()
               if name != "gspmd"}
    one = _port_one_process(start, net.prefix)
    image = _image_one_process()
    assert wait() == 0
    return dict(np.load(out / "step-0.npz")), jax_ref, one, image


def _params(got, name):
    key = f"{name}-param-"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


def _close(losses, params, ref_losses, ref_params):
    """Losses within TOL relative; every parameter within TOL of the
    largest |value| over the reference's parameters (2 Adam steps move a
    parameter by about lr wherever its gradient's sign holds, so a
    gradient that f32 sums round to near zero can move a few 1e-7 of a
    zero-initialized bias either way)."""
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=0)
    assert set(params) == set(ref_params)
    scale = max(float(np.abs(v).max()) for v in ref_params.values())
    errs = {k: float(np.abs(v - ref_params[k]).max()) / scale
            for k, v in params.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", ["dp4", "ring", "ulysses"])
def test_mesh_step_matches_jax_step(results, name):
    got, jax_ref, _, _ = results
    _close(got[f"{name}-losses"], _params(got, name), *jax_ref[name])


@pytest.mark.parametrize("name", ["ring", "ulysses", "gspmd"])
def test_sequence_parallel_step_matches_one_process(results, name):
    got, _, one, _ = results
    _close(got[f"{name}-losses"], _params(got, name), *one)


def test_mesh_step_layout(results):
    got = results[0]
    layout = ast.literal_eval(str(got["ulysses-layout"]))
    assert layout["world_size"] == 4
    assert layout["mesh_axes"] == [["dp", 2], ["pp", 1], ["sp", 2],
                                   ["tp", 1], ["ep", 1]]
    assert layout["device_ids"] == [0, 1, 2, 3]
    assert layout["plan"]["sp_attention"] == "ulysses"
    assert layout["plan"]["strategy"] == "dp+ulysses"
    assert layout["specs"] and all(v == [] for v in layout["specs"].values())


def test_transformer_on_dp_sp_matches_one_process(results):
    got = results[0]
    losses, params = cases.wmt_run()
    _close(got["wmt-losses"], _params(got, "wmt"), losses, params)


def test_image_batch_falls_back_to_dp_times_sp(results):
    got, _, _, (loss, params) = results
    assert not bool(got["image-sp_active"])
    np.testing.assert_allclose(float(got["image-loss"]), loss, rtol=TOL)
    for k, v in params.items():
        err = np.abs(got[f"image-param-{k}"] - v).max() / np.abs(v).max()
        assert err <= TOL, (k, err)
