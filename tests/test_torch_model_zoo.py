"""``gluon.model_zoo.vision`` of the port against the JAX package's, on the
CPU: the table and its errors, the names of all 36 nets, and one
training step of ResNet V2.

Every one of ``get_model``'s 36 names builds a net whose
``collect_params()`` names (in order) are the JAX net's, on construction,
before any shape is known (the nets' shapes after a forward are held per
family in ``test_torch_zoo_*.py``).  Unknown names and ``pretrained=True``
raise ``MXNetError``; ``register_model`` adds a name; the ``vision``
namespace has every public name of the JAX one.

``resnet18_v2(thumbnail=True, classes=10)`` takes one ``DataParallelStep``
SGD step (lr 0.1, momentum 0.9, wd 1e-4) from the JAX net's weights on an
(8, 3, 32, 32) batch in both packages (the JAX step on a one-device CPU
mesh): the loss within 1e-5 relative; each parameter's update (relative
L2) against the same port step in float64, the port's within 1e-4 and
the JAX step's within 2e-2 (``UPDATE_TOL``); a parameter the float64
step leaves stays bit for bit; the first
BatchNorm's gamma and beta (``scale=False, center=False``,
``grad_req="null"``) are not in the step's parameters and stay 1 and 0,
weight decay included.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import DataParallelStep as JaxDataParallelStep
from mxnet_tpu.parallel import local_mesh
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.parallel import DataParallelStep
from torch_zoo_parity import images, pair

NAMES = sorted(jvision._models)
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# each tensor's update, relative L2, against the same port step in
# float64: the port's f32 step sat within 1.5e-5 of it, the JAX step's
# f32 (XLA's CPU fusions) within 8.1e-3 (a BatchNorm beta of stage 4)
UPDATE_TOL = {"port_vs_float64": 1e-4, "jax_vs_float64": 2e-2}


def test_table_has_the_jax_names():
    assert len(NAMES) == 36
    assert sorted(tvision._models) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_names_match_jax_on_construction(name):
    prefix = name.replace(".", "_") + "_"
    jnet = jvision.get_model(name, prefix=prefix)
    tnet = tvision.get_model(name, prefix=prefix)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert not any(p._inited for p in tnet.collect_params().values())


def test_get_model_errors_and_register_model():
    with pytest.raises(MXNetError, match="not supported"):
        tvision.get_model("resnet19_v3")
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.get_model("alexnet", pretrained=True)
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.get_resnet(2, 18, pretrained=True)
    with pytest.raises(MXNetError, match="version"):
        tvision.get_resnet(3, 18)
    net = tvision.get_model("MobileNet0.25", prefix="case_")
    assert isinstance(net, tvision.MobileNet) and net.prefix == "case_"
    made = []
    tvision.register_model("TinyNet", lambda **kw: made.append(kw) or "net")
    try:
        assert tvision.get_model("tinynet", classes=3) == "net"
        assert made == [{"classes": 3}]
    finally:
        del tvision._models["tinynet"]
    assert tmx.gluon.model_zoo.get_model is tvision.get_model


def test_vision_namespace_has_the_jax_names():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(jvision) - public(tvision) == set()


def _v2_pair():
    x = images(8, 32)
    y = np.random.RandomState(2).randint(0, 10, 8).astype(np.float32)

    def make(v, **kw):
        return v.get_model("resnet18_v2", thumbnail=True, classes=10, **kw)

    jnet, tnet = pair(make, "r18v2_", x)
    return jnet, tnet, x, y


def test_resnet_v2_step_matches_jax_and_keeps_the_fixed_batchnorm():
    jnet, tnet, x, y = _v2_pair()
    prefix = jnet.prefix
    jstep = JaxDataParallelStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        mesh=local_mesh(devices=[jax.devices("cpu")[0]]), optimizer="sgd",
        optimizer_params=SGD)
    jloss = float(np.asarray(jstep.step(jmx.nd.array(x), jmx.nd.array(y))))
    after = {k: np.asarray(v) for k, v in jstep.params.items()}
    before_step = copy.deepcopy(tnet)
    tstep = DataParallelStep(tnet, SoftmaxCrossEntropyLoss(),
                             optimizer="sgd", optimizer_params=SGD,
                             device="cpu")
    tloss = float(tstep.step(torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    fixed = tnet.features[0]
    assert fixed.weight.requires_grad is False
    assert fixed.bias.requires_grad is False
    stepped = {id(p) for p in tstep.params}
    assert id(fixed.weight) not in stepped and id(fixed.bias) not in stepped
    np.testing.assert_array_equal(fixed.weight.detach().numpy(), 1.0)
    np.testing.assert_array_equal(fixed.bias.detach().numpy(), 0.0)
    for name in (prefix + "batchnorm0_gamma", prefix + "batchnorm0_beta"):
        np.testing.assert_array_equal(
            after[name], jnet.collect_params()[name].data().asnumpy())
    tparams = {k: p._reduce().double().numpy()
               for k, p in tnet.collect_params().items()}
    # the yardstick: the same port step in float64
    f64 = copy.deepcopy(before_step).double()
    DataParallelStep(f64, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params=SGD, device="cpu").step(
        torch.from_numpy(x).double(), torch.from_numpy(y).double())
    yard = {k: p._reduce().numpy() for k, p in f64.collect_params().items()}
    moved = 0
    for name, want in after.items():
        start = jnet.collect_params()[name].data().asnumpy()
        norm = float(np.linalg.norm(yard[name] - start))
        if norm == 0.0:
            assert np.array_equal(tparams[name], start), name
            continue
        moved += 1
        port_err = np.linalg.norm(tparams[name] - yard[name]) / norm
        jax_err = np.linalg.norm(want - yard[name]) / norm
        assert port_err <= UPDATE_TOL["port_vs_float64"], (name, port_err)
        assert jax_err <= UPDATE_TOL["jax_vs_float64"], (name, jax_err)
    assert moved > 0.5 * len(after)
