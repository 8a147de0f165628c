"""``HybridBlock.export`` of the port's vision nets against the JAX
package's, on the CPU, as ``test_torch_symbol_block.py`` holds BERT's.

A narrow ResNet V1b (``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64,
128, 256], stride_in_1x1=False)``), the same ResNet V2
(``BottleneckV2``), ``mobilenetv2_0.25``, ``DenseNet(16, 8, (2, 2, 2,
2))`` and ``inceptionv3`` (10 classes each) are built in both packages;
the port's net resolves its shapes on one image and the JAX net takes
its values by ``set_data`` (no JAX forward is needed to export).  Each
exported graph is the JAX one node for node (op, attributes, input
wiring, variable names), with the same heads, argument nodes and graph
attributes, and the two parameter files hold the same keys and values.
The files load both ways: ``SymbolBlock.imports`` of the port's files in
the JAX package and of the JAX files in the port give the port Block's
eval output within 1e-5 of its largest value (ResNet V2).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from torch_zoo_parity import CPU, assert_close, build, images


def _narrow(version):
    def make(v, **k):
        if v is tvision:
            k["init_weights"] = False
        block = v.BottleneckV1 if version == 1 else v.BottleneckV2
        extra = {"stride_in_1x1": False} if version == 1 else {}
        cls = v.ResNetV1 if version == 1 else v.ResNetV2
        return cls(block, [1, 1, 1, 1], [16, 32, 64, 128, 256], classes=10,
                   **extra, **k)
    return make


NETS = {
    "resnet_v1b": (_narrow(1), 32),
    "resnet_v2": (_narrow(2), 32),
    "mobilenetv2_0.25": (lambda v, **k: v.get_model(
        "mobilenetv2_0.25", classes=10, **k), 32),
    "densenet": (lambda v, **k: v.DenseNet(16, 8, (2, 2, 2, 2), classes=10,
                                           **k), 32),
    "inceptionv3": (lambda v, **k: v.get_model("inceptionv3", classes=10,
                                               **k), 299),
}


def _exported(name, tmp_path):
    """Both nets with the port's values, each exported: the two paths,
    the input and the port net."""
    make, res = NETS[name]
    prefix = name.replace(".", "_") + "_"
    jnet, tnet = build(make, prefix)
    x = images(1, res)
    tmx.random.seed(3)
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    tnet.eval()
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    tp = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        p.set_data(tp[k]._reduce().numpy())
    jpath, tpath = str(tmp_path / "jnet"), str(tmp_path / "tnet")
    jnet.export(jpath, 0)
    tnet.export(tpath, 0)
    return jpath, tpath, x, tnet


def _key(n):
    return (n["op"], n["name"] if n["op"] == "null" else None,
            n.get("attrs"), [i[:2] for i in n["inputs"]])


@pytest.mark.parametrize("name", sorted(NETS))
def test_export_is_the_jax_export_node_for_node(name, tmp_path):
    jpath, tpath, _, _ = _exported(name, tmp_path)
    J = json.load(open(f"{jpath}-symbol.json"))
    T = json.load(open(f"{tpath}-symbol.json"))
    assert [_key(n) for n in T["nodes"]] == [_key(n) for n in J["nodes"]]
    assert T["heads"] == J["heads"] and T["arg_nodes"] == J["arg_nodes"]
    assert T["attrs"] == J["attrs"]
    ops = {n["op"] for n in T["nodes"]}
    assert {"Convolution", "BatchNorm"} <= ops
    jp = jmx.nd.load(f"{jpath}-0000.params")
    tp = tmx.nd.load(f"{tpath}-0000.params")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].asnumpy(), jp[k].asnumpy())


def test_exported_files_load_both_ways(tmp_path):
    jpath, tpath, x, tnet = _exported("resnet_v2", tmp_path)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    for path in (jpath, tpath):
        for mx in (tmx, jmx):
            sb = mx.gluon.SymbolBlock.imports(
                f"{path}-symbol.json", ["data"], f"{path}-0000.params",
                ctx=mx.cpu())
            xa = (mx.nd.array(x, ctx=mx.cpu()) if mx is tmx
                  else mx.nd.array(x))
            assert_close(sb(xa).asnumpy(), want, 1e-5)
