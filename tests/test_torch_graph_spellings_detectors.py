"""The detectors' graph spellings against the JAX package on the CPU:
``SSD`` and ``FasterRCNN`` export the JAX graphs node for node (op,
attributes, input wiring, variable names; op-node name counters and a
JAX variable's deferred ``__shape__`` aside), and ``SymbolBlock`` of the
port's export, run in both packages, gives the port's eager outputs in
predict mode (rtol 1e-4 / atol 1e-5: five conv layers with BatchNorm);
their training losses, whose JAX bodies read ``.shape`` (or unpack a
Symbol), trace no graph in either package.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import faster_rcnn as jfr
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu_torch.models import faster_rcnn as tfr
from mxnet_tpu_torch.models import ssd as tssd
from test_torch_graph_spellings import CPU, export_and_compare
from torch_fresh_names import fresh_jax_names  # noqa: F401


def test_ssd_exports_and_its_loss_traces_no_graph(tmp_path):
    net = tssd.ssd_300(3, prefix="ssdg_")
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    net(tmx.nd.array(x, ctx=CPU))  # deferred shapes
    with torch.no_grad():
        want = [o.numpy() for o in net.eval()(torch.from_numpy(x))]
    ops = export_and_compare(tmp_path, net, jssd.ssd_300(3, prefix="ssdg_"),
                             ("data",), [x], want, rtol=1e-4, atol=1e-5)
    assert ops.count("_contrib_MultiBoxPrior") == 5
    names = [jmx.sym.var(n) for n in "acbl"]
    with pytest.raises((ValueError, AttributeError)):
        jssd.SSDTrainLoss()(*names)
    with pytest.raises(AttributeError):
        tssd.SSDTrainLoss()(*[tmx.sym.var(n) for n in "acbl"])


def test_faster_rcnn_exports_and_its_loss_traces_no_graph(tmp_path):
    net = tfr.faster_rcnn_small(2, prefix="frg_")
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    x = np.random.RandomState(3).rand(1, 3, 64, 64).astype(np.float32)
    net.detect(tmx.nd.array(x, ctx=CPU))  # deferred shapes, both stages
    with torch.no_grad():
        want = [o.numpy() for o in net.eval()(torch.from_numpy(x))]
    jnet = jfr.faster_rcnn_small(2, prefix="frg_")
    export_and_compare(tmp_path, net, jnet, ("data",), [x], want, rtol=1e-4,
                       atol=1e-5)
    names = ("data", "gt", "im")
    with pytest.raises(AttributeError, match="shape"):
        jfr.FasterRCNNTrainLoss(jnet)(*[jmx.sym.var(n) for n in names])
    with pytest.raises(AttributeError, match="shape"):
        tfr.FasterRCNNTrainLoss(net)(*[tmx.sym.var(n) for n in names])
