"""The port's example scripts (``python -m mxnet_tpu_torch.examples.*``)
against the JAX package's ``examples/``, on the CPU: ``train_mnist`` here,
``train_wmt`` in ``test_torch_examples_wmt.py``, ``train_imagenet`` and
``train_detection`` in ``test_torch_examples_imagenet.py`` and
``test_torch_examples_detection.py``, the four over
the helpers of ``torch_example_parity.py``.

Each example's model and loss, with the JAX example's weights carried
across (by position in ``collect_params()``, shapes checked), gives the
JAX example's first-step loss on the same batch within 1e-5 of its
magnitude (``train_wmt`` with dropout 0 in both, since the packages' draws
differ).  Each example then runs as a CPU subprocess at
``tests/test_examples_e2e.py``'s small arguments and exits 0; ``--device
auto`` without a card raises naming ``--device cpu``, and ``train_wmt
--dp 2`` names ROADMAP A.9.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import autograd as tag
from torch_example_parity import (CPU, assert_loss_close, carry, jax_example,
                                  run_example)


def test_mnist_first_step_loss_is_the_jax_examples():
    from mxnet_tpu_torch.examples import train_mnist as tex

    jex = jax_example("train_mnist")
    X, y = tex.synthetic_mnist()
    jX, jy = jex.synthetic_mnist()
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    idx = np.random.RandomState(42).permutation(len(X))[:64]
    data, label = X[idx], y[idx]
    jnet = jex.build_net("lenet")
    jmx.random.seed(42)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    tnet = tex.build_net("lenet")
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    tnet.hybridize()
    with jag.record():
        jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jmx.nd.array(data)), jmx.nd.array(label))
    with tag.pause():
        tnet(tmx.nd.array(data[:1], ctx=CPU))  # the deferred shapes
    carry(jnet, tnet)
    with tag.record():
        tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(tmx.nd.array(data, ctx=CPU)), tmx.nd.array(label, ctx=CPU))
    assert_loss_close(float(tloss.asnumpy().mean()),
                      float(jloss.asnumpy().mean()))


def test_train_mnist_runs():
    res = run_example("train_mnist", "--epochs", 2, "--batch-size", 256)
    assert res.returncode == 0, (res.stdout[-1500:], res.stderr[-1500:])
    assert "MNIST example OK" in res.stdout
    assert any(line.startswith("throughput ") for line in
               res.stdout.splitlines())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_auto_without_a_card_names_device_cpu(capsys):
    """No fallback: the default --device auto is the card, and without
    one the script raises before it trains, naming --device cpu."""
    from mxnet_tpu_torch.examples import train_mnist

    with pytest.raises(tmx.MXNetError, match="--device cpu"):
        train_mnist.main(["--epochs", "1"])
    assert "MNIST example OK" not in capsys.readouterr().out
