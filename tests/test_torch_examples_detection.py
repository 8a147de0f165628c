"""``python -m mxnet_tpu_torch.examples.train_detection`` against the JAX
package's ``examples/train_detection.py`` on the CPU (helpers and
tolerance: ``torch_example_parity.py``): the default SSD and
``SSDTrainLoss`` on the example's own batch, recorded, with the JAX
weights carried across, against the JAX example's; then Faster-RCNN and
the detection-RecordIO SSD path as CPU subprocesses at
``tests/test_examples_e2e.py``'s arguments.
"""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import autograd as tag
from torch_example_parity import (CPU, assert_loss_close, carry, jax_example,
                                  run_example)


def test_detection_first_step_loss_is_the_jax_examples():
    from mxnet_tpu_torch.examples import train_detection as tex

    jex = jax_example("train_detection")
    B, S = 4, 96
    x, (labels,) = tex.synthetic_batch("ssd", B, S, CPU)
    jx = np.random.RandomState(0).rand(B, 3, S, S).astype(np.float32)
    np.testing.assert_array_equal(x.asnumpy(), jx)
    jnet = jex.ssd_300(num_classes=1)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    with jag.record():
        a, c, b = jnet(jmx.nd.array(jx))
        jloss = jex.SSDTrainLoss()(a, c, b, jmx.nd.array(labels.asnumpy()))
    tnet, loss_block = tex.build("ssd", 1, CPU)
    with tag.pause():
        tnet(x)  # the deferred shapes
    carry(jnet, tnet)
    with tag.record():
        a, c, b = tnet(x)
        tloss = loss_block(a, c, b, labels)
    assert_loss_close(float(tloss.asnumpy().mean()),
                      float(jloss.asnumpy().mean()))


def test_train_detection_faster_rcnn_runs():
    res = run_example("train_detection", "--model", "faster_rcnn",
                      "--steps", 4, "--image-size", 64, "--batch-size", 2)
    assert res.returncode == 0, (res.stdout[-1500:], res.stderr[-1500:])
    assert "faster_rcnn: loss" in res.stdout, res.stdout[-500:]


def test_train_detection_recordio_runs(tmp_path):
    """The BASELINE config-5 input path: a detection RecordIO ->
    ImageDetIter (bbox-aware augmentation) -> SSD."""
    res = run_example("train_detection", "--model", "ssd", "--make-rec",
                      16, "--steps", 4, "--image-size", 64, "--batch-size",
                      2)
    assert res.returncode == 0, (res.stdout[-1500:], res.stderr[-1500:])
    assert "synthesized 16-image det RecordIO" in res.stdout
    assert "ssd: loss" in res.stdout, res.stdout[-500:]
