"""``python -m mxnet_tpu_torch.examples.train_imagenet`` against the JAX
package's ``examples/train_imagenet.py`` on the CPU (helpers and
tolerance: ``torch_example_parity.py``).

The example's net and ``DataParallelStep`` (its first ``step`` returns
the training-mode loss before the update) with the JAX net's weights
carried across, against the JAX net's training-mode logits (one jitted
forward) and the same mean softmax cross entropy, on one batch at
``resnet18_v1`` (the JAX e2e test's model; ``resnet50_v1b``, the default,
is the card's ``examples`` phase); then the ``--rec`` path as a CPU
subprocess at ``tests/test_examples_e2e.py``'s arguments.
"""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from torch_example_parity import CPU, assert_loss_close, carry, run_example


def _mean_ce(logits, labels):
    z = logits.astype(np.float64)
    z = z - z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(labels)), labels.astype(int)].mean())


def test_imagenet_first_step_loss_is_the_jax_nets():
    import torch

    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.examples import train_imagenet as tex
    from torch_zoo_parity import jax_forward

    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 1000, 4).astype(np.float32)
    jnet = jvision.get_model("resnet18_v1")
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    with jag.pause():
        jnet(jmx.nd.array(x[:1]))  # the deferred shapes
    tmx.random.seed(0)
    tnet, step = tex.build("resnet18_v1", CPU)
    tnet.eval()
    with torch.no_grad():
        tnet(torch.from_numpy(x[:1]))
    carry(jnet, tnet)
    want = _mean_ce(jax_forward(jnet, x, train=True), y)
    got = float(step.step(tmx.nd.array(x, ctx=CPU),
                          tmx.nd.array(y, ctx=CPU)))
    assert_loss_close(got, want)


def test_train_imagenet_rec_runs(tmp_path):
    from mxnet_tpu_torch import recordio

    rec = str(tmp_path / "train.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "train.idx"), rec, "w")
    rng = np.random.RandomState(0)
    for i in range(64):
        arr = rng.randint(0, 255, (48, 48, 3), np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i % 5),
                                                           i, 0),
                                         arr, quality=80))
    w.close()
    res = run_example("train_imagenet", "--rec", rec, "--model",
                      "resnet18_v1", "--batch-size", 8, "--image-shape",
                      "3,32,32", "--num-classes", 5, "--steps", 3)
    assert res.returncode == 0, (res.stdout[-1500:], res.stderr[-1500:])
    assert "final loss" in res.stdout, res.stdout[-500:]
