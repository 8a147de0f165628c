"""LeNet/MLP MNIST training, the port's copy of the JAX package's
``examples/train_mnist.py`` (reference: example/image-classification/
train_mnist.py) with the same arguments and defaults.  The data is the
synthetic MNIST the JAX script builds (class-conditional blobs, no
download).

    python -m mxnet_tpu_torch.examples.train_mnist [--network lenet|mlp]
        [--epochs 3] [--batch-size 64] [--lr 0.01] [--device auto|cpu]
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.examples import context_of


def build_net(kind):
    net = gluon.nn.HybridSequential()
    if kind == "lenet":
        net.add(
            gluon.nn.Conv2D(20, 5, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Conv2D(50, 5, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(500, activation="relu"),
            gluon.nn.Dense(10),
        )
    else:
        net.add(gluon.nn.Flatten(),
                gluon.nn.Dense(128, activation="relu"),
                gluon.nn.Dense(64, activation="relu"),
                gluon.nn.Dense(10))
    return net


def synthetic_mnist(n=2048):
    """Class-conditional blobs with digit-like structure: enough for the
    convergence smoke this script doubles as (BASELINE config 1)."""
    rng = np.random.RandomState(0)
    X = np.zeros((n, 1, 28, 28), np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        c = y[i]
        cx, cy = 8 + (c % 4) * 4, 8 + (c // 4) * 4
        X[i, 0, cy - 3:cy + 3, cx - 3:cx + 3] = 1.0
        X[i, 0] += rng.randn(28, 28) * 0.15
    return X, y.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="lenet", choices=["lenet", "mlp"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"])
    args = ap.parse_args(argv)
    ctx = context_of(args.device)

    mx.random.seed(42)
    X, y = synthetic_mnist()
    net = build_net(args.network)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()

    B = args.batch_size
    shuffle_rng = np.random.RandomState(42)  # reproducible convergence smoke
    t0, seen = time.perf_counter(), 0
    for epoch in range(args.epochs):
        metric.reset()
        perm = shuffle_rng.permutation(len(X))
        for i in range(0, len(X) - B + 1, B):
            idx = perm[i:i + B]
            data = nd.array(X[idx], ctx=ctx)
            label = nd.array(y[idx], ctx=ctx)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(B)
            metric.update(label, out)
            seen += B
        name, acc = metric.get()
        print(f"Epoch[{epoch}] train-{name}={acc:.4f}", flush=True)
    print(f"throughput {seen / (time.perf_counter() - t0):.1f} img/s")
    assert acc > 0.95, f"failed to converge: {acc}"
    print("MNIST example OK")


if __name__ == "__main__":
    main()
