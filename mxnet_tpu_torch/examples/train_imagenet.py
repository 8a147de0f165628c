"""ImageNet-style classification training, the port's copy of the JAX
package's ``examples/train_imagenet.py`` (reference:
example/image-classification/train_imagenet.py): a model-zoo net over
``ImageRecordIter`` (.rec) input through the fused ``DataParallelStep``,
with the same arguments and defaults.

    python -m mxnet_tpu_torch.examples.train_imagenet --rec train.rec \\
        --model resnet50_v1b
    python -m mxnet_tpu_torch.examples.train_imagenet --synthetic
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.examples import context_of
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import DataParallelStep


def build(model, ctx, dtype="float32", lr=0.1):
    """The example's net (Xavier-initialized on ``ctx``, cast to
    ``dtype``) and its SGD step."""
    net = vision.get_model(model)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if dtype == "bfloat16":
        net.cast("bfloat16")
    step = DataParallelStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": lr, "momentum": 0.9,
                          "wd": 1e-4}, device=ctx)
    return net, step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec", default=None, help=".rec file (ImageRecordIter)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--model", default="resnet50_v1b")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"],
                    help="auto is the CUDA card (raises without one); cpu "
                         "runs on the CPU")
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    ctx = context_of(args.device)

    shape = tuple(int(s) for s in args.image_shape.split(","))
    mx.random.seed(0)
    net, step = build(args.model, ctx, args.dtype, args.lr)

    if args.rec:
        it = mx.io.ImageRecordIter(
            path_imgrec=args.rec, batch_size=args.batch_size,
            data_shape=shape, shuffle=True, rand_crop=True,
            rand_mirror=True, ctx=ctx)
        # device-side prefetch: decode/augment and the copy of the next
        # batch to the device run in a background thread while the
        # current step computes
        it = mx.io.DevicePrefetchIter(it, step)

        def batches():
            while True:
                for b in it:
                    yield b.data[0], b.label[0]
                it.reset()
    else:
        rng = np.random.RandomState(0)
        x = rng.rand(args.batch_size, *shape).astype(np.float32)
        y = rng.randint(0, args.num_classes,
                        args.batch_size).astype(np.float32)
        xb = nd.array(x, ctx=ctx, dtype=args.dtype)
        yb = nd.array(y, ctx=ctx)

        def batches():
            while True:
                yield xb, yb

    gen = batches()
    t0 = time.perf_counter()
    for i, (data, label) in zip(range(args.steps), gen):
        # step() returns a lazy AsyncLoss: dispatch never blocks, and the
        # loss is only read back at the logging interval below
        loss = step.step(data, label)
        if i % 10 == 0:
            v = float(loss)
            dt = time.perf_counter() - t0
            seen = (i + 1) * args.batch_size
            print(f"step {i}: loss={v:.4f}  {seen / dt:.1f} img/s",
                  flush=True)
    step.drain()  # land (and error-check) every in-flight step
    v = float(loss)
    print(f"throughput {args.steps * args.batch_size / (time.perf_counter() - t0):.1f} img/s")
    print(f"final loss {v:.4f}")
    assert np.isfinite(v)


if __name__ == "__main__":
    main()
