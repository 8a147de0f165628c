"""Detection training, SSD or Faster-RCNN (BASELINE config 5), the port's
copy of the JAX package's ``examples/train_detection.py`` (reference:
example/ssd/train.py and example/rcnn/train_end2end.py) with the same
arguments and defaults.

    python -m mxnet_tpu_torch.examples.train_detection --model ssd --steps 20
    python -m mxnet_tpu_torch.examples.train_detection --model faster_rcnn
    # detection RecordIO -> ImageDetIter (bbox-aware augmentation) -> SSD:
    python -m mxnet_tpu_torch.examples.train_detection --model ssd \\
        --rec det.rec
    python -m mxnet_tpu_torch.examples.train_detection --model ssd \\
        --make-rec 64
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.examples import context_of
from mxnet_tpu_torch.models import (FasterRCNNTrainLoss, SSDTrainLoss,
                                    faster_rcnn_small, ssd_300)


def _synth_det_rec(n, size, num_classes):
    """Write a synthetic detection RecordIO (random images, 1-2 packed
    det boxes each) in a new temporary directory and return its path."""
    import tempfile

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image.detection import pack_det_label

    d = tempfile.mkdtemp(prefix="det_rec_")
    rec, idx = f"{d}/det.rec", f"{d}/det.idx"
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        arr = rng.randint(0, 255, (size, size, 3), np.uint8)
        objs = [[i % num_classes, 0.2, 0.25, 0.7, 0.75]]
        if i % 2:  # alternate 1/2 boxes so the -1 label padding is real
            objs.append([(i + 1) % num_classes, 0.1, 0.1, 0.45, 0.5])
        header = recordio.IRHeader(
            0, pack_det_label(np.array(objs, np.float32)), i, 0)
        w.write_idx(i, recordio.pack_img(header, arr, quality=90))
    w.close()
    print(f"synthesized {n}-image det RecordIO at {rec}")
    return rec


def _next_batch(it):
    try:
        batch = next(it)
    except StopIteration:
        it.reset()
        try:
            batch = next(it)
        except StopIteration:
            raise SystemExit("--rec file holds no records")
    return batch.data[0], batch.label[0]


def synthetic_batch(model, B, S, ctx):
    """The example's fixed batch: images and the model's labels (SSD:
    normalized corner boxes [cls, x1, y1, x2, y2]; Faster-RCNN: pixel
    boxes and im_info)."""
    x = nd.array(np.random.RandomState(0).rand(B, 3, S, S)
                 .astype(np.float32), ctx=ctx)
    if model == "ssd":
        labels = nd.array(np.tile(
            np.array([[[0, 0.25, 0.25, 0.75, 0.75]]], np.float32),
            (B, 1, 1)), ctx=ctx)
        return x, (labels,)
    gt = nd.array(np.tile(np.array(
        [[[0, S // 4, S // 4, 3 * S // 4, 3 * S // 4]]], np.float32),
        (B, 1, 1)), ctx=ctx)
    im_info = nd.array(np.tile(np.array([[S, S, 1.0]], np.float32),
                               (B, 1)), ctx=ctx)
    return x, (gt, im_info)


def build(model, num_classes, ctx):
    """(net, loss block), Xavier-initialized on ``ctx``."""
    if model == "ssd":
        net = ssd_300(num_classes=num_classes)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        return net, SSDTrainLoss()
    net = faster_rcnn_small(num_classes=num_classes)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net, FasterRCNNTrainLoss(net)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ssd",
                    choices=["ssd", "faster_rcnn"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"])
    ap.add_argument("--rec", default=None,
                    help="detection RecordIO (packed det labels) -> "
                         "ImageDetIter input path; SSD only")
    ap.add_argument("--make-rec", type=int, default=0, metavar="N",
                    help="synthesize an N-image detection RecordIO in a "
                         "temp dir and train from it (SSD only)")
    args = ap.parse_args(argv)
    ctx = context_of(args.device)

    mx.random.seed(0)
    B, S = args.batch_size, args.image_size
    x, labels = synthetic_batch(args.model, B, S, ctx)

    if args.make_rec and not args.rec:
        args.rec = _synth_det_rec(args.make_rec, S, args.num_classes)
    det_iter = None
    if args.rec:
        if args.model != "ssd":
            raise SystemExit("--rec drives the SSD input path")
        from mxnet_tpu_torch.image.detection import (CreateDetAugmenter,
                                                     ImageDetIter)

        # real config-5 preprocessing: bbox-aware mirror + random crop +
        # mean/std normalization (the reference SSD recipe)
        augs = CreateDetAugmenter((3, S, S), rand_mirror=True,
                                  rand_crop=0.5, mean=True, std=True)
        det_iter = ImageDetIter(batch_size=B, data_shape=(3, S, S),
                                path_imgrec=args.rec, shuffle=True,
                                aug_list=augs, ctx=ctx)

    net, loss_block = build(args.model, args.num_classes, ctx)
    if args.model == "ssd":
        if det_iter is not None:
            def forward():
                data, lab = _next_batch(det_iter)
                anchors, cls_preds, box_preds = net(data)
                return loss_block(anchors, cls_preds, box_preds, lab)
        else:
            def forward():
                anchors, cls_preds, box_preds = net(x)
                return loss_block(anchors, cls_preds, box_preds, *labels)
    else:
        def forward():
            return loss_block(x, *labels)

    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    t0 = time.perf_counter()
    first = last = None
    for i in range(args.steps):
        with autograd.record():
            loss = forward()
        loss.backward()
        trainer.step(B)
        # read the loss back only at display cadence: a per-step
        # asnumpy() blocks the dispatch pipeline on every iteration
        if i % 5 == 0 or i == args.steps - 1:
            last = float(loss.asnumpy().mean())
            if first is None:
                first = last
        if i % 5 == 0:
            print(f"step {i}: loss={last:.4f}  "
                  f"{(i + 1) * B / (time.perf_counter() - t0):.1f} img/s",
                  flush=True)
    trainer.drain()
    print(f"throughput {args.steps * B / (time.perf_counter() - t0):.1f} "
          "img/s")
    print(f"{args.model}: loss {first:.4f} -> {last:.4f} "
          f"({args.steps} steps)")
    assert np.isfinite(last)


if __name__ == "__main__":
    main()
