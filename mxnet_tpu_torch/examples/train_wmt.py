"""Transformer machine-translation training (BASELINE config 4), the
port's copy of the JAX package's ``examples/train_wmt.py`` (reference:
GluonNLP scripts/machine_translation train_transformer.py) with the same
arguments and defaults.

The encoder-decoder Transformer trains with label-smoothed cross entropy
through the fused multi-input ``DataParallelStep`` on one device.  The
default data is a synthetic reverse-copy corpus; point --src/--tgt at
token-id files (one space-separated sentence per line) for real data.
``--dp`` and ``--sp`` above 1 train over a mesh of dp x sp processes, one
card each, which the port's launcher starts (every process builds the
same batch and the step cuts its block; ``--sp`` splits the sequence)::

    python -m mxnet_tpu_torch.examples.train_wmt --model base --steps 30
    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local \
        python -m mxnet_tpu_torch.examples.train_wmt --dp 2 --sp 2
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.examples import context_of
from mxnet_tpu_torch.models.transformer import (Transformer,
                                                label_smoothed_ce,
                                                transformer_base,
                                                transformer_big)
from mxnet_tpu_torch.parallel import DataParallelStep, dist, make_mesh

PAD, BOS, EOS = 0, 1, 2


def synthetic_batch(rng, batch, src_len, vocab):
    src = rng.randint(3, vocab, (batch, src_len)).astype(np.int32)
    tgt_in = np.zeros((batch, src_len + 2), np.int32)
    tgt_out = np.zeros((batch, src_len + 2), np.int32)
    rev = src[:, ::-1]
    tgt_in[:, 0] = BOS
    tgt_in[:, 1:src_len + 1] = rev
    tgt_out[:, :src_len] = rev
    tgt_out[:, src_len] = EOS
    return src, tgt_in, tgt_out


def load_parallel_corpus(src_path, tgt_path, max_len, batch):
    """Token-id files (one space-separated sentence per line) -> one
    padded (src, tgt_in, tgt_out) batch of the first `batch` pairs."""
    def read(path):
        rows = []
        with open(path) as f:
            for line in f:
                toks = [int(t) for t in line.split()][:max_len]
                if toks:
                    rows.append(toks)
        return rows

    s_rows, t_rows = read(src_path), read(tgt_path)
    if len(s_rows) != len(t_rows):
        raise SystemExit(f"corpus length mismatch: {len(s_rows)} src vs "
                         f"{len(t_rows)} tgt sentences")
    n = min(batch, len(s_rows))
    Ls = max(len(r) for r in s_rows[:n])
    Lt = max(len(r) for r in t_rows[:n]) + 2
    src = np.full((n, Ls), PAD, np.int32)
    tgt_in = np.full((n, Lt), PAD, np.int32)
    tgt_out = np.full((n, Lt), PAD, np.int32)
    for i in range(n):
        src[i, :len(s_rows[i])] = s_rows[i]
        tgt_in[i, 0] = BOS
        tgt_in[i, 1:len(t_rows[i]) + 1] = t_rows[i]
        tgt_out[i, :len(t_rows[i])] = t_rows[i]
        tgt_out[i, len(t_rows[i])] = EOS
    return src, tgt_in, tgt_out


def build_net(model, vocab_size):
    """The example's Transformer, its Parameters left for
    ``initialize``."""
    if model == "tiny":
        return Transformer(vocab_size, units=64, hidden_size=128,
                           num_heads=4, num_layers=2, dropout=0.1,
                           init_weights=False)
    make = transformer_base if model == "base" else transformer_big
    return make(vocab_size, init_weights=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="base", choices=["base", "big", "tiny"])
    ap.add_argument("--src", default=None, help="source token-id file")
    ap.add_argument("--tgt", default=None, help="target token-id file")
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--src-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoothing", type=float, default=0.1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"])
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    mesh, rank = None, 0
    if args.dp * args.sp != 1:
        n_dev = args.dp * args.sp
        dist.init_from_env(force_cpu=args.device == "cpu")
        if dist.process_count() != n_dev:
            raise SystemExit(
                f"--dp {args.dp} --sp {args.sp} needs {n_dev} processes, "
                f"have {dist.process_count()}: start them with python -m "
                f"mxnet_tpu_torch.tools.launch -n {n_dev}")
        mesh, rank = make_mesh(sp=args.sp), dist.process_index()
        ctx = (mx.cpu() if args.device == "cpu"
               else mx.gpu(dist.device().index))
    else:
        ctx = context_of(args.device)

    mx.random.seed(0)
    net = build_net(args.model, args.vocab_size)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if args.dtype == "bfloat16":
        net.cast("bfloat16")

    step = DataParallelStep(
        net,
        lambda logits, labels: label_smoothed_ce(logits, labels,
                                                 smoothing=args.smoothing),
        optimizer="adam", optimizer_params={"learning_rate": args.lr},
        device=ctx, mesh=mesh)

    rng = np.random.RandomState(0)
    if args.src and args.tgt:
        src, tgt_in, tgt_out = load_parallel_corpus(
            args.src, args.tgt, args.src_len, args.batch_size)
    else:
        src, tgt_in, tgt_out = synthetic_batch(rng, args.batch_size,
                                               args.src_len, args.vocab_size)
    sb = nd.array(src, ctx=ctx, dtype="int32")
    tb = nd.array(tgt_in, ctx=ctx, dtype="int32")
    lb = nd.array(tgt_out.astype(np.float32), ctx=ctx)

    tokens_per_step = int((tgt_out != PAD).sum())
    t0 = time.perf_counter()
    for i in range(args.steps):
        # lazy AsyncLoss: forced at step 0 (the first step's set-up split
        # off) and at the end
        loss = step.step((sb, tb), lb)
        if i == 0 and rank == 0:
            val = float(loss)
            print(f"step 0: loss={val:.4f} (first step "
                  f"{time.perf_counter() - t0:.1f}s)", flush=True)
            t0 = time.perf_counter()
    step.drain()
    val = float(loss)
    dt = time.perf_counter() - t0
    rate = tokens_per_step * max(args.steps - 1, 1) / dt
    if rank == 0:
        print(f"throughput {rate:.0f} tok/s")
        print(f"final loss {val:.4f}  {rate:.0f} tok/s")
    assert np.isfinite(val)
    if mesh is not None:
        dist.shutdown()


if __name__ == "__main__":
    main()
