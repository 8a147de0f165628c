"""BERT MLM pretraining over a mesh of processes, the port's copy of the
JAX package's ``examples/bert_pretrain.py`` with the same arguments and
defaults (``--sp`` is the port's addition: sequence parallelism, with
``--sp-attention`` picking the route).

One card:  python -m mxnet_tpu_torch.examples.bert_pretrain --steps 20
dp4:       python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local \\
               python -m mxnet_tpu_torch.examples.bert_pretrain --dp 4
dp2 x tp2: ... bert_pretrain --dp 2 --tp 2
dp2 x pp2: ... bert_pretrain --dp 2 --pp 2   (the stacked pp encoder)

Every process builds the same seeded weights and batch; the step cuts
each process's block of the batch and, with the rules, of the weights:
``bert_sharding_rules`` (Megatron tensor parallelism over ``--tp``), or
with ``--pp`` above 1 the pipelined BERT (``BERTForMLMPipelined`` /
``bert_pp_small``) and ``bert_pp_sharding_rules``, as the JAX example
picks them.  ``--sp`` above 1 with ``--tp`` or ``--pp`` above 1 raises
(ROADMAP A.9 part 4).
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.examples import context_of
from mxnet_tpu_torch.models.bert import (bert_base, bert_sharding_rules,
                                         bert_small)
from mxnet_tpu_torch.models.bert_pp import (BERTForMLMPipelined,
                                            bert_pp_sharding_rules,
                                            bert_pp_small)
from mxnet_tpu_torch.parallel import DataParallelStep, dist, make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="small", choices=["small", "base"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--sp-attention", default="ring",
                    choices=["ring", "ulysses", "gather"])
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (uses the stacked pp encoder)")
    ap.add_argument("--pp-microbatches", type=int, default=2)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"])
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")

    n_dev = args.dp * args.sp * args.tp * args.pp
    mesh, rank = None, 0
    if n_dev > 1:
        dist.init_from_env(force_cpu=args.device == "cpu")
        if dist.process_count() != n_dev:
            raise SystemExit(
                f"need {n_dev} processes, have {dist.process_count()}: "
                f"start them with python -m mxnet_tpu_torch.tools.launch "
                f"-n {n_dev}")
        mesh = make_mesh(sp=args.sp, tp=args.tp, pp=args.pp)
        rank = dist.process_index()
        ctx = (mx.cpu() if args.device == "cpu"
               else mx.gpu(dist.device().index))
    else:
        ctx = context_of(args.device)

    mx.random.seed(0)
    if args.pp > 1:
        make = (BERTForMLMPipelined if args.model == "base"
                else bert_pp_small)
        rules = bert_pp_sharding_rules()
    else:
        make = bert_base if args.model == "base" else bert_small
        rules = bert_sharding_rules()
    net = make(dropout=0.0, init_weights=False)
    if args.model != "base":
        args.seq_len = min(args.seq_len, 64)  # small-config max_length
    net.initialize(mx.init.Normal(0.02), ctx=ctx)
    if args.dtype == "bfloat16":
        net.cast("bfloat16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def mlm_loss(logits, labels):
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1))

    ring = {"ring": True, "ulysses": "ulysses",
            "gather": False}[args.sp_attention]
    step = DataParallelStep(net, mlm_loss, optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4},
                            device=ctx, mesh=mesh, ring_attention=ring,
                            rules=rules,
                            pp_microbatches=args.pp_microbatches)
    V = 30522 if args.model == "base" else 512
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, V, (args.batch_size, args.seq_len)).astype(
        np.int32)
    labels = tokens.astype(np.float32)

    t0 = time.perf_counter()
    for i in range(args.steps):
        # lazy AsyncLoss: only the logging interval pays a host readback
        loss = step.step(tokens, labels)
        if i % 5 == 0:
            v = float(loss)
            dt = time.perf_counter() - t0
            toks = (i + 1) * args.batch_size * args.seq_len
            if rank == 0:
                print(f"step {i}: loss={v:.4f}  {toks / dt:.0f} tok/s",
                      flush=True)
    step.drain()
    v = float(loss)
    if rank == 0:
        print(f"final mlm loss {v:.4f} on mesh "
              f"dp{args.dp}xsp{args.sp}xpp{args.pp}xtp{args.tp}")
    assert np.isfinite(v)
    if mesh is not None:
        dist.shutdown()


if __name__ == "__main__":
    main()
