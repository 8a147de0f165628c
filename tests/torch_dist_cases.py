"""Worker bodies of the port's multi-process parity tests.

Run by the port's launcher as a gloo group on the CPU::

    python -m mxnet_tpu_torch.tools.launch -n 4 --force-cpu \\
        python tests/torch_dist_cases.py OUTDIR attention step

Each named case runs on every rank and writes ``OUTDIR/<case>-<rank>.npz``
(rank 0 only, where the ranks hold replicas); the test files hold the
results against the JAX package in the pytest process.  Inputs the JAX
side also needs (weights, batches) are read from ``OUTDIR`` too.
"""
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch.parallel import dist  # noqa: E402

# the attention inputs: N 8, L 64, D 16, from RandomState(0)
ATT_SHAPE = (8, 64, 16)
STEP_LR = 1e-3
STEPS = 2


def attention_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(*ATT_SHAPE).astype(np.float32) for _ in range(4)]


# meshes over permuted device lists: the slices' blocks follow the mesh's
# order, not the process group's (which sorts its ranks)
PERMUTED = {"perm_sp4": ({"sp": 4}, [2, 0, 3, 1]),
            "perm_dp2sp2": ({"dp": 2, "sp": 2}, [1, 0, 3, 2])}


def _attention_routes(mesh):
    from mxnet_tpu_torch.parallel import (ring_self_attention,
                                          ulysses_self_attention)
    from mxnet_tpu_torch.parallel.ring import gather_attention

    return {
        "ring": lambda a, b, c, causal: ring_self_attention(
            mesh, a, b, c, causal=causal),
        "ulysses": lambda a, b, c, causal: ulysses_self_attention(
            mesh, a, b, c, causal=causal),
        "gather": lambda a, b, c, causal: gather_attention(
            a, b, c, causal=causal, mesh=mesh),
    }


def _attention_blocks(mesh, prefix):
    """Every route x causal on this rank's sp block of the inputs."""
    q, k, v, do = attention_inputs()
    coords = mesh.coords()
    sl = coords["sp"]
    n = ATT_SHAPE[1] // mesh.axis_size("sp")
    blk = slice(sl * n, (sl + 1) * n)
    out = {f"{prefix}coords": np.array([coords.get("dp", 0), sl])}
    for name, fn in _attention_routes(mesh).items():
        for causal in (False, True):
            ts = [torch.tensor(x[:, blk]).requires_grad_() for x in (q, k, v)]
            o = fn(*ts, causal)
            o.backward(torch.tensor(do[:, blk]))
            key = f"{prefix}{name}-{int(causal)}"
            out[key + "-out"] = o.detach().numpy()
            for t, g in zip(ts, "qkv"):
                out[f"{key}-d{g}"] = t.grad.numpy()
    return out


def case_attention(outdir, rank):
    """ring / ulysses / gather x causal, each rank its L/4 block; then the
    same on the meshes of ``PERMUTED``."""
    from mxnet_tpu_torch.parallel import make_mesh

    out = _attention_blocks(make_mesh(sp=4), "")
    for name, (axes, devices) in PERMUTED.items():
        out.update(_attention_blocks(make_mesh(devices=devices, **axes),
                                     f"{name}/"))
    np.savez(os.path.join(outdir, f"attention-{rank}.npz"), **out)


def _mlm(loss):
    def mlm(logits, labels):
        return loss(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return mlm


STEP_MESHES = {"dp4": ({}, False), "ring": ({"sp": 2}, True),
               "ulysses": ({"sp": 2}, "ulysses"), "gspmd": ({"sp": 2}, False)}


def case_step(outdir, rank):
    """BERT (bert_small widths) on dp4 and dp2 x sp2 (ring, ulysses, the
    gather): two Adam steps each from the weights in start.npz."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.bert import bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    data = np.load(os.path.join(outdir, "start.npz"))
    prefix = str(data["prefix"])
    start = {k: data[k] for k in data.files if k not in ("prefix", "tokens")}
    tokens = data["tokens"]
    out = {}
    for name, (axes, ring) in STEP_MESHES.items():
        net = bert_small(dropout=0.0, device="cpu", init_weights=False)
        from_mxnet_tpu_params(net, start, prefix)
        step = DataParallelStep(
            net, _mlm(SoftmaxCrossEntropyLoss()), optimizer="adam",
            optimizer_params={"learning_rate": STEP_LR}, device="cpu",
            mesh=make_mesh(**axes), ring_attention=ring)
        out[f"{name}-losses"] = np.array(
            [float(step.step(tokens, tokens.astype(np.float32)))
             for _ in range(STEPS)])
        for k, v in net.state_dict().items():
            out[f"{name}-param-{prefix}{gluon_name(net, k)}"] = v.numpy()
        out[f"{name}-layout"] = np.array(repr(step.layout()))
    out.update(_image_fallback(rank))
    losses, params = wmt_run(make_mesh(sp=2))
    out["wmt-losses"] = losses
    out.update({f"wmt-param-{k}": v for k, v in params.items()})
    if rank == 0:
        np.savez(os.path.join(outdir, f"step-{rank}.npz"), **out)


def wmt_run(mesh=None):
    """The tiny Transformer of train_wmt without dropout, two SGD steps
    on its synthetic batch with padding (label-smoothed cross entropy
    over the non-pad tokens) -> (losses, parameters).  SGD, since the
    attention key biases have a zero gradient in exact arithmetic, which
    Adam would scale up from rounding noise to about lr."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.train_wmt import synthetic_batch
    from mxnet_tpu_torch.models.transformer import (Transformer,
                                                    label_smoothed_ce)
    from mxnet_tpu_torch.parallel import DataParallelStep

    mx.random.seed(0)
    net = Transformer(64, units=32, hidden_size=64, num_heads=4,
                      num_layers=1, dropout=0.0, init_weights=False)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    src, tgt_in, tgt_out = synthetic_batch(np.random.RandomState(0), 4, 6,
                                           64)
    src[:, 4:] = 0  # padded sources: the masks cross the sp blocks
    step = DataParallelStep(net, label_smoothed_ce, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5,
                                              "momentum": 0.9},
                            device="cpu", mesh=mesh)
    losses = [float(step.step((src, tgt_in), tgt_out.astype(np.float32)))
              for _ in range(STEPS)]
    return np.array(losses), {k: v.detach().numpy()
                              for k, v in net.state_dict().items()}


def image_net():
    from mxnet_tpu_torch import gluon, init

    torch.manual_seed(0)
    net = gluon.nn.HybridSequential(prefix="img_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(4, 3, padding=1, in_channels=3),
                gluon.nn.GlobalAvgPool2D(), gluon.nn.Flatten(),
                gluon.nn.Dense(3, in_units=4))
    from mxnet_tpu_torch import context

    net.initialize(init.Xavier(), ctx=context.cpu())
    return net


def image_batch():
    rng = np.random.RandomState(1)
    return (rng.rand(8, 3, 6, 6).astype(np.float32),
            rng.randint(0, 3, 8).astype(np.float32))


def _image_fallback(rank):
    """An NCHW batch on dp2 x sp2: dim 1 (3 channels) does not divide by
    sp, so the batch is split over dp x sp (the JAX step's fallback)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    net = image_net()
    x, y = image_batch()
    step = DataParallelStep(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            device="cpu", mesh=make_mesh(sp=2))
    loss = float(step.step(x, y))
    _, _, sp_active = step._placements((x,), y)
    return {"image-loss": np.array(loss),
            "image-sp_active": np.array(sp_active),
            **{f"image-param-{k}": v.detach().numpy()
               for k, v in net.state_dict().items()}}


def case_kvstore(outdir, rank):
    """The JAX worker's dist_sync checks (tests/dist/
    dist_sync_kvstore_worker.py) and a Trainer over the processes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    cpu = mx.cpu()
    kv = mx.kv.create("dist_sync")
    n, shape = kv.num_workers, (4, 3)
    out = {"num_workers": np.array(n), "rank": np.array(kv.rank)}
    kv.init("a", nd.zeros(shape, ctx=cpu))
    kv.push("a", nd.ones(shape, ctx=cpu) * (rank + 1))
    a = nd.zeros(shape, ctx=cpu)
    kv.pull("a", out=a)
    out["push_sum"] = a.asnumpy()
    kv.init("b", nd.ones(shape, ctx=cpu) * (rank + 7))
    b = nd.zeros(shape, ctx=cpu)
    kv.pull("b", out=b)
    out["init_broadcast"] = b.asnumpy()
    kv2 = mx.kv.create("dist_sync")
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    kv2.init(3, nd.ones(shape, ctx=cpu))
    for _ in range(4):
        kv2.push(3, nd.ones(shape, ctx=cpu) * (rank + 1))
    w = nd.zeros(shape, ctx=cpu)
    kv2.pull(3, out=w)
    out["server_sgd"] = w.asnumpy()
    # many keys in flat buckets of 64 bytes: 3 buckets of 16 floats each
    os.environ["MX_ALLREDUCE_BUCKET_MB"] = str(64 / (1 << 20))
    keys = [10, 11, 12, 13, 14, 15]
    for k in keys:
        kv.init(k, nd.zeros((8,), ctx=cpu))
    out["n_buckets"] = np.array(kv.push_bucketed(
        keys, [nd.ones((8,), ctx=cpu) * (rank + k) for k in keys]))
    del os.environ["MX_ALLREDUCE_BUCKET_MB"]
    pulled = [nd.zeros((8,), ctx=cpu) for _ in keys]
    kv.pull(keys, out=pulled)
    out["bucket_sums"] = np.stack([p.asnumpy() for p in pulled])
    from mxnet_tpu_torch.checkpoint import agree_resume_step

    out["resume_step"] = np.array(agree_resume_step(10 + 5 * rank, kv))
    for name, params in trainer_run(rank, n).items():
        out[f"trainer-{name}"] = params
    kv.barrier()
    np.savez(os.path.join(outdir, f"kvstore-{rank}.npz"), **out)


def trainer_batches():
    rng = np.random.RandomState(2)
    return [(rng.rand(8, 4).astype(np.float32),
             rng.rand(8, 3).astype(np.float32)) for _ in range(3)]


def trainer_run(rank=0, n=1, kvstore="dist_sync"):
    """A Dense(3) trained by Adam for 3 steps on the batches of
    ``trainer_batches``, each process on its n-th of every batch and the
    step's batch size the global one; one process (n 1) takes them whole."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    torch.manual_seed(0)
    net = gluon.nn.Dense(3, in_units=4, prefix="tr_")
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.1}, kvstore=kvstore)
    for x, y in trainer_batches():
        b = x.shape[0] // n
        xs = nd.array(x[rank * b:(rank + 1) * b], ctx=mx.cpu())
        ys = nd.array(y[rank * b:(rank + 1) * b], ctx=mx.cpu())
        with autograd.record():
            loss = ((net(xs) - ys) ** 2).sum()
        loss.backward()
        trainer.step(x.shape[0])
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# tensor parallelism: bert_small on these meshes, from start<V>.npz;
# name -> (mesh axes, vocabulary, clip_global_norm)
TP_LAYOUTS = {"dp2tp2": ({"tp": 2}, 512, None),
              "tp4": ({"tp": 4}, 512, None),
              "tp4_v510": ({"tp": 4}, 510, None),
              "dp2tp2_clip": ({"tp": 2}, 512, 0.5)}
# pipeline parallelism: bert_pp_small from start_pp.npz, 2 microbatches
PP_LAYOUTS = {"dp2pp2": {"pp": 2}, "pp4": {"pp": 4},
              "pp2tp2": {"pp": 2, "tp": 2}}
PP_MICROBATCHES = 2


def _sharded_run(outdir, make, start_file, axes, rules, clip=None,
                 microbatches=4):
    """Two Adam steps of ``make(dropout=0.0)`` from the weights in
    ``start_file`` on ``make_mesh(**axes)`` with ``rules`` -> {losses,
    gathered params, state, layout} (the gathers are collectives)."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    data = np.load(os.path.join(outdir, start_file))
    prefix = str(data["prefix"])
    start = {k: data[k] for k in data.files if k not in ("prefix", "tokens")}
    tokens = data["tokens"]
    vocab = next(v.shape[0] for k, v in start.items()
                 if k.endswith("word_embed_weight"))
    net = make(vocab_size=vocab, dropout=0.0, device="cpu",
               init_weights=False)
    from_mxnet_tpu_params(net, start, prefix)
    step = DataParallelStep(
        net, _mlm(SoftmaxCrossEntropyLoss()), optimizer="adam",
        optimizer_params={"learning_rate": STEP_LR}, device="cpu",
        mesh=make_mesh(**axes), rules=rules, clip_global_norm=clip,
        pp_microbatches=microbatches)
    losses = [float(step.step(tokens, tokens.astype(np.float32)))
              for _ in range(STEPS)]
    state = step.state_dict()
    out = {"losses": np.array(losses), "layout": np.array(repr(step.layout())),
           "collective": np.array(step.snapshot_requires_collective())}
    for sec in ("params", "opt_state"):
        for k, v in state[sec].items():
            out[f"{sec}/{k}"] = np.asarray(v)
    return out


def case_tp(outdir, rank):
    """bert_small on the meshes of ``TP_LAYOUTS`` with
    ``bert_sharding_rules``; rank 0 writes ``tp-0.npz``."""
    from mxnet_tpu_torch.models.bert import bert_sharding_rules, bert_small

    out = {}
    for name, (axes, vocab, clip) in TP_LAYOUTS.items():
        res = _sharded_run(outdir, bert_small, f"start{vocab}.npz", axes,
                           bert_sharding_rules(), clip=clip)
        out.update({f"{name}:{k}": v for k, v in res.items()})
    if rank == 0:
        np.savez(os.path.join(outdir, f"tp-{rank}.npz"), **out)


def _pipeline_vs_loop(outdir, rank):
    """``pipeline_apply`` over the pp4 mesh (one layer a stage) with the
    whole stack on every process, against the loop over the same stack:
    the output, the input's gradient and this stage's rows of the stack's
    gradients, and the two microbatch errors of the scope."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.models.bert_pp import bert_pp_small
    from mxnet_tpu_torch.parallel import make_mesh, pipeline_apply

    data = np.load(os.path.join(outdir, "start_pp.npz"))
    prefix = str(data["prefix"])
    net = bert_pp_small(dropout=0.0, device="cpu", init_weights=False)
    from_mxnet_tpu_params(net, {k: data[k] for k in data.files
                                if k not in ("prefix", "tokens")}, prefix)
    enc = net.encoder
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, 4, 16, 64).astype(np.float32))
    cot = torch.tensor(rng.randn(2, 4, 16, 64).astype(np.float32))
    mesh = make_mesh(pp=4)
    out = {}
    for tag, run in (("loop", None), ("pipe", mesh)):
        xi = x.clone().requires_grad_()
        stack = {k: v.detach().clone().requires_grad_()
                 for k, v in enc.stacked().items()}
        if run is None:
            y = torch.stack([_loop(enc, stack, xi[m]) for m in range(2)])
        else:
            y = pipeline_apply(run, enc._layer, stack, xi)
        (y * cot).sum().backward()
        out[f"{tag}-out"] = y.detach().numpy()
        out[f"{tag}-dx"] = xi.grad.numpy()
        for k, v in stack.items():
            out[f"{tag}-d{k}"] = v.grad[rank].numpy()
    from mxnet_tpu_torch.parallel.scope import pipeline_parallel_scope

    for tag, (axes, m) in {"err-micro": ({"pp": 4}, 3),
                           "err-dp": ({"dp": 2, "pp": 2}, 8)}.items():
        try:
            with pipeline_parallel_scope(make_mesh(**axes),
                                         ("dp",) if "dp" in axes else (),
                                         m):
                enc(torch.zeros(8 // axes.get("dp", 1), 16, 64))
            out[tag] = np.array("")
        except MXNetError as e:
            out[tag] = np.array(str(e))
    return out


def _loop(enc, stack, x):
    for i in range(next(iter(stack.values())).shape[0]):
        x = enc._layer({k: v[i] for k, v in stack.items()}, x)
    return x


def case_pp(outdir, rank):
    """bert_pp_small on the meshes of ``PP_LAYOUTS`` with
    ``bert_pp_sharding_rules``, then :func:`_pipeline_vs_loop`; every rank
    writes ``pp-<rank>.npz``."""
    from mxnet_tpu_torch.models.bert_pp import (bert_pp_sharding_rules,
                                                bert_pp_small)

    out = {}
    for name, axes in PP_LAYOUTS.items():
        res = _sharded_run(outdir, bert_pp_small, "start_pp.npz", axes,
                           bert_pp_sharding_rules(),
                           microbatches=PP_MICROBATCHES)
        out.update({f"{name}:{k}": v for k, v in res.items()})
    out.update(_pipeline_vs_loop(outdir, rank))
    np.savez(os.path.join(outdir, f"pp-{rank}.npz"), **out)


BERT_PRETRAIN_ARGS = ["--steps", "2", "--seq-len", "16", "--device", "cpu"]


def _bert_pretrain(outdir, rank, name, args):
    import contextlib
    import io

    from mxnet_tpu_torch.examples import bert_pretrain

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bert_pretrain.main(args + BERT_PRETRAIN_ARGS)
    if rank == 0:
        with open(os.path.join(outdir, f"{name}-0.txt"), "w") as f:
            f.write(text.getvalue())


def case_bert_pretrain(outdir, rank):
    """``examples.bert_pretrain`` on a dp1 x sp2 mesh (Ulysses) over this
    group; rank 0's output goes to ``bert_pretrain-0.txt``.  The example
    shuts the group down at its end, so this case comes last."""
    _bert_pretrain(outdir, rank, "bert_pretrain",
                   ["--sp", "2", "--sp-attention", "ulysses"])


def case_bert_pretrain_tp(outdir, rank):
    """``examples.bert_pretrain --dp 2 --tp 2`` (last, as above)."""
    _bert_pretrain(outdir, rank, "bert_pretrain_tp",
                   ["--dp", "2", "--tp", "2"])


def case_bert_pretrain_pp(outdir, rank):
    """``examples.bert_pretrain --dp 2 --pp 2`` (last, as above)."""
    _bert_pretrain(outdir, rank, "bert_pretrain_pp",
                   ["--dp", "2", "--pp", "2"])


# ---------------------------------------------------------------------------
# format-2 checkpoints across ranks, resizes and the elastic supervisor
# ---------------------------------------------------------------------------
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "broadcast", "broadcast_object_list",
                "barrier", "reduce", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "gather", "scatter", "send", "recv", "isend", "irecv",
                "batch_isend_irecv")


@contextlib.contextmanager
def counting_collectives(counts):
    """Count every call of a ``torch.distributed`` collective or
    point-to-point function into ``counts`` (name -> calls)."""
    import torch.distributed as tdist

    saved = {n: getattr(tdist, n) for n in _COLLECTIVES if hasattr(tdist, n)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(tdist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(tdist, name, fn)


RESIZE_TOKENS = np.random.RandomState(0).randint(0, 512, (8, 16)).astype(
    np.int32)


def bert_tp_step(outdir, axes, rules=True, start="start512.npz"):
    """(step, tokens): ``bert_small`` from the weights in ``start`` (None:
    seeded, with RESIZE_TOKENS) on ``make_mesh(**axes)``, with
    ``bert_sharding_rules`` when ``rules``, Adam at STEP_LR."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.bert import bert_sharding_rules, bert_small
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    if start is None:
        net = bert_small(vocab_size=512, dropout=0.0, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        tokens = RESIZE_TOKENS
    else:
        data = np.load(os.path.join(outdir, start))
        net = bert_small(vocab_size=512, dropout=0.0, device="cpu",
                         init_weights=False)
        from_mxnet_tpu_params(net, {k: data[k] for k in data.files
                                    if k not in ("prefix", "tokens")},
                              str(data["prefix"]))
        tokens = data["tokens"]
    step = DataParallelStep(
        net, _mlm(SoftmaxCrossEntropyLoss()), optimizer="adam",
        optimizer_params={"learning_rate": STEP_LR}, device="cpu",
        mesh=make_mesh(**axes), rules=bert_sharding_rules() if rules else None)
    return step, tokens


def _flat_state(state, prefix=""):
    return {f"{prefix}{sec}/{k}": np.asarray(v)
            for sec in ("params", "opt_state") for k, v in state[sec].items()}


def case_ckpt_sharded(outdir, rank):
    """bert_small on dp2 x tp2: STEPS Adam steps, each saved in format 2
    to ``port_ckpt`` (rank 0 the leader); the collectives
    ``shard_state_dict`` calls, the payloads it returns and the gathered
    state; then the JAX step's directory ``jax_ckpt`` restored onto dp4
    and tp4.  Every rank writes ``ckpt_sharded-<rank>.npz``."""
    from mxnet_tpu_torch import checkpoint

    step, tokens = bert_tp_step(outdir, {"tp": 2})
    ck = checkpoint.AsyncCheckpointer(os.path.join(outdir, "port_ckpt"),
                                      save_every=1, keep=STEPS,
                                      writer=rank == 0, sharded=True)
    losses = []
    for _ in range(STEPS):
        losses.append(float(step.step(tokens, tokens.astype(np.float32))))
        ck.step(step)
    ck.close()
    counts = {}
    with counting_collectives(counts):
        shard = step.shard_state_dict()
    out = {"losses": np.array(losses),
           "shard_collectives": np.array(sum(counts.values())),
           "shard_rank": np.array(shard["rank"]),
           "shard_nprocs": np.array(shard["nprocs"]),
           "manifest": np.array(json.dumps(shard["manifest"]))}
    for sec in ("params", "opt_state"):
        for k, payloads in shard[sec].items():
            for j, v in payloads:
                out[f"payload/{sec}/{k}#{j}"] = _numpy(v)
    out.update(_flat_state(step.state_dict(), "saved:"))
    # format 1 of a sharded step: every rank joins the gather, rank 0
    # writes; the preemption path's save_now cannot gather, so it writes
    # format 2 whatever the checkpointer's format
    f1 = checkpoint.AsyncCheckpointer(os.path.join(outdir, "port_f1"),
                                      save_every=STEPS + 1,
                                      initial_step=STEPS, writer=rank == 0)
    f1.step(step)
    f1.close()
    pre = checkpoint.AsyncCheckpointer(os.path.join(outdir, "port_pre"),
                                       save_every=100, initial_step=STEPS,
                                       writer=rank == 0)
    # the leader's constructor clears staging dirs: every rank constructs
    # before any writes, as a training loop's steps order them
    dist.barrier()
    out["save_now"] = np.array(pre.save_now(step))
    pre.close()
    for name, axes in (("dp4", ({}, False)), ("tp4", ({"tp": 4}, True))):
        step2, _ = bert_tp_step(outdir, axes[0], rules=axes[1])
        got = checkpoint.restore(os.path.join(outdir, "jax_ckpt"), step2)
        out[f"restored_step:{name}"] = np.array(got)
        out.update(_flat_state(step2.state_dict(), f"{name}:"))
    np.savez(os.path.join(outdir, f"ckpt_sharded-{rank}.npz"), **out)


def _numpy(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _restore_into(outdir, src, axes, rules, tag, out):
    """Restore ``src`` onto ``make_mesh(**axes)``; the gathered state and
    the load's info go to ``out`` under ``tag``."""
    from mxnet_tpu_torch import checkpoint

    step, _ = bert_tp_step(outdir, axes, rules=rules, start=None)
    state = checkpoint.load_checkpoint_state(os.path.join(outdir, src))
    info = step.load_state_dict(
        {"params": state["params"], "opt_state": state["opt_state"]},
        saved_layout=state["layout"])
    out[f"{tag}:info"] = np.array(json.dumps(info))
    out[f"{tag}:step"] = np.array(state["step"])
    out.update(_flat_state(step.state_dict(), f"{tag}:"))
    return step


def case_resize_save2(outdir, rank):
    """Two ranks, tp2: STEPS Adam steps saved in format 2 to ``r2``; the
    gathered state (the oracle) to ``resize_save2-0.npz``."""
    from mxnet_tpu_torch import checkpoint

    step, tokens = bert_tp_step(outdir, {"tp": 2}, start=None)
    ck = checkpoint.AsyncCheckpointer(os.path.join(outdir, "r2"),
                                      save_every=STEPS, writer=rank == 0,
                                      sharded=True)
    for _ in range(STEPS):
        step.step(tokens, tokens.astype(np.float32))
        ck.step(step)
    ck.close()
    out = _flat_state(step.state_dict(), "oracle:")
    if rank == 0:
        np.savez(os.path.join(outdir, f"resize_save2-{rank}.npz"), **out)


def case_resize_2to4(outdir, rank):
    """Four ranks: ``r2`` restored onto dp4 and onto dp2 x tp2; the second
    saved again in format 2 to ``r4`` at the same step."""
    from mxnet_tpu_torch import checkpoint

    out = {}
    _restore_into(outdir, "r2", {}, False, "dp4", out)
    step = _restore_into(outdir, "r2", {"tp": 2}, True, "dp2tp2", out)
    ck = checkpoint.AsyncCheckpointer(os.path.join(outdir, "r4"),
                                      save_every=STEPS,
                                      initial_step=STEPS - 1,
                                      writer=rank == 0, sharded=True)
    ck.step(step)
    ck.close()
    if rank == 0:
        np.savez(os.path.join(outdir, f"resize_2to4-{rank}.npz"), **out)


def case_resize_4to2(outdir, rank):
    """Two ranks: ``r4`` (dp2 x tp2) restored onto tp2 and onto dp2."""
    out = {}
    _restore_into(outdir, "r4", {"tp": 2}, True, "tp2", out)
    _restore_into(outdir, "r4", {}, False, "dp2", out)
    if rank == 0:
        np.savez(os.path.join(outdir, f"resize_4to2-{rank}.npz"), **out)


ELASTIC_TOTAL, ELASTIC_SAVE_EVERY, ELASTIC_PER_RANK = 6, 2, 4


def _elastic_run(outdir, rank, ckdir, tag, demand=None):
    """The elastic worker: a Dense net trained by SGD over ``make_mesh()``
    of every process, ELASTIC_PER_RANK rows a rank of a seeded shuffle
    (``NDArrayIter``, its position in the checkpoint); resumes from the
    gang's common newest scheduled step of ``ckdir`` (or ``demand``),
    whatever world size saved it, and checkpoints in format 2 every
    ELASTIC_SAVE_EVERY steps (rank 0 the leader).  Rank 0 writes the
    final parameters to ``final_<tag>.npz``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, fault, gluon
    from mxnet_tpu_torch.io.io import NDArrayIter
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    world = dist.process_count()
    kv = mx.kv.create("dist_sync")
    rng = np.random.RandomState(0)
    X = rng.randn(96, 4).astype(np.float32)
    Y = X @ np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)
    torch.manual_seed(0)
    net = gluon.nn.Dense(1, in_units=4, prefix="el_")
    net.initialize(mx.init.Normal(0.5), ctx=mx.cpu())
    step = DataParallelStep(net, gluon.loss.L2Loss(), optimizer="sgd",
                            optimizer_params={"learning_rate": 0.05,
                                              "momentum": 0.9},
                            device="cpu", mesh=make_mesh())
    it = NDArrayIter(X, Y, batch_size=ELASTIC_PER_RANK * world,
                     shuffle=True, seed=7, ctx=mx.cpu())
    local = checkpoint.latest_valid_step(ckdir,
                                         multiple_of=ELASTIC_SAVE_EVERY)
    start = checkpoint.agree_resume_step(local, kv)
    if demand is not None:
        start = demand
    if start:
        state = checkpoint.load_checkpoint_state(ckdir, step=start)
        info = step.load_state_dict(
            {"params": state["params"], "opt_state": state["opt_state"]},
            saved_layout=state["layout"])
        it.set_state(state["extra"]["iter"])
        print(f"elastic: rank {rank} resuming at step {start} world "
              f"{world} resharded={info['resharded']} "
              f"old_world={info['old_world']}", flush=True)
    ckpt = checkpoint.AsyncCheckpointer(
        ckdir, save_every=ELASTIC_SAVE_EVERY, keep=100, initial_step=start,
        writer=rank == 0, sharded=True)
    fault.install_preemption_handler(ckpt, step)
    for _ in range(start, ELASTIC_TOTAL):
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            batch = it.next()
        float(step.step(batch.data[0], batch.label[0]))
        ckpt.step(step, extra={"iter": it.get_state()})
    ckpt.close()
    params = step.state_dict()["params"]
    if rank == 0:
        np.savez(os.path.join(outdir, f"final_{tag}.npz"), **params)
    print(f"elastic: rank {rank}/{world} done", flush=True)


def case_elastic(outdir, rank):
    """The elastic run: checkpoints under ``ckpt``."""
    _elastic_run(outdir, rank, os.path.join(outdir, "ckpt"), "elastic")


def case_elastic_baseline(outdir, rank):
    """A fixed gang resumed at ``baseline/resume_step`` from
    ``baseline/ckpt`` (a copy of the elastic run's directory)."""
    base = os.path.join(outdir, "baseline")
    with open(os.path.join(base, "resume_step")) as f:
        demand = int(f.read())
    _elastic_run(outdir, rank, os.path.join(base, "ckpt"), "baseline",
                 demand)


# ---------------------------------------------------------------------------
# the synchronized BatchNorm
# ---------------------------------------------------------------------------
SYNCBN_STEPS = 2
SYNCBN_LR = 0.1


def syncbn_batch():
    """16 NCHW images, deliberately non-iid over the batch (each block of
    4 its own scale and offset), and 5-class labels."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4, 3, 6, 6) * (i + 1) + i
                        for i in range(4)]).astype(np.float32)
    return x, rng.randint(0, 5, 16).astype(np.float32)


def syncbn_net(start, sync=False):
    """Conv2D(8) + BatchNorm (or SyncBatchNorm) + relu + pooling + Dense(5)
    with the weights of ``start`` (Gluon names, prefix ``sbn_``)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm

    net = gluon.nn.HybridSequential(prefix="sbn_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(8, 3, padding=1, in_channels=3),
                SyncBatchNorm(in_channels=8, num_devices=4,
                              prefix="batchnorm0_") if sync
                else gluon.nn.BatchNorm(in_channels=8),
                gluon.nn.Activation("relu"), gluon.nn.GlobalAvgPool2D(),
                gluon.nn.Flatten(), gluon.nn.Dense(5, in_units=8))
    from_mxnet_tpu_params(net, start, "sbn_")
    return net


def torch_bn_net():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(8, 5))


def syncbn_run(net, mesh=None):
    """SYNCBN_STEPS SGD steps on ``syncbn_batch`` -> (losses, state)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import DataParallelStep

    x, y = syncbn_batch()
    step = DataParallelStep(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                            optimizer_params={"learning_rate": SYNCBN_LR,
                                              "momentum": 0.9},
                            device="cpu", mesh=mesh)
    losses = [float(step.step(x, y)) for _ in range(SYNCBN_STEPS)]
    return np.array(losses), step.state_dict()


def case_syncbn(outdir, rank):
    """The net of ``syncbn_net`` on dp4 (BatchNorm, then SyncBatchNorm) and
    on dp2 x sp2 (the NCHW batch split over dp x sp), and the torch
    modules of ``torch_bn_net`` on dp4; rank 0 writes ``syncbn-0.npz``."""
    from mxnet_tpu_torch.parallel import make_mesh

    data = np.load(os.path.join(outdir, "syncbn_start.npz"))
    start = {k: data[k] for k in data.files}
    out = {}
    for name, sync, axes in (("dp4", False, {}), ("dp4_sync", True, {}),
                             ("dp2sp2", False, {"sp": 2})):
        losses, state = syncbn_run(syncbn_net(start, sync),
                                   make_mesh(**axes))
        out[f"{name}:losses"] = losses
        out.update(_flat_state(state, f"{name}:"))
    losses, state = syncbn_run(torch_bn_net(), make_mesh())
    out["torch_bn:losses"] = losses
    out.update(_flat_state(state, "torch_bn:"))
    if rank == 0:
        np.savez(os.path.join(outdir, f"syncbn-{rank}.npz"), **out)


CASES = {"attention": case_attention, "step": case_step,
         "kvstore": case_kvstore, "bert_pretrain": case_bert_pretrain,
         "tp": case_tp, "pp": case_pp,
         "bert_pretrain_tp": case_bert_pretrain_tp,
         "bert_pretrain_pp": case_bert_pretrain_pp,
         "ckpt_sharded": case_ckpt_sharded,
         "resize_save2": case_resize_save2, "resize_2to4": case_resize_2to4,
         "resize_4to2": case_resize_4to2, "elastic": case_elastic,
         "elastic_baseline": case_elastic_baseline, "syncbn": case_syncbn}


def start_group(outdir, n, *names):
    """Launch ``n`` ranks running ``names`` from a thread of the calling
    process (the launcher in-process: no second interpreter to import the
    port); ``wait()`` returns the gang's exit code."""
    import threading

    from mxnet_tpu_torch.tools.launch import launch

    rc = []
    t = threading.Thread(target=lambda: rc.append(launch(
        [sys.executable, os.path.abspath(__file__), str(outdir), *names],
        n, force_cpu=True)), daemon=True)
    t.start()

    def wait(timeout=300):
        t.join(timeout)
        return rc[0] if rc else None

    return wait


def main():
    outdir, names = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)  # four ranks share the host's cores
    dist.init_from_env()
    rank = dist.process_index()
    for name in names:
        CASES[name](outdir, rank)
    if dist.is_initialized():  # a case may have ended the group itself
        dist.barrier()
        dist.shutdown()
    print(f"rank {rank}: {' '.join(names)} OK", flush=True)


if __name__ == "__main__":
    main()
