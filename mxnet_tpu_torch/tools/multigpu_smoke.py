"""The multi-card check of the port: BERT-base MLM over a mesh of
processes, one card each.

    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local \\
        python -m mxnet_tpu_torch.tools.multigpu_smoke [--steps 5]

Every rank joins the NCCL group the launcher describes.  First the three
sequence-parallel attention routes are called directly on an sp4 mesh at
BERT-base's attention shape, f32 and bf16, causal and not, against the
plain version over the whole sequence (``ATT_TOL``; the causal gather is
the route whose offsets only a slice of more than one rank exercises).
Then BERT-base (``bert_base(30522, dropout=0.0)``, seeded weights, the
global batch 32 x 512 of ``chip_smoke.py``'s ``train`` phase, Adam at lr
1e-4) trains ``--steps`` steps in f32 and then in bf16 on each layout:
dp4, dp2 x sp2 with the K/V gather (``gspmd``), ring and Ulysses routes,
and with ``bert_sharding_rules`` dp2 x tp2 and tp4 (Megatron tensor
parallelism); then the pipelined BERT (``BERTForMLMPipelined()``, the
same widths) with ``bert_pp_sharding_rules`` and PP_MICRO microbatches
on dp4 (the loop), dp2 x pp2, pp4 and pp2 x tp2.  Each layout's losses
and final parameters (gathered whole, rank 0's) are held against its
model's dp4 run from the same weights: losses within ``LOSS_TOL``
relative, parameters within ``PARAM_TOL`` of the largest |value| of dp4's
and, in f32, within ``UPDATE_TOL`` of dp4's largest change from the
start.  Then the Gluon loop with ``Trainer(kvstore="dist_sync")`` on each
rank's quarter of the batch against ``DataParallelStep`` on dp4 (3
steps).  Recorded: step ms (CUDA-event median of the timed steps, rank 0)
and tokens/s per card, each rank's launches of K1 and K3-K5 (and of the
``wgmma16`` design) over the timed steps (K1 26 and K3-K5 12 a step, on
H/tp heads under tp; under pp K3-K5 L/pp x M and K1 2 + 2 (L/pp) M a
step; the ring's block products are plain torch, so it launches no
K3-K5), the NCCL all-reduce of the step's flat gradient buckets in GB/s
(bus bandwidth, 2 (n - 1) / n of the bytes, over the CUDA-event median of
10), the planner's ranking and predicted breakdown for BERT-base on the
cards (``planner.Hardware`` with the card's 989 TFLOP/s bf16 or 67
TFLOP/s f32, that bus bandwidth and 80 GB) beside the measured step ms of
each layout (read, not gated), and ``nvidia-smi``'s name and power limit
of each card.

Then ``reshard``: BERT-base f32 on dp2 x tp2, 2 Adam steps, a format-2
save (each rank its own blocks) and a format-1 save (gathered) of the same
state, each timed, with the bytes each rank wrote; the format-2 directory
restored onto dp4 and onto tp4 and 2 more steps on each, against the same
layout started from the gathered state (``LOSS_TOL`` / ``PARAM_TOL``).
And ``syncbn``: resnet50_v1b NCHW on dp4 at a global batch of
SYNCBN_BATCH with BatchNorm over the global batch, against one card on
the whole batch, in f64 (``SYNCBN_TOL``) and in f32 (bounded by one
card's own f32 spread from f64), and its f32 step time against dp4 with
each rank's own statistics.  ``--parts`` picks the parts (default all).

Rank 0 prints one JSON line per layout and dtype, then the summary, and
writes it all to ``--out`` (default ``build/multigpu_smoke.json``); the
launcher's exit code is non-zero when a check fails.

Not under the launcher, ``--elastic-drive`` runs the elastic shrink
through the port's launcher: a 4-rank ``--elastic`` gang of BERT-base
(8 x 512 a rank, Adam, format-2 saves every 2 steps) under
``MX_FAULT_SPEC=crash:step=3:rank=3:if-world=4`` shrinks to 3 and resumes
from the step-2 checkpoint; its final parameters must equal, bit for bit,
those of a fixed 3-rank gang resumed from the same checkpoint; the dead
time is reported (``build/multigpu_elastic.json``)::

    python -m mxnet_tpu_torch.tools.multigpu_smoke --elastic-drive
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BERT_VOCAB = 30522
BATCH, SEQ = 32, 512
SEED = 0
LR = 1e-4
# name, model, mesh axes, ring_attention, rules; each layout is held
# against the first of its model
LAYOUTS = (("dp4", "bert", {}, False, None),
           ("gather", "bert", {"sp": 2}, False, None),
           ("ring", "bert", {"sp": 2}, True, None),
           ("ulysses", "bert", {"sp": 2}, "ulysses", None),
           ("dp2tp2", "bert", {"tp": 2}, False, "bert"),
           ("tp4", "bert", {"tp": 4}, False, "bert"),
           ("pp_dp4", "bert_pp", {}, False, "bert_pp"),
           ("dp2pp2", "bert_pp", {"pp": 2}, False, "bert_pp"),
           ("pp4", "bert_pp", {"pp": 4}, False, "bert_pp"),
           ("pp2tp2", "bert_pp", {"pp": 2, "tp": 2}, False, "bert_pp"))
PP_MICRO = 4
LAYERS = 12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# against dp4 from the same weights, where the reduction order of every
# sum differs: the readings on four H100s were 2.05e-7 (f32) and 3.41e-5
# (bf16) on the loss, 1.09e-6 and 7.32e-4 of max |param| on the
# parameters.  A layout whose parameters do not move differs by about
# 5e-4 (Adam at lr 1e-4, 5 steps) and its loss by the 2.8% a step takes
# off; UPDATE_TOL holds the f32 parameters to a fraction of dp4's own
# change (p - p0).  bf16 has no f32 master copy, so its update is mostly
# rounding and is read, not gated: its loss gate does that work.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARAM_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
UPDATE_TOL = {"float32": 1e-2}
# the routes called directly on an sp4 mesh, against the plain version
# over the whole sequence (chip_smoke.py's flash tolerances: f32 absolute;
# 16-bit in ulp_ratio, the wgmma16 design's 0.5, the ring's one rounding
# 1, and 2 for the gather's dk and dv, each a bf16 sum of the slice's
# partial gradients rounded by every rank's K5)
ATT_SHAPE = (96, 512, 64)  # BERT-base's attention at 8 x 512
ATT_TOL = {"out": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
EPS16 = 2.0 ** -7
FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
PER_STEP = {"layer_norm": 26, **{n: 12 for n in FLASH}}


def _smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()


def _mlm_loss():
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    loss = SoftmaxCrossEntropyLoss()

    def mlm(logits, labels):
        return loss(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))

    return mlm


def _batch():
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, BERT_VOCAB, (BATCH, SEQ)).astype(np.int32)
    return torch.from_numpy(tokens), torch.from_numpy(
        tokens.astype(np.float32))


def _model(dtype, kind="bert"):
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.models.bert_pp import BERTForMLMPipelined

    make = bert_base if kind == "bert" else BERTForMLMPipelined
    model = make(BERT_VOCAB, dropout=0.0,
                 generator=torch.Generator().manual_seed(SEED))
    return cast(model, "bfloat16") if dtype == "bfloat16" else model


def _rules(kind):
    """The sharding rules of a layout (None: every parameter whole)."""
    from mxnet_tpu_torch.models.bert import bert_sharding_rules
    from mxnet_tpu_torch.models.bert_pp import bert_pp_sharding_rules

    if kind is None:
        return None
    return (bert_sharding_rules if kind == "bert"
            else bert_pp_sharding_rules)()


def _planner(bus_gb_per_s, measured):
    """The planner's ranking for BERT-base's signature (32 x 512, 12
    stacked layers, ``bert_sharding_rules``) over the cards, for each
    dtype's peak rate, beside the measured median step ms of the layout of
    the same mesh (dp4, dp2 x sp2 as the gather, dp2 x tp2, tp4, dp2 x
    pp2, pp4, pp2 x tp2; the pp ones on the pipelined model)."""
    from mxnet_tpu_torch.models.bert import bert_sharding_rules
    from mxnet_tpu_torch.parallel import dist, planner

    n = dist.process_count()
    model = _model("float32")
    names = {(("dp", 4),): "dp4", (("dp", 2), ("sp", 2)): "gather",
             (("dp", 2), ("tp", 2)): "dp2tp2",
             (("tp", 4),): "tp4", (("dp", 2), ("pp", 2)): "dp2pp2",
             (("pp", 4),): "pp4", (("pp", 2), ("tp", 2)): "pp2tp2"}
    out = {}
    for dtype, nbytes in (("float32", 4), ("bfloat16", 2)):
        sig = planner.signature_of(model, (BATCH, SEQ),
                                   rules=bert_sharding_rules(),
                                   stacked_layers=LAYERS,
                                   bytes_per_param=nbytes)
        hw = planner.Hardware(flops_per_device=PEAK_FLOPS[dtype],
                              ici_bw=bus_gb_per_s * 1e9,
                              mem_per_device=80e9)
        plan = planner.plan_for(sig, n, hw=hw, strategy="auto",
                                microbatches=PP_MICRO)
        rows = []
        for c in planner.enumerate_plans(sig, n, hw=hw,
                                         microbatches=PP_MICRO):
            key = tuple((a, s) for a, s in c.plan.mesh_axes if s > 1)
            layout = names.get(key)
            rows.append({
                "mesh": dict(key), "strategy": c.plan.strategy,
                "predicted_ms": c.step_s * 1e3,
                "predicted_compute_ms": c.cost["compute_s"] * 1e3,
                "predicted_comm_ms": {k: v * 1e3
                                      for k, v in c.cost["comm"].items()},
                "mem_gb": c.cost["mem_bytes"] / 1e9,
                "measured_layout": layout,
                "measured_ms": measured.get(f"{layout}-{dtype}")})
        out[dtype] = {"chosen": plan.strategy,
                      "chosen_mesh": {a: s for a, s in plan.mesh_axes
                                      if s > 1},
                      "ranking": rows}
    del model
    return out


def _per_step(axes, ring):
    """Launches a step of each counted kernel on one rank."""
    pp = axes.get("pp", 1)
    if pp > 1:
        per = LAYERS // pp * PP_MICRO
        return {"layer_norm": 2 + 2 * per, **{n: per for n in FLASH}}
    return {k: (0 if ring is True and k in FLASH else v)
            for k, v in PER_STEP.items()}


def _whole_params(step):
    """Every parameter of the step's block whole, in ``collect_params``
    order, on the card (a sharded one gathered over its slice)."""
    return [step._whole(p._tensor().detach(), p._tensor())
            for p in step.block.collect_params().values()]


def _counters():
    from mxnet_tpu_torch.ops import kernels

    return {n: getattr(kernels, n) for n in ("layer_norm",) + FLASH}


def _run_layout(kind, axes, ring, rules, dtype, steps, tokens, labels):
    """(losses, step ms, launches, wgmma16 launches, parameters, step)."""
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    model = _model(dtype, kind)
    step = DataParallelStep(model, _mlm_loss(), optimizer="adam",
                            optimizer_params={"learning_rate": LR},
                            mesh=make_mesh(**axes), ring_attention=ring,
                            rules=_rules(rules), pp_microbatches=PP_MICRO)
    losses = [float(step.step(tokens, labels))]  # the first: set-up
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for n in FLASH:
        counters[n].launches_wgmma16 = 0
    marks = []
    for _ in range(steps - 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        handle = step.step(tokens, labels)
        b.record()
        marks.append((a, b, handle))
    torch.cuda.synchronize()
    losses += [float(h) for _, _, h in marks]
    ms = [a.elapsed_time(b) for a, b, _ in marks]
    launches = {n: fn.launches for n, fn in counters.items()}
    w16 = {n: counters[n].launches_wgmma16 for n in FLASH}
    return losses, ms, launches, w16, _whole_params(step), step


def _ulp_ratio(got, want):
    """max |got - want| / (2 eps |want| + eps max|want|), bf16's eps."""
    g, w = got.detach().float(), want.detach().float()
    allow = 2 * EPS16 * w.abs() + EPS16 * float(w.abs().max()) + 1e-30
    return float(((g - w).abs() / allow).max())


def _sp_attention():
    """ring, Ulysses and the K/V gather on ``make_mesh(sp=n)``, each rank
    its L/n block of seeded (N, L, D) q, k, v and output cotangent, f32
    and bf16, causal and not: outputs and q/k/v gradients against
    ``flash_attention_ref`` over the whole sequence (autograd), and the
    launches of K3-K5 each call (gather and Ulysses 1, the ring 0).
    Rows: one per route, dtype and causal, with every rank's verdict."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.ops.kernels import flash_attention_ref
    from mxnet_tpu_torch.parallel import (dist, make_mesh,
                                          ring_self_attention,
                                          ulysses_self_attention)
    from mxnet_tpu_torch.parallel.ring import gather_attention

    mesh = make_mesh(sp=dist.process_count())
    sl, n = mesh.axis_index("sp"), mesh.axis_size("sp")
    N, L, D = ATT_SHAPE
    blk = slice(sl * L // n, (sl + 1) * L // n)
    g = torch.Generator().manual_seed(SEED)
    base = [torch.randn(N, L, D, generator=g).to(dist.device())
            for _ in range(4)]
    routes = {
        "ring": lambda c, *a: ring_self_attention(mesh, *a, causal=c),
        "ulysses": lambda c, *a: ulysses_self_attention(mesh, *a, causal=c),
        "gather": lambda c, *a: gather_attention(*a, causal=c, mesh=mesh)}
    counters = _counters()
    rows = []
    for dtype in ("float32", "bfloat16"):
        q, k, v, do = (t.to(getattr(torch, dtype)) for t in base)
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref_out, _ = flash_attention_ref(*leaves, causal)
            want = dict(zip(("out", "dq", "dk", "dv"), (
                ref_out.detach(), *torch.autograd.grad(ref_out, leaves,
                                                       do))))
            want = {key: t[:, blk] for key, t in want.items()}
            for route, fn in routes.items():
                for c in counters.values():
                    c.launches = 0
                mine = [t[:, blk].clone().requires_grad_() for t in (q, k, v)]
                out = fn(causal, *mine)
                grads = torch.autograd.grad(out, mine, do[:, blk])
                torch.cuda.synchronize()
                got = dict(zip(("out", "dq", "dk", "dv"),
                               (out.detach(), *grads)))
                if dtype == "float32":
                    err = {key: float((got[key] - want[key]).abs().max())
                           for key in got}
                    good = all(err[key] <= ATT_TOL[key] for key in err)
                else:
                    err = {key: _ulp_ratio(got[key], want[key])
                           for key in got}
                    gate = {key: 1.0 if route == "ring" else
                            2.0 if route == "gather" and key in ("dk", "dv")
                            else 0.5 for key in got}
                    good = all(err[key] <= gate[key] for key in err)
                launches = {f: counters[f].launches for f in FLASH}
                want_l = 0 if route == "ring" else 1
                good = good and all(x == want_l for x in launches.values())
                flag = torch.tensor([int(good)], device=dist.device())
                tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
                rows.append({"route": route, "dtype": dtype,
                             "causal": causal, "rank0_errors": err,
                             "rank0_launches": launches,
                             "ok": bool(flag.item())})
    return {"shape": ATT_SHAPE, "mesh": dict(mesh.shape), "rows": rows,
            "ok": all(r["ok"] for r in rows)}


def _allreduce_gbps(params):
    """Bus GB/s of the NCCL all-reduce of the step's flat gradient buckets
    (one buffer per bucket of ``bucket_cap_bytes``), CUDA-event median of
    10 rounds."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel import dist

    groups = dist.buckets(params)
    flats = [torch.zeros(sum(params[i].numel() for i in idx),
                         dtype=params[idx[0]].dtype,
                         device=params[idx[0]].device) for idx in groups]
    nbytes = sum(f.numel() * f.element_size() for f in flats)
    n = dist.process_count()
    times = []
    for r in range(12):
        tdist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        works = [tdist.all_reduce(f, async_op=True) for f in flats]
        for w in works:
            w.wait()
        b.record()
        torch.cuda.synchronize()
        if r >= 2:
            times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    return {"buckets": len(flats), "bytes": nbytes, "ms": ms,
            "bus_gb_per_s": 2 * (n - 1) / n * nbytes / (ms * 1e-3) / 1e9}


def _trainer_vs_step(tokens, labels, steps=3):
    """``Trainer(kvstore="dist_sync")`` on each rank's quarter of the batch
    against ``DataParallelStep`` on dp4: (losses of each, max |diff| of the
    parameters over the largest |value|)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.parallel import DataParallelStep, dist, make_mesh

    rank, n = dist.process_index(), dist.process_count()
    b = BATCH // n
    ctx = mx.gpu(dist.device().index)
    net = _model("float32")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": LR}, kvstore="dist_sync")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x = nd.array(tokens[rank * b:(rank + 1) * b].cpu().numpy(), ctx=ctx,
                 dtype="int32")
    y = nd.array(labels[rank * b:(rank + 1) * b].cpu().numpy(), ctx=ctx)
    t_losses = []
    for _ in range(steps):
        with autograd.record():
            out = net(x)
            loss = loss_fn(out.reshape((-1, BERT_VOCAB)), y.reshape((-1,)))
        loss.backward()
        trainer.step(BATCH * SEQ)
        # the global mean: the ranks' sums of per-token losses, summed
        t_losses.append(float(dist.allreduce_sum(
            loss._data.detach().float().sum())) / (BATCH * SEQ))
    trainer.drain()
    ref = _model("float32")
    step = DataParallelStep(ref, _mlm_loss(), optimizer="adam",
                            optimizer_params={"learning_rate": LR},
                            mesh=make_mesh())
    s_losses = [float(step.step(tokens, labels)) for _ in range(steps)]
    scale = max(float(p.detach().abs().max()) for p in ref.parameters())
    err = max(float((a.detach() - b.detach()).abs().max())
              for a, b in zip(net.parameters(), ref.parameters())) / scale
    return t_losses, s_losses, err


RESHARD_STEPS = 2  # before the save, and again after each restore
RESHARD_TARGETS = (("dp4", {}, None), ("tp4", {"tp": 4}, "bert"))
SYNCBN_BATCH, SYNCBN_RES, SYNCBN_STEPS = 128, 224, 2
SYNCBN_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# dp4 with the global statistics against one card on the global batch.
# In f64 they must agree but for the step's f32 update rounding (each
# update is computed in f32): losses within 1e-6 relative, parameters and
# running statistics within 1e-6 of the largest |value|.  In f32 this
# net at its random start is chaotic (two f32 runs of one card that differ
# only in rounding move 3% of max |param| apart in 2 steps on the CPU), so
# dp4's f32 distance from the f64 card must stay within F32_SPREAD times
# one card's f32 distance from it
SYNCBN_TOL = {"loss_rel": 1e-6, "state_of_max": 1e-6}
SYNCBN_F32_SPREAD = 2.0
ELASTIC_TOTAL, ELASTIC_SAVE_EVERY, ELASTIC_PER_RANK = 6, 2, 8
ELASTIC_FAULT = "crash:step=3:rank=3:if-world=4"
# the elastic drive's worker command and extra launcher flags
WORKER = [sys.executable, "-m", "mxnet_tpu_torch.tools.multigpu_smoke"]
LAUNCH_FLAGS = []


def _bert_step(axes, rules):
    from mxnet_tpu_torch.parallel import DataParallelStep, make_mesh

    return DataParallelStep(_model("float32"), _mlm_loss(), optimizer="adam",
                            optimizer_params={"learning_rate": LR},
                            mesh=make_mesh(**axes), rules=_rules(rules))


def _rank_sum(values):
    """Every rank's ``values`` (floats), gathered: [[rank 0's], ...]."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel import dist

    mine = torch.tensor(values, dtype=torch.float64, device=dist.device())
    every = [torch.zeros_like(mine) for _ in range(dist.process_count())]
    tdist.all_gather(every, mine)
    return [[float(v) for v in t] for t in every]


def _timed_save(step, directory, sharded):
    """One scheduled save of ``step`` at RESHARD_STEPS into ``directory``
    (format 2, or format 1 gathered to rank 0), the wall from the call to
    the file on disk -> (seconds, bytes this rank wrote)."""
    import shutil

    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import dist

    rank = dist.process_index()
    if rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    dist.barrier()
    ck = checkpoint.AsyncCheckpointer(directory, save_every=RESHARD_STEPS,
                                      initial_step=RESHARD_STEPS - 1,
                                      writer=rank == 0, sharded=sharded)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    ck.step(step)
    ck.close()
    wall = time.perf_counter() - t0
    dist.barrier()
    d = os.path.join(directory, f"step-{RESHARD_STEPS}")
    names = ([f"params-shard-{rank}.nd", f"optstate-shard-{rank}.nd"]
             if sharded else (["params.nd", "opt_state.nd"] if rank == 0
                              else []))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in names
                 if os.path.exists(os.path.join(d, f)))
    return wall, nbytes


def _reshard(tokens, labels, root):
    """BERT-base f32 on dp2 x tp2 with ``bert_sharding_rules``:
    RESHARD_STEPS Adam steps, a format-2 save (each rank its own blocks,
    no collective) and a format-1 save (gathered) of the same state, each
    timed; then the format-2 directory restored onto dp4 and tp4 and
    RESHARD_STEPS more steps on each, against the same layout started
    from the gathered state (``load_state_dict`` of ``state_dict()``):
    losses and parameters within LOSS_TOL / PARAM_TOL (bit for bit
    expected: the same values on the same layout)."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import dist

    out = {}
    step = _bert_step({"tp": 2}, "bert")
    out["losses"] = [float(step.step(tokens, labels))
                     for _ in range(RESHARD_STEPS)]
    f2 = os.path.join(root, "reshard_format2")
    f2_s, f2_bytes = _timed_save(step, f2, True)
    f1_s, f1_bytes = _timed_save(step, os.path.join(root, "reshard_format1"),
                                 False)
    walls = _rank_sum([f2_s, f1_s, f2_bytes, f1_bytes])
    out["save"] = {
        "format2_s_by_rank": [w[0] for w in walls],
        "format1_s_by_rank": [w[1] for w in walls],
        "format2_s": max(w[0] for w in walls),
        "format1_s": max(w[1] for w in walls),
        "format2_bytes_by_rank": [int(w[2]) for w in walls],
        "format1_bytes_by_rank": [int(w[3]) for w in walls]}
    meta = json.load(open(os.path.join(f2, f"step-{RESHARD_STEPS}",
                                       "meta.json")))
    ent = meta["manifest"]["params"]
    big = max((k for k in ent if len(ent[k]["shards"]) > 1),
              key=lambda k: math.prod(ent[k]["shape"]))
    whole = math.prod(ent[big]["shape"])
    share = {}
    for sh in ent[big]["shards"]:
        vol = math.prod(b - a for a, b in sh["slice"])
        share[sh["rank"]] = share.get(sh["rank"], 0) + vol / whole
    out["largest_sharded"] = {"name": big, "shape": ent[big]["shape"],
                              "share_by_rank": share}
    gathered = step.state_dict()
    del step
    torch.cuda.empty_cache()
    ok = True
    for name, axes, rules in RESHARD_TARGETS:
        runs = {}
        for how in ("restored", "gathered"):
            s2 = _bert_step(axes, rules)
            if how == "restored":
                t0 = time.perf_counter()
                got = checkpoint.restore(f2, s2)
                restore_s = time.perf_counter() - t0
            else:
                got = RESHARD_STEPS
                s2.load_state_dict(gathered)
            counters = _counters()
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            losses = [float(s2.step(tokens, labels))
                      for _ in range(RESHARD_STEPS)]
            launches = {k: fn.launches for k, fn in counters.items()}
            runs[how] = (got, losses, _whole_params(s2), launches)
            del s2
            torch.cuda.empty_cache()
        (got, losses, params, launches), (_, ref_losses, ref_params, _) = \
            runs["restored"], runs["gathered"]
        want = {k: v * RESHARD_STEPS for k, v in PER_STEP.items()}
        by_rank = [dict(zip(PER_STEP, map(int, c))) for c in _rank_sum(
            [launches[k] for k in PER_STEP])]
        scale = max(float(p.abs().max()) for p in ref_params)
        row = {"restored_step": got, "restore_s": restore_s,
               "losses": losses, "gathered_losses": ref_losses,
               "loss_rel_err": max(abs(a - b) / abs(b)
                                   for a, b in zip(losses, ref_losses)),
               "param_err_of_max": max(
                   float((a.float() - b.float()).abs().max())
                   for a, b in zip(params, ref_params)) / scale,
               "bitwise": losses == ref_losses and all(
                   bool(torch.equal(a, b))
                   for a, b in zip(params, ref_params)),
               "launches_by_rank": by_rank, "launches_expected": want}
        row["ok"] = bool(got == RESHARD_STEPS
                         and all(r == want for r in by_rank)
                         and row["loss_rel_err"] <= LOSS_TOL["float32"]
                         and row["param_err_of_max"]
                         <= PARAM_TOL["float32"])
        ok = ok and row["ok"]
        out[name] = row
        del runs
    out["ok"] = ok
    if dist.process_index() == 0:
        import shutil

        shutil.rmtree(f2, ignore_errors=True)
        shutil.rmtree(os.path.join(root, "reshard_format1"),
                      ignore_errors=True)
    return out


def _resnet_step(mesh, dtype="float32"):
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.resnet import resnet50_v1b
    from mxnet_tpu_torch.parallel import DataParallelStep

    model = resnet50_v1b(layout="NCHW",
                         generator=torch.Generator().manual_seed(SEED))
    return DataParallelStep(cast(model, dtype), SoftmaxCrossEntropyLoss(),
                            optimizer="sgd", optimizer_params=SYNCBN_SGD,
                            mesh=mesh)


def _resnet_timed(step, x, y):
    """SYNCBN_STEPS steps -> (losses, CUDA-event ms of each)."""
    marks = []
    for _ in range(SYNCBN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        h = step.step(x, y)
        b.record()
        marks.append((a, b, h))
    torch.cuda.synchronize()
    return [float(h) for _, _, h in marks], [a.elapsed_time(b)
                                             for a, b, _ in marks]


def _resnet_run(mesh, dtype, x, y):
    """(losses, step ms, float state in f64) of SYNCBN_STEPS steps."""
    step = _resnet_step(mesh, dtype)
    losses, ms = _resnet_timed(step, x.to(getattr(torch, dtype)), y)
    state = {k: v.detach().double() for k, v in step.block.state_dict().items()
             if v.is_floating_point()}
    del step
    torch.cuda.empty_cache()
    return losses, ms, state


def _state_err(a, b, ref):
    """max |a - b| over the parameters and over the running statistics,
    each of the largest |value| of ``ref``'s."""
    out = {}
    for tag, pick in (("param", lambda k: "running" not in k),
                      ("running", lambda k: "running" in k)):
        keys = [k for k in ref if pick(k)]
        scale = max(float(ref[k].abs().max()) for k in keys)
        out[tag] = max(float((a[k] - b[k]).abs().max()) for k in keys) / scale
    return out


def _syncbn():
    """resnet50_v1b NCHW on dp4 at a global batch of SYNCBN_BATCH x 224^2,
    SYNCBN_STEPS SGD steps, BatchNorm over the global batch, against one
    card (rank 0, no mesh) on the whole batch: in f64 within SYNCBN_TOL;
    in f32 dp4's distance from the f64 card within SYNCBN_F32_SPREAD times
    the one-card f32 run's.  Then the dp4 f32 step's time against the same
    step with the local statistics (the batch reduction hidden from
    BatchNorm: each rank's own block, the JAX step's semantics lost), the
    synchronized BatchNorm's cost."""
    from mxnet_tpu_torch.parallel import dist, make_mesh, scope

    rank = dist.process_index()
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.rand(SYNCBN_BATCH, 3, SYNCBN_RES,
                                  SYNCBN_RES)).to(dist.device())
    y = torch.from_numpy(rng.randint(0, 1000, SYNCBN_BATCH).astype(
        np.float32)).to(dist.device())
    torch.backends.cudnn.benchmark = False
    out = {"batch": SYNCBN_BATCH}
    runs = {}
    for dtype in ("float64", "float32"):
        runs[f"dp4_{dtype}"] = _resnet_run(make_mesh(), dtype, x, y)
        if rank == 0:
            runs[f"one_{dtype}"] = _resnet_run(None, dtype, x, y)
        dist.barrier()
    ok = True
    if rank == 0:
        truth = runs["one_float64"]
        for dtype in ("float64", "float32"):
            dp, one = runs[f"dp4_{dtype}"], runs[f"one_{dtype}"]
            row = {"losses": dp[0], "one_card_losses": one[0],
                   "step_ms": dp[1], "one_card_step_ms": one[1],
                   "loss_rel_err": max(abs(a - b) / abs(b)
                                       for a, b in zip(dp[0], one[0])),
                   "err_of_max": _state_err(dp[2], one[2], one[2])}
            if dtype == "float64":
                row["ok"] = bool(
                    row["loss_rel_err"] <= SYNCBN_TOL["loss_rel"]
                    and max(row["err_of_max"].values())
                    <= SYNCBN_TOL["state_of_max"])
            else:
                row["dp4_from_f64"] = _state_err(dp[2], truth[2], truth[2])
                row["one_card_from_f64"] = _state_err(one[2], truth[2],
                                                      truth[2])
                row["ok"] = all(
                    row["dp4_from_f64"][k]
                    <= SYNCBN_F32_SPREAD * row["one_card_from_f64"][k] + 1e-6
                    for k in ("param", "running"))
            out[dtype] = row
            ok = ok and row["ok"]
    del runs
    torch.cuda.empty_cache()
    # the cost: timed f32 steps with and without the global statistics
    timing = {}
    xf = x.float()
    for tag in ("global", "local"):
        step = _resnet_step(make_mesh())
        orig = scope.batch_reduction
        if tag == "local":
            scope.batch_reduction = lambda: None
        try:
            step.step(xf, y)
            _, t = _resnet_timed(step, xf, y)
        finally:
            scope.batch_reduction = orig
        timing[f"{tag}_ms"] = statistics.median(t)
        del step
        torch.cuda.empty_cache()
    out.update(timing)
    out["sync_cost_ms"] = timing["global_ms"] - timing["local_ms"]
    good = _rank_sum([1.0 if ok else 0.0])
    out["ok"] = all(g[0] == 1.0 for g in good)
    return out


def _elastic_batch(i, world):
    """Step ``i``'s global token batch: ELASTIC_PER_RANK rows a rank of
    the world, the same whoever runs it."""
    rng = np.random.RandomState(SEED + i)
    return torch.from_numpy(rng.randint(
        0, BERT_VOCAB, (ELASTIC_PER_RANK * world, SEQ)).astype(np.int32))


def _elastic_worker(root, tag, demand=None):
    """One rank of the elastic gang: BERT-base f32 on ``make_mesh()`` of
    every process, Adam, ELASTIC_TOTAL steps from the gang's common newest
    scheduled step of ``root/ckpt`` (or ``demand``), a format-2 save every
    ELASTIC_SAVE_EVERY (rank 0 the leader).  Rank 0 prints each step's
    end (host clock) and writes the final parameters to
    ``root/final_<tag>.pt``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, fault
    from mxnet_tpu_torch.parallel import DataParallelStep, dist, make_mesh

    rank, world = dist.process_index(), dist.process_count()
    ckdir = os.path.join(root, "ckpt")
    step = DataParallelStep(_model("float32"), _mlm_loss(), optimizer="adam",
                            optimizer_params={"learning_rate": LR},
                            mesh=make_mesh())
    kv = mx.kv.create("dist_sync")
    start = checkpoint.agree_resume_step(checkpoint.latest_valid_step(
        ckdir, multiple_of=ELASTIC_SAVE_EVERY), kv)
    if demand is not None:
        start = demand
    if start:
        t0 = time.perf_counter()
        state = checkpoint.load_checkpoint_state(ckdir, step=start)
        info = step.load_state_dict(
            {"params": state["params"], "opt_state": state["opt_state"]},
            saved_layout=state["layout"])
        print(json.dumps({"elastic_resume": start, "rank": rank,
                          "world": world, "resharded": info["resharded"],
                          "old_world": info["old_world"],
                          "restore_s": time.perf_counter() - t0}),
              flush=True)
    ckpt = checkpoint.AsyncCheckpointer(
        ckdir, save_every=ELASTIC_SAVE_EVERY,
        keep=ELASTIC_TOTAL // ELASTIC_SAVE_EVERY, initial_step=start,
        writer=rank == 0, sharded=True)
    fault.install_preemption_handler(ckpt, step)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    for i in range(start, ELASTIC_TOTAL):
        tokens = _elastic_batch(i, world).to(dist.device())
        loss = float(step.step(tokens, tokens.float()))
        if rank == 0:
            print(json.dumps({"elastic_step": i + 1, "world": world,
                              "t": time.time(), "loss": loss,
                              "launches": {k: fn.launches for k, fn
                                           in counters.items()}}),
                  flush=True)
        ckpt.step(step)
    ckpt.close()
    params = [p.detach().cpu() for p in _whole_params(step)]
    if rank == 0:
        torch.save(params, os.path.join(root, f"final_{tag}.pt"))
    dist.barrier()


def _elastic_drive(out):
    """Not under the launcher: the port's launcher runs a 4-rank
    ``--elastic`` gang of :func:`_elastic_worker` under ELASTIC_FAULT
    (rank 3 dies at step 3 of every world-4 incarnation), which shrinks to
    3 and resumes from the step-2 checkpoint written at world 4; then a
    fixed 3-rank gang resumed at step 2 from a copy of that directory.
    The final parameters must be equal bit for bit.  The dead time is
    from the end of the last step at world 4 to the end of the first at
    world 3 (teardown, re-spawn, rendezvous, restore and one step)."""
    import shutil

    root = os.path.join("build", "elastic_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launch = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
              *LAUNCH_FLAGS]
    worker = ["--", *WORKER, "--elastic-worker"]
    t0 = time.perf_counter()
    gang = subprocess.run(
        launch + ["-n", "4", "--elastic", "--max-restarts", "0",
                  "--term-timeout", "10", "--restart-backoff", "0.5"]
        + worker + [root, "--tag", "elastic"], capture_output=True,
        text=True, timeout=1500,
        env=dict(os.environ, MX_FAULT_SPEC=ELASTIC_FAULT))
    gang_s = time.perf_counter() - t0
    base = os.path.join(root, "baseline")
    os.makedirs(base)
    shutil.copytree(os.path.join(root, "ckpt", "step-2"),
                    os.path.join(base, "ckpt", "step-2"))
    baseline = subprocess.run(
        launch + ["-n", "3"] + worker + [base, "--tag", "baseline",
                                         "--resume-step", "2"],
        capture_output=True, text=True, timeout=900)

    def events(text, key):
        got = []
        for line in text.splitlines():
            body = line.split("] ", 1)[-1]
            if body.startswith("{") and key in body:
                got.append(json.loads(body))
        return got

    steps = events(gang.stdout, "elastic_step")
    resumes = events(gang.stdout, "elastic_resume")
    last4 = max((e["t"] for e in steps if e["world"] == 4), default=None)
    first3 = min((e["t"] for e in steps if e["world"] == 3), default=None)
    row = {"gang_rc": gang.returncode, "baseline_rc": baseline.returncode,
           "gang_s": gang_s,
           "shrunk": "shrinking gang 4 -> 3" in gang.stderr,
           "crashes": gang.stdout.count("injected crash at step 3"),
           "steps": steps, "resumes": resumes,
           "baseline_resumes": events(baseline.stdout, "elastic_resume"),
           "dead_s": (first3 - last4) if last4 and first3 else None}
    # rank 0's launches over the world-3 incarnation's steps
    after = [e for e in steps if e["world"] == 3]
    row["launches_world3"] = after[-1]["launches"] if after else None
    row["launches_expected"] = {k: v * len(after)
                                for k, v in PER_STEP.items()}
    same = False
    try:
        a = torch.load(os.path.join(root, "final_elastic.pt"))
        b = torch.load(os.path.join(base, "final_baseline.pt"))
        same = len(a) == len(b) and all(bool(torch.equal(x, y))
                                        for x, y in zip(a, b))
    except OSError as e:
        row["error"] = str(e)
    row["params_bitwise"] = same
    row["ok"] = bool(gang.returncode == 0 and baseline.returncode == 0
                     and row["shrunk"] and row["crashes"] == 1 and same
                     and row["launches_world3"] == row["launches_expected"]
                     and len(resumes) == 3 and all(
                         r["elastic_resume"] == 2 and r["world"] == 3
                         and r["old_world"] == 4 and r["resharded"]
                         for r in resumes))
    if not row["ok"]:
        row["gang_stderr_tail"] = gang.stderr[-4000:]
        row["baseline_stderr_tail"] = baseline.stderr[-2000:]
    row["nvidia_smi"] = _smi()
    print(json.dumps({"elastic_shrink": row}), flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(row, f, indent=1)
    shutil.rmtree(root, ignore_errors=True)
    return 0 if row["ok"] else 1


PARTS = ("attention", "layouts", "trainer", "reshard", "syncbn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts of the check, in this "
                         f"order: {', '.join(PARTS)} (default all)")
    ap.add_argument("--elastic-drive", action="store_true",
                    help="run the elastic shrink (not under the launcher)")
    ap.add_argument("--elastic-worker", metavar="DIR", default=None)
    ap.add_argument("--tag", default="elastic")
    ap.add_argument("--resume-step", type=int, default=None)
    args = ap.parse_args(argv)
    if args.elastic_drive:
        return _elastic_drive(args.out or os.path.join(
            "build", "multigpu_elastic.json"))
    parts = [p for p in args.parts.split(",") if p]
    unknown = sorted(set(parts) - set(PARTS))
    if unknown:
        ap.error(f"no part {unknown}")
    out_path = args.out or os.path.join("build", "multigpu_smoke.json")
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.parallel import dist

    if not dist.init_from_env():
        print("multigpu_smoke: run it under python -m "
              "mxnet_tpu_torch.tools.launch -n 4", file=sys.stderr)
        return 2
    rank, n = dist.process_index(), dist.process_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank == 0:
        _build.build_all()  # once, into build/; the others load it
    dist.barrier()
    _build.build_all()
    if args.elastic_worker:
        _elastic_worker(args.elastic_worker, args.tag, args.resume_step)
        dist.shutdown()
        return 0
    # the global batch on the card, as the train phase keeps it: each step
    # cuts its block there (a pageable host copy would sync every step)
    tokens, labels = (t.to(dist.device()) for t in _batch())
    report = {"world": n, "nvidia_smi": _smi() if rank == 0 else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "parts": parts, "layouts": {}}
    ok = True
    if "attention" in parts:
        att = _sp_attention()
        report["sp_attention"] = att
        ok = att["ok"]
        if rank == 0:
            print(json.dumps({"sp_attention": att}), flush=True)
    if "layouts" in parts:
        measured = {}
        for dtype in ("float32", "bfloat16"):
            ref, p0 = {}, {}
            for name, kind, axes, ring, rules in LAYOUTS:
                t0 = time.perf_counter()
                if kind not in p0:
                    fresh = _model(dtype, kind)
                    p0[kind] = [p._tensor().detach().to(dist.device())
                                for p in fresh.collect_params().values()]
                    del fresh
                losses, ms, launches, w16, params, step = _run_layout(
                    kind, axes, ring, rules, dtype, args.steps, tokens, labels)
                want = {k: v * (args.steps - 1)
                        for k, v in _per_step(axes, ring).items()}
                row = {"layout": name, "model": kind, "mesh": axes,
                       "dtype": dtype, "losses": losses,
                       "step_ms": ms, "step_ms_median": statistics.median(ms),
                       "tokens_per_s_per_card": BATCH * SEQ / n
                       / (statistics.median(ms) * 1e-3),
                       "launches": launches, "launches_wgmma16": w16,
                       "launches_expected": want, "wall_s": None}
                measured[f"{name}-{dtype}"] = row["step_ms_median"]
                row["launches_ok"] = launches == want and (
                    w16 == {k: want[k] for k in FLASH} if dtype == "bfloat16"
                    else not any(w16.values()))
                if kind not in ref:
                    ref[kind] = (losses, params)
                    if dtype == "float32" and name == "dp4":
                        report["allreduce"] = _allreduce_gbps(
                            [p for p in step.params])
                else:
                    r_losses, r_params = ref[kind]
                    scale = max(float(p.abs().max()) for p in r_params)
                    row["loss_rel_err"] = max(
                        abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
                    diff = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(params, r_params))
                    moved = max(float((b.float() - c.float()).abs().max())
                                for b, c in zip(r_params, p0[kind]))
                    row["param_err_of_max"] = diff / scale
                    # the difference over dp4's largest change from the start
                    row["param_err_of_update"] = diff / moved
                    row["parity_ok"] = bool(
                        row["loss_rel_err"] <= LOSS_TOL[dtype]
                        and row["param_err_of_max"] <= PARAM_TOL[dtype]
                        and row["param_err_of_update"]
                        <= UPDATE_TOL.get(dtype, math.inf))
                # every rank's launches, gathered for the report
                counts = torch.tensor([launches[k] for k in PER_STEP],
                                      dtype=torch.int64, device=dist.device())
                every = [torch.zeros_like(counts) for _ in range(n)]
                import torch.distributed as tdist

                tdist.all_gather(every, counts)
                row["launches_by_rank"] = [dict(zip(PER_STEP, map(int, c)))
                                           for c in every]
                row["launches_ok"] = row["launches_ok"] and all(
                    r == want for r in row["launches_by_rank"])
                row["finite"] = all(math.isfinite(x) for x in losses)
                row["wall_s"] = time.perf_counter() - t0
                good = (row["launches_ok"] and row["finite"]
                        and row.get("parity_ok", True))
                row["ok"] = bool(good)
                ok = ok and good
                report["layouts"][f"{name}-{dtype}"] = row
                if rank == 0:
                    print(json.dumps(row), flush=True)
                del step, params
                torch.cuda.empty_cache()
            ref = p0 = None
        report["planner"] = _planner(report["allreduce"]["bus_gb_per_s"],
                                     measured)
        if rank == 0:
            print(json.dumps({"planner": report["planner"]}), flush=True)
    if "trainer" in parts:
        t_losses, s_losses, err = _trainer_vs_step(tokens, labels)
        report["trainer_dist_sync"] = {
            "trainer_losses": t_losses, "step_losses": s_losses,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(t_losses, s_losses)),
            "param_err_of_max": err}
        tr = report["trainer_dist_sync"]
        tr["ok"] = bool(tr["loss_rel_err"] <= LOSS_TOL["float32"]
                        and err <= PARAM_TOL["float32"])
        ok = ok and tr["ok"]
        if rank == 0:
            print(json.dumps({"trainer_dist_sync": tr,
                              "allreduce": report.get("allreduce")}),
                  flush=True)
    for part, fn in (("reshard", lambda: _reshard(tokens, labels, "build")),
                     ("syncbn", _syncbn)):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        res = fn()
        res["wall_s"] = time.perf_counter() - t0
        report[part] = res
        ok = ok and res["ok"]
        if rank == 0:
            print(json.dumps({part: res}), flush=True)
    report["ok"] = ok
    if rank == 0:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"ok": ok, "world": n,
                          "nvidia_smi": report["nvidia_smi"]}), flush=True)
    dist.barrier()
    dist.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
