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

Rank 0 prints one JSON line per layout and dtype, then the summary, and
writes it all to ``--out`` (default ``build/multigpu_smoke.json``); the
launcher's exit code is non-zero when a check fails.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "multigpu_smoke.json"))
    args = ap.parse_args(argv)
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
    # the global batch on the card, as the train phase keeps it: each step
    # cuts its block there (a pageable host copy would sync every step)
    tokens, labels = (t.to(dist.device()) for t in _batch())
    report = {"world": n, "nvidia_smi": _smi() if rank == 0 else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "layouts": {}}
    att = _sp_attention()
    report["sp_attention"] = att
    ok = att["ok"]
    if rank == 0:
        print(json.dumps({"sp_attention": att}), flush=True)
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
    report["ok"] = ok
    if rank == 0:
        print(json.dumps({"trainer_dist_sync": tr,
                          "allreduce": report.get("allreduce")}), flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"ok": ok, "world": n,
                          "nvidia_smi": report["nvidia_smi"]}), flush=True)
    dist.barrier()
    dist.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
