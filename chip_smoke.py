#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card and check
it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ..., "ok": ...}``):

  device                  card name and power limit (nvidia-smi), torch and
                          CUDA versions, and the seconds the kernel build
                          took (one nvcc per ``csrc/*.cu``, all at once).
  kernel_layer_norm       kernel K1 vs its plain version at (8, 1024),
                          (64, 1024) and (8192, 1024) f32, atol 1e-5 on out,
                          mu and rstd; times of the kernel, the plain version
                          and ``torch.nn.functional.layer_norm`` (the library
                          yardstick, never called by the port) beside the
                          bound.
  kernel_paged_attention  kernel K2 vs its plain version at the serving
                          path's shape (S 8, H 16, hd 64, pages of 16, 65-page
                          pools, P 9, ragged lengths with 0, 1, 16 and 132)
                          and at a long-context shape (lengths ~1000, P 64),
                          atol 1e-5; times beside the bound, with
                          ``scaled_dot_product_attention`` over the gathered
                          dense view as the library yardstick.
  serve                   Transformer-big (vocab 32000, 6+6 layers,
                          1024/4096, 16 heads) with seeded random weights
                          serves 16 requests with mid-flight arrivals through
                          ``ServingEngine`` (8 slots, pages of 16, max_len
                          128, sources padded to 64, stream_every 4).  The
                          launch counters are zeroed just before and read
                          just after: each kernel must have run exactly as
                          often as the path calls it (K1 18 times per decode
                          step and 12 per prefill, K2 6 times per step).
  serve_parity            one request's encoder memory and first 4 decode
                          logits on the card vs the same weights on the CPU
                          through the plain versions, max abs diff <= 2e-3.
  serve_profile           8 full slots decoding 32 steps under
                          torch.profiler: device time by kernel and the
                          device's busy share of the wall time.

Then the card's nvidia-smi line, one ``{"kernels": [...]}`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase makes
the script exit non-zero without that line, as does a machine without
CUDA or a directory without the package.

Times are CUDA-event medians of 25 samples of 10 back-to-back calls each,
enqueued behind a device sleep so that host-side launch cost does not
show as device time.  ``bound_ms`` is the larger of the bytes the
function must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(the H100 SXM data sheet at 700 W).
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, samples: int = 25, reps: int = 10) -> float:
    """Median device ms per call of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # hold the device while the host enqueues the sample, so the
        # events bracket back-to-back device work only
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch, ctx):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    return {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "build_s": time.perf_counter() - t0}


def phase_layer_norm(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import layer_norm, layer_norm_ref

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes, worst = [], 0.0
    for n, c in ((8, 1024), (64, 1024), (8192, 1024)):
        x = torch.randn(n, c, device=dev, generator=g) * 2 + 0.5
        gamma = torch.randn(c, device=dev, generator=g)
        beta = torch.randn(c, device=dev, generator=g)
        got = layer_norm(x, gamma, beta)
        want = layer_norm_ref(x, gamma, beta)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err)
        b_ms, b_by = bound(4 * (2 * n * c + 2 * c + 2 * n), 8 * n * c)
        shapes.append({
            "shape": [n, c], "max_abs_err": err, "ok": err <= 1e-5,
            "ms": time_ms(torch, lambda: layer_norm(x, gamma, beta)),
            "plain_ms": time_ms(torch, lambda: layer_norm_ref(x, gamma,
                                                              beta)),
            "library_ms": time_ms(torch, lambda: F.layer_norm(
                x, (c,), gamma, beta, 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by})
    ctx["layer_norm"] = dict(shapes[0], max_abs_err=worst)
    return {"atol": 1e-5, "shapes": shapes,
            "ok": all(s["ok"] for s in shapes)}


def _paged_case(torch, g, S, H, hd, ps, P, lengths):
    """Pools and a page table whose live entries are distinct pages."""
    dev = g.device
    n_live = [math.ceil(L / ps) for L in lengths]
    N = 1 + sum(n_live)
    kp = torch.randn(N, ps, H, hd, device=dev, generator=g)
    vp = torch.randn(N, ps, H, hd, device=dev, generator=g)
    q = torch.randn(S, H, hd, device=dev, generator=g)
    perm = list(1 + np.random.RandomState(SEED).permutation(N - 1))
    table = np.zeros((S, P), np.int32)
    for s, k in enumerate(n_live):
        table[s, :k] = perm[:k]
        perm = perm[k:]
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def phase_paged_attention(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import (paged_decode_attention,
                                             paged_decode_attention_ref)

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    S, H, hd, ps = 8, 16, 64, 16
    cases = {"path": (9, [0, 1, 16, 132, 37, 64, 100, 5]),
             "long_context": (64, [1000 + 3 * s for s in range(S)])}
    out = []
    for name, (P, lengths) in cases.items():
        q, kp, vp, table, lens = _paged_case(torch, g, S, H, hd, ps, P,
                                             lengths)
        if name == "path":  # the serving path's pools: S * 8 + 1 pages
            pad = 65 - kp.shape[0]
            kp = torch.cat([kp, torch.randn(pad, ps, H, hd, device=dev,
                                            generator=g)])
            vp = torch.cat([vp, torch.randn(pad, ps, H, hd, device=dev,
                                            generator=g)])
        args = (q, kp, vp, table, lens)
        got = paged_decode_attention(*args)
        want = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        zero_ok = all(bool((got[s] == 0).all())
                      for s, L in enumerate(lengths) if L == 0)
        # the library yardstick: SDPA over the gathered dense view
        idx = table.reshape(-1).long()
        K = kp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
        V = vp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
        K, V = K.contiguous(), V.contiguous()
        keep = (torch.arange(P * ps, device=dev)[None] < lens[:, None].long())
        mask = keep[:, None, None, :]
        q4 = q[:, :, None, :]
        live = sum(min(L, P * ps) for L in lengths)
        n_bytes = (live * H * hd * 2 * 4 + 2 * S * H * hd * 4
                   + table.numel() * 4 + S * 4)
        b_ms, b_by = bound(n_bytes, 4 * live * H * hd)
        out.append({
            "case": name, "S": S, "H": H, "hd": hd, "page_size": ps,
            "pool_pages": kp.shape[0], "P": P, "lengths": lengths,
            "max_abs_err": err, "zeros_for_length_0": zero_ok,
            "ok": err <= 1e-5 and zero_ok,
            "ms": time_ms(torch, lambda: paged_decode_attention(*args)),
            "plain_ms": time_ms(torch,
                                lambda: paged_decode_attention_ref(*args)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, K, V, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by})
    ctx["paged_decode_attention"] = dict(
        out[0], max_abs_err=max(c["max_abs_err"] for c in out))
    return {"atol": 1e-5, "cases": out, "ok": all(c["ok"] for c in out)}


def _requests(n, vocab, seed):
    from mxnet_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    reqs = [Request(rng.randint(3, vocab, rng.randint(8, 65)),
                    max_new_tokens=int(rng.randint(16, 97)), bos_id=1,
                    eos_id=2) for _ in range(n)]
    arrivals = [0] * min(n, 8) + sorted(
        int(a) for a in rng.randint(1, 120, max(0, n - 8)))
    return reqs, arrivals


def phase_serve(torch, ctx):
    from mxnet_tpu_torch.models.transformer import transformer_big
    from mxnet_tpu_torch.ops.kernels import (layer_norm,
                                             paged_decode_attention)
    from mxnet_tpu_torch.serving import ServingEngine, TransformerAdapter

    vocab = 32000
    t0 = time.perf_counter()
    model = transformer_big(vocab, dropout=0.0, max_length=1024,
                            generator=torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    adapter = TransformerAdapter(model, src_max_len=64)
    kw = dict(slots=8, page_size=16, max_len=128, stream_every=4)
    ctx.update(model=model, adapter=adapter, engine_kw=kw)
    # warm-up: cuBLAS handles and the allocator's pools, on a fresh engine
    ServingEngine(adapter, **kw).serve(_requests(2, vocab, SEED + 1)[0])
    torch.cuda.synchronize()

    eng = ServingEngine(adapter, **kw)
    reqs, arrivals = _requests(16, vocab, SEED)
    layer_norm.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = eng.serve(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ln, pa = layer_norm.launches, paged_decode_attention.launches
    ctx["launches"] = {"layer_norm": ln, "paged_decode_attention": pa}

    steps = eng.step_count
    prefills = len(reqs) + sum(r.preemptions for r in reqs)
    n_tok = sum(len(v) for v in out.values())
    finished = all(r.stream.finished for r in reqs)
    lengths_ok = all(1 <= len(out[r.id]) <= r.max_new_tokens
                     and (len(out[r.id]) == r.max_new_tokens
                          or out[r.id][-1] == r.eos_id) for r in reqs)
    in_vocab = all(((v >= 0) & (v < vocab)).all() for v in out.values())
    pages_back = eng.pages_free == eng.num_pages - 1
    step_ms = [1e3 * s / n for n, s in eng.burst_times]

    src = torch.from_numpy(adapter.prefill_src(reqs[0])).cuda()
    prefill_ms = time_ms(torch, lambda: adapter.prefill(src), samples=20,
                         reps=1)
    return {
        "model": "transformer_big", "vocab": vocab, "params": n_params,
        "init_s": init_s, "requests": len(reqs), "arrivals": arrivals,
        "engine": kw, "src_max_len": 64, "pool_pages": eng.num_pages,
        "decode_steps": steps, "prefills": prefills,
        "preemptions": sum(r.preemptions for r in reqs),
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "decode_step_ms_median": statistics.median(step_ms),
        "prefill_ms_median": prefill_ms,
        "launches": ctx["launches"],
        "launches_expected": {"layer_norm": 18 * steps + 12 * prefills,
                              "paged_decode_attention": 6 * steps},
        "card": ctx["smi"],
        "ok": bool(finished and lengths_ok and in_vocab and pages_back
                   and ln > 0 and pa > 0
                   and ln == 18 * steps + 12 * prefills
                   and pa == 6 * steps),
        "checks": {"finished": finished, "lengths": lengths_ok,
                   "in_vocab": bool(in_vocab), "pages_back": pages_back}}


def _first_logits(torch, model, src_np, steps, device, feed=None):
    """Encoder memory and the first ``steps`` decode logits of one
    request, teacher-forced with ``feed`` (greedy from this device's own
    logits when None), through the paged cache the engine uses."""
    from mxnet_tpu_torch.serving import (PagedKVCache, PagedStepCache,
                                         page_coords)

    ps = 16
    sa = model.decoder.layers[0].self_attn
    cache = PagedKVCache(len(model.decoder.layers), 2, ps, sa.num_heads,
                         sa.head_dim, device=device)
    table = torch.tensor([[1]], dtype=torch.int32, device=device)
    with torch.no_grad():
        mem, keep = model._encode_h(torch.from_numpy(src_np).to(device))
        tok, toks, logits = 1, [], []
        for t in range(steps):
            pos = torch.tensor([t], dtype=torch.int32, device=device)
            pages, rows = page_coords(table, pos, ps)
            caches = [PagedStepCache(k, v, table, pages, rows, pos + 1)
                      for k, v in cache.pools]
            tok_t = torch.tensor([[tok]], dtype=torch.int32, device=device)
            lg = model._decode_step(tok_t, pos, mem, keep, caches)
            logits.append(lg.cpu())
            tok = int(feed[t]) if feed is not None else int(lg.argmax())
            toks.append(tok)
    return mem.cpu(), torch.cat(logits), toks


def phase_serve_parity(torch, ctx):
    from mxnet_tpu_torch.models.transformer import transformer_big

    model = ctx["model"]
    cpu_model = transformer_big(32000, dropout=0.0, max_length=1024,
                                device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    rng = np.random.RandomState(SEED + 2)
    src = np.zeros((1, 64), np.int32)
    src[0, :40] = rng.randint(3, 32000, 40)
    mem_g, lg_g, toks = _first_logits(torch, model, src, 4,
                                      torch.device("cuda", 0))
    mem_c, lg_c, _ = _first_logits(torch, cpu_model, src, 4,
                                   torch.device("cpu"), feed=toks)
    d_mem = float((mem_g - mem_c).abs().max())
    d_lg = float((lg_g - lg_c).abs().max())
    finite = bool(torch.isfinite(lg_g).all() and torch.isfinite(mem_g).all())
    return {"steps": 4, "max_abs_diff_memory": d_mem,
            "max_abs_diff_logits": d_lg, "logit_abs_max": float(
                lg_c.abs().max()), "tol": 2e-3, "finite": finite,
            "ok": finite and d_lg <= 2e-3 and d_mem <= 2e-3}


def phase_serve_profile(torch, ctx):
    """Where the serving time goes: 8 full slots decoding 32 steps each
    under torch.profiler (device activity only), device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(ctx["adapter"], **ctx["engine_kw"])
    rng = np.random.RandomState(SEED + 3)
    reqs = [Request(rng.randint(3, 32000, 64), max_new_tokens=32, bos_id=1,
                    eos_id=-1) for _ in range(8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    ours = sum(ms for ms, _, k in rows
               if "ln_fwd_f32" in k or "paged_decode_f32" in k)
    return {"requests": len(reqs), "decode_steps": eng.step_count,
            "wall_ms": wall_ms, "device_busy_ms": busy if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "device_ops": sum(c for _, c, _ in rows),
            "k1_k2_device_ms": ours,
            "top": [{"name": k[:100], "ms": ms, "count": c}
                    for ms, c, k in rows[:12]]}


KERNELS = (
    ("layer_norm", "mxnet_tpu_torch/csrc/layer_norm.cu",
     "mxnet_tpu/ops/pallas/fused.py:98"),
    ("paged_decode_attention", "mxnet_tpu_torch/csrc/paged_attention.cu",
     "mxnet_tpu/ops/pallas/paged_attention.py:38"),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print(f"chip_smoke: no mxnet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    ctx, failed = {}, []
    phases = (("device", phase_device),
              ("kernel_layer_norm", phase_layer_norm),
              ("kernel_paged_attention", phase_paged_attention),
              ("serve", phase_serve),
              ("serve_parity", phase_serve_parity),
              ("serve_profile", phase_serve_profile))
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(torch, ctx)
            ok = bool(res.pop("ok", True))
        except Exception as e:  # a phase's failure is reported, not fatal
            traceback.print_exc()
            res, ok = {"error": f"{type(e).__name__}: {e}"[:2000]}, False
        line = {"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
                **res}
        emit(line)
        if not ok:
            failed.append(name)

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in KERNELS:
        k = ctx[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": ctx["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}})
    print(ctx["smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
