#!/usr/bin/env python
"""Gang-wide trace analysis over per-rank telemetry JSONL streams (the
port's copy of the JAX package's ``tools/trace_report.py``, run by the
port's ``launch.py``).

``telemetry.py`` leaves one ``rank-<R>.jsonl`` event stream per
rank under ``MX_TELEMETRY_DIR``; this CLI merges them into the questions a
human (or the launch.py supervisor, or CI) actually asks after a run:

  * **per-step breakdown** — compile vs steady-state step counts and
    wall, and where a steady step's time goes (``dispatch`` /
    ``input_stage`` / ``block_wait`` / ``loss_wait`` span phases, H2D
    bytes and how much of them a prefetcher overlapped);
  * **per-rank skew table with straggler flagging** — two rules, because
    sync-SGD hides stragglers two different ways:
      - *idle-gap skew* (checked first): wall-clock run span minus time
        accounted by that rank's top-level spans (and step walls).  In
        lock-step training the straggler's lost time is *unrecorded host
        time* (slow disk, GC, CPU contention, a sleeping process) while
        its peers' equal share of waiting shows up inside recorded
        ``loss_wait``/``block_wait``/collective/dispatch regions — and
        the victims' step walls BALLOON from that waiting, so the naive
        "slowest wall = straggler" reading names the wrong rank.  The
        rank whose unaccounted time towers over the others is the one
        everyone else was waiting for;
      - *step-wall skew*: mean steady step wall over a sliding window of
        each rank's newest steps; a rank slower than the fastest by more
        than the threshold is flagged.  Applied only when idle gaps are
        symmetric (the non-lockstep shape: independent cadences, one
        rank's compute/dispatch genuinely slower);
  * **collective bandwidth table** — per op and per rank: count, bytes,
    dispatch wall, effective MB/s (first-use compile-tagged events are
    excluded from the bandwidth math);
  * **retrace attribution** — which executor kept recompiling, with the
    newest offending signature;
  * **heartbeat-gap timeline** — stretches where a rank's event stream
    went silent longer than the threshold: the "was it stuck or slow,
    and *when*" answer for post-mortems.

Exit code: 0 clean, 2 usage/IO error, 3 when anomalies were flagged
(stragglers, retrace storms, event gaps) — CI and the supervisor key off
it.  ``--json`` emits the full report object for machines.

Importable WITHOUT torch or the package (stdlib only): the launch.py supervisor
runs it right after a gang death, where importing torch could hang on a
poisoned CUDA runtime.  The JSONL schema knowledge is shared with
``telemetry.py`` — keep the two in sync.

Thresholds come from flags, falling back to env knobs registered in
``env_vars.py``: ``MX_TRACE_WINDOW`` (sliding window, default
20 steps), ``MX_TRACE_STRAGGLER_PCT`` (skew threshold, default 25%),
``MX_TRACE_HEARTBEAT_GAP_SEC`` (silence threshold, default 30 s).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_gang", "build_report", "format_text", "main"]

DEFAULT_WINDOW = 20
DEFAULT_STRAGGLER_PCT = 25.0
DEFAULT_GAP_SEC = 30.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
def load_gang(directory: str) -> Tuple[Dict[int, List[dict]], List[str]]:
    """{rank: [events...]} for every rank-<R>.jsonl under ``directory``,
    plus human-readable warnings (torn lines, missing clock anchors)."""
    ranks: Dict[int, List[dict]] = {}
    warnings: List[str] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        raise SystemExit(f"trace_report: cannot read {directory}: {e}")
    for name in names:
        if not (name.startswith("rank-") and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len("rank-"):-len(".jsonl")])
        except ValueError:
            continue
        events: List[dict] = []
        torn = 0
        with open(os.path.join(directory, name), errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    torn += 1
                    continue
                if isinstance(ev, dict) and "kind" in ev:
                    events.append(ev)
        if torn:
            warnings.append(f"rank {rank}: {torn} torn JSONL line(s) "
                            "skipped (SIGKILL mid-write?)")
        if events and not any(e["kind"] == "clock_anchor" for e in events):
            # the satellite contract: old-format files must degrade loudly,
            # not silently misalign the merged timeline
            warnings.append(
                f"rank {rank}: no clock_anchor events (old-format stream?) "
                "— cross-rank span alignment falls back to per-event wall "
                "stamps and may be skewed by flush latency")
        ranks[rank] = events
    return ranks, warnings


def _pair_spans(events: List[dict]) -> List[dict]:
    """Completed spans: {name, dur_ms, depth, tid, t} (begin wall stamp).
    Handles both forms the recorder emits: complete ``span`` events
    (hot-path) and ``span_begin``/``span_end`` pairs (blocking regions)."""
    open_spans: Dict[int, dict] = {}
    out: List[dict] = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "span":
            out.append({"name": ev.get("name", "?"),
                        "dur_ms": float(ev.get("dur_ms", 0.0)),
                        "depth": int(ev.get("depth", 0)),
                        "tid": ev.get("tid"),
                        "t": float(ev.get("t", 0.0))})
        elif kind == "span_begin" and "span" in ev:
            open_spans[ev["span"]] = ev
        elif kind == "span_end" and ev.get("span") in open_spans:
            begin = open_spans.pop(ev["span"])
            out.append({"name": ev.get("name", "?"),
                        "dur_ms": float(ev.get("dur_ms", 0.0)),
                        "depth": int(begin.get("depth", 0)),
                        "tid": begin.get("tid"),
                        "t": float(begin.get("t", 0.0))})
    return out


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------
def _resize_stamps(events: List[dict]) -> List[float]:
    """Wall stamps of ``resize`` events (elastic gang resize — a new
    incarnation at a different world size, recorded by
    ``parallel/dist.py`` at the post-resize rendezvous)."""
    return sorted(float(e["t"]) for e in events
                  if e.get("kind") == "resize" and "t" in e)


def _rank_stats(events: List[dict], window: int) -> dict:
    # an elastic resize restarts the process, re-rendezvouses and
    # RECOMPILES every executable: the teardown silence and the fresh
    # compile wall belong to the resize, not to this rank's behavior.
    # Skew/idle accounting therefore runs on the NEWEST segment only
    # (events after the last resize) — without this, every survivor of a
    # resize reads as an idle-gap straggler against a rank that died
    # before it.
    resizes = _resize_stamps(events)
    n_resizes = len(resizes)
    if resizes:
        cut = resizes[-1]
        events = [e for e in events
                  if e.get("kind") == "resize"
                  or float(e.get("t", cut)) >= cut]
    steps = [e for e in events if e.get("kind") == "step"]
    steady = [e for e in steps if not e.get("traced")]
    compile_ = [e for e in steps if e.get("traced")]
    spans = _pair_spans(events)
    top_level = [s for s in spans if s["depth"] == 0]
    # idle-gap accounting runs on the BUSIEST thread only: checkpoint
    # writer / prefetcher threads overlap the training thread, and summing
    # across threads would count the same wall twice
    by_tid: Dict[object, float] = {}
    for s in top_level:
        by_tid[s["tid"]] = by_tid.get(s["tid"], 0.0) + s["dur_ms"]
    main_tid = max(by_tid, key=by_tid.get) if by_tid else None
    span_account_ms = by_tid.get(main_tid, 0.0)
    step_wall_ms = sum(float(e.get("wall_ms", 0.0)) for e in steps)
    # span coverage and step walls OVERLAP (a DataParallelStep stream's
    # train_step spans contain the step walls; a Trainer stream's step
    # walls contain its push_bucketed/fused_apply spans), so summing them
    # would double-count busy time, clamp idle_gap to 0 everywhere, and
    # blind the straggler rule.  max() of the two is a lower bound on
    # accounted busy time that never double-counts — and also covers the
    # edge where the busiest span thread is a checkpoint writer rather
    # than the training loop.
    accounted_ms = max(span_account_ms, step_wall_ms)
    # idle-gap accounting runs over the TRAINING window (first step/span
    # event -> last event): rendezvous/compile slack before training is
    # shared by every rank and would only dilute the skew percentage
    work_kinds = ("step", "span", "span_begin", "span_end")
    work_stamps = [float(e["t"]) for e in events
                   if e.get("kind") in work_kinds and "t" in e]
    stamps = [float(e.get("t", 0.0)) for e in events
              if e.get("kind") != "clock_anchor" and "t" in e]
    if work_stamps and stamps:
        run_span_ms = (max(stamps) - min(work_stamps)) * 1e3
    elif len(stamps) > 1:
        run_span_ms = (max(stamps) - min(stamps)) * 1e3
    else:
        run_span_ms = 0.0
    win = steady[-window:] if window > 0 else steady
    win_walls = [float(e.get("wall_ms", 0.0)) for e in win]
    span_ms: Dict[str, Dict[str, float]] = {}
    for s in spans:
        agg = span_ms.setdefault(s["name"],
                                 {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += s["dur_ms"]
        agg["max_ms"] = max(agg["max_ms"], s["dur_ms"])
    return {
        "resizes": n_resizes,
        "steps": len(steps),
        "steady_steps": len(steady),
        "compile_steps": len(compile_),
        "compile_ms": round(sum(float(e.get("wall_ms", 0.0))
                                for e in compile_), 3),
        "steady_wall_ms": round(sum(float(e.get("wall_ms", 0.0))
                                    for e in steady), 3),
        "mean_steady_ms": round(
            sum(float(e.get("wall_ms", 0.0)) for e in steady)
            / len(steady), 3) if steady else None,
        "window_steps": len(win),
        "window_mean_ms": (round(sum(win_walls) / len(win_walls), 3)
                           if win_walls else None),
        "block_wait_ms": round(sum(float(e.get("block_wait_ms", 0.0))
                                   for e in steps), 3),
        "transfer_bytes": sum(int(e.get("transfer_bytes", 0))
                              for e in steps),
        "h2d_overlapped_bytes": sum(int(e.get("h2d_overlapped", 0))
                                    for e in steps),
        "run_span_ms": round(run_span_ms, 3),
        "accounted_ms": round(accounted_ms, 3),
        "idle_gap_ms": round(max(0.0, run_span_ms - accounted_ms), 3),
        # serving-mode streams (router/replica processes) break both
        # straggler rules' assumptions: the driver thread blocks in
        # request polls while HTTP handler threads do the work, so the
        # busiest-thread idle-gap math reads wait time as unaccounted
        # skew, and there are no steady step walls at all.  Flagged
        # here so build_report can exclude them and defer request-level
        # analysis to serve_report.py.
        "serving_mode": any(
            str(e.get("kind", "")).startswith("serve_")
            or (e.get("kind") in ("span", "span_begin")
                and str(e.get("name", "")).startswith("serve_"))
            for e in events),
        "spans": {k: {"count": v["count"],
                      "total_ms": round(v["total_ms"], 3),
                      "max_ms": round(v["max_ms"], 3)}
                  for k, v in sorted(span_ms.items())},
    }


def _collective_table(ranks: Dict[int, List[dict]]) -> List[dict]:
    rows: List[dict] = []
    for rank, events in sorted(ranks.items()):
        per_op: Dict[str, dict] = {}
        for e in events:
            if e.get("kind") != "collective":
                continue
            op = str(e.get("op", "?"))
            row = per_op.setdefault(op, {"count": 0, "bytes": 0,
                                         "wall_ms": 0.0, "compile": 0})
            row["count"] += 1
            if e.get("traced"):
                row["compile"] += 1  # first-use compile: not bandwidth
            else:
                row["bytes"] += int(e.get("nbytes", 0))
                row["wall_ms"] += float(e.get("wall_ms", 0.0))
        for op, row in sorted(per_op.items()):
            mbps = (row["bytes"] / 1e6 / (row["wall_ms"] / 1e3)
                    if row["wall_ms"] > 0 else 0.0)
            rows.append({"rank": rank, "op": op, "count": row["count"],
                         "compile_calls": row["compile"],
                         "bytes": row["bytes"],
                         "wall_ms": round(row["wall_ms"], 3),
                         "mb_per_sec": round(mbps, 2)})
    return rows


def _retrace_table(ranks: Dict[int, List[dict]]) -> List[dict]:
    rows = []
    for rank, events in sorted(ranks.items()):
        for e in events:
            if e.get("kind") == "retrace":
                rows.append({"rank": rank,
                             "executor": e.get("executor", "?"),
                             "traces": int(e.get("traces", 0)),
                             "signature": str(e.get("signature", ""))[:200]})
    return rows


def _event_gaps(ranks: Dict[int, List[dict]], gap_sec: float) -> List[dict]:
    """Stretches of stream silence longer than gap_sec, per rank.  A gap
    containing a ``resize`` stamp is the gang teardown + re-rendezvous of
    an elastic resize — planned dead time, not a hung rank."""
    rows = []
    for rank, events in sorted(ranks.items()):
        resizes = _resize_stamps(events)
        stamps = sorted(float(e["t"]) for e in events
                        if "t" in e and e.get("kind") != "clock_anchor")
        for prev, cur in zip(stamps, stamps[1:]):
            if cur - prev > gap_sec:
                if any(prev < s <= cur for s in resizes):
                    continue
                rows.append({"rank": rank, "at": round(prev, 3),
                             "gap_sec": round(cur - prev, 3)})
    return rows


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (stdlib-only, the
    same estimator telemetry.py uses for its rolling rollups)."""
    if not sorted_vals:
        return 0.0
    import math

    idx = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[idx]


# cap on per-request rows carried in the report object: a million-request
# serving log must not turn --json into a gigabyte; the aggregate
# percentiles cover the full population either way (log()-style note in
# the section itself records the truncation)
MAX_REQUEST_ROWS = 200


def _serving_section(ranks: Dict[int, List[dict]]) -> Optional[dict]:
    """Per-request serving breakdown from ``serve_request`` /
    ``serve_preempt`` / ``serve_slo_violation`` events plus the
    ``serve_stream`` spans' occupancy gauges.  None when the gang never served."""
    requests: List[dict] = []
    preempts: Dict[str, int] = {}
    slo: Dict[str, int] = {"ttft": 0, "tpot": 0}
    occupancy: List[dict] = []
    for rank, events in sorted(ranks.items()):
        for e in events:
            kind = e.get("kind")
            if kind == "serve_request":
                requests.append({
                    "rank": rank,
                    "id": str(e.get("request_id", "?")),
                    "queue_ms": round(float(e.get("queue_wait_ms", 0.0)), 3),
                    "prefill_ms": round(float(e.get("prefill_ms", 0.0)), 3),
                    "decode_ms": round(float(e.get("decode_ms", 0.0)), 3),
                    "latency_ms": round(float(e.get("latency_ms", 0.0)), 3),
                    "ttft_ms": round(float(e.get("ttft_ms", 0.0)), 3),
                    "tokens": int(e.get("tokens", 0)),
                    "reason": e.get("reason"),
                })
            elif kind == "serve_preempt":
                rid = str(e.get("request_id", "?"))
                preempts[rid] = preempts.get(rid, 0) + 1
            elif kind == "serve_slo_violation":
                stage = str(e.get("stage", "?"))
                slo[stage] = slo.get(stage, 0) + 1
            elif kind == "span" and e.get("name") == "serve_stream":
                occupancy.append({
                    "t": round(float(e.get("t", 0.0)), 3),
                    "rank": rank,
                    "active_slots": int(e.get("active_slots", 0)),
                    "queue_depth": int(e.get("queue_depth", 0)),
                })
    if not requests and not occupancy and not preempts:
        return None
    ttfts = sorted(r["ttft_ms"] for r in requests if r["ttft_ms"] > 0)
    lats = sorted(r["latency_ms"] for r in requests)
    occupancy.sort(key=lambda row: row["t"])
    slots = [row["active_slots"] for row in occupancy]
    out = {
        "requests": len(requests),
        "tokens": sum(r["tokens"] for r in requests),
        "ttft_p50_ms": round(_percentile(ttfts, 50), 3),
        "ttft_p99_ms": round(_percentile(ttfts, 99), 3),
        "latency_p50_ms": round(_percentile(lats, 50), 3),
        "latency_p99_ms": round(_percentile(lats, 99), 3),
        "preemptions": sum(preempts.values()),
        "preempted_requests": preempts,
        "slo_violations": slo,
        "per_request": requests[:MAX_REQUEST_ROWS],
        "per_request_truncated": max(0, len(requests) - MAX_REQUEST_ROWS),
        "slot_occupancy": {
            "samples": len(occupancy),
            "mean_active_slots": (round(sum(slots) / len(slots), 3)
                                  if slots else 0.0),
            "max_active_slots": max(slots) if slots else 0,
            "max_queue_depth": max((row["queue_depth"]
                                    for row in occupancy), default=0),
            # burst-cadence timeline (newest MAX_REQUEST_ROWS points):
            # active slots + queue depth per stream boundary
            "timeline": occupancy[-MAX_REQUEST_ROWS:],
        },
    }
    return out


def _find_stragglers(per_rank: Dict[int, dict], pct: float) -> List[dict]:
    flagged: List[dict] = []
    if len(per_rank) < 2:
        return flagged
    # rule 1: idle-gap skew — checked FIRST because sync training INVERTS
    # the naive wall reading: the victim ranks' step walls balloon (they
    # wait for the straggler inside their dispatch/collectives) while the
    # straggler's own wall stays small.  A rank whose unaccounted host
    # time towers over the others' is the one everyone waited for, and
    # once that's established the wall skew is explained (victim waiting)
    # and must not be double-reported against the victims.
    idles = {r: s["idle_gap_ms"] for r, s in per_rank.items()
             if s["run_span_ms"] > 0}
    if len(idles) >= 2:
        base = min(idles.values())
        # skew % is measured against the STEADY portion of the run:
        # compile wall is recorded, shared by every rank, and often
        # rivals the whole steady phase on cold caches — leaving it in
        # the denominator dilutes a real straggler below threshold
        span = max(s["run_span_ms"] - s["compile_ms"]
                   for s in per_rank.values())
        for r, idle in sorted(idles.items()):
            excess = idle - base
            if span > 0 and excess / span * 100.0 > pct and excess > 100.0:
                flagged.append({
                    "rank": r, "rule": "idle-gap",
                    "detail": f"{idle:.0f}ms unaccounted host time vs "
                              f"{base:.0f}ms on the best rank "
                              f"({excess / span * 100:.0f}% of the "
                              "steady run span) — peers were waiting on "
                              "this rank inside recorded waits"})
    if flagged:
        return flagged
    # rule 2: step-wall skew over the sliding window — the non-lockstep
    # shape (independent cadences, no collective coupling): a rank whose
    # own recorded step wall is genuinely slower is the straggler.
    means = {r: s["window_mean_ms"] for r, s in per_rank.items()
             if s["window_mean_ms"] is not None and s["window_steps"] >= 3}
    if len(means) >= 2:
        fastest = min(means.values())
        slowest = max(means.values())
        if fastest > 0 and (slowest - fastest) / fastest * 100.0 > pct:
            for r, m in sorted(means.items()):
                if (m - fastest) / fastest * 100.0 > pct:
                    flagged.append({
                        "rank": r, "rule": "step-wall",
                        "detail": f"window mean {m:.2f}ms vs fastest "
                                  f"{fastest:.2f}ms "
                                  f"(+{(m - fastest) / fastest * 100:.0f}%)"})
    return flagged


def build_report(directory: str, window: Optional[int] = None,
                 straggler_pct: Optional[float] = None,
                 gap_sec: Optional[float] = None) -> dict:
    """The full gang report object (what ``--json`` prints)."""
    # None means "not given" — an explicit 0 must survive to _rank_stats,
    # whose window<=0 branch means "all steady steps"
    if window is None:
        window = int(_env_float("MX_TRACE_WINDOW", DEFAULT_WINDOW))
    pct = (straggler_pct if straggler_pct is not None
           else _env_float("MX_TRACE_STRAGGLER_PCT", DEFAULT_STRAGGLER_PCT))
    gap_sec = (gap_sec if gap_sec is not None
               else _env_float("MX_TRACE_HEARTBEAT_GAP_SEC", DEFAULT_GAP_SEC))
    ranks, warnings = load_gang(directory)
    warnings = list(warnings)
    per_rank = {r: _rank_stats(events, window)
                for r, events in ranks.items()}
    # gang-wide phase breakdown: where a steady step's time goes
    phase_names = ("input_stage", "dispatch", "block_wait", "loss_wait")
    phases = {}
    steady_total = sum(s["steady_steps"] for s in per_rank.values())
    for name in phase_names:
        tot = sum(s["spans"].get(name, {}).get("total_ms", 0.0)
                  for s in per_rank.values())
        cnt = sum(s["spans"].get(name, {}).get("count", 0)
                  for s in per_rank.values())
        if cnt:
            phases[name] = {"count": cnt, "total_ms": round(tot, 3),
                            "mean_ms": round(tot / cnt, 3)}
    # serving streams confuse both straggler rules (driver thread
    # blocks while HTTP threads serve; no step cadence): exclude them
    # from the skew math and point at serve_report, which reconstructs
    # per-request trees instead of per-step walls
    serving_ranks = sorted(r for r, s in per_rank.items()
                           if s.get("serving_mode"))
    stragglers = _find_stragglers(
        {r: s for r, s in per_rank.items()
         if not s.get("serving_mode")}, pct)
    if serving_ranks:
        warnings.append(
            f"rank(s) {serving_ranks} are serving-mode streams — "
            "excluded from straggler rules; run serve_report.py "
            "for request-level analysis")
    retraces = _retrace_table(ranks)
    gaps = _event_gaps(ranks, gap_sec)
    resizes = []
    for r, events in sorted(ranks.items()):
        for e in events:
            if e.get("kind") == "resize":
                resizes.append({"rank": r,
                                "old_world": e.get("old_world"),
                                "new_world": e.get("new_world"),
                                "at": round(float(e.get("t", 0.0)), 3)})
    anomalies = []
    for s in stragglers:
        anomalies.append(f"straggler: rank {s['rank']} ({s['rule']}): "
                         f"{s['detail']}")
    for row in retraces:
        anomalies.append(f"retrace storm: rank {row['rank']} "
                         f"{row['executor']} traced {row['traces']} "
                         "distinct signatures")
    for row in gaps:
        anomalies.append(f"event gap: rank {row['rank']} silent for "
                         f"{row['gap_sec']:.1f}s (> {gap_sec:.0f}s) at "
                         f"t={row['at']}")
    return {
        "dir": os.path.abspath(directory),
        "num_ranks": len(ranks),
        "window": window,
        "straggler_pct": pct,
        "gap_sec": gap_sec,
        "per_rank": {str(r): s for r, s in sorted(per_rank.items())},
        "step_phases": phases,
        "steady_steps_total": steady_total,
        "compile_steps_total": sum(s["compile_steps"]
                                   for s in per_rank.values()),
        "compile_ms_total": round(sum(s["compile_ms"]
                                      for s in per_rank.values()), 3),
        "collectives": _collective_table(ranks),
        "serving": _serving_section(ranks),
        "serving_ranks": serving_ranks,
        "retraces": retraces,
        "resizes": resizes,
        "event_gaps": gaps,
        "stragglers": stragglers,
        "warnings": warnings,
        "anomalies": anomalies,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"


def format_text(rep: dict) -> str:
    out: List[str] = []
    w = out.append
    w(f"gang trace report — {rep['dir']} "
      f"({rep['num_ranks']} rank(s), window={rep['window']})")
    for warn in rep["warnings"]:
        w(f"  WARNING: {warn}")
    w("")
    w("per-step breakdown")
    w(f"  compile: {rep['compile_steps_total']} step(s), "
      f"{rep['compile_ms_total']:.0f}ms   steady: "
      f"{rep['steady_steps_total']} step(s)")
    for name, ph in rep["step_phases"].items():
        w(f"  {name:<12} mean {ph['mean_ms']:8.3f}ms   "
          f"total {ph['total_ms']:10.1f}ms   n={ph['count']}")
    w("")
    for row in rep.get("resizes", []):
        w(f"  elastic resize: rank {row['rank']} rejoined at world size "
          f"{row['new_world']} (was {row['old_world']}) — skew/idle stats "
          "below cover the post-resize segment only")
    if rep.get("resizes"):
        w("")
    w("per-rank skew")
    w(f"  {'rank':>4} {'steps':>6} {'win mean ms':>12} {'block ms':>10} "
      f"{'idle gap ms':>12} {'h2d':>10} straggler")
    flagged = {s["rank"]: s for s in rep["stragglers"]}
    for r, s in rep["per_rank"].items():
        mark = ""
        if int(r) in flagged:
            mark = f"<-- {flagged[int(r)]['rule']}"
        wm = (f"{s['window_mean_ms']:.3f}"
              if s["window_mean_ms"] is not None else "-")
        w(f"  {r:>4} {s['steady_steps']:>6} {wm:>12} "
          f"{s['block_wait_ms']:>10.1f} {s['idle_gap_ms']:>12.1f} "
          f"{_fmt_bytes(s['transfer_bytes']):>10} {mark}")
    for s in rep["stragglers"]:
        w(f"  rank {s['rank']} [{s['rule']}]: {s['detail']}")
    w("")
    if rep["collectives"]:
        w("collective bandwidth")
        w(f"  {'rank':>4} {'op':<20} {'n':>5} {'bytes':>10} "
          f"{'wall ms':>10} {'MB/s':>9}")
        for row in rep["collectives"]:
            w(f"  {row['rank']:>4} {row['op']:<20} {row['count']:>5} "
              f"{_fmt_bytes(row['bytes']):>10} {row['wall_ms']:>10.1f} "
              f"{row['mb_per_sec']:>9.1f}")
        w("")
    srv = rep.get("serving")
    if srv:
        w("serving")
        w(f"  {srv['requests']} request(s), {srv['tokens']} token(s); "
          f"TTFT p50 {srv['ttft_p50_ms']:.1f}ms p99 "
          f"{srv['ttft_p99_ms']:.1f}ms; latency p50 "
          f"{srv['latency_p50_ms']:.1f}ms p99 "
          f"{srv['latency_p99_ms']:.1f}ms")
        occ = srv["slot_occupancy"]
        w(f"  slot occupancy: mean {occ['mean_active_slots']:.2f} / max "
          f"{occ['max_active_slots']} active over {occ['samples']} stream "
          f"boundaries; max queue depth {occ['max_queue_depth']}")
        if srv["preemptions"]:
            w(f"  {srv['preemptions']} preemption(s): " + ", ".join(
                f"{rid} x{n}" for rid, n in
                sorted(srv["preempted_requests"].items())))
        viol = {k: v for k, v in srv["slo_violations"].items() if v}
        if viol:
            w("  SLO violations: " + ", ".join(
                f"{k}={v}" for k, v in sorted(viol.items())))
        w(f"  {'id':<12} {'queue ms':>9} {'prefill ms':>11} "
          f"{'decode ms':>10} {'ttft ms':>8} {'tok':>4} reason")
        for r in srv["per_request"][:20]:
            w(f"  {r['id']:<12} {r['queue_ms']:>9.1f} "
              f"{r['prefill_ms']:>11.1f} {r['decode_ms']:>10.1f} "
              f"{r['ttft_ms']:>8.1f} {r['tokens']:>4} {r['reason']}")
        if len(srv["per_request"]) > 20 or srv["per_request_truncated"]:
            hidden = (len(srv["per_request"]) - 20
                      + srv["per_request_truncated"])
            w(f"  ... {hidden} more request(s) (--json carries "
              f"{MAX_REQUEST_ROWS})")
        w("")
    if rep["retraces"]:
        w("retrace attribution")
        for row in rep["retraces"]:
            w(f"  rank {row['rank']} {row['executor']}: "
              f"{row['traces']} distinct signatures; newest: "
              f"{row['signature']}")
        w("")
    if rep["event_gaps"]:
        w("heartbeat/event gaps")
        for row in rep["event_gaps"]:
            w(f"  rank {row['rank']}: silent {row['gap_sec']:.1f}s "
              f"starting t={row['at']}")
        w("")
    if rep["anomalies"]:
        w(f"ANOMALIES ({len(rep['anomalies'])}):")
        for a in rep["anomalies"]:
            w(f"  - {a}")
    else:
        w("no anomalies detected")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-rank telemetry JSONL into a gang-wide "
                    "report (straggler hunting, step breakdown, "
                    "collective bandwidth).")
    ap.add_argument("directory", help="MX_TELEMETRY_DIR of the run")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report object")
    ap.add_argument("--window", type=int, default=None, metavar="N",
                    help="sliding window of newest steady steps for the "
                         "skew table; 0 = all steady steps (default: "
                         f"MX_TRACE_WINDOW or {DEFAULT_WINDOW})")
    ap.add_argument("--straggler-pct", type=float, default=None, metavar="P",
                    help="flag a rank slower/idler than the best by more "
                         "than P%% (default: MX_TRACE_STRAGGLER_PCT or "
                         f"{DEFAULT_STRAGGLER_PCT})")
    ap.add_argument("--heartbeat-gap", type=float, default=None, metavar="S",
                    help="flag event-stream silences longer than S seconds "
                         "(default: MX_TRACE_HEARTBEAT_GAP_SEC or "
                         f"{DEFAULT_GAP_SEC})")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.directory):
        print(f"trace_report: {args.directory} is not a directory",
              file=sys.stderr)
        return 2
    rep = build_report(args.directory, window=args.window,
                       straggler_pct=args.straggler_pct,
                       gap_sec=args.heartbeat_gap)
    if rep["num_ranks"] == 0:
        print(f"trace_report: no rank-*.jsonl streams under "
              f"{args.directory}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep))
    else:
        print(format_text(rep))
    return 3 if rep["anomalies"] else 0


if __name__ == "__main__":
    sys.exit(main())
