#!/usr/bin/env python
"""Fleet-wide serving-request analysis over merged telemetry JSONL
streams.

The serving stack writes one ``rank-<R>.jsonl`` stream per process —
the Router's ``serve_route``/``serve_dispatch`` spans in its stream,
each replica's ``serve_handle``/``serve_queue``/``serve_prefill``/
``serve_decode`` spans plus the per-request ``serve_request`` event in
its own — all correlated by the ``trace_id`` the Router minted and
propagated in the ``X-MX-Trace`` header.  This CLI merges the streams
(clock-anchor alignment, the same wall<-mono mapping
``telemetry.export_chrome_trace`` uses) and reconstructs ONE span tree
per request, then answers the question the per-rank views cannot:
*why was the p99 slow?*

  * **tail-latency attribution table** — p50 / p50-p90 / p90-p99 / p99+
    buckets, each broken into the six legs of a request's life:
    router queue (residence outside any dispatch attempt), dispatch
    (network + serialization: attempt wall minus replica handle wall),
    replica queue, prefill (ingest included), decode, stream (handle
    residual);
  * **dominant cause per slow request** — priority-ordered:
    ``failover`` (a dispatch attempt died; the router's
    ``serve_cause`` event), ``preempt`` (recompute preemption),
    ``swap`` (decoded across a weight hot-swap window), ``cache_miss``
    (prefix-cache miss), ``straggler`` (its replica's decode ms/token
    exceeds ``--straggler-x`` times the fleet median), else the largest
    leg;
  * **SLO violations** — the engine's ``serve_slo_violation`` events
    (``MX_SERVE_SLO_TTFT_MS`` / ``MX_SERVE_SLO_TPOT_MS`` at serve
    time) plus an optional analysis-time ``--slo-total-ms`` gate;
  * **unfinished request trees** — traces whose ``serve_route`` /
    ``serve_handle`` begin never saw its end: the fleet edition of the
    flight recorder's "died inside X" clue (what launch.py's
    gang-death hook echoes).

Exit code: 0 clean, 2 usage/IO error, 3 when SLO violations were found
— CI and the launch.py supervisor key off it.  ``--json`` emits the
full report object for machines.

Importable WITHOUT torch or the package (stdlib only), like its siblings
``trace_report.py`` / ``mem_report.py`` — the supervisor runs it right
after a gang death.  The JSONL schema knowledge is shared with
``telemetry.py`` and ``serving/router.py`` — keep
them in sync.  Request-level serving analysis lives HERE; step-level
training analysis (and its straggler rules, which serving's
driver+HTTP thread shape would confuse) stays in ``trace_report.py``,
which defers to this tool when it detects serving-mode streams.

Thresholds come from flags, falling back to env knobs registered in
``env_vars.py``: ``MX_RQTRACE_STRAGGLER_X`` (replica decode
ms/token vs fleet median, default 2.0).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_streams", "build_report", "format_text", "main"]

DEFAULT_STRAGGLER_X = 2.0
LEGS = ("router_queue_ms", "dispatch_ms", "replica_queue_ms",
        "prefill_ms", "decode_ms", "stream_ms")
MAX_SLOW_ROWS = 50
MAX_UNFINISHED_ROWS = 20


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
def load_streams(paths: List[str]) -> Tuple[Dict[str, List[dict]],
                                            List[str]]:
    """{stream_name: [events...]} for every ``rank-<R>.jsonl`` under the
    given directories (or explicit .jsonl files), plus human-readable
    warnings.  Stream names stay unique when several directories hold
    the same rank number (a router dir next to a replica dir)."""
    streams: Dict[str, List[dict]] = {}
    warnings: List[str] = []
    files: List[Tuple[str, str]] = []
    for path in paths:
        if os.path.isdir(path):
            found = sorted(glob.glob(os.path.join(path, "rank-*.jsonl")))
            if not found:
                warnings.append(f"no rank-*.jsonl streams under {path!r}")
            files.extend((path, f) for f in found)
        elif os.path.isfile(path):
            files.append((os.path.dirname(path) or ".", path))
        else:
            raise OSError(f"no such telemetry dir or stream: {path!r}")
    for base, fpath in files:
        name = os.path.basename(fpath)
        if name in streams:  # same rank number from a second directory
            name = f"{os.path.basename(os.path.abspath(base))}/{name}"
        events: List[dict] = []
        torn = 0
        with open(fpath, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    torn += 1  # a crash mid-write leaves one torn tail
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
        if torn:
            warnings.append(f"{name}: {torn} torn line(s) skipped")
        streams[name] = events
    return streams, warnings


def _anchor_offset(events: List[dict]) -> Optional[float]:
    """wall - mono offset from the stream's clock_anchor events (median
    over all anchors; None when the stream predates anchors)."""
    offs = sorted(ev["wall"] - ev["mono"] for ev in events
                  if ev.get("kind") == "clock_anchor"
                  and "wall" in ev and "mono" in ev)
    if not offs:
        return None
    return offs[len(offs) // 2]


def _extract_spans(events: List[dict], stream: str,
                   warnings: List[str]) -> Tuple[List[dict], List[dict]]:
    """(closed_spans, open_spans) for one stream, start times on the
    gang wall timeline.  Closed spans come from complete ``span``
    events and matched begin/end pairs; an unmatched ``span_begin`` is
    the "died inside X" clue and lands in open_spans."""
    off = _anchor_offset(events)
    closed: List[dict] = []
    opens: Dict[int, dict] = {}
    last_wall = 0.0
    for ev in events:
        t = ev.get("t")
        if isinstance(t, (int, float)):
            last_wall = max(last_wall, float(t))
        kind = ev.get("kind")
        if kind not in ("span", "span_begin", "span_end"):
            continue
        mono = ev.get("mono")
        if kind == "span":
            dur = float(ev.get("dur_ms", 0.0))
            if off is not None and isinstance(mono, (int, float)):
                start = float(mono) + off
            else:  # old-format stream: approximate from the wall stamp
                start = float(ev.get("t", 0.0)) - dur / 1e3
            closed.append(dict(ev, start_wall=start, stream=stream))
        elif kind == "span_begin":
            start = (float(mono) + off
                     if off is not None and isinstance(mono, (int, float))
                     else float(ev.get("t", 0.0)))
            opens[ev.get("span")] = dict(ev, start_wall=start,
                                         stream=stream)
        elif kind == "span_end":
            begin = opens.pop(ev.get("span"), None)
            if begin is None:
                continue
            merged = dict(begin)
            merged["dur_ms"] = float(ev.get("dur_ms", 0.0))
            if "error" in ev:
                merged["error"] = ev["error"]
            merged["kind"] = "span"
            closed.append(merged)
    open_spans = []
    for sp in opens.values():
        sp["open_ms"] = max(0.0, (last_wall - sp["start_wall"]) * 1e3)
        open_spans.append(sp)
    return closed, open_spans


# ---------------------------------------------------------------------------
# per-request reconstruction
# ---------------------------------------------------------------------------
SERVE_EVENT_KINDS = ("serve_request", "serve_slo_violation", "serve_cause",
                     "serve_preempt", "serve_failover",
                     "serve_pool_pressure", "serve_prefix")


def _collect_traces(streams: Dict[str, List[dict]],
                    warnings: List[str]) -> Dict[str, dict]:
    """trace_id -> raw material: spans + serving events, cross-stream."""
    traces: Dict[str, dict] = {}

    def bucket(tid) -> dict:
        return traces.setdefault(str(tid), {
            "spans": [], "open_spans": [], "events": []})

    for stream, events in streams.items():
        closed, open_spans = _extract_spans(events, stream, warnings)
        for sp in closed:
            if sp.get("trace_id") and str(sp.get("name", "")
                                          ).startswith("serve_"):
                bucket(sp["trace_id"])["spans"].append(sp)
        for sp in open_spans:
            if sp.get("trace_id"):
                bucket(sp["trace_id"])["open_spans"].append(sp)
        for ev in events:
            if ev.get("kind") not in SERVE_EVENT_KINDS:
                continue
            tid = ev.get("trace_id")
            if tid is None and ev.get("kind") == "serve_request":
                # untraced engine-only run (no router): still analyzable
                # from the event's own legs, keyed by request id
                tid = f"req:{ev.get('request_id')}"
            if tid is not None:
                bucket(tid)["events"].append(dict(ev, stream=stream))
    return traces


def _build_request(tid: str, raw: dict) -> dict:
    """One reconstructed request: its span tree roots, leg breakdown
    and engine-attributed cause (straggler attribution needs the whole
    fleet and happens later in build_report)."""
    spans = raw["spans"]
    by_name: Dict[str, List[dict]] = {}
    for sp in spans:
        by_name.setdefault(str(sp.get("name")), []).append(sp)
    route = min(by_name.get("serve_route", []),
                key=lambda s: s["start_wall"], default=None)
    handle = min(by_name.get("serve_handle", []),
                 key=lambda s: s["start_wall"], default=None)
    dispatches = sorted(by_name.get("serve_dispatch", []),
                        key=lambda s: s["start_wall"])
    sreq = next((e for e in raw["events"]
                 if e.get("kind") == "serve_request"), None)
    slo = [e for e in raw["events"]
           if e.get("kind") == "serve_slo_violation"]
    failover = (any(e.get("kind") in ("serve_cause", "serve_failover")
                    and (e.get("cause") == "failover"
                         or e.get("kind") == "serve_failover")
                    for e in raw["events"])
                or any(d.get("error") for d in dispatches))

    legs = dict.fromkeys(LEGS, 0.0)
    route_ms = float(route["dur_ms"]) if route else 0.0
    handle_ms = float(handle["dur_ms"]) if handle else 0.0
    disp_ms = sum(float(d["dur_ms"]) for d in dispatches)
    if sreq is not None:
        legs["replica_queue_ms"] = float(sreq.get("queue_wait_ms", 0.0))
        legs["prefill_ms"] = float(sreq.get("prefill_ms", 0.0))
        legs["decode_ms"] = float(sreq.get("decode_ms", 0.0))
    else:
        q = min(by_name.get("serve_queue", []),
                key=lambda s: s["start_wall"], default=None)
        legs["replica_queue_ms"] = float(q["dur_ms"]) if q else 0.0
        legs["prefill_ms"] = sum(float(s["dur_ms"])
                                 for s in by_name.get("serve_prefill", []))
        legs["decode_ms"] = sum(float(s["dur_ms"])
                                for s in by_name.get("serve_decode", []))
    legs["prefill_ms"] += sum(float(s["dur_ms"])
                              for s in by_name.get("serve_ingest", []))
    served = (legs["replica_queue_ms"] + legs["prefill_ms"]
              + legs["decode_ms"])
    if handle_ms:
        legs["stream_ms"] = max(0.0, handle_ms - served)
    inner = handle_ms if handle_ms else served + legs["stream_ms"]
    if disp_ms:
        legs["dispatch_ms"] = max(0.0, disp_ms - inner)
    if route_ms:
        legs["router_queue_ms"] = max(0.0, route_ms - disp_ms)
    latency = (route_ms or handle_ms
               or (float(sreq.get("latency_ms", 0.0)) if sreq else 0.0))

    cause = str(sreq.get("cause", "none")) if sreq else "none"
    if failover:
        cause = "failover"  # outranks the engine's verdict: the request
        #                     paid a whole failed attempt first
    replica = None
    if sreq is not None:
        replica = sreq.get("rank")
    elif handle is not None:
        replica = handle.get("replica")
    elif dispatches:
        replica = dispatches[-1].get("replica")
    opens = sorted(raw["open_spans"],
                   key=lambda s: s.get("depth", 0), reverse=True)
    return {
        "trace_id": tid,
        "request_id": (sreq.get("request_id") if sreq else
                       (route or handle or {}).get("request_id")),
        "latency_ms": round(latency, 3),
        "ttft_ms": round(float(sreq.get("ttft_ms", 0.0)), 3)
        if sreq else None,
        "tokens": int(sreq.get("tokens", 0)) if sreq else 0,
        "replica": replica,
        "legs": {k: round(v, 3) for k, v in legs.items()},
        "attempts": len(dispatches),
        "failed_attempts": sum(1 for d in dispatches if d.get("error")),
        "cause": cause,
        "slo_violated": sorted({str(e.get("stage")) for e in slo}),
        "late_sampled": any(sp.get("late_sampled") for sp in spans),
        "spans": len(spans),
        "open_span": ({"name": opens[0].get("name"),
                       "stream": opens[0].get("stream"),
                       "open_ms": round(opens[0]["open_ms"], 1)}
                      if opens else None),
        "finished": bool(sreq) or (route is not None and not opens),
    }


def _dominant_leg(req: dict) -> str:
    legs = req["legs"]
    return max(LEGS, key=lambda k: legs[k])


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def _bucketize(reqs: List[dict]) -> List[dict]:
    """The tail-latency attribution table: p50 / p50-p90 / p90-p99 /
    p99+ cohorts with mean per-leg breakdown and cause histogram."""
    lats = sorted(r["latency_ms"] for r in reqs)
    p50, p90, p99 = (_percentile(lats, 50), _percentile(lats, 90),
                     _percentile(lats, 99))
    edges = [("p50", lambda v: v <= p50),
             ("p50-p90", lambda v: p50 < v <= p90),
             ("p90-p99", lambda v: p90 < v <= p99),
             ("p99+", lambda v: v > p99)]
    rows = []
    for label, member in edges:
        cohort = [r for r in reqs if member(r["latency_ms"])]
        if not cohort:
            rows.append({"bucket": label, "count": 0})
            continue
        n = len(cohort)
        causes: Dict[str, int] = {}
        for r in cohort:
            causes[r["cause"]] = causes.get(r["cause"], 0) + 1
        rows.append({
            "bucket": label, "count": n,
            "latency_ms": round(sum(r["latency_ms"]
                                    for r in cohort) / n, 3),
            "legs": {k: round(sum(r["legs"][k] for r in cohort) / n, 3)
                     for k in LEGS},
            "causes": dict(sorted(causes.items(),
                                  key=lambda kv: -kv[1])),
        })
    return rows


def _flag_stragglers(reqs: List[dict], straggler_x: float) -> List[dict]:
    """Fleet-wide straggler attribution: a replica whose mean decode
    ms/token exceeds ``straggler_x`` times the fleet median re-labels
    its cause-less requests ``straggler``.  Needs >= 2 replicas — one
    replica has no fleet to be slower than."""
    per_rep: Dict[object, List[float]] = {}
    for r in reqs:
        if r["tokens"] > 0 and r["replica"] is not None:
            per_rep.setdefault(r["replica"], []).append(
                r["legs"]["decode_ms"] / r["tokens"])
    if len(per_rep) < 2:
        return []
    means = {rep: sum(v) / len(v) for rep, v in per_rep.items()}
    # LOWER median on even fleets: with 2 replicas the upper median IS
    # the suspect, and comparing it against itself would hide it
    med = sorted(means.values())[(len(means) - 1) // 2]
    flagged = [rep for rep, m in means.items()
               if med > 0 and m > straggler_x * med]
    for r in reqs:
        if r["replica"] in flagged and r["cause"] == "none":
            r["cause"] = "straggler"
    return [{"replica": rep, "decode_ms_per_token": round(means[rep], 3),
             "fleet_median": round(med, 3)} for rep in sorted(
                 flagged, key=lambda rep: -means[rep])]


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
def build_report(streams: Dict[str, List[dict]],
                 straggler_x: Optional[float] = None,
                 slo_total_ms: float = 0.0,
                 warnings: Optional[List[str]] = None) -> dict:
    warnings = list(warnings or [])
    if straggler_x is None:
        straggler_x = _env_float("MX_RQTRACE_STRAGGLER_X",
                                 DEFAULT_STRAGGLER_X)
    traces = _collect_traces(streams, warnings)
    reqs = [_build_request(tid, raw) for tid, raw in traces.items()]
    finished = [r for r in reqs if r["finished"]]
    unfinished = sorted((r for r in reqs if not r["finished"]),
                        key=lambda r: -(r["open_span"] or {}
                                        ).get("open_ms", 0.0))
    stragglers = _flag_stragglers(finished, straggler_x)

    violations: List[dict] = []
    for r in finished:
        for stage in r["slo_violated"]:
            violations.append({"trace_id": r["trace_id"],
                               "stage": stage,
                               "latency_ms": r["latency_ms"],
                               "cause": r["cause"]})
        if slo_total_ms > 0 and r["latency_ms"] > slo_total_ms:
            violations.append({"trace_id": r["trace_id"],
                               "stage": "total",
                               "latency_ms": r["latency_ms"],
                               "threshold_ms": slo_total_ms,
                               "cause": r["cause"]})
    lats = sorted(r["latency_ms"] for r in finished)
    slow_floor = _percentile(lats, 90)
    slow = sorted((r for r in finished
                   if r["latency_ms"] > slow_floor or r["slo_violated"]),
                  key=lambda r: -r["latency_ms"])
    causes: Dict[str, int] = {}
    for r in finished:
        causes[r["cause"]] = causes.get(r["cause"], 0) + 1
    return {
        "streams": sorted(streams),
        "requests": len(finished),
        "unfinished": len(unfinished),
        "latency_ms": {"p50": _percentile(lats, 50),
                       "p90": _percentile(lats, 90),
                       "p99": _percentile(lats, 99),
                       "max": lats[-1] if lats else 0.0},
        "attribution": _bucketize(finished) if finished else [],
        "causes": dict(sorted(causes.items(), key=lambda kv: -kv[1])),
        "straggler_replicas": stragglers,
        "straggler_x": straggler_x,
        "slow_requests": [
            {"trace_id": r["trace_id"], "request_id": r["request_id"],
             "latency_ms": r["latency_ms"], "replica": r["replica"],
             "dominant_leg": _dominant_leg(r), "cause": r["cause"],
             "attempts": r["attempts"],
             "slo_violated": r["slo_violated"]}
            for r in slow[:MAX_SLOW_ROWS]],
        "slo_violations": violations,
        "unfinished_requests": [
            {"trace_id": r["trace_id"], "request_id": r["request_id"],
             "replica": r["replica"], "open_span": r["open_span"],
             "attempts": r["attempts"]}
            for r in unfinished[:MAX_UNFINISHED_ROWS]],
        "per_request": {r["trace_id"]: r for r in finished},
        "warnings": warnings,
    }


def format_text(report: dict) -> str:
    out: List[str] = []
    put = out.append
    put(f"serve_report: {len(report['streams'])} stream(s), "
        f"{report['requests']} completed request(s), "
        f"{report['unfinished']} unfinished")
    lat = report["latency_ms"]
    put(f"latency ms: p50={lat['p50']:.1f} p90={lat['p90']:.1f} "
        f"p99={lat['p99']:.1f} max={lat['max']:.1f}")
    if report["attribution"]:
        put("")
        put("== tail-latency attribution (mean ms per leg) ==")
        hdr = (f"{'bucket':>8} {'n':>5} {'latency':>9} "
               + " ".join(f"{leg[:-3]:>12}" for leg in LEGS))
        put(hdr)
        for row in report["attribution"]:
            if not row["count"]:
                continue
            put(f"{row['bucket']:>8} {row['count']:>5} "
                f"{row['latency_ms']:>9.1f} "
                + " ".join(f"{row['legs'][leg]:>12.1f}" for leg in LEGS))
    if report["causes"]:
        put("")
        put("== attributed causes ==")
        for cause, n in report["causes"].items():
            put(f"  {cause:<12} {n}")
    for srep in report["straggler_replicas"]:
        put(f"  straggler replica {srep['replica']}: "
            f"{srep['decode_ms_per_token']:.2f} ms/token vs fleet "
            f"median {srep['fleet_median']:.2f} "
            f"(x{report['straggler_x']:.1f} rule)")
    if report["slow_requests"]:
        put("")
        put("== slow requests (> p90 or SLO-violating) ==")
        put(f"{'trace':>18} {'latency':>9} {'replica':>8} "
            f"{'dominant leg':>16} {'cause':>12}")
        for r in report["slow_requests"]:
            put(f"{str(r['trace_id']):>18} {r['latency_ms']:>9.1f} "
                f"{str(r['replica']):>8} {_short(r['dominant_leg']):>16} "
                f"{r['cause']:>12}")
    if report["slo_violations"]:
        put("")
        put(f"== SLO violations ({len(report['slo_violations'])}) ==")
        for v in report["slo_violations"][:MAX_SLOW_ROWS]:
            put(f"  trace {v['trace_id']}: stage={v['stage']} "
                f"latency={v['latency_ms']:.1f}ms cause={v['cause']}")
    if report["unfinished_requests"]:
        put("")
        put("== unfinished requests (died inside ...) ==")
        for r in report["unfinished_requests"]:
            sp = r["open_span"] or {}
            put(f"  trace {r['trace_id']}: open {sp.get('name')} "
                f"({sp.get('open_ms', 0.0):.0f} ms before stream end, "
                f"{sp.get('stream')})")
    for w in report["warnings"]:
        put(f"warning: {w}")
    return "\n".join(out) + "\n"


def _short(leg: str) -> str:
    return leg[:-3] if leg.endswith("_ms") else leg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="serve_report",
        description="per-request tail-latency attribution over merged "
                    "serving telemetry streams")
    ap.add_argument("paths", nargs="+",
                    help="telemetry dir(s) (rank-*.jsonl) or stream files")
    ap.add_argument("--json", action="store_true",
                    help="emit the report object as JSON")
    ap.add_argument("--straggler-x", type=float, default=None,
                    help="replica decode ms/token vs fleet median "
                         "(default MX_RQTRACE_STRAGGLER_X or "
                         f"{DEFAULT_STRAGGLER_X})")
    ap.add_argument("--slo-total-ms", type=float, default=0.0,
                    help="analysis-time end-to-end latency SLO "
                         "(0 = serve-time events only)")
    args = ap.parse_args(argv)
    try:
        streams, warnings = load_streams(args.paths)
    except OSError as e:
        print(f"serve_report: {e}", file=sys.stderr)
        return 2
    if not streams:
        print("serve_report: no telemetry streams found", file=sys.stderr)
        return 2
    report = build_report(streams, straggler_x=args.straggler_x,
                          slo_total_ms=args.slo_total_ms,
                          warnings=warnings)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        sys.stdout.write(format_text(report))
    return 3 if report["slo_violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
