#!/usr/bin/env python
"""Gang-wide memory & compile-cost report over per-rank telemetry JSONL
streams.

``memwatch.py`` records ``mem`` samples (per-device watermarks +
categorized live-array census), ``mem_leak`` warnings, per-executable
``compile`` cost events, and ``oom_report`` post-mortems into the same
``rank-<R>.jsonl`` streams telemetry writes; this CLI merges them into
the after-the-run questions:

  * **per-rank watermark / category table** — peak bytes per rank, the
    last census split by category (params / optimizer / inflight /
    checkpoint / other), and each category's own high-water mark;
  * **leak-trend verdict** — the trailing-window monotonic-growth check
    re-run offline over each rank's samples (same rule as the in-process
    detector: strictly increasing totals across the window above a noise
    floor), plus any ``mem_leak`` events the run recorded live.  Verdict
    per rank: ``leak`` / ``clean`` / ``no-data``;
  * **executable cost table** — one row per ``compile`` event: executor,
    stable fingerprint (the AOT-cache key), compile wall, FLOPs,
    argument/output/temp bytes where the run captured them, and the
    AOT-cache disposition — entries the run DESERIALIZED from the
    persistent executable cache (``MX_EXECUTABLE_CACHE_DIR``) are marked
    ``hit`` with their deserialize wall, so a post-mortem distinguishes
    "loaded in 0.2s" from "compiled in 40s";
  * **OOM post-mortems** — any ``oom_report`` echoed verbatim (largest
    category, watermark, in-flight depth, top executables).

Exit code: 0 clean, 2 usage/IO error (no rank streams), 3 when anomalies
were flagged (a leak verdict or an OOM) — CI and the launch.py
supervisor can key off it, mirroring ``trace_report.py``.  ``--json``
emits the full report object.

Importable WITHOUT torch or the package (stdlib only), like trace_report.py:
the JSONL schema knowledge is shared with ``memwatch.py`` —
keep the two in sync.  The leak window falls back to the same
``MX_MEMWATCH_LEAK_WINDOW`` knob the in-process detector reads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

__all__ = ["load_gang", "build_report", "format_text", "main"]

DEFAULT_LEAK_WINDOW = 12
# same noise floor as memwatch._LEAK_MIN_GROWTH: strictly-increasing
# growth below this across the whole window is allocator jitter
LEAK_MIN_GROWTH = 1 << 16


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
def load_gang(directory: str) -> Dict[int, List[dict]]:
    """{rank: [events...]} for every rank-<R>.jsonl under ``directory``
    (torn lines skipped, like trace_report)."""
    ranks: Dict[int, List[dict]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        raise SystemExit(f"mem_report: cannot read {directory}: {e}")
    for name in names:
        if not (name.startswith("rank-") and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len("rank-"):-len(".jsonl")])
        except ValueError:
            continue
        events: List[dict] = []
        with open(os.path.join(directory, name), errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn final line of a SIGKILLed rank
                if isinstance(ev, dict) and "kind" in ev:
                    events.append(ev)
        ranks[rank] = events
    return ranks


def _cat_bytes(ev: dict) -> Dict[str, int]:
    out = {}
    for cat, row in (ev.get("categories") or {}).items():
        out[cat] = int(row.get("nbytes", 0)) if isinstance(row, dict) \
            else int(row)
    return out


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------
def _leak_verdict(mems: List[dict], window: int) -> dict:
    """Offline re-run of the in-process trend rule over the TRAILING
    window of samples: strictly monotonic growth of the live total above
    the noise floor = leak; fewer samples than the window = no-data."""
    if len(mems) < window:
        return {"verdict": "no-data", "samples": len(mems),
                "window": window}
    tail = mems[-window:]
    totals = [int(e.get("live_bytes", 0)) for e in tail]
    growing = all(b > a for a, b in zip(totals, totals[1:]))
    growth = totals[-1] - totals[0]
    if growing and growth > LEAK_MIN_GROWTH:
        first, last = _cat_bytes(tail[0]), _cat_bytes(tail[-1])
        deltas = {c: last.get(c, 0) - first.get(c, 0)
                  for c in set(first) | set(last)}
        top = max(deltas, key=deltas.get) if deltas else "other"
        return {"verdict": "leak", "samples": len(mems), "window": window,
                "growth_bytes": growth, "category": top,
                "category_growth_bytes": deltas.get(top, 0)}
    return {"verdict": "clean", "samples": len(mems), "window": window,
            "growth_bytes": growth}


def _rank_mem(events: List[dict], window: int) -> dict:
    mems = [e for e in events if e.get("kind") == "mem"]
    leaks = [e for e in events if e.get("kind") == "mem_leak"]
    watermark = max((int(e.get("watermark_bytes", 0)) for e in mems),
                    default=0)
    peak_cats: Dict[str, int] = {}
    for e in mems:
        for cat, nb in _cat_bytes(e).items():
            peak_cats[cat] = max(peak_cats.get(cat, 0), nb)
    last = mems[-1] if mems else {}
    # an elastic resize restarts the process: a verdict window spanning
    # the boundary mixes two allocator lifetimes, and the fresh
    # incarnation's normal ramp-up (params placed, caches warming) reads
    # as monotonic "leak" growth.  The trend rule runs on the newest
    # segment only; watermark/peaks above stay whole-stream.
    resize_stamps = [float(e["t"]) for e in events
                     if e.get("kind") == "resize" and "t" in e]
    trend_mems = mems
    if resize_stamps:
        cut = max(resize_stamps)
        trend_mems = [e for e in mems if float(e.get("t", cut)) >= cut]
    verdict = _leak_verdict(trend_mems, window)
    if leaks and verdict["verdict"] != "leak":
        # the live detector fired mid-run even if the trailing window
        # has since flattened (e.g. the leak crashed the run) — a
        # recorded leak is a leak
        verdict = dict(verdict, verdict="leak",
                       category=leaks[-1].get("category"),
                       growth_bytes=leaks[-1].get("growth_bytes", 0))
    return {
        "samples": len(mems),
        "watermark_bytes": watermark,
        "live_bytes_last": int(last.get("live_bytes", 0)),
        "categories_last": _cat_bytes(last),
        "peak_category_bytes": peak_cats,
        "host_bytes_last": last.get("host_bytes", {}),
        "bytes_in_use_last": last.get("bytes_in_use"),
        "bytes_limit": last.get("bytes_limit"),
        "leak": verdict,
        "recorded_leak_events": len(leaks),
    }


def _executables(ranks: Dict[int, List[dict]]) -> List[dict]:
    rows = []
    seen = set()
    for rank, events in sorted(ranks.items()):
        for e in events:
            if e.get("kind") != "compile":
                continue
            key = (rank, e.get("executor"), e.get("fingerprint"))
            if key in seen:
                continue
            seen.add(key)
            rows.append({
                "rank": rank,
                "executor": e.get("executor", "?"),
                "fingerprint": e.get("fingerprint", "?"),
                "site": e.get("site", ""),
                "wall_ms": float(e.get("wall_ms", 0.0)),
                "flops": e.get("flops"),
                "bytes_accessed": e.get("bytes_accessed"),
                "arg_bytes": e.get("arg_bytes"),
                "out_bytes": e.get("out_bytes"),
                "temp_bytes": e.get("temp_bytes"),
                "cache_hit": bool(e.get("cache_hit", False)),
                "deserialize_ms": e.get("deserialize_ms"),
            })
    rows.sort(key=lambda r: (-(r["temp_bytes"] or 0),
                             -(r["bytes_accessed"] or 0), -r["wall_ms"]))
    return rows


def build_report(directory: str, window: Optional[int] = None) -> dict:
    if window is None:
        window = _env_int("MX_MEMWATCH_LEAK_WINDOW", DEFAULT_LEAK_WINDOW)
    # clamp user input too: --window 0 must not slice mems[-0:] = the
    # whole stream while claiming a zero-sample window
    window = max(2, window)
    ranks = load_gang(directory)
    per_rank = {r: _rank_mem(events, window)
                for r, events in ranks.items()}
    ooms = []
    for rank, events in sorted(ranks.items()):
        for e in events:
            if e.get("kind") == "oom_report":
                ooms.append(dict(e, rank=rank))
    anomalies = []
    for r, s in sorted(per_rank.items()):
        if s["leak"]["verdict"] == "leak":
            anomalies.append(
                f"leak: rank {r} live bytes grew monotonically "
                f"(+{s['leak'].get('growth_bytes', 0)}B over the last "
                f"{s['leak']['window']} samples); top-growing category: "
                f"{s['leak'].get('category')}")
    for e in ooms:
        anomalies.append(
            f"oom: rank {e['rank']} RESOURCE_EXHAUSTED at step "
            f"{e.get('step')}; largest live-array category: "
            f"{e.get('largest_category')}")
    return {
        "dir": os.path.abspath(directory),
        "num_ranks": len(ranks),
        "window": window,
        "per_rank": {str(r): s for r, s in sorted(per_rank.items())},
        "executables": _executables(ranks),
        "ooms": ooms,
        "anomalies": anomalies,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n}B"


def format_text(rep: dict) -> str:
    out: List[str] = []
    w = out.append
    w(f"gang memory report — {rep['dir']} ({rep['num_ranks']} rank(s), "
      f"leak window={rep['window']})")
    w("")
    w("per-rank watermarks & categories")
    w(f"  {'rank':>4} {'samples':>8} {'watermark':>11} {'live now':>10} "
      f"{'leak':>8}  categories (last sample)")
    for r, s in rep["per_rank"].items():
        cats = "  ".join(f"{c}={_fmt_bytes(b)}"
                         for c, b in sorted(s["categories_last"].items()))
        w(f"  {r:>4} {s['samples']:>8} "
          f"{_fmt_bytes(s['watermark_bytes']):>11} "
          f"{_fmt_bytes(s['live_bytes_last']):>10} "
          f"{s['leak']['verdict']:>8}  {cats}")
        if s["leak"]["verdict"] == "leak":
            w(f"       leak: +{_fmt_bytes(s['leak'].get('growth_bytes'))} "
              f"over {s['leak']['window']} samples; top-growing "
              f"category: {s['leak'].get('category')}")
        if s["host_bytes_last"]:
            hb = "  ".join(f"{c}={_fmt_bytes(b)}"
                           for c, b in sorted(s["host_bytes_last"].items()))
            w(f"       host buffers: {hb}")
    w("")
    if rep["executables"]:
        w("executable cost table (compile events)")
        w(f"  {'rank':>4} {'executor':<34} {'fingerprint':<17} "
          f"{'wall ms':>9} {'flops':>12} {'args':>9} {'out':>9} "
          f"{'temp':>9} {'aot':>12}")
        for row in rep["executables"]:
            flops = (f"{row['flops']:.3g}" if row["flops"] is not None
                     else "-")
            # "hit(0.2s)" = deserialized from the persistent AOT cache,
            # never compiled in this process; "-" = compiled fresh
            if row["cache_hit"]:
                des = row.get("deserialize_ms")
                aot = (f"hit({des / 1e3:.1f}s)" if des is not None
                       else "hit")
            else:
                aot = "-"
            w(f"  {row['rank']:>4} {row['executor']:<34.34} "
              f"{row['fingerprint']:<17} {row['wall_ms']:>9.1f} "
              f"{flops:>12} {_fmt_bytes(row['arg_bytes']):>9} "
              f"{_fmt_bytes(row['out_bytes']):>9} "
              f"{_fmt_bytes(row['temp_bytes']):>9} {aot:>12}")
        w("")
    for e in rep["ooms"]:
        w(f"OOM post-mortem: rank {e['rank']} step {e.get('step')}: "
          f"largest category {e.get('largest_category')} "
          f"({_fmt_bytes((e.get('categories') or {}).get(e.get('largest_category'), 0))}); "
          f"watermark {_fmt_bytes(e.get('watermark_bytes'))}; "
          f"inflight depth {e.get('inflight_depth')}")
    if rep["ooms"]:
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
                    "memory report (watermarks, category census, leak "
                    "verdicts, executable cost table, OOM post-mortems).")
    ap.add_argument("directory", help="MX_TELEMETRY_DIR of the run")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report object")
    ap.add_argument("--window", type=int, default=None, metavar="N",
                    help="trailing-sample window for the leak verdict "
                         "(default: MX_MEMWATCH_LEAK_WINDOW or "
                         f"{DEFAULT_LEAK_WINDOW})")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.directory):
        print(f"mem_report: {args.directory} is not a directory",
              file=sys.stderr)
        return 2
    rep = build_report(args.directory, window=args.window)
    if rep["num_ranks"] == 0:
        print(f"mem_report: no rank-*.jsonl streams under "
              f"{args.directory}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep))
    else:
        print(format_text(rep))
    return 3 if rep["anomalies"] else 0


if __name__ == "__main__":
    sys.exit(main())
