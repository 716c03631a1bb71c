"""Render a run journal: ``python -m repro_torch.core.obs.report <journal.jsonl>``.

Reads the JSONL journal written by :class:`repro_torch.core.obs.JournalSink` and
prints (1) a top-line table (event totals, traces, commits, per-island and
per-tenant rollups) and (2) a per-trace timeline of stitched evaluation
spans — one line per span, indented under its trace, so a single eval
reads ``propose → submit → dispatch → worker(score rung-k) → harvest →
commit/reject``.  ``--trace <id>`` narrows to one trace; ``--limit N``
caps how many traces render (default 20, newest first).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path


def load_journal(path) -> list[dict]:
    events = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                # a torn tail line (killed writer) is expected forensics,
                # not an error — report what survived
                continue
    return events


def _by_trace(events) -> dict:
    traces: dict = defaultdict(list)
    for ev in events:
        # spans carry the lifecycle; traced non-span events (commit,
        # requeue) ride the same timeline
        if ev.get("trace"):
            traces[ev["trace"]].append(ev)
    return traces


def _span_line(ev: dict) -> str:
    bits = [ev.get("span") or ev.get("event", "?")]
    for k in ("island", "worker", "rung", "attempt", "tenant", "n"):
        if k in ev:
            bits.append(f"{k}={ev[k]}")
    if "dur_s" in ev:
        bits.append(f"{ev['dur_s'] * 1e3:.1f}ms")
    if ev.get("committed") is not None:
        bits.append("committed" if ev["committed"] else "rejected")
    return " ".join(str(b) for b in bits)


def summarize(events: list[dict]) -> dict:
    """Machine-readable rollup (the CLI prints it; tests assert on it)."""
    kinds: dict = defaultdict(int)
    islands: dict = defaultdict(lambda: {"commits": 0, "best": 0.0})
    tenants: dict = defaultdict(lambda: defaultdict(int))
    for ev in events:
        kinds[ev.get("event", "?")] += 1
        if ev.get("event") == "commit":
            isl = islands[ev.get("island", "?")]
            isl["commits"] += 1
            isl["best"] = max(isl["best"], float(ev.get("geomean", 0.0)))
        tenant = ev.get("tenant")
        if tenant is not None:
            tenants[tenant][ev.get("event", "?")] += 1
    traces = _by_trace(events)
    return {
        "events": len(events),
        "kinds": dict(sorted(kinds.items())),
        "traces": len(traces),
        "islands": {k: dict(v) for k, v in sorted(islands.items())},
        "tenants": {k: dict(v) for k, v in sorted(tenants.items())},
    }


def render(events: list[dict], trace=None, limit: int = 20,
           out=None) -> None:
    # resolve stdout at call time, not definition time, so redirected /
    # captured stdout (tests, piping through a pager) sees the render
    out = out if out is not None else sys.stdout
    s = summarize(events)
    print(f"journal: {s['events']} events, {s['traces']} traces", file=out)
    print("  by kind: " + ", ".join(f"{k}={n}" for k, n in
                                    s["kinds"].items()), file=out)
    if s["islands"]:
        print("  islands:", file=out)
        for name, row in s["islands"].items():
            print(f"    {name:>12}  commits={row['commits']:<4} "
                  f"best={row['best']:.1f} TFLOPS", file=out)
    if s["tenants"]:
        print("  tenants:", file=out)
        for tid, row in s["tenants"].items():
            flat = ", ".join(f"{k}={n}" for k, n in sorted(row.items()))
            label = tid or "(default)"   # the default tenant's id is ""
            print(f"    {label:>12}  {flat}", file=out)

    traces = _by_trace(events)
    if trace is not None:
        picked = [(trace, traces.get(trace, []))]
        if not picked[0][1]:
            print(f"trace {trace!r} not found", file=out)
            return
    else:
        picked = sorted(traces.items(),
                        key=lambda kv: kv[1][0]["t"])[-limit:]
    print(f"\ntimelines ({len(picked)} of {len(traces)} traces):", file=out)
    for tid, spans in picked:
        spans = sorted(spans, key=lambda e: e["t"])
        print(f"  {tid}:", file=out)
        for ev in spans:
            print(f"    {ev['t']:10.4f}  {_span_line(ev)}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.obs.report",
        description="Render a run journal (JSONL) as a timeline.")
    ap.add_argument("journal", type=Path, help="path to journal.jsonl")
    ap.add_argument("--trace", default=None,
                    help="render only this trace id")
    ap.add_argument("--limit", type=int, default=20,
                    help="max traces to render (newest first)")
    args = ap.parse_args(argv)
    if not args.journal.exists():
        print(f"no such journal: {args.journal}", file=sys.stderr)
        return 2
    render(load_journal(args.journal), trace=args.trace, limit=args.limit)
    return 0


if __name__ == "__main__":          # pragma: no cover - CLI entry
    sys.exit(main())
