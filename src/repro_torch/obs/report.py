"""Summarize a merged pPython trace.

``python -m repro_torch.obs.report TRACE.json [...]`` prints, per trace:

* a per-op table — event count, total/mean duration, bytes moved, and
  effective bandwidth where byte counts are attached;
* a per-rank table — wall window, time under comm-category spans
  (``comm.*`` / ``coll.*``, interval-union so nested spans are not
  double-counted), and the comm-vs-compute fraction.

``--validate`` checks the document against the checked-in schema
(``trace_schema.json``) with a small dependency-free validator that
covers the subset of JSON Schema the schema file uses: ``type``,
``required``, ``properties``, ``items``, ``enum``, ``minimum``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

COMM_CATEGORIES = ("comm", "coll")

_TYPES: dict[str, tuple[type, ...]] = {
    "object": (dict,),
    "array": (list,),
    "string": (str,),
    "number": (int, float),
    "integer": (int,),
    "boolean": (bool,),
}


def validate(doc: Any, schema: dict, path: str = "$") -> list[str]:
    """Return a list of violations (empty = valid)."""
    errs: list[str] = []
    t = schema.get("type")
    if t is not None:
        ok = isinstance(doc, _TYPES[t])
        if t in ("number", "integer") and isinstance(doc, bool):
            ok = False
        if not ok:
            return [f"{path}: expected {t}, got {type(doc).__name__}"]
    if "enum" in schema and doc not in schema["enum"]:
        errs.append(f"{path}: {doc!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(doc, (int, float)) \
            and not isinstance(doc, bool) and doc < schema["minimum"]:
        errs.append(f"{path}: {doc} < minimum {schema['minimum']}")
    if isinstance(doc, dict):
        for req in schema.get("required", ()):
            if req not in doc:
                errs.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in doc:
                errs.extend(validate(doc[key], sub, f"{path}.{key}"))
    if isinstance(doc, list) and "items" in schema:
        sub = schema["items"]
        for i, item in enumerate(doc):
            errs.extend(validate(item, sub, f"{path}[{i}]"))
            if len(errs) > 50:
                errs.append(f"{path}: ... (truncated)")
                break
    return errs


def default_schema() -> dict:
    with open(Path(__file__).parent / "trace_schema.json") as f:
        return json.load(f)


def _union_length(intervals: list[tuple[float, float]]) -> float:
    """Total covered length of possibly-overlapping intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)


def summarize(doc: dict) -> dict:
    """Aggregate a merged trace document.

    Returns ``{"ops": {name: {...}}, "ranks": {pid: {...}}}`` with
    durations in seconds and bytes summed where the events carry them.
    """
    ops: dict[str, dict[str, float]] = {}
    per_rank_spans: dict[int, list[tuple[str, float, float]]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev["name"]
        ts = ev.get("ts", 0.0) / 1e6
        dur = ev.get("dur", 0.0) / 1e6
        o = ops.setdefault(name, {"count": 0, "total_s": 0.0, "bytes": 0})
        o["count"] += 1
        o["total_s"] += dur
        b = (ev.get("args") or {}).get("bytes")
        if isinstance(b, (int, float)) and b > 0:
            o["bytes"] += b
        per_rank_spans.setdefault(ev.get("pid", 0), []).append(
            (name, ts, ts + dur)
        )

    for o in ops.values():
        o["mean_us"] = (o["total_s"] / o["count"]) * 1e6 if o["count"] else 0.0
        o["gib_s"] = (
            o["bytes"] / o["total_s"] / 2**30 if o["total_s"] > 0 else 0.0
        )

    ranks: dict[int, dict[str, float]] = {}
    for pid, spans in sorted(per_rank_spans.items()):
        lo = min(s[1] for s in spans)
        hi = max(s[2] for s in spans)
        wall = hi - lo
        comm = _union_length(
            [(a, b) for name, a, b in spans
             if name.split(".", 1)[0] in COMM_CATEGORIES]
        )
        ranks[pid] = {
            "events": len(spans),
            "wall_s": wall,
            "comm_s": comm,
            "comm_frac": comm / wall if wall > 0 else 0.0,
            "compute_frac": 1.0 - comm / wall if wall > 0 else 0.0,
        }
    return {"ops": ops, "ranks": ranks}


def print_report(path: str, doc: dict, out=sys.stdout) -> None:
    s = summarize(doc)
    np_ = (doc.get("otherData") or {}).get("np", len(s["ranks"]))
    print(f"\n== {path} (np={np_}) ==", file=out)
    print(f"{'op':<24}{'count':>8}{'total ms':>12}{'mean us':>12}"
          f"{'bytes':>14}{'GiB/s':>10}", file=out)
    for name, o in sorted(s["ops"].items(),
                          key=lambda kv: -kv[1]["total_s"]):
        gib = f"{o['gib_s']:.3f}" if o["bytes"] else "-"
        print(f"{name:<24}{o['count']:>8}{o['total_s'] * 1e3:>12.3f}"
              f"{o['mean_us']:>12.1f}{o['bytes']:>14}{gib:>10}", file=out)
    print(f"\n{'rank':<6}{'events':>8}{'wall ms':>12}{'comm ms':>12}"
          f"{'comm %':>9}{'compute %':>11}", file=out)
    for pid, r in sorted(s["ranks"].items()):
        print(f"{pid:<6}{r['events']:>8}{r['wall_s'] * 1e3:>12.3f}"
              f"{r['comm_s'] * 1e3:>12.3f}{r['comm_frac'] * 100:>8.1f}%"
              f"{r['compute_frac'] * 100:>10.1f}%", file=out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("traces", nargs="+", help="merged trace JSON file(s)")
    ap.add_argument("--validate", action="store_true",
                    help="check each trace against the schema; exit 1 on "
                         "violation")
    ap.add_argument("--schema", default=None,
                    help="alternate JSON schema file")
    args = ap.parse_args(argv)

    schema = None
    if args.validate:
        if args.schema:
            with open(args.schema) as f:
                schema = json.load(f)
        else:
            schema = default_schema()

    bad = 0
    for path in args.traces:
        with open(path) as f:
            doc = json.load(f)
        if schema is not None:
            errs = validate(doc, schema)
            if errs:
                bad += 1
                print(f"{path}: INVALID", file=sys.stderr)
                for e in errs[:20]:
                    print(f"  {e}", file=sys.stderr)
                continue
            print(f"{path}: schema OK "
                  f"({len(doc.get('traceEvents', []))} events)")
        print_report(path, doc)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
