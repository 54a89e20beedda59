"""``python -m repro_torch.obs`` — inspect traces and flight bundles.

Subcommands:

* ``summarize PATH`` — condensed view of a Chrome trace JSON (span /
  instant / counter totals per name) or a flight bundle (failure reason,
  step span, last snapshot);
* ``validate PATH`` — check a trace file against the documented schema
  (``docs/observability.md``); non-zero exit on any problem (the CI
  obs-smoke gate);
* ``convert BUNDLE -o OUT`` — extract a flight bundle's trace tail into a
  standalone Perfetto-loadable trace file;
* ``bottleneck PATH`` — per-step bandwidth attribution report from a
  traced run (top-K most expensive steps with their dominant term) or the
  aggregate blocks of a ``BENCH_serving.json`` (runs served with
  ``--attribution``).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import bottleneck as bottleneck_mod
from repro_torch.obs import flight as flight_mod
from repro_torch.obs import trace as trace_mod


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _is_bundle(doc: dict) -> bool:
    return "bundle_schema_version" in doc


def cmd_summarize(args: argparse.Namespace) -> int:
    doc = _load(args.path)
    if _is_bundle(doc):
        out = flight_mod.summarize_bundle(doc)
    else:
        out = trace_mod.summarize_trace(doc)
    json.dump(out, sys.stdout, indent=1, default=float)
    print()
    return 0


def cmd_validate(args: argparse.Namespace) -> int:
    doc = _load(args.path)
    errors = trace_mod.validate_trace(doc)
    if errors:
        for e in errors:
            print(f"INVALID {args.path}: {e}", file=sys.stderr)
        return 1
    n = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    print(f"ok: {args.path} ({n} events, schema v"
          f"{trace_mod.TRACE_SCHEMA_VERSION})")
    return 0


def cmd_bottleneck(args: argparse.Namespace) -> int:
    doc = _load(args.path)
    try:
        if "traceEvents" in doc:
            rep = bottleneck_mod.report_from_trace(doc, top_k=args.top)
        elif _is_bundle(doc):
            # Post-mortem: the last snapshot carries the at-failure ledger.
            snap = (doc.get("snapshots") or [{}])[-1]
            attr = snap.get("attribution")
            if not attr:
                print(f"{args.path}: bundle snapshots carry no attribution "
                      f"(was the run served with --attribution?)",
                      file=sys.stderr)
                return 1
            print(f"at-failure attribution (step {attr.get('step')}, "
                  f"label {attr.get('label')}, bw optimality "
                  f"{attr.get('optimal_fraction', 0.0):.3f}):")
            for comp, secs in attr.get("components", {}).items():
                print(f"  {comp:<20s} {secs:12.6f}s")
            return 0
        else:
            rep = bottleneck_mod.report_from_bench(doc)
    except ValueError as e:
        print(f"{args.path}: {e}", file=sys.stderr)
        return 1
    print(bottleneck_mod.format_report(rep))
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    bundle = flight_mod.load_bundle(args.path)
    tail = bundle.get("trace_tail")
    if not tail:
        print(f"{args.path}: bundle carries no trace tail (was the run "
              f"traced?)", file=sys.stderr)
        return 1
    rec = trace_mod.ChromeTraceRecorder(
        metadata={"converted_from": args.path,
                  "reason": bundle.get("reason")})
    rec.events.extend(tail)
    rec.save(args.out)
    print(f"wrote {args.out} ({len(tail)} events)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs", description="trace / flight-bundle tooling")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="summarize a trace or bundle")
    p.add_argument("path")
    p.set_defaults(fn=cmd_summarize)
    p = sub.add_parser("validate", help="validate a trace against the schema")
    p.add_argument("path")
    p.set_defaults(fn=cmd_validate)
    p = sub.add_parser("bottleneck",
                       help="attribution / bottleneck report from a trace, "
                            "bench JSON, or flight bundle")
    p.add_argument("path")
    p.add_argument("-k", "--top", type=int, default=5,
                   help="most-expensive steps to list (trace input only)")
    p.set_defaults(fn=cmd_bottleneck)
    p = sub.add_parser("convert", help="bundle trace tail -> trace JSON")
    p.add_argument("path")
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_convert)
    args = ap.parse_args(argv)
    return args.fn(args)
