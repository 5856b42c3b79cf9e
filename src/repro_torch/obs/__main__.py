"""Observability CLI.

  python -m repro_torch.obs trace <point.json|journal.jsonl|workload> \
      [-o trace.json] [--preset v5e] [--n-tiles N] [--pti-ns NS]

Emits a Perfetto/Chrome trace ('traceEvents' JSON — load it at
ui.perfetto.dev or chrome://tracing) for:

* a refinement/serve **payload file** (``.json`` — the cache-keyed dict
  a campaign dispatches; ``kind: "serve"`` routes to the fleet
  exporter, anything else re-simulates on the event engine),
* a campaign **journal** (``.jsonl`` — worker lanes from the exec
  journal's wall timings),
* a bare **workload name** (e.g. ``lm/qwen3-32b/L8/s512b1tp1``) —
  a payload is synthesized from ``--preset``/``--n-tiles``/``--pti-ns``
  and simulated on the event engine.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .perfetto import (trace_campaign_journal, trace_event_point,
                       trace_serve_point, write_trace)


def _payload_for(args: argparse.Namespace) -> dict:
    if os.path.isfile(args.target):
        with open(args.target) as f:
            return json.load(f)
    from ..hw.presets import resolve_preset, to_dict
    from ..sweep.refine import refine_payload
    return refine_payload(workload=args.target, n_tiles=args.n_tiles,
                          hw=to_dict(resolve_preset(args.preset)),
                          compile_opts={}, pti_ns=args.pti_ns,
                          temp_c=args.temp_c, keep_series=False)


def cmd_trace(args: argparse.Namespace) -> int:
    if args.target.endswith(".jsonl"):
        trace = trace_campaign_journal(args.target)
        kind = "campaign-journal"
    else:
        payload = _payload_for(args)
        if payload.get("kind") == "serve":
            trace = trace_serve_point(payload)
            kind = "serve-point"
        else:
            trace = trace_event_point(payload)
            kind = "event-point"
    write_trace(trace, args.output)
    print(f"{kind}: {len(trace['traceEvents'])} events -> {args.output}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    tp = sub.add_parser("trace", help="export a Perfetto/Chrome trace")
    tp.add_argument("target",
                    help="payload .json, campaign journal .jsonl, or "
                         "workload name")
    tp.add_argument("-o", "--output", default="trace.json")
    tp.add_argument("--preset", default="v5e",
                    help="hw preset for bare workload names")
    tp.add_argument("--n-tiles", type=int, default=2)
    tp.add_argument("--pti-ns", type=float, default=10_000.0)
    tp.add_argument("--temp-c", type=float, default=60.0)
    tp.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
