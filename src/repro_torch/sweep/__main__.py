"""Sweep-campaign CLI.

  python -m repro_torch.sweep run <spec.json | builtin-name> [options]
  python -m repro_torch.sweep list
  python -m repro_torch.sweep show <builtin-name>
  python -m repro_torch.sweep cache [dir] [--prune]
  python -m repro_torch.sweep crosscheck <workload> [--n-tiles N] [--preset P]
  python -m repro_torch.sweep crosscheck-hlo [spec] [--engine E] [--no-cache]

``run`` prints a per-phase progress log, a ``name,value`` CSV summary
block, and writes the campaign record JSON (default:
``benchmarks/artifacts/campaigns/<name>.json`` when run from the repo
root, else ``./<name>.campaign.json``) plus a per-point JSONL journal
next to it. ``--backend spool`` routes refinement through a resumable
filesystem job spool (see ``python -m repro_torch.exec worker``): kill the
run, re-invoke it, and only never-finished points are re-simulated.
``cache`` reports entry count / size / lifetime hit-rate for a result
cache and ``--prune`` drops entries from older schema generations.

Port of ``repro/sweep/__main__.py``. ``run`` and ``crosscheck-hlo`` take
``--device``: the pre-screen runs the list-schedule kernel on the card by
default and raises when there is none; ``--device cpu`` runs its plain
version (the same records, bit for bit). ``list``, ``show``, ``cache`` and
``crosscheck`` are numpy only and take no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .runner import run_campaign, save_result
from .spec import builtin_spec_names, load_builtin_spec, load_spec

DEFAULT_CAMPAIGN_DIR = os.path.join("benchmarks", "artifacts", "campaigns")
DEFAULT_CACHE_DIR = os.path.join("benchmarks", "artifacts", "sweep_cache")
DEVICE_HELP = ("where the pre-screen runs: the CUDA card by default (raises "
               "without one); 'cpu' runs the list schedule's plain version")


def _default_out(name: str) -> str:
    if os.path.isdir("benchmarks"):
        return os.path.join(DEFAULT_CAMPAIGN_DIR, f"{name}.json")
    return f"{name}.campaign.json"


def _load_spec(name: str):
    """Load + validate a spec; returns None after printing a clean
    one-line error (bad name/path, unknown field, bad axis...)."""
    try:
        return load_spec(name)
    except (FileNotFoundError, KeyError, ValueError) as e:
        msg = e.args[0] if e.args else e   # KeyError reprs its arg
        print(f"error: {msg}", file=sys.stderr)
        return None


def cmd_run(args: argparse.Namespace) -> int:
    spec = _load_spec(args.spec)
    if spec is None:
        return 2
    if args.refine_mode:
        spec.refine.mode = args.refine_mode
    if args.engine:
        spec.refine.engine = args.engine
    if args.refine_batch is not None:
        if args.refine_batch < 0:
            print(f"--refine-batch must be >= 0, got {args.refine_batch}")
            return 2
        spec.refine.batch = args.refine_batch
    cache_dir = None
    if not args.no_cache:
        cache_dir = args.cache_dir or spec.cache_dir or DEFAULT_CACHE_DIR
    out = args.out or _default_out(spec.name)
    journal = args.journal
    if journal is None:
        base = out[:-len(".json")] if out.endswith(".json") else out
        journal = base + ".journal.jsonl"
    res = run_campaign(spec, workers=args.workers,
                       use_cache=not args.no_cache, cache_dir=cache_dir,
                       backend=args.backend, spool_dir=args.spool_dir,
                       journal_path=journal,
                       allow_partial=args.allow_partial, device=args.device,
                       progress=lambda m: print(f"  [{spec.name}] {m}"))
    save_result(res, out)
    s = res.summary
    print(f"campaign,{spec.name},")
    print(f"grid_points,{s['grid_points']},{s['cells']} cells")
    print(f"prescreen_s,{s['prescreen_s']:.3g},one kernel launch per part")
    print(f"backend,{s['backend']},")
    print(f"refined,{s['refined']},{s['cache_hits']} cache hits / "
          f"{s['simulated']} simulated")
    if s.get("failed"):
        print(f"failed,{s['failed']},coverage {s['coverage']:.3f} "
              f"(--allow-partial degraded points)")
    print(f"refine_s,{s['refine_s']:.3g},")
    if s.get("deviation_max") is not None:
        print(f"deviation_range,{s['deviation_min']:.3g},"
              f"max {s['deviation_max']:.3g} (event/analytic)")
    if "best_time_point" in s:
        b = s["best_time_point"]
        print(f"best_time_ns,{b['time_ns']:.6g},"
              f"{b['workload']} {b['overrides']}")
    if "best_goodput_point" in s:
        b = s["best_goodput_point"]
        print(f"best_goodput_rps,{b['goodput_rps']:.6g},"
              f"{b['workload']} ({b['chips']} chips, "
              f"{b['energy_per_req_j']:.4g} J/req)")
    print(f"artifact,{out},")
    print(f"journal,{journal},")
    return 0


def cmd_list(_args: argparse.Namespace) -> int:
    """List builtin specs with workload count, grid size, and the spec's
    one-line ``description`` field — how new campaigns are discovered."""
    names = builtin_spec_names()
    if not names:
        print("no builtin specs found")
        return 1
    for n in names:
        spec = load_builtin_spec(n)
        print(f"{n:>20s}  {len(spec.workloads):3d} workloads  "
              f"{spec.grid_size:6d} points  {len(spec.cells()):4d} cells  "
              f"refine={spec.refine.mode:<7s} {spec.description}")
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    spec = _load_spec(args.spec)
    if spec is None:
        return 2
    print(json.dumps(spec.to_dict(), indent=1))
    return 0


def cmd_cache(args: argparse.Namespace) -> int:
    from .cache import ResultCache, SCHEMA_VERSION

    cache = ResultCache(args.dir)
    st = cache.stats()
    print(f"cache_dir,{args.dir},")
    print(f"entries,{st['entries']},")
    print(f"bytes,{st['bytes']},")
    current = st["by_schema"].get(SCHEMA_VERSION, 0)
    stale = st["entries"] - current
    print(f"schema_current,{current},schema v{SCHEMA_VERSION}")
    print(f"schema_stale,{stale},older/untagged generations")
    life = cache.lifetime_stats()
    if life["runs"]:
        print(f"lifetime_hits,{life['hits']},over {life['runs']} campaigns")
        print(f"lifetime_misses,{life['misses']},")
        print(f"hit_rate,{life['hit_rate']:.3f},")
    if args.prune:
        removed = cache.prune()
        print(f"pruned,{removed},stale entries removed")
    return 0


def cmd_crosscheck(args: argparse.Namespace) -> int:
    """Run one point on BOTH refinement engines and print the deltas —
    the operational form of the fast engine's exactness contract."""
    from ..hw.presets import resolve_preset, to_dict
    from .refine import crosscheck_point, refine_payload

    try:
        # user-input resolution only: a deep KeyError inside the
        # simulation must surface as a traceback, not a usage error
        hw = to_dict(resolve_preset(args.preset))
        payload = refine_payload(
            workload=args.workload, n_tiles=args.n_tiles, hw=hw,
            compile_opts={}, pti_ns=args.pti_ns, temp_c=60.0,
            keep_series=False, engine="fast")
        from ..graph.workloads import resolve_workload
        resolve_workload(args.workload)
    except KeyError as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    out = crosscheck_point(payload)
    print(f"workload,{out['workload']},")
    print(f"extrapolated,{out['extrapolated']},"
          f"{out['replayed_tasks']}/{out['n_tasks']} tasks replayed")
    print(f"max_interval_diff_ns,{out['max_interval_diff_ns']:.6g},")
    print(f"makespan_diff_ns,{out['makespan_diff_ns']:.6g},")
    print(f"analytic_makespan_ns,{out['analytic_makespan_ns']:.6g},"
          f"list_schedule estimate, event/analytic "
          f"{out['analytic_ratio']:.3g}")
    worst = max(out["record_rel_diff"].items(), key=lambda kv: kv[1])
    print(f"worst_record_rel_diff,{worst[1]:.6g},{worst[0]}")
    for k, v in sorted(out["detail"].items()):
        print(f"detail.{k},{v},")
    return 0


def cmd_crosscheck_hlo(args: argparse.Namespace) -> int:
    """Run the builtin ``hlo_crosscheck`` campaign — every captured-HLO
    fixture and its hand-built twin through the analytic pre-screen and
    refinement — and report per-fixture deviation ratios against the
    bands documented in ``src/repro_torch/configs/hlo/manifest.json``;
    a spec with ``torch/<fixture>`` workloads (the port's captured
    programs: ``src/repro_torch/configs/torch_graphs/crosscheck.json``)
    reports theirs against ``configs/torch_graphs/manifest.json``'s bands
    and the HLO captures. Exit 1 when any cell lands out of band."""
    spec = _load_spec(args.spec)
    if spec is None:
        return 2
    if args.engine:
        spec.refine.engine = args.engine
    cache_dir = None if args.no_cache else (
        args.cache_dir or spec.cache_dir or DEFAULT_CACHE_DIR)
    out = args.out or _default_out(spec.name)
    res = run_campaign(spec, workers=args.workers,
                       use_cache=not args.no_cache, cache_dir=cache_dir,
                       backend=args.backend, device=args.device,
                       progress=lambda m: print(f"  [{spec.name}] {m}"))
    save_result(res, out)
    xck = res.summary.get("hlo_crosscheck") or {}
    txck = res.summary.get("torch_crosscheck") or {}
    if not xck and not txck:
        print("error: campaign paired no hlo/<fixture> or torch/<fixture> records "
              "with twins — check the spec's workloads", file=sys.stderr)
        return 2
    print(f"campaign,{spec.name},")
    print(f"grid_points,{res.summary['grid_points']},"
          f"{res.summary['cells']} cells")
    print(f"refined,{res.summary['refined']},"
          f"{res.summary['cache_hits']} cache hits")
    ok = True
    for tag, what, xs in (("fixture", "ingested", xck), ("torch_fixture", "captured", txck)):
        for fx, s in sorted(xs.items()):
            ok = ok and s["in_band"] == s["cells"]
            print(f"{tag},{fx},{s['in_band']}/{s['cells']} cells in band "
                  f"{s['band']} vs {s['twin']}")
            print(f"analytic_ratio,{s['analytic_ratio_min']:.4g},"
                  f"max {s['analytic_ratio_max']:.4g} ({what}/hand-built)")
            if s.get("hlo_analytic_ratio_min") is not None:
                print(f"hlo_analytic_ratio,{s['hlo_analytic_ratio_min']:.4g},"
                      f"max {s['hlo_analytic_ratio_max']:.4g} (captured/HLO capture)")
    refined_ratios = [r["hlo_deviation"]["refined_ratio"]
                      for r in res.records
                      if "refined_ratio" in r.get("hlo_deviation", {})]
    if refined_ratios:
        print(f"refined_ratio,{min(refined_ratios):.4g},"
              f"max {max(refined_ratios):.4g} (both engines refined)")
    print(f"artifact,{out},")
    print(f"in_band,{str(ok).lower()},")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="execute a campaign")
    rp.add_argument("spec", help="spec JSON path or builtin name")
    rp.add_argument("--backend", choices=("inline", "pool", "spool"),
                    default=None,
                    help="refinement execution service (default: inferred "
                         "from --workers: 0/1 inline, else pool)")
    rp.add_argument("--workers", type=int, default=None,
                    help="refinement worker processes "
                         "(default: one per core; 0 = inline; with "
                         "--backend spool: locally spawned spool workers, "
                         "0 = external workers only)")
    rp.add_argument("--spool-dir", default=None,
                    help="spool backend job directory (default: "
                         "<cache-root>/spool/<campaign>)")
    rp.add_argument("--journal", default=None,
                    help="per-point JSONL journal path "
                         "(default: <out>.journal.jsonl)")
    rp.add_argument("--no-cache", action="store_true",
                    help="ignore + don't write the result cache")
    rp.add_argument("--cache-dir", default=None)
    rp.add_argument("--out", default=None, help="campaign JSON output path")
    rp.add_argument("--refine-mode", choices=("pareto", "all", "none"),
                    default=None, help="override the spec's refine mode")
    rp.add_argument("--engine", choices=("event", "fast", "auto"),
                    default=None,
                    help="override the spec's refine engine (fast = "
                         "core.fastsim interval replay + steady-state "
                         "layer extrapolation)")
    rp.add_argument("--refine-batch", type=int, default=None,
                    help="override the spec's refine.batch: max points "
                         "per batched cross-point refinement job "
                         "(0/1 = per-point, the default)")
    rp.add_argument("--allow-partial", action="store_true",
                    help="graceful degradation: failed/quarantined "
                         "points become status:failed records with the "
                         "error attached instead of aborting the "
                         "campaign; the summary reports coverage")
    rp.add_argument("--device", default=None, help=DEVICE_HELP)
    rp.set_defaults(fn=cmd_run)

    lp = sub.add_parser("list", help="list builtin campaign specs")
    lp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("show", help="print a spec as JSON")
    sp.add_argument("spec")
    sp.set_defaults(fn=cmd_show)

    cp = sub.add_parser("cache", help="result-cache stats / maintenance")
    cp.add_argument("dir", nargs="?", default=DEFAULT_CACHE_DIR,
                    help=f"cache directory (default: {DEFAULT_CACHE_DIR})")
    cp.add_argument("--prune", action="store_true",
                    help="delete entries from other schema generations")
    cp.set_defaults(fn=cmd_cache)

    xp = sub.add_parser("crosscheck",
                        help="compare fast vs event refinement engines "
                             "on one workload point")
    xp.add_argument("workload", help="workload name, e.g. "
                    "lm/qwen3-32b/L32/s1024b8tp4pod8")
    xp.add_argument("--n-tiles", type=int, default=2)
    xp.add_argument("--preset", default="v5e")
    xp.add_argument("--pti-ns", type=float, default=100_000.0)
    xp.set_defaults(fn=cmd_crosscheck)

    hp = sub.add_parser(
        "crosscheck-hlo",
        help="run the builtin hlo_crosscheck campaign: captured HLO "
             "graphs vs their hand-built twins, deviation ratios "
             "checked against the fixture manifest's documented bands")
    hp.add_argument("spec", nargs="?", default="hlo_crosscheck",
                    help="spec JSON path or builtin name "
                         "(default: hlo_crosscheck)")
    hp.add_argument("--backend", choices=("inline", "pool", "spool"),
                    default=None)
    hp.add_argument("--workers", type=int, default=0)
    hp.add_argument("--no-cache", action="store_true")
    hp.add_argument("--cache-dir", default=None)
    hp.add_argument("--out", default=None)
    hp.add_argument("--engine", choices=("event", "fast", "auto"),
                    default=None,
                    help="override the spec's refine engine")
    hp.add_argument("--device", default=None, help=DEVICE_HELP)
    hp.set_defaults(fn=cmd_crosscheck_hlo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
