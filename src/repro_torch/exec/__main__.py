"""Execution-service CLI.

  python -m repro_torch.exec worker <spool> [--follow] [--max-jobs N]
  python -m repro_torch.exec janitor <spool> [--once] [--interval S]
  python -m repro_torch.exec status <spool-dir|journal.jsonl> [--watch]
  python -m repro_torch.exec journal <file> [--expect-done] [--allow-failed]

``worker`` drains (or, with ``--follow``, keeps watching) a filesystem
job spool — run any number of these, from any process or host sharing
the spool directory. ``janitor`` is the standalone maintenance daemon
(lease reclaim, poison quarantine, ``.tmp``/corrupt GC, ``done/``
compaction) — pair one with any shared spool so a dead runner never
strands the fleet; ``--once`` does a single sweep and exits. ``status``
on a spool directory prints queue counts plus backoff and quarantine
detail (``backed_off``, ``next_retry_eta_s``, ``quarantined``); on a
campaign journal it folds per-phase throughput (points/s, cached vs
simulated), per-worker liveness, and an ETA — ``--watch`` tails the
journal incrementally (complete lines only, torn-tail safe) and
reprints until the campaign finishes. ``journal`` folds a campaign
journal into per-status counts; ``--expect-done`` exits non-zero unless
every point resolved (the CI smoke assertion; add ``--allow-failed``
for ``--allow-partial`` campaigns where failed is a terminal status).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .journal import CampaignJournal
from .spool import Spool
from .worker import run_worker


def cmd_worker(args: argparse.Namespace) -> int:
    n = run_worker(args.spool, drain=not args.follow, poll_s=args.poll_s,
                   hb_s=args.hb_s, max_jobs=args.max_jobs,
                   log=lambda m: print(m, flush=True))
    print(f"worker exit: {n} jobs completed")
    return 0


def cmd_janitor(args: argparse.Namespace) -> int:
    from .janitor import run_janitor
    n = run_janitor(args.spool, interval_s=args.interval,
                    lease_s=args.lease_s, tmp_age_s=args.tmp_age_s,
                    corrupt_age_s=args.corrupt_age_s,
                    compact_age_s=(None if args.no_compact
                                   else args.compact_age_s),
                    iterations=1 if args.once else args.passes,
                    journal_path=args.journal,
                    log=lambda m: print(m, flush=True))
    print(f"janitor exit: {n} jobs reclaimed")
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    if os.path.isdir(args.path):
        spool = Spool(args.path)
        while True:
            st = spool.status()
            for k, v in st.items():
                if v is None:
                    continue
                v = f"{v:.1f}" if isinstance(v, float) else v
                print(f"{k},{v}", flush=True)
            if not args.watch or (st["jobs"] == 0 and st["active"] == 0):
                return 0
            time.sleep(args.interval)
    # a campaign journal: fold incrementally into progress + ETA
    from ..obs.progress import (CampaignProgress, JournalFollower,
                                render_progress)
    prog = CampaignProgress()
    follower = JournalFollower(args.path)
    while True:
        prog.feed_all(follower.poll())
        for w in follower.warnings:
            print(f"warning: {w}", file=sys.stderr)
        follower.warnings.clear()
        s = prog.summary(now=time.time() if args.watch else None)
        for line in render_progress(s):
            print(line, flush=True)
        if not args.watch or s["finished"]:
            return 0
        time.sleep(args.interval)


def cmd_journal(args: argparse.Namespace) -> int:
    view = CampaignJournal.load(args.path)
    for w in view.warnings:
        print(f"warning: {w}", file=sys.stderr)
    counts = view.counts()
    for k in ("total", "done", "cached", "failed", "other"):
        print(f"{k},{counts[k]}")
    if view.summary:
        print(f"summary,{json.dumps(view.summary, sort_keys=True)}")
    if args.expect_done:
        ok = view.all_done(min_points=args.min_points,
                           allow_failed=args.allow_failed)
        print(f"all_done,{ok}")
        return 0 if ok else 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.exec",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    wp = sub.add_parser("worker", help="drain/follow a job spool")
    wp.add_argument("spool", help="spool directory")
    wp.add_argument("--follow", action="store_true",
                    help="keep polling instead of exiting when drained")
    wp.add_argument("--poll-s", type=float, default=0.5)
    wp.add_argument("--hb-s", type=float, default=5.0,
                    help="heartbeat interval (lease keep-alive)")
    wp.add_argument("--max-jobs", type=int, default=None)
    wp.set_defaults(fn=cmd_worker)

    janp = sub.add_parser(
        "janitor", help="spool maintenance daemon: lease reclaim, "
                        "poison quarantine, .tmp/corrupt GC, done/ "
                        "compaction")
    janp.add_argument("spool", help="spool directory")
    janp.add_argument("--interval", type=float, default=10.0,
                      help="seconds between maintenance passes")
    janp.add_argument("--once", action="store_true",
                      help="single pass, then exit")
    janp.add_argument("--passes", type=int, default=None,
                      help="exit after N passes (default: run forever)")
    janp.add_argument("--lease-s", type=float, default=None,
                      help="override the spool's reclaim lease")
    janp.add_argument("--tmp-age-s", type=float, default=300.0,
                      help="GC .tmp staging files older than this")
    janp.add_argument("--corrupt-age-s", type=float, default=300.0,
                      help="GC torn done/ files older than this")
    janp.add_argument("--compact-age-s", type=float, default=60.0,
                      help="compact done/ files older than this")
    janp.add_argument("--no-compact", action="store_true",
                      help="disable done/ compaction")
    janp.add_argument("--journal", default=None,
                      help="append ev:janitor lines to this campaign "
                           "journal")
    janp.set_defaults(fn=cmd_janitor)

    stp = sub.add_parser(
        "status", help="spool queue counts, or campaign progress + ETA "
                       "from a journal file")
    stp.add_argument("path", help="spool directory or journal .jsonl")
    stp.add_argument("--watch", action="store_true",
                     help="keep tailing/reprinting until finished")
    stp.add_argument("--interval", type=float, default=2.0,
                     help="watch poll interval in seconds")
    stp.set_defaults(fn=cmd_status)

    jp = sub.add_parser("journal", help="summarize a campaign journal")
    jp.add_argument("path")
    jp.add_argument("--expect-done", action="store_true",
                    help="exit 1 unless all points are done/cached")
    jp.add_argument("--allow-failed", action="store_true",
                    help="with --expect-done: failed counts as terminal "
                         "(--allow-partial campaigns)")
    jp.add_argument("--min-points", type=int, default=1)
    jp.set_defaults(fn=cmd_journal)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
