"""`python -m shadow_tpu_torch.cli sweep` — run and inspect
counterfactual sweeps (PyTorch port of shadow_tpu/sweep/cli.py).

    python -m shadow_tpu_torch.cli sweep run --spec sweep.json \
        --sweep-dir out/ --workers 2 [--platform cpu]
    python -m shadow_tpu_torch.cli sweep run --sweep-dir out/ --resume
    python -m shadow_tpu_torch.cli sweep status --sweep-dir out/
    python -m shadow_tpu_torch.cli sweep report --sweep-dir out/ --top 10

`--platform` sets the device the prewarm and every worker run on: `gpu`
(the default, the card; it fails without CUDA) or `cpu`.

Exit codes (docs/10-sweep.md):
  0  sweep complete with a ranked best point (failed / quarantined
     points are accounted, not fatal)
  1  sweep complete but no point was rankable
  2  usage error
  5  preempted (SIGTERM): rerun with --resume
  6  stalled (the fleet lost every worker and its respawn budget)
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.cli sweep",
        description="warm-pool counterfactual sweep engine")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="execute a sweep")
    r.add_argument("--spec", help="sweep spec JSON (optional with "
                                  "--resume: reloads from the dir)")
    r.add_argument("--sweep-dir", required=True,
                   help="durable sweep state: sweep journal, fleet "
                        "journal, job dirs, report")
    r.add_argument("--workers", type=int, default=2)
    r.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="the prewarm's and the workers' device: gpu "
                        "(the card; no CUDA fails the points) or cpu")
    r.add_argument("--resume", action="store_true",
                   help="replay the sweep + fleet journals; "
                        "completed points are not re-run")
    r.add_argument("--no-prewarm", action="store_true",
                   help="skip the distinct-program prewarm pass "
                        "(workers compile on first lease instead)")
    r.add_argument("--no-fsync", action="store_true",
                   help="skip journal fsyncs (tests only; forfeits "
                        "power-loss durability)")

    s = sub.add_parser("status", help="summarize a sweep dir "
                                      "(read-only)")
    s.add_argument("--sweep-dir", required=True)

    rp = sub.add_parser("report", help="print the ranked report")
    rp.add_argument("--sweep-dir", required=True)
    rp.add_argument("--top", type=int, default=0,
                    help="limit ranking rows (0 = all)")
    return p


def _cmd_run(args) -> int:
    from shadow_tpu_torch.sweep.driver import SweepDriver
    from shadow_tpu_torch.sweep.plan import SweepSpec

    spec = None
    if args.spec:
        spec = SweepSpec.from_file(args.spec)
    elif not args.resume:
        print("error: sweep run needs --spec (or --resume with an "
              "existing sweep dir)", file=sys.stderr)
        return 2
    prewarm = False if args.no_prewarm else None
    driver = SweepDriver(
        args.sweep_dir, spec, workers=args.workers,
        resume=args.resume, fsync=not args.no_fsync, prewarm=prewarm,
        log=lambda m: print(m, file=sys.stderr),
        device="cpu" if args.platform == "cpu" else "cuda")
    rc = driver.run(install_signals=True)
    block = driver.report()
    print(json.dumps({
        "exit": rc, "id": block["id"], "complete": block["complete"],
        "points": block["points"], "best": block.get("best"),
        "census": block["census"]["distinct"],
        "report": os.path.join(args.sweep_dir, "sweep_report.json"),
    }))
    return rc


def _cmd_status(args) -> int:
    """Read-only: replays both journals, touches neither."""
    from shadow_tpu_torch.fleet import journal as journal_mod
    from shadow_tpu_torch.fleet.cli import fold_job_status
    from shadow_tpu_torch.sweep import driver as driver_mod

    frames, _ = journal_mod.replay(
        os.path.join(args.sweep_dir, driver_mod.SWEEP_JOURNAL))
    if not frames:
        print(f"error: no sweep journal in {args.sweep_dir}",
              file=sys.stderr)
        return 2
    records, _ = journal_mod.replay(
        os.path.join(args.sweep_dir, "journal.log"))
    status, _ = fold_job_status(records)
    out = driver_mod.fold_sweep_status(frames, status)
    rpath = os.path.join(args.sweep_dir, driver_mod.SWEEP_REPORT)
    if os.path.isfile(rpath):
        out["report"] = rpath
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def _cmd_report(args) -> int:
    rpath = os.path.join(args.sweep_dir, "sweep_report.json")
    if not os.path.isfile(rpath):
        print(f"error: no sweep_report.json in {args.sweep_dir} "
              f"(sweep still running? try `sweep status`)",
              file=sys.stderr)
        return 2
    with open(rpath) as f:
        rep = json.load(f)
    if args.top and rep.get("ranking"):
        rep["ranking"] = rep["ranking"][:args.top]
    print(json.dumps(rep, indent=1, sort_keys=True))
    return 0


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "status":
        return _cmd_status(args)
    return _cmd_report(args)


if __name__ == "__main__":
    sys.exit(main())
