"""`python -m shadow_tpu_torch.cli fleet` — run and inspect scenario
fleets (PyTorch port of shadow_tpu/fleet/cli.py).

    python -m shadow_tpu_torch.cli fleet run --jobs-file sweep.json \
        --fleet-dir out/ --workers 4 [--platform cpu]
    python -m shadow_tpu_torch.cli fleet run --fleet-dir out/ --resume
    python -m shadow_tpu_torch.cli fleet status --fleet-dir out/

`--platform` sets the device every worker (and the resident program)
runs on: `gpu` (the default, the card; it fails without CUDA) or
`cpu`.

Exit codes (docs/8-fleet.md §exit codes):
  0  fleet complete; every job done (quarantined jobs are parked
     with their salvage, which is success in salvage mode)
  1  unsalvaged failures (a non-retryable job, or any quarantine
     under --no-salvage)
  2  usage error
  5  preempted (SIGTERM): in-flight jobs checkpointed and requeued;
     rerun with --resume
  6  stalled: jobs remain but every worker (and the respawn budget)
     is gone
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from shadow_tpu_torch.fleet.spec import FleetPolicy, load_jobs_file

_POLICY_FILE = "fleet_policy.json"


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.cli fleet",
        description="fault-tolerant scenario-fleet runner")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="execute a fleet of jobs")
    r.add_argument("--jobs-file",
                   help="JSON jobs file (optional with --resume: "
                        "specs reload from the fleet dir)")
    r.add_argument("--fleet-dir", required=True,
                   help="durable fleet state: journal, job dirs, "
                        "fleet_manifest.json")
    r.add_argument("--workers", type=int, default=2)
    r.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="the workers' device: gpu (the card; no CUDA "
                        "fails the jobs) or cpu")
    r.add_argument("--resume", action="store_true",
                   help="replay the journal; completed jobs are not "
                        "re-run")
    r.add_argument("--no-salvage", action="store_true",
                   help="treat quarantined jobs as fleet failure "
                        "(exit 1) instead of parked successes")
    r.add_argument("--drain-timeout", type=float, default=60.0,
                   help="seconds to wait for preempted jobs to "
                        "checkpoint on SIGTERM")
    r.add_argument("--no-fsync", action="store_true",
                   help="skip journal fsyncs (tests only; forfeits "
                        "power-loss durability)")
    r.add_argument("--resident", action="store_true",
                   help="continuous lane admission: run every job as "
                        "a tenant lease of ONE resident packed "
                        "program (fleet/admission.py) instead of one "
                        "worker process per job; joins/leaves happen "
                        "at window barriers with zero retraces")
    r.add_argument("--resident-lanes", type=int, default=None,
                   help="lane count of the resident program "
                        "(default: max(2, number of jobs))")
    r.add_argument("--resident-horizon-s", type=int, default=None,
                   help="simulated horizon of the resident program "
                        "in seconds (default: sized from the jobs)")
    r.add_argument("--slo-sustained", type=int, default=2,
                   help="consecutive breached SLO evaluations before "
                        "the admission gate acts")
    r.add_argument("--slo-stride", type=int, default=1,
                   help="evaluate per-lane flow p99s every Nth "
                        "barrier (the degradation ladder raises this "
                        "host-side stride as its first relief step)")
    r.add_argument("--flow-sample", type=int, default=1,
                   help="resident flow-sampling period feeding the "
                        "SLO gate (0 disables the gate's p99 input)")

    s = sub.add_parser("status", help="summarize a fleet dir "
                                      "(read-only)")
    s.add_argument("--fleet-dir", required=True)
    return p


def _cmd_run(args) -> int:
    from shadow_tpu_torch.fleet.runner import FleetRunner

    device = "cpu" if args.platform == "cpu" else "cuda"
    policy_path = os.path.join(args.fleet_dir, _POLICY_FILE)
    specs = None
    if args.jobs_file:
        policy, specs = load_jobs_file(args.jobs_file)
    elif args.resume and os.path.isfile(policy_path):
        with open(policy_path) as f:
            policy = FleetPolicy.from_dict(json.load(f))
    elif args.resume:
        policy = FleetPolicy()
    else:
        print("error: fleet run needs --jobs-file (or --resume "
              "with an existing fleet dir)", file=sys.stderr)
        return 2
    os.makedirs(args.fleet_dir, exist_ok=True)
    tmp = policy_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(policy.as_dict(), f, indent=1, sort_keys=True)
    os.replace(tmp, policy_path)

    if args.resident:
        from shadow_tpu_torch.fleet.admission import (
            AdmissionGate,
            run_resident_fleet,
        )

        man = run_resident_fleet(
            args.fleet_dir, policy, specs,
            lanes=args.resident_lanes,
            horizon_s=args.resident_horizon_s,
            resume=args.resume, fsync=not args.no_fsync,
            gate=AdmissionGate(sustained=args.slo_sustained,
                               eval_stride=args.slo_stride),
            flow_sample=args.flow_sample, device=device,
            log=lambda m: print(m, file=sys.stderr))
        counts = man["counts"]
        bad = counts.get("failed", 0) + (
            counts.get("quarantined", 0) if args.no_salvage else 0)
        rc = 1 if bad else (0 if man["complete"] else 6)
        print(json.dumps({"exit": rc, "counts": counts,
                          "admission": {
                              k: man["admission"][k] for k in
                              ("admitted", "completed", "evicted",
                               "quarantined", "resident", "deferred",
                               "program_key_stable")},
                          "manifest": os.path.join(
                              args.fleet_dir, "fleet_manifest.json")}))
        return rc
    runner = FleetRunner(
        args.fleet_dir, policy, specs, workers=args.workers,
        resume=args.resume, fsync=not args.no_fsync,
        salvage=not args.no_salvage,
        drain_timeout_s=args.drain_timeout, device=device,
        log=lambda m: print(m, file=sys.stderr))
    rc = runner.run(install_signals=True)
    man_path = os.path.join(args.fleet_dir, "fleet_manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    print(json.dumps({"exit": rc, "counts": man["counts"],
                      "preempted": man["preempted"],
                      "stalled": man["stalled"],
                      "manifest": man_path}))
    return rc


def fold_job_status(records) -> tuple[dict, dict]:
    """Pure fold of replayed journal frames -> (job status map,
    checkpoint map). Shared by `fleet status` and the sweep status
    paths (sweep/cli.py), which join these statuses
    against the sweep journal's rounds."""
    status: dict = {}
    checkpoints: dict = {}
    for rec in records:
        job = rec.get("job")
        ev = rec.get("ev")
        if not job:
            continue
        if ev in ("job_added",):
            status.setdefault(job, "queued")
        elif ev in ("leased", "running"):
            status[job] = "leased" if ev == "leased" else "running"
        elif ev == "done":
            status[job] = "done"
        elif ev == "failed":
            status[job] = "failed" if rec.get("final") else "queued"
        elif ev == "requeued":
            status[job] = "queued"
        elif ev == "quarantined":
            status[job] = "quarantined"
        if ev == "heartbeat" and rec.get("checkpoint"):
            checkpoints[job] = rec["checkpoint"]
    return status, checkpoints


def _cmd_status(args) -> int:
    """Read-only: never touches the journal (a live fleet owns it)."""
    from shadow_tpu_torch.fleet import journal as journal_mod

    jpath = os.path.join(args.fleet_dir, "journal.log")
    records, good = journal_mod.replay(jpath)
    status, checkpoints = fold_job_status(records)
    counts: dict = {}
    for st in status.values():
        counts[st] = counts.get(st, 0) + 1
    out = {"journal_events": len(records), "journal_bytes": good,
           "counts": counts, "jobs": status,
           "checkpoints": checkpoints}
    lease_log = os.path.join(args.fleet_dir, "resident", "leases.log")
    if os.path.isfile(lease_log):
        # resident fleet: fold the lease journal read-only
        # (fleet/admission.py LeaseTable shares this replay)
        lrecs, _ = journal_mod.replay(lease_log)
        pop: dict = {}
        for rec in lrecs:
            if rec.get("ev") != "lease":
                continue
            lane, st = rec.get("lane"), rec.get("state")
            if st in ("admitted", "running"):
                pop[lane] = {"job": rec.get("job"), "state": st,
                             "epoch": rec.get("epoch")}
            else:
                pop.pop(lane, None)
        out["resident"] = {"lease_frames": len(lrecs),
                           "population": {str(k): v for k, v
                                          in sorted(pop.items())}}
    sweep_log = os.path.join(args.fleet_dir, "sweep.log")
    if os.path.isfile(sweep_log):
        # this fleet dir is a sweep's execution substrate: fold the
        # sweep journal read-only into per-round progress (points
        # done / failed / pruned per round) instead of leaving only
        # the flat job counts above (sweep/driver.py shares the fold)
        from shadow_tpu_torch.sweep import driver as sweep_driver

        frames, _ = journal_mod.replay(sweep_log)
        if frames:
            try:
                out["sweep"] = sweep_driver.fold_sweep_status(
                    frames, status)
            except Exception as e:  # noqa: BLE001 — status stays up
                out["sweep"] = {"error": f"{type(e).__name__}: {e}"}
    man_path = os.path.join(args.fleet_dir, "fleet_manifest.json")
    if os.path.isfile(man_path):
        out["manifest"] = man_path
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    return _cmd_status(args)


if __name__ == "__main__":
    sys.exit(main())
