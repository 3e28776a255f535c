"""Dual-mode conformance driver (the port's tools/dualmode_diff.py) —
run vproc workloads on BOTH backends (simulation + real host kernel)
and diff the normalized syscall traces, or compare two previously
dumped traces offline.

Run mode (executes both backends per workload; the simulator runs on
the card unless --platform cpu asks for the CPU):
    python -m shadow_tpu_torch.tools.dualmode_diff --workload bind \
        --workload epoll
    ... --workload fast          # every fast workload
    ... --workload all           # incl. slow ones
Compare mode (offline, no execution):
    ... --sim sim.json --host host.json
Common:
    --seed N --time-scale F --json report.json --dump-dir DIR --list
    --platform cpu|gpu

Exit codes: 0 = all agree, 1 = usage/IO error, 2 = sandbox has no
bindable localhost ports (environment, not divergence), 4 = at least
one workload diverged or errored (matches the CLI's divergence code).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXIT_OK = 0
EXIT_USAGE = 1
EXIT_NO_PORTS = 2
EXIT_DIVERGED = 4


def _expand(names, catalog, fast, full):
    out = []
    for n in names:
        if n == "all":
            out.extend(full)
        elif n == "fast":
            out.extend(fast)
        elif n in catalog:
            out.append(n)
        else:
            return None, n
    # de-dup, keep first-mention order
    return list(dict.fromkeys(out)), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run workloads under both backends and diff "
                    "normalized syscall traces (docs/7-conformance.md)")
    ap.add_argument("--workload", action="append", default=[],
                    help="catalog name, or 'fast'/'all' (repeatable)")
    ap.add_argument("--sim", default=None,
                    help="compare mode: dumped sim trace JSON")
    ap.add_argument("--host", default=None,
                    help="compare mode: dumped host trace JSON")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--time-scale", type=float, default=0.05,
                    help="sim ns -> real seconds on the host backend")
    ap.add_argument("--json", default=None, help="write a JSON report")
    ap.add_argument("--dump-dir", default=None,
                    help="dump each run's normalized traces here")
    ap.add_argument("--list", action="store_true",
                    help="list the workload catalog and exit")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="run the simulator on the CPU ('cpu'); unset "
                         "or 'gpu' is the card")
    args = ap.parse_args(argv)

    from shadow_tpu_torch.hostrun import (
        DUAL_WORKLOADS, FAST_DUAL_WORKLOADS, WORKLOADS, PortsUnavailable,
        diff_traces, render, run_dual)
    from shadow_tpu_torch.hostrun.trace import load as load_trace

    if args.list:
        for w in WORKLOADS.values():
            mode = "dual" if w.host_ok else "sim-only"
            tag = " [slow]" if w.slow else ""
            note = f" — {w.note}" if w.note else ""
            print(f"{w.name:18s} {mode}{tag}{note}")
        return EXIT_OK

    if (args.sim is None) != (args.host is None):
        print("compare mode needs BOTH --sim and --host",
              file=sys.stderr)
        return EXIT_USAGE

    report = {"mode": None, "results": {}}
    worst = EXIT_OK

    if args.sim is not None:
        report["mode"] = "compare"
        try:
            sim_doc = load_trace(args.sim)
            host_doc = load_trace(args.host)
        except (OSError, ValueError) as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return EXIT_USAGE
        res = diff_traces(sim_doc.get("procs", {}),
                          host_doc.get("procs", {}))
        print(render(res))
        report["results"]["compare"] = res.to_json()
        if not res.agree:
            worst = EXIT_DIVERGED
    else:
        names, bad = _expand(args.workload or ["fast"], WORKLOADS,
                             FAST_DUAL_WORKLOADS, DUAL_WORKLOADS)
        if names is None:
            print(f"unknown workload {bad!r} (try --list)",
                  file=sys.stderr)
            return EXIT_USAGE
        report["mode"] = "run"
        for name in names:
            w = WORKLOADS[name]
            if not w.host_ok:
                print(f"== {name}: SKIP (sim-only: {w.note})")
                report["results"][name] = {"agree": None,
                                           "skipped": "sim-only"}
                continue
            try:
                res = run_dual(name, seed=args.seed,
                               time_scale=args.time_scale,
                               device="cpu" if args.platform == "cpu"
                               else None)
            except PortsUnavailable as e:
                print(f"== {name}: SKIP (no localhost ports: {e})",
                      file=sys.stderr)
                return EXIT_NO_PORTS
            except Exception as e:  # noqa: BLE001 — a verdict, reported
                print(f"== {name}: ERROR {type(e).__name__}: {e}",
                      file=sys.stderr)
                report["results"][name] = {
                    "agree": False,
                    "error": f"{type(e).__name__}: {e}"}
                worst = EXIT_DIVERGED
                continue
            print(f"== {name}")
            print(render(res.diff))
            report["results"][name] = res.diff.to_json()
            if not res.diff.agree:
                worst = EXIT_DIVERGED
            if args.dump_dir:
                os.makedirs(args.dump_dir, exist_ok=True)
                for side, procs in (("sim", res.sim), ("host", res.host)):
                    path = os.path.join(args.dump_dir,
                                        f"{name}.{side}.json")
                    with open(path, "w") as f:
                        json.dump({"meta": {"workload": name,
                                            "backend": side,
                                            "seed": args.seed},
                                   "procs": procs}, f, indent=1,
                                  sort_keys=True)

    report["agree"] = worst == EXIT_OK
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
