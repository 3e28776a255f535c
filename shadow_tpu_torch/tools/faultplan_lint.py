"""Offline fault-plan validator (the port's tools/faultplan_lint.py) —
CI gate for fault schedules before they burn a run (the determinism
contract makes a bad plan fail the
same way every retry, so catch it before the cluster does).

Checks (faults/plan.py validate_records): times sorted and
non-negative, kinds known, link kinds carry both endpoints, host /
vertex ids in range when bounds are given, loss in [0,1],
latency deltas non-negative (a negative delta would break the
conservative window), crash-before-restart ordering per host; warns
when times do not align to the window length (effects quantize to the
enclosing window boundary).

Inputs: a standalone JSON plan ({"faults": [...]}; see
examples/faultplan_degraded.json) or a shadow.config.xml whose
<fault> elements are checked by name only (name->index resolution
needs a built topology; use --hosts/--vertices for range checks on
raw-integer plans).

With --checkpoint the plan is additionally cross-checked against a
snapshot's recorded metadata (utils/checkpoint.py peek_meta): the
snapshot's num_hosts feeds the range checks, and any target capacity
flag (--event-capacity / --outbox-capacity / --router-ring) smaller
than what the snapshot was saved at is an ERROR — resuming into a
shrunken config cannot transplant (capacities only grow), so it fails
here at lint time instead of at resume time.

Usage: python -m shadow_tpu_torch.tools.faultplan_lint plan.json
       [--hosts N] [--vertices N]
       [--min-jump-ns NS] [--checkpoint SNAP.npz]
       [--event-capacity N] [--outbox-capacity N] [--router-ring N]
Exit 0 = clean (warnings allowed), 1 = errors.
"""

from __future__ import annotations

import argparse
import json
import sys


def lint_text(text: str, *, hosts=None, vertices=None, min_jump_ns=None):
    """Returns (errors, warnings) for a JSON plan or XML config blob."""
    from shadow_tpu_torch.faults.plan import (FaultRecord, KIND_NAMES,
                                        records_from_json,
                                        validate_records, _value_raw)

    stripped = text.lstrip()
    if stripped.startswith("<"):
        from shadow_tpu_torch.config.xmlconfig import parse_config

        cfg = parse_config(text)
        recs = []
        errors = []
        names = {name for name, _ in cfg.expanded_hosts()}
        # Name -> index resolution needs placement; lint with stable
        # symbolic indices so per-host ordering checks (crash before
        # restart) still see distinct endpoints. Range checks are
        # skipped for names (a configured name is in range by
        # construction).
        sym_idx: dict = {}

        def sym(tok):
            return sym_idx.setdefault(str(tok), len(sym_idx))

        for i, spec in enumerate(cfg.faults):
            kname = spec.kind.lower()
            if kname not in KIND_NAMES:
                errors.append(f"<fault> {i} (t={spec.time_ns}): unknown "
                              f"kind '{spec.kind}'")
                continue
            for end in (spec.a, spec.b):
                if end is not None and end not in names:
                    try:
                        int(end)
                    except (TypeError, ValueError):
                        errors.append(
                            f"<fault> {i} (t={spec.time_ns}): '{end}' "
                            f"names no configured host")
            kind = KIND_NAMES[kname]
            recs.append(FaultRecord(
                t_ns=spec.time_ns, kind=kind,
                a=sym(spec.a), b=sym(spec.b) if spec.b is not None else -1,
                value=_value_raw(kind, spec.value)))
        e2, warnings = validate_records(recs, min_jump_ns=min_jump_ns)
        return errors + e2, warnings
    try:
        recs = records_from_json(json.loads(text))
    except (ValueError, KeyError) as e:
        return [str(e)], []
    return validate_records(recs, num_hosts=hosts, num_vertices=vertices,
                            min_jump_ns=min_jump_ns)


def lint_against_checkpoint(meta: dict, *, hosts=None,
                            event_capacity=None, outbox_capacity=None,
                            router_ring=None):
    """Cross-check resume intent against a snapshot's __meta__.
    Returns (errors, warnings, effective_hosts) — effective_hosts is
    the snapshot's num_hosts, for the plan's range checks."""
    errors: list = []
    warnings: list = []
    caps = meta.get("capacities") or {}
    snap_hosts = caps.get("num_hosts")
    if hosts is not None and snap_hosts is not None \
            and hosts != snap_hosts:
        errors.append(
            f"--hosts {hosts} but the snapshot was saved with "
            f"num_hosts={snap_hosts} — a transplant cannot change "
            f"the host axis")
    targets = {"event_capacity": event_capacity,
               "outbox_capacity": outbox_capacity,
               "router_ring": router_ring}
    for knob, want in targets.items():
        have = caps.get(knob)
        if want is None or have is None:
            continue
        if want < have:
            errors.append(
                f"--{knob.replace('_', '-')} {want} is smaller than "
                f"the snapshot's recorded {knob}={have} — capacities "
                f"only grow; resuming into a shrunken config would "
                f"be refused at load time")
        elif want > have:
            warnings.append(
                f"--{knob.replace('_', '-')} {want} grows the "
                f"snapshot's {knob}={have}; the resume will "
                f"transplant (pad-with-empty)")
    if meta.get("shards") is not None:
        warnings.append(
            f"snapshot was taken under {meta['shards']} shard(s); "
            f"state is global-layout, any --workers count resumes it")
    return errors, warnings, (snap_hosts if hosts is None else hosts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a fault plan offline (JSON plan or "
                    "shadow.config.xml)")
    ap.add_argument("plan", help="plan file (.json) or config (.xml)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="host count for crash/restart range checks")
    ap.add_argument("--vertices", type=int, default=None,
                    help="topology vertex count for link/partition "
                         "range checks")
    ap.add_argument("--min-jump-ns", type=int, default=None,
                    help="window length: warn on times that quantize")
    ap.add_argument("--checkpoint", default=None, metavar="SNAP",
                    help="cross-check against a snapshot's recorded "
                         "capacity/shard metadata (resume lint)")
    ap.add_argument("--event-capacity", type=int, default=None,
                    help="intended resume event_capacity (checked "
                         "against the snapshot's)")
    ap.add_argument("--outbox-capacity", type=int, default=None)
    ap.add_argument("--router-ring", type=int, default=None)
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress warnings, print errors only")
    args = ap.parse_args(argv)

    with open(args.plan) as f:
        text = f.read()
    hosts = args.hosts
    ckpt_errors: list = []
    ckpt_warnings: list = []
    if args.checkpoint:
        from shadow_tpu_torch.utils.checkpoint import peek_meta

        try:
            meta = peek_meta(args.checkpoint)
        except (OSError, ValueError, KeyError) as e:
            ckpt_errors.append(f"{args.checkpoint}: {e}")
            meta = None
        if meta is not None:
            ckpt_errors, ckpt_warnings, hosts = lint_against_checkpoint(
                meta, hosts=args.hosts,
                event_capacity=args.event_capacity,
                outbox_capacity=args.outbox_capacity,
                router_ring=args.router_ring)
    errors, warnings = lint_text(text, hosts=hosts,
                                 vertices=args.vertices,
                                 min_jump_ns=args.min_jump_ns)
    errors = ckpt_errors + errors
    warnings = ckpt_warnings + warnings
    for e in errors:
        print(f"ERROR: {e}", file=sys.stderr)
    if not args.quiet:
        for w in warnings:
            print(f"WARNING: {w}", file=sys.stderr)
    if errors:
        print(f"{args.plan}: {len(errors)} error(s), "
              f"{len(warnings)} warning(s)", file=sys.stderr)
        return 1
    print(f"{args.plan}: OK ({len(warnings)} warning(s))",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
