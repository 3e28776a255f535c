"""The pure reducer: per-job manifest blocks -> a ranked objective
table.

rank() is a pure function of (job entries, objective) with
deterministic tie-breaks — (value, point id) — so an uninterrupted
sweep, a SIGKILL-resumed sweep, and the lint's re-derivation
(tools/telemetry_lint.py) all produce byte-identical tables from the
same per-job results. The fleet's bit-identity contract
(fleet/scenario.py: run(0->T) == run(0->C) + resume(C->T)) is what
makes the inputs themselves kill-invariant; this module just
refuses to add any nondeterminism on top.

`events_per_sec` is the one wallclock-tainted metric (it ranks
machine speed as much as the scenario); it is accepted because
operators ask for it, but resume byte-identity and the chaos
ranking-identity check only hold for the simulation-deterministic
metrics, and docs/10-sweep.md says so.
"""

# The port's copy of shadow_tpu/sweep/reduce.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import math

from shadow_tpu_torch.sweep.plan import METRICS, Objective

# table-row verdicts: eligible rows rank by value; ineligible rows
# sink to the bottom in point order, each naming why
ELIGIBLE = ("ok", "warnings")


def metric_value(entry: dict, metric: str):
    """Extract one objective value from a fleet-manifest job entry.
    None when the job carries no data for it (a failed build, flows
    not traced, zero sampled flows). The lint mirrors this extraction
    verbatim to re-derive recorded rankings."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    result = entry.get("result") or {}
    counters = result.get("counters") or {}
    if metric == "events":
        v = counters.get("events_processed")
        return None if v is None else int(v)
    if metric == "drops":
        v = counters.get("drops_total")
        return None if v is None else int(v)
    if metric == "events_per_sec":
        v = result.get("events_per_sec")
        return None if v is None else float(v)
    # flow percentiles: the WORST per-lane summary — a sweep point is
    # as slow as its slowest tenant lane
    pkey = {"flow_p50_ns": "p50_ns", "flow_p95_ns": "p95_ns",
            "flow_p99_ns": "p99_ns"}[metric]
    per_lane = (result.get("flows") or {}).get("per_lane") or {}
    vals = [int(s.get(pkey, 0)) for s in per_lane.values()
            if int(s.get("count", 0) or 0) > 0]
    return max(vals) if vals else None


def verdict_of(entry: dict, objective: Objective) -> str:
    """Row verdict for one job entry. Terminal fleet states map
    directly; a done job downgrades to "warnings" when its run
    self-healed (health verdict not clean), which stays rankable
    unless the objective demands clean health."""
    status = entry.get("status")
    if status in ("failed", "quarantined"):
        return status
    if status != "done":
        return "pending"
    hv = (entry.get("result") or {}).get("health_verdict")
    if hv is not None and hv != "clean":
        return "unhealthy" if objective.require_clean_health \
            else "warnings"
    return "ok"


def rank(entries: dict, objective: Objective) -> list:
    """Fold per-point job entries into the ranked table.

    `entries` maps point id -> fleet-manifest job entry. Rows are
    {"point", "value", "verdict"}: eligible rows first, ordered by
    objective value (ascending for goal=min, descending for
    goal=max) with point id breaking ties; ineligible rows (failed,
    quarantined, unhealthy, value-less) follow in point order. A
    divergent point therefore never sinks the sweep — it just ranks
    unplaceable, with its verdict naming why."""
    eligible, rest = [], []
    for pid in sorted(entries):
        verdict = verdict_of(entries[pid], objective)
        value = (metric_value(entries[pid], objective.metric)
                 if verdict in ELIGIBLE else None)
        if verdict in ELIGIBLE and value is None:
            verdict = "no_data"
        row = {"point": pid, "value": value, "verdict": verdict}
        (eligible if verdict in ELIGIBLE else rest).append(row)
    sign = 1 if objective.goal == "min" else -1
    eligible.sort(key=lambda r: (sign * r["value"], r["point"]))
    return eligible + rest


def survivors(table: list, keep: int) -> list:
    """The first `keep` eligible points of a ranked table — THE prune
    rule (search.py halving and the lint's re-derivation both call
    this, so a recorded prune decision can never disagree with its
    re-derivation except by tampering)."""
    return [r["point"] for r in table
            if r["verdict"] in ELIGIBLE][:max(0, int(keep))]


def halving_keep(n_eligible: int, eta: int) -> int:
    """Survivor count of one successive-halving prune: ceil(n/eta),
    never below 1 (shared with the lint)."""
    return max(1, math.ceil(int(n_eligible) / max(2, int(eta))))
