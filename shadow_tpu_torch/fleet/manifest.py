"""fleet_manifest.json — the roll-up of every job's verdict.

Rewritten atomically after every terminal transition (not just at
exit), so a fleet killed mid-run still leaves an accurate partial
manifest next to the journal that supersedes it. `tools/
telemetry_lint.py --fleet-manifest` validates the schema: attempt
histories monotone, every terminal job carries a verdict, every
quarantined job carries its salvage pointers.
"""

# The port's copy of shadow_tpu/fleet/manifest.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import json
import os

from shadow_tpu_torch.fleet import journal as journal_mod
from shadow_tpu_torch.fleet import state as state_mod

SCHEMA = "shadow-tpu-fleet-manifest"
SCHEMA_VERSION = 1

_VERDICTS = {state_mod.DONE: "ok",
             state_mod.FAILED: "failed",
             state_mod.QUARANTINED: "quarantined"}


def _job_entry(queue, j) -> dict:
    jid = j.spec.id
    rel = os.path.join("jobs", jid)
    entry = {
        "status": j.status,
        "kind": j.spec.kind,
        "seed": j.spec.seed,
        "spec_digest": j.spec.digest(),
        "attempts": j.attempts,
        "executions": j.execs,
        "worker_losses": j.worker_losses,
        "device_losses": j.device_losses,
        "attempt_history": list(j.attempt_history),
        "backoff_history": [round(b, 6) for b in j.backoff_history],
        "verdict": _VERDICTS.get(j.status),
        "dir": rel,
        "result": j.result,
        "failure": j.failure,
        "quarantine_reason": j.quarantine_reason,
    }
    # bucket-affinity fields (fleet/affinity.py): the spec-derived
    # scheduling key, plus the realized program key once the job's
    # run_manifest reported one — equal affinity_keys must map to
    # equal program_keys (the lint's consistency check)
    from shadow_tpu_torch.fleet.affinity import affinity_key

    entry["affinity_key"] = affinity_key(j.spec)
    if j.result and j.result.get("program_key"):
        entry["program_key"] = j.result["program_key"]
    if getattr(j.spec, "replicas", 1) > 1:
        # packed job: surface the per-lane verdicts + requeue children
        # at the entry level so the lint (and the operator) need not
        # dig through result — lane children carry lane_of back-links
        entry["replicas"] = int(j.spec.replicas)
        if j.result and j.result.get("lanes"):
            entry["lanes"] = j.result["lanes"]
    if getattr(j.spec, "lane_of", None):
        entry["lane_of"] = j.spec.lane_of
    if j.result and j.result.get("flows"):
        # per-flow latency summary (telemetry/flows.py): the job-level
        # copy is the roll-up input for the fleet "flows" block
        entry["flows"] = j.result["flows"]
    if j.result and j.result.get("causality"):
        # causality accounting (telemetry/causality.py): the job-level
        # copy is the roll-up input for the fleet "causality" block
        entry["causality"] = j.result["causality"]
    if j.result and j.result.get("elastic"):
        # elastic recovery record (parallel/elastic.py): the job-level
        # copy is the roll-up input for the fleet "elastic" block
        entry["elastic"] = j.result["elastic"]
    if j.result and j.result.get("device_lease"):
        entry["device_lease"] = j.result["device_lease"]
    if j.shards_override:
        entry["shards_override"] = int(j.shards_override)
    run_man = os.path.join(queue.job_dir(jid), "run_manifest.json")
    if os.path.isfile(run_man):
        entry["run_manifest"] = os.path.join(rel, "run_manifest.json")
    if j.status == state_mod.QUARANTINED:
        from shadow_tpu_torch.utils import checkpoint as ckpt

        entry["salvage"] = {
            "dir": rel,
            "checkpoint": j.checkpoint or ckpt.latest_checkpoint(
                os.path.join(queue.job_dir(jid), "ck")),
            "run_manifest": entry.get("run_manifest"),
            "result": (os.path.join(rel, "result.json")
                       if os.path.isfile(os.path.join(
                           queue.job_dir(jid), "result.json"))
                       else None),
        }
    return entry


def fleet_manifest(queue, *, workers_alive: int = 0,
                   preempted: bool = False, stalled: bool = False,
                   complete: bool = False,
                   admission: dict | None = None,
                   sweep: dict | None = None) -> dict:
    """`admission` is the resident-program block
    (fleet/admission.py ResidentProgram.manifest_block): lease-count
    conservation, program-key stability, the degradation ladder's
    history and the per-lane device planes. tools/telemetry_lint.py
    validates it (admitted == completed + evicted + quarantined +
    resident; SLO verdicts consistent with flow percentiles).

    `sweep` is the sweep roll-up block (sweep/driver.py sweep_block)
    when this fleet is one sweep's execution substrate: lattice
    conservation, the distinct-program census vs the prewarm log, and
    the per-round rankings. The lint validates that block too."""
    counts: dict[str, int] = {}
    jobs = {}
    for jid in sorted(queue.jobs):
        j = queue.jobs[jid]
        counts[j.status] = counts.get(j.status, 0) + 1
        jobs[jid] = _job_entry(queue, j)
    # flows roll-up: sum every flow-traced job's counters, and fold
    # the per-lane (per-tenant) sample counts into one table — the
    # lint checks these totals against the per-job entries
    flows_tot = None
    for jid, entry in jobs.items():
        fl = entry.get("flows")
        if not fl:
            continue
        if flows_tot is None:
            flows_tot = {"jobs": 0, "sampled": 0, "recorded": 0,
                         "harvested": 0, "lost_ring": 0,
                         "lost_window_clamp": 0, "lane_samples": {}}
        flows_tot["jobs"] += 1
        for k in ("sampled", "recorded", "harvested", "lost_ring",
                  "lost_window_clamp"):
            flows_tot[k] += int(fl.get(k, 0) or 0)
        for lane, summ in (fl.get("per_lane") or {}).items():
            flows_tot["lane_samples"][lane] = (
                flows_tot["lane_samples"].get(lane, 0)
                + int(summ.get("count", 0) or 0))
    # causality roll-up: sum every causality-traced job's lineage
    # accounting and fold the binding-cause histograms fleet-wide —
    # "what is the FLEET waiting on" (the lint checks these totals
    # against the per-job entries)
    caus_tot = None
    for jid, entry in jobs.items():
        cz = entry.get("causality")
        if not cz:
            continue
        if caus_tot is None:
            caus_tot = {"jobs": 0, "sampled": 0, "harvested": 0,
                        "lost_ring": 0, "windows_attributed": 0,
                        "windows_lost": 0, "causes": {}}
        caus_tot["jobs"] += 1
        for k in ("sampled", "harvested", "lost_ring",
                  "windows_attributed", "windows_lost"):
            caus_tot[k] += int(cz.get(k, 0) or 0)
        for cause, n in (cz.get("causes") or {}).items():
            caus_tot["causes"][cause] = (
                caus_tot["causes"].get(cause, 0) + int(n or 0))
    # elastic roll-up: sum every elastic job's loss/divergence/shrink
    # accounting fleet-wide — "how degraded is the FLEET" (the lint
    # checks these totals against the per-job entries)
    elastic_tot = None
    for jid, entry in jobs.items():
        el = entry.get("elastic")
        dlosses = int(entry.get("device_losses", 0) or 0)
        if not el and not dlosses:
            continue
        if elastic_tot is None:
            elastic_tot = {"jobs": 0, "device_lost": 0,
                           "shard_divergence": 0, "mesh_shrinks": 0,
                           "ladder_steps": 0, "fleet_requeues": 0}
        elastic_tot["jobs"] += 1
        elastic_tot["fleet_requeues"] += dlosses
        if el:
            elastic_tot["device_lost"] += len(el.get("losses") or ())
            elastic_tot["shard_divergence"] += len(
                el.get("divergences") or ())
            elastic_tot["mesh_shrinks"] += len(
                el.get("mesh_transitions") or ())
            elastic_tot["ladder_steps"] += len(
                el.get("ladder_steps") or ())
    return {
        "schema": SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "policy": queue.policy.as_dict(),
        "preempted": bool(preempted),
        "stalled": bool(stalled),
        "complete": bool(complete),
        "workers_alive": workers_alive,
        "journal_events": queue.events,
        # idempotent-fold refusals (fleet/state.py): duplicate
        # terminal frames a crashed writer left behind — surfaced, not
        # swallowed, so an operator can audit what replay ignored
        "journal_warnings": list(queue.fold_warnings),
        "counts": counts,
        **({"flows": flows_tot} if flows_tot else {}),
        **({"causality": caus_tot} if caus_tot else {}),
        **({"elastic": elastic_tot} if elastic_tot else {}),
        **({"admission": admission} if admission else {}),
        **({"sweep": sweep} if sweep else {}),
        "jobs": jobs,
    }


def write_fleet_manifest(path: str, man: dict) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    journal_mod.fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path
