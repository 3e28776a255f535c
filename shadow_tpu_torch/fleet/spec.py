"""Job specs and the jobs file (docs/8-fleet.md §jobs file).

A fleet executes heterogeneous *scenarios*: each job is a
(config x seed x fault plan) declaration plus its own robustness
budget (attempts, wallclock deadline, escalation policy). The jobs
file is JSON:

    {
      "fleet": {            # defaults, all optional
        "max_attempts": 3, "lease_timeout_s": 60.0,
        "backoff_base_s": 0.25, "backoff_cap_s": 30.0,
        "backoff_seed": 1, "requeue_budget": 8
      },
      "jobs": [
        {"id": "sweep-00", "kind": "scenario", "seed": 3,
         "hosts": 8, "load": 2, "sim_s": 1,
         "event_capacity": 32, "outbox_capacity": 32,
         "router_ring": 32,
         "faults": [{"time_s": 0.3, "kind": "loss",
                     "a": 0, "b": 0, "value": 0.02}],
         "auto_grow": true, "max_grow": 8,
         "max_attempts": 3, "max_wallclock_s": 300.0},
        ...
      ]
    }

Kinds:
- "scenario": a seeded PHOLD run on the single-vertex soak topology
  (the chaos-soak scenario surface) under the self-healing supervisor
  — undersized capacities + auto_grow exercise escalation; undersized
  capacities withOUT auto_grow fail deterministically (the quarantine
  path's test vector).
- "chaos_trial": one tools/chaos_soak.py run_trial, parameterized by
  the same knobs the soak CLI takes (chaos_soak --jobs dogfoods the
  fleet through this kind).

Every enqueued job gets a spec dir `jobs/<id>/` holding `spec.json`
(the durable copy — `fleet run --resume` reloads specs from these,
so the jobs file is not needed to resume), its supervisor
checkpoints, its run manifest, and its result.
"""

# The port's copy of shadow_tpu/fleet/spec.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Optional

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclasses.dataclass
class FleetPolicy:
    """Fleet-wide defaults a job spec may override (attempts,
    deadline). Backoff is deterministic: delay for (job, attempt) is
    base * 2^(attempt-1) * (1 + jitter) with jitter drawn from a
    counter RNG seeded by (backoff_seed, job id, attempt) — two runs
    of the same fleet produce the same backoff schedule, so fleet
    logs are reproducible."""

    max_attempts: int = 3
    # heartbeats only flow once the engine is stepping rounds, so the
    # lease timeout must cover a cold XLA compile of the window program
    lease_timeout_s: float = 60.0
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 30.0
    backoff_seed: int = 1
    requeue_budget: int = 8        # worker-loss requeues before parking
    deadline_grace: float = 1.5    # watchdog kills at deadline * grace

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"unknown fleet policy key(s): {bad}")
        return cls(**d)


@dataclasses.dataclass
class JobSpec:
    id: str
    kind: str = "scenario"         # "scenario" | "chaos_trial"
    seed: int = 1
    # scenario shape (chaos_soak's PHOLD surface)
    hosts: int = 8
    load: int = 2
    sim_s: int = 1
    event_capacity: int = 32
    outbox_capacity: int = 32
    router_ring: int = 32
    faults: tuple = ()             # JSON fault records (plan.py schema)
    # per-job robustness budget
    auto_grow: bool = True
    max_grow: int = 8
    max_retries: int = 0           # in-run supervisor retries; the
    # fleet owns the retry budget, so in-run retries default off
    checkpoint_every_windows: int = 8
    max_attempts: Optional[int] = None      # None = fleet default
    max_wallclock_s: Optional[float] = None  # per-job deadline
    # open-system injection (shadow_tpu/inject/): a trace file the
    # job streams into the scenario. The staging buffer's lane count
    # sizes from the trace unless pinned; resume-after-kill continues
    # the trace from the checkpoint's cursor without replay (the
    # feeder syncs to the snapshot), so injected jobs keep the fleet's
    # bit-identity contract.
    inject_trace: Optional[str] = None
    inject_lanes: Optional[int] = None
    # Packed ensemble job (docs/8-fleet.md §packed jobs): replicas > 1
    # runs R copies of the scenario in ONE compiled program — `hosts`
    # is the per-lane host count, the program carries hosts*replicas
    # rows — with lane-isolated health (core/lanes.py) attached. A
    # lane that trips is quarantined on device (healthy lanes finish
    # bit-identically), salvaged from the last clean checkpoint, and
    # requeued by the fleet as a standalone replicas=1 job at regrown
    # capacities; `lane_of` records that provenance on the child.
    replicas: int = 1
    lane_of: Optional[str] = None  # parent packed-job id (requeues)
    # per-flow latency tracing (telemetry/flows.py): sample 1-in-N
    # cross-host packets into the device flow ring; 0 = off. The job
    # manifest grows a "flows" block and the fleet manifest rolls the
    # per-lane latency summaries up per tenant.
    flow_sample: int = 0
    # causal critical-path profiling (telemetry/causality.py): sample
    # 1-in-N emitted events into the lineage recorder and latch which
    # clamp decided every window end; 0 = off. The job manifest grows
    # a "causality" block (critical chains, binding-cause histogram)
    # and the fleet manifest rolls the cause counts up fleet-wide.
    causality_sample: int = 0
    # Tenant lease terms (fleet/admission.py, resident programs):
    # `tenant_class` ranks the job for SLO-aware shedding —
    # "protected" tenants are never evicted by the admission gate and
    # their SLO breaches drive the degradation ladder; "best_effort"
    # tenants are the shedding pool. `slo_p99_ms` is the per-flow p99
    # latency objective (telemetry/flows.py per-lane percentiles feed
    # the gate); None = no SLO. Both also annotate standalone runs'
    # results (scenario.py records an "slo" verdict), so the same
    # spec file serves resident and per-process execution.
    tenant_class: str = "best_effort"
    slo_p99_ms: Optional[float] = None
    # compile-time program specialization (compile/specialize.py):
    # "auto" trims capabilities the build proves statically dead
    # (reliability loss draws, the timer handler family) out of the
    # traced program; the trimmed variant keys separately in the warm
    # AOT store, so a fleet of lossless jobs serves the lean program
    # while faulted jobs serve the full one. "off" always runs the
    # full program.
    specialize: str = "auto"
    # Elastic degraded-mesh execution (parallel/elastic.py): shards > 1
    # runs the scenario shard_map'd over that many devices — the worker
    # leases an explicit device set of this width, and a DEVICE_LOST
    # requeue re-enqueues the job at the next-pow2-down width (a
    # continuation, not a new attempt: checkpoints hold global layout,
    # so the shrunk mesh resumes the same run). `sentinel` attaches the
    # cross-shard integrity sentinel so checkpoints carry the
    # verified-state ledger and silent divergence latches as
    # SHARD_DIVERGENCE instead of corrupting results.
    shards: int = 1
    sentinel: bool = False
    # chaos_trial knobs (chaos_soak.run_trial)
    kills: int = 2
    verify: bool = False
    # test/chaos lever: sleep this long at every round barrier —
    # stretches a run's wallclock without touching its simulation
    # (worker-loss and deadline tests need a window to land a kill in)
    round_sleep_s: float = 0.0

    def __post_init__(self):
        if not _ID_RE.match(self.id):
            raise ValueError(
                f"job id {self.id!r} must match {_ID_RE.pattern} "
                f"(it names a directory)")
        if self.kind not in ("scenario", "chaos_trial"):
            raise ValueError(f"job {self.id}: unknown kind "
                             f"{self.kind!r}")
        self.faults = tuple(
            f if isinstance(f, dict) else dict(f) for f in self.faults)
        if self.inject_trace is not None and self.kind != "scenario":
            raise ValueError(f"job {self.id}: inject_trace only "
                             f"applies to kind 'scenario'")
        if int(self.replicas) < 1:
            raise ValueError(f"job {self.id}: replicas must be >= 1")
        if self.replicas > 1 and self.kind != "scenario":
            raise ValueError(f"job {self.id}: packed jobs (replicas > "
                             f"1) only apply to kind 'scenario'")
        if self.replicas > 1 and self.inject_trace is not None:
            raise ValueError(
                f"job {self.id}: inject_trace addresses a single "
                f"scenario's host ids — packed jobs can't stream it")
        if self.inject_lanes is not None:
            n = int(self.inject_lanes)
            if n <= 0 or n & (n - 1):
                raise ValueError(f"job {self.id}: inject_lanes must "
                                 f"be a positive power of two")
        if int(self.flow_sample) < 0:
            raise ValueError(f"job {self.id}: flow_sample must be "
                             f">= 0 (0 disables flow tracing)")
        if int(self.causality_sample) < 0:
            raise ValueError(f"job {self.id}: causality_sample must "
                             f"be >= 0 (0 disables causality tracing)")
        if self.specialize not in ("auto", "off"):
            raise ValueError(
                f"job {self.id}: specialize must be 'auto' or 'off', "
                f"got {self.specialize!r}")
        if self.tenant_class not in ("protected", "best_effort"):
            raise ValueError(
                f"job {self.id}: tenant_class must be 'protected' or "
                f"'best_effort', got {self.tenant_class!r}")
        if self.slo_p99_ms is not None and float(self.slo_p99_ms) <= 0:
            raise ValueError(f"job {self.id}: slo_p99_ms must be > 0 "
                             f"(None disables the SLO)")
        n = int(self.shards)
        if n < 1 or n & (n - 1):
            raise ValueError(f"job {self.id}: shards must be a "
                             f"positive power of two, got {self.shards}")
        if n > 1 and self.kind != "scenario":
            raise ValueError(f"job {self.id}: shards > 1 only applies "
                             f"to kind 'scenario'")
        if n > 1 and (self.hosts * max(int(self.replicas), 1)) % n:
            raise ValueError(
                f"job {self.id}: total host rows "
                f"({self.hosts}x{self.replicas}) must divide by "
                f"shards ({n})")

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = list(self.faults)
        return d

    def digest(self) -> str:
        blob = json.dumps(self.as_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"job {d.get('id', '?')}: unknown "
                             f"key(s): {bad}")
        return cls(**d)


def parse_jobs_obj(obj: Any) -> tuple[FleetPolicy, list]:
    """Parse a loaded jobs-file object -> (policy, [JobSpec])."""
    if not isinstance(obj, dict) or "jobs" not in obj:
        raise ValueError('jobs file must be an object with a "jobs" '
                         'array')
    policy = FleetPolicy.from_dict(obj.get("fleet", {}) or {})
    jobs = [JobSpec.from_dict(j) for j in obj["jobs"]]
    if not jobs:
        raise ValueError("jobs file declares zero jobs")
    seen = set()
    for j in jobs:
        if j.id in seen:
            raise ValueError(f"duplicate job id {j.id!r}")
        seen.add(j.id)
    return policy, jobs


def load_jobs_file(path: str) -> tuple[FleetPolicy, list]:
    with open(path) as f:
        return parse_jobs_obj(json.load(f))
