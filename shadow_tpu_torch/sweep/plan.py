"""Declarative sweep plans (docs/10-sweep.md §spec grammar).

A SweepSpec is one scenario template plus a list of axes; expanding
it produces a deterministic job lattice — point `p0013` means the
same coordinates in every process that ever loads the spec, which is
what lets a resumed driver, the status fold, and the lint all agree
without coordination. The plan also knows its distinct-program
census BEFORE anything runs: each point's bucket-affinity key
(fleet/affinity.py — capacities quantized to the same pow2 lattice
the build applies) and predicted specialization vector
(compile/specialize.py rules applied at the spec level) are pure
functions of the spec, so the driver prewarms exactly the programs
the pool will serve (the reference's `compcache_ctl prewarm --sweep`
has no port yet: ROADMAP.md Queue 1 item 14).

The sweep file is JSON:

    {
      "sweep": {
        "id": "relay-what-if",
        "objective": {"metric": "flow_p99_ns", "goal": "min"},
        "search": {"strategy": "halving", "eta": 2, "rounds": 3}
      },
      "fleet": { ... FleetPolicy, optional ... },
      "template": { ... JobSpec fields except "id" ... },
      "axes": [
        {"field": "seed", "values": [1, 2, 3, 4]},
        {"field": "load", "values": [1, 2]},
        {"field": "event_capacity", "values": [24, 48]}
      ]
    }
"""

# The port's copy of shadow_tpu/sweep/plan.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import re
from typing import Any

from shadow_tpu_torch.fleet.spec import FleetPolicy, JobSpec, _ID_RE

# user-rankable objectives (reduce.py metric_value): the per-lane
# flow percentiles, the drop counters, and throughput
METRICS = ("flow_p50_ns", "flow_p95_ns", "flow_p99_ns",
           "drops", "events", "events_per_sec")
GOALS = ("min", "max")
STRATEGIES = ("grid", "random", "halving")

# a sweep id prefixes nothing (each sweep owns its dir) but still
# names directories/frames; job ids are "r<round>-<pid>" and must fit
# the fleet's 64-char id regex, so cap the sweep's own id length
_SWEEP_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,31}$")

# fields a sweep axis may NOT vary: identity is the plan's job, and
# lane-requeue provenance is runtime state, not a coordinate
_FORBIDDEN_AXES = frozenset({"id", "lane_of"})

# mirror of compile/specialize.py _plan_touches_reliability: fault
# record kinds that can rewrite the reliability table (keep loss live)
_REL_KINDS = frozenset({"link_down", "link_up", "loss", "partition",
                        "heal"})


@dataclasses.dataclass(frozen=True)
class Objective:
    metric: str = "events"
    goal: str = "max"
    # when True, a done job whose run manifest's health verdict is not
    # "clean" (it self-healed through warnings) is ranked ineligible
    require_clean_health: bool = False

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"objective metric must be one of "
                             f"{METRICS}, got {self.metric!r}")
        if self.goal not in GOALS:
            raise ValueError(f"objective goal must be 'min' or 'max', "
                             f"got {self.goal!r}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Objective":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"unknown objective key(s): {bad}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Axis:
    field: str
    values: tuple

    def __post_init__(self):
        if self.field in _FORBIDDEN_AXES:
            raise ValueError(f"axis field {self.field!r} is not "
                             f"sweepable")
        if self.field not in {f.name for f in
                              dataclasses.fields(JobSpec)}:
            raise ValueError(f"axis field {self.field!r} is not a "
                             f"JobSpec field")
        if not self.values:
            raise ValueError(f"axis {self.field!r} declares zero "
                             f"values")


@dataclasses.dataclass(frozen=True)
class Point:
    """One lattice point: a stable id plus its axis coordinates.
    `pid` is positional (zero-padded row-major index), so two
    expansions of the same spec agree byte-for-byte."""

    pid: str
    index: int
    coords: dict


@dataclasses.dataclass
class SweepSpec:
    id: str
    objective: Objective
    search: dict
    template: dict
    axes: tuple
    policy: FleetPolicy
    prewarm: bool = True

    @classmethod
    def from_obj(cls, obj: Any) -> "SweepSpec":
        if not isinstance(obj, dict) or "sweep" not in obj:
            raise ValueError('sweep file must be an object with a '
                             '"sweep" block')
        blk = obj["sweep"]
        sid = blk.get("id")
        if not sid or not _SWEEP_ID_RE.match(str(sid)):
            raise ValueError(f"sweep id {sid!r} must match "
                             f"{_SWEEP_ID_RE.pattern}")
        objective = Objective.from_dict(blk.get("objective") or {})
        search = validate_search(blk.get("search") or {})
        template = dict(obj.get("template") or {})
        if "id" in template:
            raise ValueError("template must not set 'id' — point ids "
                             "come from the lattice")
        axes_obj = obj.get("axes") or []
        if not axes_obj:
            raise ValueError("sweep declares zero axes")
        axes = []
        seen = set()
        for a in axes_obj:
            ax = Axis(field=a["field"], values=tuple(a["values"]))
            if ax.field in seen:
                raise ValueError(f"duplicate axis field "
                                 f"{ax.field!r}")
            seen.add(ax.field)
            if ax.field in template:
                raise ValueError(f"axis field {ax.field!r} also set "
                                 f"in the template")
            axes.append(ax)
        lattice = 1
        for ax in axes:
            lattice *= len(ax.values)
        if lattice > 65536:
            raise ValueError(f"lattice of {lattice} points exceeds "
                             f"the 65536-point cap")
        if template.get("kind", "scenario") != "scenario":
            raise ValueError("sweeps expand scenario jobs only "
                             "(template kind must be 'scenario')")
        if search.get("strategy") == "halving" and \
                search.get("budget_field") in seen:
            raise ValueError(
                f"halving budget_field {search['budget_field']!r} is "
                f"also a sweep axis — refinement rounds would "
                f"override the coordinate")
        policy = FleetPolicy.from_dict(obj.get("fleet", {}) or {})
        spec = cls(id=str(sid), objective=objective, search=search,
                   template=template, axes=tuple(axes), policy=policy,
                   prewarm=bool(blk.get("prewarm", True)))
        # validate template + axes by materializing the first point —
        # a bad knob fails at load time, not mid-sweep
        spec.point_spec(expand(spec)[0], 0)
        return spec

    @classmethod
    def from_file(cls, path: str) -> "SweepSpec":
        with open(path) as f:
            return cls.from_obj(json.load(f))

    def as_dict(self) -> dict:
        return {
            "sweep": {"id": self.id,
                      "objective": self.objective.as_dict(),
                      "search": dict(self.search),
                      "prewarm": self.prewarm},
            "fleet": self.policy.as_dict(),
            "template": dict(self.template),
            "axes": [{"field": a.field, "values": list(a.values)}
                     for a in self.axes],
        }

    def digest(self) -> str:
        blob = json.dumps(self.as_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def lattice_size(self) -> int:
        n = 1
        for ax in self.axes:
            n *= len(ax.values)
        return n

    def point_spec(self, point: Point, round_no: int,
                   overrides: dict | None = None) -> JobSpec:
        """Materialize one lattice point as a fleet JobSpec for one
        round. `overrides` carries the search strategy's per-round
        budget scaling (search.py)."""
        d = dict(self.template)
        d.update(point.coords)
        if overrides:
            d.update(overrides)
        d["id"] = job_id(round_no, point.pid)
        return JobSpec.from_dict(d)


def validate_search(cfg: dict) -> dict:
    """Normalize + validate a search config (search.py consumes it).
    Returns a plain dict so it journals verbatim."""
    cfg = dict(cfg)
    strategy = cfg.setdefault("strategy", "grid")
    if strategy not in STRATEGIES:
        raise ValueError(f"search strategy must be one of "
                         f"{STRATEGIES}, got {strategy!r}")
    if strategy == "random":
        cfg.setdefault("seed", 1)
        samples = int(cfg.setdefault("samples", 0))
        if samples <= 0:
            raise ValueError("random search needs samples > 0")
    if strategy == "halving":
        eta = int(cfg.setdefault("eta", 2))
        if eta < 2:
            raise ValueError("halving eta must be >= 2")
        rounds = cfg.setdefault("rounds", None)
        if rounds is not None and int(rounds) < 1:
            raise ValueError("halving rounds must be >= 1")
        field = cfg.setdefault("budget_field", "sim_s")
        if field not in {f.name for f in
                         dataclasses.fields(JobSpec)}:
            raise ValueError(f"halving budget_field {field!r} is not "
                             f"a JobSpec field")
        scale = int(cfg.setdefault("budget_scale", 2))
        if scale < 1:
            raise ValueError("halving budget_scale must be >= 1")
    known = {"grid": {"strategy"},
             "random": {"strategy", "seed", "samples"},
             "halving": {"strategy", "eta", "rounds", "budget_field",
                         "budget_scale"}}[strategy]
    bad = sorted(set(cfg) - known)
    if bad:
        raise ValueError(f"unknown {strategy} search key(s): {bad}")
    return cfg


def job_id(round_no: int, pid: str) -> str:
    """Fleet job id of one point in one round — survivors of a
    halving prune re-run as NEW jobs under the next round's prefix,
    so every execution keeps its own dir, journal frames, and
    manifest entry."""
    return f"r{int(round_no)}-{pid}"


def expand(spec: SweepSpec) -> list:
    """The deterministic lattice: the cartesian product of the axes
    in declaration order, last axis fastest (row-major), point ids
    zero-padded so lexicographic order IS lattice order."""
    total = spec.lattice_size()
    width = max(4, len(str(max(0, total - 1))))
    fields = [a.field for a in spec.axes]
    points = []
    for i, combo in enumerate(itertools.product(
            *[a.values for a in spec.axes])):
        points.append(Point(pid=f"p{i:0{width}d}", index=i,
                            coords=dict(zip(fields, combo))))
    return points


def predict_caps(spec: JobSpec) -> dict:
    """Spec-level mirror of compile/specialize.derive for the fleet
    scenario surface: the soak topology is lossless (SOAK_GRAPH
    carries no reliability attribute), so loss stays live only when a
    fault record can rewrite the reliability table; PHOLD's handler
    declares no TIMER emission, so timers stay live only when an
    inject lane is attached. The realized vector in the job's run
    manifest is the ground truth this prediction is checked against
    (the lint warns on divergence — an escalation rebuild can
    legitimately change it)."""
    if getattr(spec, "specialize", "auto") == "off":
        return {"dropped": [], "key_extra": None}
    loss_live = any(str(f.get("kind", "")).lower() in _REL_KINDS
                    for f in (spec.faults or ()))
    timers_live = bool(getattr(spec, "inject_trace", None))
    dropped = sorted(n for n, live in
                     (("loss", loss_live), ("timers", timers_live))
                     if not live)
    return {"dropped": dropped,
            "key_extra": "-".join("no_" + n for n in dropped) or None}


def plan_census(specs) -> dict:
    """The distinct-program census of a set of point specs, computed
    BEFORE anything runs: one entry per bucket-affinity key
    (fleet/affinity.py), carrying how many points share it, its pow2
    capacity buckets, and its predicted specialization vector. This
    is what the driver prewarms — exactly the distinct keys, never
    per-point."""
    from shadow_tpu_torch.compile.buckets import CAPACITY_KEYS, quantize_pow2
    from shadow_tpu_torch.fleet.affinity import affinity_key

    programs: dict = {}
    for s in specs:
        ak = affinity_key(s)
        if ak not in programs:
            programs[ak] = {
                "count": 0,
                "example": s.id,
                "buckets": {k: quantize_pow2(int(getattr(s, k)))
                            for k in CAPACITY_KEYS},
                "specialization": (predict_caps(s)["key_extra"]
                                   or "full"),
            }
        programs[ak]["count"] += 1
    return {"distinct": len(programs),
            "programs": {k: programs[k] for k in sorted(programs)}}
