"""Continuous lane admission: tenant leases over a resident program
(PyTorch port of shadow_tpu/fleet/admission.py; the lease table, the
gate and the ladder are copies, the lane surgery runs on the port's
tensors over core/lanes.py's LaneAdmission planes).

A *resident* program is one compiled packed program (compile/
buckets.py pow2 shapes, compile/serve.py warm serving) whose lane population
changes at window barriers WITHOUT retracing — the LLM-serving
continuous-batching shape, for sims. Everything here is host-side
orchestration over machinery that already exists:

- heterogeneous lanes: every tenant's scenario pads up to the shared
  pow2 lane bucket (compile.buckets.lane_bucket; apps/phold.py
  active_hosts occupies the prefix) and packs as one lane of the
  shared program (fleet/scenario.py build_resident_shell /
  build_tenant_donor);
- lane leases: a LaneLease state machine
  (FREE -> ADMITTED -> RUNNING -> {COMPLETED, EVICTED, QUARANTINED}
  -> FREE) journaled through fleet/journal.py frames, so `--resume`
  reconstructs the resident population exactly by replay;
- join = implant the tenant's donor state into the lane's host rows
  at the next barrier (events time-shifted to the join barrier),
  leave = flush-and-salvage (faults/escalate.py extract_lane) with
  the lane returned to the free pool;
- SLO-aware admission: an AdmissionGate fed by per-lane flow p99s
  (telemetry/flows.py) and lane health latches (core/lanes.py)
  defers/rejects joins and degrades in EXPLICIT ordered steps
  (raise SLO-evaluation stride -> defer admissions -> evict
  best-effort -> quarantine) instead of tripping fatal latches.

The robustness invariant (the churn containment oracle): healthy
resident lanes are byte-identical to an undisturbed run regardless of
churn in other lanes, and the program key is identical before and after
every admission event — joins and leaves mutate runtime data, never
shapes. The port's zero-retrace proof is compile.serve.live_cache_size:
the dispatch callable records the distinct input shapes it ran on, and
that count stays 1.

`lane_digest` equals the reference's for the same state, bit for bit
(each leaf hashed under its flax path as the reference's dtype).

Single-controller, single-shard (shards=1) programs only, like the
fleet's packed jobs.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from shadow_tpu_torch.fleet import journal as journal_mod

# --- LaneLease state machine -----------------------------------------

FREE = "free"
ADMITTED = "admitted"
RUNNING = "running"
COMPLETED = "completed"
EVICTED = "evicted"
QUARANTINED = "quarantined"

LEASE_TERMINAL = (COMPLETED, EVICTED, QUARANTINED)

# legal transitions, keyed by current state. A terminal lease must
# fold through FREE before the lane takes another tenant — except a
# QUARANTINED lane, which stays parked (its trip bits are latched on
# device; only a program restart clears them).
LEASE_LEGAL = {
    FREE: (ADMITTED,),
    ADMITTED: (RUNNING,),
    RUNNING: LEASE_TERMINAL,
    COMPLETED: (FREE,),
    EVICTED: (FREE,),
    QUARANTINED: (FREE,),
}


class LaneLease:
    """One lane's current lease (host-side record; the device shadow
    is core/lanes.LaneAdmission)."""

    __slots__ = ("lane", "state", "job", "epoch", "t_join", "lease_end",
                 "tenant_class", "slo_p99_ms", "ended_at", "digest",
                 "salvage", "reason")

    def __init__(self, lane: int):
        self.lane = int(lane)
        self.state = FREE
        self.job: Optional[str] = None
        self.epoch = 0
        self.t_join: Optional[int] = None
        self.lease_end: Optional[int] = None
        self.tenant_class = "best_effort"
        self.slo_p99_ms: Optional[float] = None
        self.ended_at: Optional[int] = None
        self.digest: Optional[str] = None
        self.salvage: Optional[str] = None
        self.reason: Optional[str] = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class LeaseTable:
    """Journaled lease state machine over R lanes — the fleet
    journal's framing (fleet/journal.py) with a lease-specific fold.
    record() appends one frame then folds it; replay and live share
    the fold, so a resumed table cannot disagree with a live one.

    Idempotent-fold hardening (same contract as FleetQueue._apply): a
    duplicate or conflicting terminal transition for a lane whose
    lease is already settled — a crash between effect and ack can
    journal one — keeps the FIRST terminal state and warns instead of
    crashing or flipping the verdict."""

    def __init__(self, path: str, lanes: int, *, fsync: bool = True,
                 resume: bool = False):
        self.path = path
        self.lease = [LaneLease(r) for r in range(int(lanes))]
        self.seq = 0
        self.admitted_total = 0
        self.completed_total = 0
        self.evicted_total = 0
        self.quarantined_total = 0
        self.deferred_total = 0
        self.degrade_level = 0
        self.degrade_history: list = []
        self.fold_warnings: list = []
        self.history: list = []          # terminal lease records
        if resume:
            for rec in journal_mod.replay(path)[0]:
                self._apply(rec)
        elif os.path.exists(path) and journal_mod.replay(path)[0]:
            raise FileExistsError(
                f"{path} already holds a lease journal — resume it or "
                f"use a fresh directory")
        self.journal = journal_mod.Journal(path, fsync=fsync)

    # -- fold ---------------------------------------------------------
    def record(self, rec: dict) -> dict:
        self.seq += 1
        rec = dict(rec, seq=self.seq)
        self.journal.append(rec)
        self._apply(rec)
        return rec

    def _apply(self, rec: dict) -> None:
        self.seq = max(self.seq, int(rec.get("seq", 0)))
        ev = rec.get("ev")
        if ev == "degrade":
            self.degrade_level = int(rec.get("level", 0))
            self.degrade_history.append(
                {k: rec.get(k) for k in ("level", "step", "why", "t")})
            return
        if ev == "defer":
            self.deferred_total += 1
            return
        if ev != "lease":
            return
        lane = int(rec.get("lane", -1))
        if not 0 <= lane < len(self.lease):
            self.fold_warnings.append(
                f"lease journal: frame for lane {lane} out of range "
                f"(lanes={len(self.lease)}); ignored")
            return
        cur = self.lease[lane]
        st = rec.get("state")
        if st not in LEASE_LEGAL.get(cur.state, ()):
            if st in LEASE_TERMINAL and cur.state in LEASE_TERMINAL:
                self.fold_warnings.append(
                    f"lease journal: duplicate terminal '{st}' for "
                    f"lane {lane} (job {rec.get('job')}) — lease "
                    f"already {cur.state}; keeping the first verdict")
            else:
                self.fold_warnings.append(
                    f"lease journal: illegal transition "
                    f"{cur.state} -> {st} for lane {lane}; ignored")
            return
        if st == ADMITTED:
            cur.state = ADMITTED
            cur.job = rec.get("job")
            cur.epoch = int(rec.get("epoch", cur.epoch + 1))
            cur.t_join = rec.get("t_join")
            cur.lease_end = rec.get("lease_end")
            cur.tenant_class = rec.get("tenant_class", "best_effort")
            cur.slo_p99_ms = rec.get("slo_p99_ms")
            cur.digest = cur.salvage = cur.reason = None
            cur.ended_at = None
            self.admitted_total += 1
        elif st == RUNNING:
            cur.state = RUNNING
        elif st in LEASE_TERMINAL:
            cur.state = st
            cur.ended_at = rec.get("t_end")
            cur.digest = rec.get("digest")
            cur.salvage = rec.get("salvage")
            cur.reason = rec.get("reason")
            self.history.append(cur.as_dict())
            if st == COMPLETED:
                self.completed_total += 1
            elif st == EVICTED:
                self.evicted_total += 1
            else:
                self.quarantined_total += 1
        elif st == FREE:
            self.lease[lane] = LaneLease(lane)
            self.lease[lane].epoch = cur.epoch

    # -- queries ------------------------------------------------------
    def resident(self) -> list:
        """Leases currently holding a lane (ADMITTED or RUNNING)."""
        return [l for l in self.lease if l.state in (ADMITTED, RUNNING)]

    def population(self) -> dict:
        """{lane: (job, state, epoch)} of the resident set — the
        thing `--resume` must reconstruct exactly."""
        return {l.lane: (l.job, l.state, l.epoch)
                for l in self.resident()}

    def free_lanes(self) -> list:
        return [l.lane for l in self.lease if l.state == FREE]

    def counts(self) -> dict:
        return {
            "lanes": len(self.lease),
            "admitted": self.admitted_total,
            "completed": self.completed_total,
            "evicted": self.evicted_total,
            "quarantined": self.quarantined_total,
            "resident": len(self.resident()),
            "deferred": self.deferred_total,
        }

    def close(self) -> None:
        self.journal.close()


# --- SLO-aware admission gate ----------------------------------------

# the degradation ladder, in order. Each step is strictly less
# destructive than tripping a fatal latch — the whole point is that a
# protected tenant's SLO breach degrades service for best-effort
# tenants instead of aborting anybody.
LADDER = ("nominal", "stride", "defer", "evict", "quarantine")


class AdmissionGate:
    """SLO evaluation + the degradation ladder, host-side.

    Inputs per barrier: the flow records drained since the last
    evaluation (telemetry/flows.py FlowRecord, each carrying .lane)
    and the lease table. A lane breaches when its p99 flow latency
    exceeds its tenant's slo_p99_ms; `sustained` consecutive breached
    evaluations make the breach actionable:

    - a best-effort tenant breaching its OWN SLO is evicted at that
      barrier (shedding — its salvage artifact survives);
    - a protected tenant's sustained breach climbs the ladder one
      step per barrier: (1) raise the SLO-evaluation stride — note
      the device flow ring's sample_period is a static shape field,
      so the stride relief is host-side evaluation cadence, never a
      retrace — (2) defer admissions, (3) evict the worst best-effort
      lane, (4) quarantine the breaching lane (core/lanes TRIP_SLO).
      `sustained` clear evaluations walk the ladder back down."""

    def __init__(self, *, sustained: int = 2, eval_stride: int = 1,
                 max_stride: int = 8):
        self.sustained = max(1, int(sustained))
        self.base_stride = max(1, int(eval_stride))
        self.stride = self.base_stride
        self.max_stride = max(self.base_stride, int(max_stride))
        self.level = 0                 # index into LADDER
        self.streak: dict = {}         # lane -> consecutive breaches
        self.clear_streak = 0          # protected all-clear evals
        self._tick = 0
        self.last_p99: dict = {}       # lane -> p99_ns at last eval
        self.breached_jobs: dict = {}  # job -> worst breach ratio

    @property
    def defer_admissions(self) -> bool:
        return self.level >= LADDER.index("defer")

    def evaluate(self, new_records, table: LeaseTable) -> list:
        """-> list of actions: ("evict", lane, why) |
        ("quarantine", lane, why). Ladder moves are reflected in
        self.level / self.stride; the caller journals them."""
        self._tick += 1
        if (self._tick - 1) % self.stride:
            return []                  # stride relief: skip this eval
        from shadow_tpu_torch.telemetry.flows import per_lane_latency

        p99 = {int(k): v["p99_ns"]
               for k, v in per_lane_latency(new_records).items()}
        self.last_p99.update(p99)
        actions = []
        protected_breach = None
        for lease in table.resident():
            if lease.state != RUNNING or lease.slo_p99_ms is None:
                continue
            lane = lease.lane
            if lane not in p99:
                continue               # no fresh samples: no verdict
            slo_ns = float(lease.slo_p99_ms) * 1e6
            if p99[lane] > slo_ns:
                self.streak[lane] = self.streak.get(lane, 0) + 1
                self.breached_jobs[lease.job] = max(
                    self.breached_jobs.get(lease.job, 0.0),
                    p99[lane] / slo_ns)
            else:
                self.streak[lane] = 0
            if self.streak.get(lane, 0) < self.sustained:
                continue
            why = (f"p99 {p99[lane]}ns > slo {int(slo_ns)}ns for "
                   f"{self.streak[lane]} evaluations")
            if lease.tenant_class == "best_effort":
                actions.append(("evict", lane, f"slo breach: {why}"))
                self.streak[lane] = 0
            elif protected_breach is None:
                protected_breach = (lane, why)
        if protected_breach is not None:
            self.clear_streak = 0
            lane, why = protected_breach
            if self.level < len(LADDER) - 1:
                self.level += 1
            step = LADDER[self.level]
            if step == "stride":
                self.stride = min(self.stride * 2, self.max_stride)
            elif step == "evict":
                victim = self._worst_best_effort(table, p99)
                if victim is not None:
                    actions.append((
                        "evict", victim,
                        f"shed for protected lane {lane}: {why}"))
            elif step == "quarantine":
                actions.append((
                    "quarantine", lane,
                    f"slo breach exhausted the ladder: {why}"))
        else:
            self.clear_streak += 1
            if self.clear_streak >= self.sustained and self.level > 0:
                self.level -= 1
                self.clear_streak = 0
                if LADDER[self.level + 1] == "stride":
                    self.stride = self.base_stride
        return actions

    def _worst_best_effort(self, table: LeaseTable, p99: dict):
        cands = [l for l in table.resident()
                 if l.state == RUNNING and l.tenant_class == "best_effort"]
        if not cands:
            return None
        return max(cands,
                   key=lambda l: p99.get(l.lane, -1)).lane


# --- host-side lane surgery helpers ----------------------------------

_NON_TENANT_PREFIXES = (".lanes", ".admission", ".telem", ".flows",
                        ".inject")


def lane_digest(sim, lane: int, replicas: int) -> str:
    """sha256 over one lane's share of every [H]-leading leaf — the
    tenant's result fingerprint. Lane-health/lease planes, telemetry
    and flow rings are whole-program observability state and are
    excluded, exactly like the reference's containment oracle: this
    digest must be byte-identical between a churned and an undisturbed
    run for every healthy lane."""
    import numpy as np

    from shadow_tpu_torch.convert import sim_to_numpy

    H = int(sim.events.num_hosts)
    hs = H // int(replicas)
    lo, hi = int(lane) * hs, (int(lane) + 1) * hs
    h = hashlib.sha256()
    for key, a in sim_to_numpy(sim).items():
        if key.startswith(_NON_TENANT_PREFIXES):
            continue
        if a.ndim == 0 or a.shape[0] != H:
            continue
        h.update(key.encode())
        h.update(np.ascontiguousarray(a[lo:hi]).tobytes())
    return h.hexdigest()


def _map_leaves(sim, fn):
    """A new Sim whose tensor leaves are fn(flax path, tensor) (the
    port's tree_map_with_path over convert.sim_tensors' paths)."""
    import dataclasses

    from shadow_tpu_torch.core.events import is_static

    def walk(obj, prefix):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None or is_static(f):
                continue
            path = f"{prefix}.{f.name}"
            kw[f.name] = (walk(v, path) if dataclasses.is_dataclass(v)
                          else fn(path, v))
        return obj.replace(**kw)

    return walk(sim, "")


def _implant_lane(sim, donor_leaves: dict, lane: int, width: int,
                  t_join: int):
    """Seed one lane's host rows from a tenant donor build: every
    [H]-leading leaf's lane block is overwritten with the donor's SAME
    rows (the donor is a full-shape build, so identity planes — lane
    ids, IPs, peer bases — are already correct for this lane), and the
    donor's boot events are time-shifted to the join barrier. Pure data
    movement at fixed shapes/dtypes: the dispatch program never sees a
    new shape."""
    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.core import simtime

    H = int(sim.events.num_hosts)
    lo, hi = int(lane) * int(width), (int(lane) + 1) * int(width)

    def merge(key, a):
        if key.startswith(_NON_TENANT_PREFIXES):
            return a
        if a.ndim == 0 or a.shape[0] != H:
            return a
        b = donor_leaves.get(key)
        if b is None:
            return a                 # attach-time plane the donor lacks
        blk = convert._leaf(key.rsplit(".", 1)[-1], b[lo:hi], a.device)
        if key == ".events.time":
            blk = torch.where(blk == simtime.INVALID, blk,
                              blk + int(t_join))
        out = a.clone()
        out[lo:hi] = blk.to(a.dtype)
        return out

    return _map_leaves(sim, merge)


def _flush_lane(sim, lane: int, width: int):
    """Host-side flush of one lane's pending events (leave/evict): the
    device-side admission barrier would catch them next window, but
    flushing AT the decision point means a pending fault wakeup or
    stale delivery can never execute between the decision and the next
    barrier."""
    from shadow_tpu_torch.core import simtime

    lo, hi = int(lane) * int(width), (int(lane) + 1) * int(width)
    t = sim.events.time.clone()
    t[lo:hi] = simtime.INVALID
    return sim.replace(events=sim.events.replace(time=t))


def _set_row(x, r: int, v):
    out = x.clone()
    out[r] = v
    return out


def _set_lease_planes(sim, lane: int, *, active: bool,
                      lease_end=None, t_join=None, bump_epoch=False):
    """Update the device LaneAdmission planes for one lane (host-side,
    between dispatches — fixed shapes/dtypes)."""
    from shadow_tpu_torch.core import simtime

    adm = sim.admission
    r = int(lane)
    inv = simtime.INVALID
    adm = adm.replace(
        active=_set_row(adm.active, r, bool(active)),
        lease_end=_set_row(adm.lease_end, r,
                           inv if lease_end is None else int(lease_end)),
        admitted_at=_set_row(adm.admitted_at, r,
                             inv if t_join is None else int(t_join)),
        completed=_set_row(adm.completed, r, False),
        completed_at=_set_row(adm.completed_at, r, inv),
        epoch=(_set_row(adm.epoch, r, adm.epoch[r] + 1) if bump_epoch
               else adm.epoch),
    )
    return sim.replace(admission=adm)


def _quarantine_lane(sim, lane: int, at_ns: int):
    """Host-side quarantine (the ladder's last step): latch the lane's
    quarantine mask + TRIP_SLO so the device freeze takes over at the
    next barrier, exactly as if a capacity latch had tripped — but by
    explicit policy, not by corruption."""
    from shadow_tpu_torch.core.lanes import TRIP_SLO

    lanes = sim.lanes
    r = int(lane)
    lanes = lanes.replace(
        quarantined=_set_row(lanes.quarantined, r, True),
        quarantined_at=_set_row(lanes.quarantined_at, r, int(at_ns)),
        trip_bits=_set_row(lanes.trip_bits, r,
                           lanes.trip_bits[r] | TRIP_SLO))
    return sim.replace(lanes=lanes)


# --- the resident program --------------------------------------------

class ResidentProgram:
    """One warm packed program + a lease table + an admission gate:
    the host loop that makes the lane population continuous.

    Lifecycle per barrier (one dispatch = `chunk_windows` windows; 1
    by default, which is what bounds admission latency — the SET-style
    runahead bound — to a single window barrier):

        dispatch -> fold completions/quarantines -> drain flows ->
        gate.evaluate -> evictions -> admissions -> checkpoint

    All mutations between dispatches are runtime data at fixed
    shapes; compile.serve.live_cache_size proves zero retraces (one
    input shape ever) and the recomputed program key proves the key
    never moved. The program runs on `device` (None -> "cuda")."""

    def __init__(self, specs, *, workdir: str, lanes: int,
                 horizon_s: int, chunk_windows: int = 1,
                 flow_sample: int = 1, gate: AdmissionGate | None = None,
                 checkpoint_every_events: int = 1, seed: int = 0,
                 fsync: bool = True, log=None, resume: bool = False,
                 device=None):
        from shadow_tpu_torch.compile.buckets import lane_bucket
        from shadow_tpu_torch.core import simtime
        from shadow_tpu_torch.device import resolve_device
        from shadow_tpu_torch.fleet import scenario as scen

        self.device = resolve_device(device)
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.log = log or (lambda m: None)
        self.specs = {s.id: s for s in specs}
        for s in self.specs.values():
            _check_tenant(s)
        self.lanes = int(lanes)
        self.width = lane_bucket([s.hosts for s in self.specs.values()])
        self.horizon_ns = int(horizon_s) * simtime.ONE_SECOND
        self.caps = scen.resident_caps(self.specs.values())
        self.flow_sample = int(flow_sample)
        self.gate = gate if gate is not None else AdmissionGate()
        self.checkpoint_every_events = max(0, int(checkpoint_every_events))
        self._ck_prefix = os.path.join(workdir, "ck")
        self._donors: dict = {}
        self.table = LeaseTable(os.path.join(workdir, "leases.log"),
                                self.lanes, fsync=fsync, resume=resume)
        self._bundle = scen.build_resident_shell(
            width=self.width, lanes=self.lanes, caps=self.caps,
            horizon_ns=self.horizon_ns, seed=seed,
            flow_sample=self.flow_sample, device=self.device)
        self.sim = self._bundle.sim
        self._setup_dispatch(chunk_windows)
        self.frontier = 0
        self.windows = 0
        self.events = 0
        self.dispatches = 0
        self._flow_cursor = 0
        self._events_since_ck = 0
        self.admission_events = 0
        self.results: dict = {}        # job -> terminal record dict
        from shadow_tpu_torch import telemetry

        self.harvester = (telemetry.Harvester()
                          if self.flow_sample > 0 else None)

    # -- dispatch machinery ------------------------------------------
    def _setup_dispatch(self, chunk_windows: int):
        from shadow_tpu_torch.apps import phold
        from shadow_tpu_torch.compile import serve
        from shadow_tpu_torch.utils import checkpoint as ckpt

        self._handlers = (phold.handler,)
        self._plan = ckpt._resolve_loop(
            self._bundle, self._handlers, end_time=self.horizon_ns,
            fault_fn=None, mesh=None, mesh_axis="hosts",
            windows_per_dispatch=max(1, int(chunk_windows)),
            adaptive_jump=False, device=self.device)
        warm = serve.warm_enabled(default=False)
        self._compile_info: dict = {}
        (self._chunk_fn, self._one_window, key, self._raw,
         _example) = ckpt._make_dispatch_fns(
            self._bundle, self._plan, self.sim, self._handlers,
            mesh=None, mesh_axis=None, exchange_capacity=None,
            warm=warm, compile_info=self._compile_info)
        # the retrace count: the dispatch callable, served (serve.WarmFn)
        # or live, is wrapped to record its input shapes
        if self._chunk_fn is not None \
                and not isinstance(self._chunk_fn, serve.ShapeLog):
            self._chunk_fn = serve.ShapeLog(self._chunk_fn)
        if self._one_window is not None \
                and not isinstance(self._one_window, serve.ShapeLog):
            self._one_window = serve.ShapeLog(self._one_window)
        self.program_key = key if key is not None else self._recompute_key()
        self.program_keys = {self.program_key}
        self.retraces_seen = 0

    def _recompute_key(self):
        from shadow_tpu_torch.utils import checkpoint as ckpt

        return ckpt._program_key_for(
            self._bundle, self._plan, self.sim, self._handlers,
            sharded=False, exchange_capacity=None)

    def _note_admission_event(self):
        """Zero-retrace bookkeeping after every admission event: the
        program key must not move and the live trace cache must not
        grow past one entry."""
        from shadow_tpu_torch.compile import serve

        self.admission_events += 1
        self.program_keys.add(self._recompute_key())
        fn = self._chunk_fn if self._chunk_fn is not None else self._one_window
        n = serve.live_cache_size(fn)
        if n is not None and n > 1:
            self.retraces_seen = max(self.retraces_seen, n - 1)
        self._events_since_ck += 1

    @property
    def program_key_stable(self) -> bool:
        return len(self.program_keys) == 1 and self.retraces_seen == 0

    def _dispatch_once(self, wstart: int):
        from shadow_tpu_torch.core.engine import EngineStats

        if self._chunk_fn is not None:
            sim, stats, nm = self._chunk_fn(
                self.sim, EngineStats.create(device=self.device),
                int(wstart))
            self.windows += int(stats.windows)
        else:
            # same clamp as run_windows: end + 1 so events AT the
            # horizon still execute
            wend = min(int(wstart) + self._plan.min_jump,
                       self.horizon_ns + 1)
            sim, stats, nm = self._one_window(self.sim, int(wstart), wend)
            self.windows += 1
        self.events += int(stats.events_processed)
        self.sim = sim
        self.dispatches += 1
        return int(nm)

    # -- lease operations --------------------------------------------
    def _donor(self, spec):
        from shadow_tpu_torch.convert import sim_to_numpy
        from shadow_tpu_torch.fleet import scenario as scen

        key = (spec.id, spec.seed, spec.hosts, spec.load)
        if key not in self._donors:
            donor = scen.build_tenant_donor(
                spec, width=self.width, lanes=self.lanes,
                caps=self.caps, horizon_ns=self.horizon_ns,
                device=self.device)
            self._donors[key] = sim_to_numpy(donor.sim)
        return self._donors[key]

    def admit(self, job_id: str, *, lane: int | None = None,
              force: bool = False):
        """Admit a tenant at the current frontier. Returns the lane,
        or None when deferred (no free lane, gate deferring, or the
        lease would outrun the program horizon)."""
        from shadow_tpu_torch.core import simtime

        spec = self.specs[job_id]
        if self.gate.defer_admissions and not force:
            self.table.record({"ev": "defer", "job": job_id,
                               "why": f"ladder at "
                                      f"{LADDER[self.gate.level]}"})
            self.log(f"admission deferred for {job_id} (ladder)")
            return None
        free = self.table.free_lanes()
        if lane is None:
            lane = free[0] if free else None
        elif lane not in free:
            raise ValueError(f"lane {lane} is not free")
        if lane is None:
            self.table.record({"ev": "defer", "job": job_id,
                               "why": "no free lane"})
            return None
        t_join = max(self.frontier, 0)
        lease_end = t_join + int(spec.sim_s) * simtime.ONE_SECOND
        if lease_end > self.horizon_ns:
            self.table.record({"ev": "defer", "job": job_id,
                               "why": "lease outruns horizon"})
            return None
        self._implant(spec, lane, t_join, lease_end)
        return lane

    def _implant(self, spec, lane: int, t_join: int, lease_end: int):
        epoch = self.table.lease[lane].epoch + 1
        self.table.record({
            "ev": "lease", "lane": lane, "state": ADMITTED,
            "job": spec.id, "epoch": epoch, "t_join": int(t_join),
            "lease_end": int(lease_end),
            "tenant_class": spec.tenant_class,
            "slo_p99_ms": spec.slo_p99_ms,
        })
        self.sim = _flush_lane(self.sim, lane, self.width)
        self.sim = _implant_lane(self.sim, self._donor(spec), lane,
                                 self.width, t_join)
        self.sim = _set_lease_planes(self.sim, lane, active=True,
                                     lease_end=lease_end, t_join=t_join,
                                     bump_epoch=True)
        self.table.record({"ev": "lease", "lane": lane,
                           "state": RUNNING, "job": spec.id,
                           "epoch": epoch})
        self._note_admission_event()
        self.log(f"lane {lane}: admitted {spec.id} at t={t_join} "
                 f"(lease_end={lease_end}, epoch={epoch})")

    def evict(self, job_id: str, *, reason: str = "operator") -> bool:
        lease = next((l for l in self.table.resident()
                      if l.job == job_id), None)
        if lease is None:
            return False
        self._end_lease(lease, EVICTED, reason=reason, salvage=True)
        self._note_admission_event()
        return True

    def _salvage(self, lease) -> str | None:
        from shadow_tpu_torch.faults.escalate import extract_lane
        from shadow_tpu_torch.utils import checkpoint as ckpt

        from shadow_tpu_torch.convert import sim_to_numpy

        try:
            leaves = sim_to_numpy(self.sim)
            meta = {"time_ns": int(self.frontier),
                    "capacities": ckpt.capacities_of_sim(self.sim),
                    "extra": {"job": lease.job, "epoch": lease.epoch,
                              "t_join": lease.t_join,
                              "lease_end": lease.lease_end,
                              "reason": lease.reason}}
            out, lane_meta = extract_lane(leaves, meta, lease.lane,
                                          self.lanes)
            path = os.path.join(
                self.workdir,
                f"salvage.{lease.job}.lane{lease.lane}"
                f".e{lease.epoch}.npz")
            return ckpt.save_salvage(path, out, lane_meta)
        except Exception as e:  # noqa: BLE001 — salvage is best-effort
            self.log(f"salvage failed for {lease.job}: {e}")
            return None

    def _end_lease(self, lease, state: str, *, reason: str = "",
                   salvage: bool = False, quarantine: bool = False):
        lease.reason = reason or None
        digest = lane_digest(self.sim, lease.lane, self.lanes)
        salvage_path = self._salvage(lease) if salvage else None
        rec = {"ev": "lease", "lane": lease.lane, "state": state,
               "job": lease.job, "epoch": lease.epoch,
               "t_end": int(self.frontier), "digest": digest}
        if reason:
            rec["reason"] = reason
        if salvage_path:
            rec["salvage"] = salvage_path
        self.table.record(rec)
        self.results[lease.job] = dict(rec, tenant_class=lease.tenant_class)
        if quarantine:
            self.sim = _quarantine_lane(self.sim, lease.lane,
                                        self.frontier)
            # quarantined lanes stay parked: no "free" frame
        else:
            self.sim = _flush_lane(self.sim, lease.lane, self.width)
            self.table.record({"ev": "lease", "lane": lease.lane,
                               "state": FREE, "job": lease.job,
                               "epoch": lease.epoch})
        self.sim = _set_lease_planes(self.sim, lease.lane, active=False)
        self.log(f"lane {lease.lane}: {lease.job} -> {state}"
                 + (f" ({reason})" if reason else ""))

    # -- the barrier fold --------------------------------------------
    def _fold_barrier(self):
        """Process one barrier: completions and quarantines from the
        device planes, then flow drain + SLO gate actions."""
        adm = self.sim.admission
        done = adm.completed.cpu().numpy()
        quar = self.sim.lanes.quarantined.cpu().numpy()
        for lease in list(self.table.resident()):
            if lease.state != RUNNING:
                continue
            if bool(quar[lease.lane]):
                lease.reason = "lane quarantined"
                self._end_lease(lease, QUARANTINED,
                                reason="lane health trip",
                                salvage=True, quarantine=True)
                self._note_admission_event()
            elif bool(done[lease.lane]):
                self._end_lease(lease, COMPLETED, salvage=False)
                self._note_admission_event()
        if self.harvester is None:
            return
        self.harvester.drain(self.sim)
        fresh = self.harvester.flow_records[self._flow_cursor:]
        self._flow_cursor = len(self.harvester.flow_records)
        level_before = self.gate.level
        for act, lane, why in self.gate.evaluate(fresh, self.table):
            lease = self.table.lease[lane]
            if lease.state != RUNNING:
                continue
            if act == "evict":
                self._end_lease(lease, EVICTED, reason=why,
                                salvage=True)
            else:
                self._end_lease(lease, QUARANTINED, reason=why,
                                salvage=True, quarantine=True)
            self._note_admission_event()
        if self.gate.level != level_before:
            self.table.record({
                "ev": "degrade", "level": self.gate.level,
                "step": LADDER[self.gate.level],
                "why": f"ladder {'up' if self.gate.level > level_before else 'down'} "
                       f"(stride={self.gate.stride})"})
            self.log(f"degradation ladder -> "
                     f"{LADDER[self.gate.level]}")

    def _maybe_checkpoint(self):
        from shadow_tpu_torch.utils import checkpoint as ckpt

        if (self.checkpoint_every_events
                and self._events_since_ck >= self.checkpoint_every_events):
            self._events_since_ck = 0
            ckpt.save(f"{self._ck_prefix}.{int(self.frontier)}",
                      self.sim, time_ns=int(self.frontier),
                      extra={"lease_seq": self.table.seq,
                             "kind": "resident"})

    # -- driving ------------------------------------------------------
    def advance(self, *, until_ns: int | None = None,
                max_dispatches: int = 100000) -> int:
        """Run dispatches (folding every barrier) until the frontier
        reaches `until_ns` (or the resident set drains). Returns the
        frontier."""
        from shadow_tpu_torch.core import simtime

        target = (self.horizon_ns if until_ns is None
                  else min(int(until_ns), self.horizon_ns))
        for _ in range(max_dispatches):
            self._fold_barrier()
            self._maybe_checkpoint()
            if self.frontier >= target:
                break
            nm = int(self.sim.events.min_time().amin())
            if nm == simtime.INVALID:
                # nothing pending anywhere: the frontier jumps to the
                # target (idle time costs zero dispatches)
                self.frontier = target
                self._fold_barrier()
                break
            wstart = max(nm, 0)
            if wstart >= target:
                self.frontier = min(wstart, target)
                continue
            nxt = self._dispatch_once(wstart)
            self.frontier = (nxt if nxt != simtime.INVALID
                             else min(wstart + self._plan.min_jump,
                                      target))
        return self.frontier

    def drain(self, *, max_dispatches: int = 100000) -> int:
        """Run until every resident lease reaches a terminal state."""
        from shadow_tpu_torch.core import simtime

        for _ in range(max_dispatches):
            self._fold_barrier()
            self._maybe_checkpoint()
            if not self.table.resident():
                break
            nm = int(self.sim.events.min_time().amin())
            if nm == simtime.INVALID:
                # resident but quiet: the next fold collects them
                self.frontier = max(
                    self.frontier,
                    max((l.lease_end or 0)
                        for l in self.table.resident()))
                self._fold_barrier()
                break
            nxt = self._dispatch_once(max(nm, 0))
            self.frontier = (nxt if nxt != simtime.INVALID
                             else self.frontier + self._plan.min_jump)
        return self.frontier

    # -- manifest / teardown -----------------------------------------
    def manifest_block(self) -> dict:
        from shadow_tpu_torch.core.lanes import admission_report

        blk = dict(self.table.counts())
        blk.update({
            "program_key": self.program_key,
            "program_key_stable": bool(self.program_key_stable),
            "admission_events": int(self.admission_events),
            "retraces": int(self.retraces_seen),
            "lane_width": int(self.width),
            "degrade_level": int(self.gate.level),
            "degrade_step": LADDER[self.gate.level],
            "degrade_history": list(self.table.degrade_history),
            "per_lane": admission_report(self.sim),
            "slo": {
                "eval_stride": int(self.gate.stride),
                "sustained": int(self.gate.sustained),
                "breached_jobs": {
                    k: round(v, 3)
                    for k, v in self.gate.breached_jobs.items()},
                "last_p99_ns": {str(k): int(v) for k, v in
                                sorted(self.gate.last_p99.items())},
            },
            "lease_warnings": list(self.table.fold_warnings),
        })
        return blk

    def close(self) -> None:
        self.table.close()

    # -- resume -------------------------------------------------------
    @classmethod
    def resume(cls, specs, *, workdir: str, lanes: int, horizon_s: int,
               **kw):
        """Reconstruct a resident program after a crash: replay the
        lease journal (torn tail truncated by the framing), load the
        newest checkpoint, and re-apply any lease frame newer than
        the checkpoint's recorded lease_seq — joins re-implant their
        donors at the journaled t_join, terminal frames re-flush. The
        resident population is then EXACTLY the journal's fold, which
        is the acceptance contract."""
        from shadow_tpu_torch.utils import checkpoint as ckpt

        rp = cls(specs, workdir=workdir, lanes=lanes,
                 horizon_s=horizon_s, resume=True, **kw)
        ck = ckpt.latest_checkpoint(rp._ck_prefix)
        ck_seq = 0
        if ck is not None:
            leaves, meta = ckpt.load_leaves(ck)
            rp.sim = _sim_from_leaves(rp.sim, leaves)
            rp.frontier = int(meta.get("time_ns", 0))
            ck_seq = int((meta.get("extra") or {}).get("lease_seq", 0))
        # re-apply the journal tail the checkpoint missed
        tail = [r for r in journal_mod.replay(rp.table.path)[0]
                if r.get("ev") == "lease"
                and int(r.get("seq", 0)) > ck_seq]
        for rec in tail:
            lane, st = int(rec["lane"]), rec.get("state")
            if st == ADMITTED:
                spec = rp.specs[rec["job"]]
                rp.sim = _flush_lane(rp.sim, lane, rp.width)
                rp.sim = _implant_lane(rp.sim, rp._donor(spec), lane,
                                       rp.width, int(rec["t_join"]))
                rp.sim = _set_lease_planes(
                    rp.sim, lane, active=True,
                    lease_end=int(rec["lease_end"]),
                    t_join=int(rec["t_join"]), bump_epoch=True)
            elif st in LEASE_TERMINAL or st == FREE:
                rp.sim = _flush_lane(rp.sim, lane, rp.width)
                rp.sim = _set_lease_planes(rp.sim, lane, active=False)
        return rp


def _sim_from_leaves(template, leaves: dict):
    """Rebuild a same-shape Sim from checkpoint leaves (flax-path keyed,
    utils/checkpoint.py layout) on the template's device. Leaves absent
    from the snapshot keep the template's value; shape mismatches are
    refused by name."""
    from shadow_tpu_torch import convert

    def pick(key, a):
        b = leaves.get(key)
        if b is None:
            return a
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"resume: leaf {key} shape {b.shape} != template "
                f"{tuple(a.shape)}")
        return convert._leaf(key.rsplit(".", 1)[-1], b,
                             a.device).to(a.dtype)

    return _map_leaves(template, pick)


def _check_tenant(spec) -> None:
    if spec.kind != "scenario":
        raise ValueError(f"tenant {spec.id}: resident programs take "
                         f"kind 'scenario' jobs, got {spec.kind!r}")
    if int(getattr(spec, "replicas", 1)) != 1:
        raise ValueError(f"tenant {spec.id}: a tenant occupies ONE "
                         f"lane (replicas must be 1)")
    if spec.inject_trace is not None:
        raise ValueError(f"tenant {spec.id}: trace injection is not "
                         f"supported in resident lanes")
    if spec.faults:
        raise ValueError(
            f"tenant {spec.id}: per-tenant fault plans would bake "
            f"into the shared program (kind_census) — resident "
            f"tenants must not carry faults")


# --- fleet integration -----------------------------------------------

def run_resident_fleet(fleet_dir: str, policy, specs, *,
                       lanes: int | None = None,
                       horizon_s: int | None = None,
                       resume: bool = False, log=None,
                       gate: AdmissionGate | None = None,
                       flow_sample: int = 1, fsync: bool = True,
                       device=None) -> dict:
    """`fleet run --resident`: execute every job as a tenant lease of
    ONE resident program instead of one worker process per job. The
    fleet queue keeps its journal/manifest contract (leases map to
    leased/running frames, terminal leases to done/requeued/
    quarantined), and the lease journal + admission block ride next
    to them. The program runs on `device` (None -> "cuda"). Returns the
    fleet manifest dict."""
    from shadow_tpu_torch.fleet import manifest as manifest_mod
    from shadow_tpu_torch.fleet.state import FleetQueue

    say = log or (lambda m: None)
    queue = FleetQueue(fleet_dir, policy, specs, resume=resume,
                       fsync=fsync)
    tenants = [j.spec for j in queue.jobs.values()]
    if lanes is None:
        lanes = max(2, len(tenants))
    if horizon_s is None:
        horizon_s = 4 * max(int(s.sim_s) for s in tenants) * max(
            2, len(tenants))
    rp_cls = (ResidentProgram.resume if resume else ResidentProgram)
    rp = rp_cls(tenants, workdir=os.path.join(fleet_dir, "resident"),
                lanes=int(lanes), horizon_s=int(horizon_s),
                gate=gate, flow_sample=flow_sample, fsync=fsync,
                log=say, device=device)
    resident_jobs = {l.job for l in rp.table.resident()}
    for jid, j in queue.jobs.items():
        # resumed leases keep running; everything else non-terminal
        # queues for admission
        if jid in resident_jobs and j.status != "running":
            queue.record({"ev": "leased", "job": jid,
                          "worker": "resident", "attempt":
                          max(1, j.attempts)})
            queue.record({"ev": "running", "job": jid,
                          "worker": "resident",
                          "attempt": max(1, j.attempts)})

    def _write_manifest(complete=False):
        man = manifest_mod.fleet_manifest(queue, workers_alive=0,
                                          complete=complete,
                                          admission=rp.manifest_block())
        manifest_mod.write_fleet_manifest(
            os.path.join(fleet_dir, "fleet_manifest.json"), man)
        return man

    guard = 0
    while True:
        guard += 1
        if guard > 1000:
            say("resident fleet: progress guard tripped")
            break
        settled = {jid for jid, j in queue.jobs.items() if j.terminal}
        # admit every ready job a free lane will take
        for j in queue.ready(queue.now()):
            if rp.table.free_lanes() and not rp.gate.defer_admissions:
                lane = rp.admit(j.spec.id)
                if lane is not None:
                    queue.lease(j.spec.id, "resident")
                    queue.mark_running(j.spec.id, "resident")
        if not rp.table.resident():
            if all(j.terminal for j in queue.jobs.values()):
                break
            if not queue.ready(queue.now()):
                break              # only backed-off/deferred jobs left
            continue
        rp.drain(max_dispatches=10000)
        for job_id, rec in list(rp.results.items()):
            rp.results.pop(job_id, None)   # consume: a later lease of
            # this job must not re-fold a stale verdict
            if job_id in settled or queue.jobs[job_id].terminal:
                continue
            st = rec.get("state")
            if st == COMPLETED:
                queue.complete(job_id, {
                    "ok": True, "digest": rec.get("digest"),
                    "lease": rec, "program_key": rp.program_key})
            elif st == EVICTED:
                # shedding is not the tenant's fault: requeue, don't
                # burn the failure budget
                queue.record({"ev": "requeued", "job": job_id,
                              "resume_from": None,
                              "cause": f"evicted: {rec.get('reason')}"})
            elif st == QUARANTINED:
                queue.quarantine(job_id,
                                 f"lane quarantined: {rec.get('reason')}",
                                 {"lease": rec})
        _write_manifest()
    man = _write_manifest(
        complete=all(j.terminal for j in queue.jobs.values()))
    rp.close()
    queue.close()
    return man
