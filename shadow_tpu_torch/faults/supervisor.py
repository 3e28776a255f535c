"""Run supervisor (PyTorch port of shadow_tpu/faults/supervisor.py, the
serial path): window loop + health latches + checkpoint-backed recovery
+ capacity escalation + preemption-safe resume chains.

At every dispatch barrier — one window, or one K-window chunk when
`windows_per_dispatch` > 1 (checkpoint.run_windows) — the supervisor
reads the sticky latches (faults/health.py) plus its own stall and
time-regression telemetry; every N *windows* it snapshots the sim
(utils/checkpoint.py — atomic + checksummed, so a trip mid-save never
leaves a poisoned resume point). Recovery has three paths, accounted
separately:

- **escalation** (`escalation=EscalationPolicy(...)`): a fatal
  *capacity* latch is healed, not retried — the tripped knob doubles,
  the bundle rebuilds at the grown shapes (`rebuild`, default
  bundle.rebuild) and the last clean pre-trip snapshot transplants into
  the padded arrays (faults/escalate.py). A heal consumes no retry and
  never backs off.
- **retry**: everything else restores the last good snapshot, backs
  off exponentially and retries up to max_retries before giving up
  with a structured failure report.
- **preemption** (`stop=callable`): when the flag reads true at a round
  barrier the supervisor takes one final atomic snapshot and returns
  with `preempted=True`; `resume_from` continues the chain later.

Checkpoint cadence is counted in windows. Engine-stat totals ride every
snapshot's `extra`, so a resumed chain reports cumulative work. A
barrier reads the device twice: the chunk's five stats and the four
latch scalars, one host read each.

`feeder` (inject.Feeder) streams an injection trace through the loop
(checkpoint.run_windows); its trace warnings reach the health report,
and a resume re-syncs it from the snapshot's staging planes.

Lane-isolated runs (core/lanes.py): a CONTAINED lane quarantine is not
fatal (faults/health.py), so the run goes on while the supervisor
performs lane surgery at the detecting barrier — the sick lane's slice
of the last clean snapshot (faults/escalate.py extract_lane) becomes a
salvage artifact beside the checkpoints, and `on_lane_quarantine`
(called with one LaneIncident) fires once per lane, chain-wide.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
Queue 1 item): `mesh`, `exchange_capacity`, `elastic`, `dispatch_wrap`
and `on_mesh_change` (item 9), `warm_start` (item 11b).
"""

from __future__ import annotations

import dataclasses
import time as _time
import uuid
from typing import Optional

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.faults import escalate as escalate_mod
from shadow_tpu_torch.faults import health as health_mod
from shadow_tpu_torch.utils import checkpoint as ckpt

_STAT_KEYS = ("events_processed", "micro_steps", "windows",
              "fastpath_hit", "fastpath_miss")


class LatchTrip(RuntimeError):
    """A fatal health latch fired mid-run. Carries the sim state at the
    trip so the failure path can still report from it."""

    def __init__(self, health: health_mod.RunHealth, sim=None):
        self.health = health
        self.sim = sim
        msgs = "; ".join(m for s, m in health.diagnostics() if s == "fatal")
        super().__init__(msgs or "health latch tripped")


class Preempted(RuntimeError):
    """The stop flag was set at a round barrier; a final checkpoint
    was taken before raising."""

    def __init__(self, path: str, time_ns: int, sim=None):
        self.path = path
        self.time_ns = time_ns
        self.sim = sim
        super().__init__(f"preempted at t={time_ns}, checkpoint {path}")


class DeadlineExceeded(Preempted):
    """The per-run wallclock deadline (max_run_wallclock) passed at a
    round barrier: the same final-snapshot discipline as preemption,
    latched as a `deadline` health fault."""

    def __init__(self, path: str, time_ns: int, sim=None,
                 elapsed_s: float = 0.0):
        super().__init__(path, time_ns, sim)
        self.elapsed_s = elapsed_s


@dataclasses.dataclass(frozen=True)
class LaneIncident:
    """One quarantined lane, detected at a chunk barrier of a packed
    (lane-isolated) run. Carries the blast-radius evidence plus the
    requeue context the fleet consumes (fleet/scenario.py packed
    jobs): which capacity knobs the trip bits say to regrow, and
    where the lane's salvage slice landed."""

    lane: int
    time_ns: int          # window barrier the device quarantined at
    detected_ns: int      # chunk barrier the host noticed it at
    trip_bits: int
    trip: tuple           # TRIP_* names (core.lanes.trip_names)
    flushed: int          # pending events flushed when frozen
    salvage: Optional[str] = None       # lane-surgery artifact path
    salvaged_from: Optional[str] = None  # snapshot the slice came from
    regrow: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"lane": self.lane, "time_ns": self.time_ns,
                "detected_ns": self.detected_ns,
                "trip_bits": self.trip_bits, "trip": list(self.trip),
                "flushed": self.flushed, "salvage": self.salvage,
                "salvaged_from": self.salvaged_from,
                "regrow": dict(self.regrow)}


@dataclasses.dataclass
class SupervisorResult:
    ok: bool
    sim: object
    stats: object                      # EngineStats, cumulative chain
    health: health_mod.RunHealth       # final latch snapshot
    attempts: int = 1
    resumed_from: Optional[str] = None  # snapshot path of the last resume
    checkpoints: tuple = ()            # (path, time_ns) saved, all attempts
    # the retry budget is not consumed by successful self-healing:
    retries_used: int = 0              # failure retries, <= max_retries
    escalation_restarts: int = 0       # heals; unbounded by max_retries
    escalations: tuple = ()            # Escalation records, chain-wide
    preempted: bool = False
    deadline_exceeded: bool = False    # max_run_wallclock fired
    final_checkpoint: Optional[str] = None  # preemption's last snapshot
    run_id: Optional[str] = None
    resume_of: Optional[str] = None    # run_id of the chain predecessor
    # the FINAL attempt's dispatches and the windows each executed
    # (sum == stats.windows for a clean single-attempt run)
    dispatches: int = 0
    dispatch_windows: tuple = ()
    # lane-isolated runs: every lane quarantined across the chain, with
    # salvage pointers
    lane_incidents: tuple = ()

    def failure_report(self) -> dict:
        rep = self.health.failure_report() if self.health is not None \
            else {"verdict": "preempted", "fatal": []}
        rep["attempts"] = self.attempts
        rep["resumed_from"] = self.resumed_from
        rep["retries_used"] = self.retries_used
        rep["escalation_restarts"] = self.escalation_restarts
        if self.escalations:
            rep["escalations"] = [e.as_dict() for e in self.escalations]
        if self.lane_incidents:
            rep["lane_incidents"] = [i.as_dict()
                                     for i in self.lane_incidents]
        if self.preempted:
            rep["verdict"] = "preempted"
            rep["final_checkpoint"] = self.final_checkpoint
        if self.deadline_exceeded:
            rep["verdict"] = "deadline"
            rep["final_checkpoint"] = self.final_checkpoint
        return rep


def run_supervised(bundle, app_handlers=(), *, fault_fn=None,
                   end_time=None, checkpoint_path,
                   checkpoint_every_windows: int = 64,
                   max_retries: int = 2, backoff_s: float = 0.25,
                   stall_windows: int = 512,
                   log=None, on_window=None, on_round=None,
                   harvester=None, sleep=_time.sleep,
                   escalation: escalate_mod.EscalationPolicy | None = None,
                   rebuild=None, stop=None, resume_from=None,
                   max_run_wallclock: float | None = None,
                   run_id: str | None = None,
                   mesh=None, mesh_axis: str = "hosts",
                   exchange_capacity: int | None = None,
                   config_digest: str | None = None,
                   windows_per_dispatch: int | None = None,
                   adaptive_jump: bool | None = None,
                   feeder=None, on_lane_quarantine=None,
                   warm_start: bool | None = None,
                   elastic=None, dispatch_wrap=None, on_mesh_change=None,
                   device=None) -> SupervisorResult:
    """Run `bundle` to end_time under supervision (the host-driven
    window loop of checkpoint.run_windows on `device`, None -> "cuda").

    `escalation` turns capacity trips into heals (module doc);
    `rebuild(overrides) -> SimBundle` defaults to bundle.rebuild. When
    escalation rebuilds, an explicit `fault_fn` is dropped and
    re-resolved from the rebuilt bundle's installed plan (a closure over
    the old shapes would poison the new run); a specialized bundle
    (compile/specialize.py) is specialized again at the grown shapes, so
    the healed program stays trimmed. `stop()` is polled at
    every round barrier; `resume_from` is a snapshot path continuing a
    previous chain (grown-capacity snapshots transplant automatically).
    `max_run_wallclock` is a chain-wide wallclock budget in seconds:
    when a barrier finds it spent, the supervisor takes the
    preemption-style final snapshot and returns with
    `deadline_exceeded=True`. `on_round(sim, wstats, wstart, wend,
    next_min)` runs after the health check at each barrier;
    `on_window(sim, wend)` after it. `log` takes one message string;
    `sleep` is injectable for tests.

    `windows_per_dispatch` / `adaptive_jump` (default: the bundle cfg's
    knobs) select the chunked loop: the barrier — health latches,
    harvest, checkpoint cadence, stop/deadline polls, on_round — runs
    once per chunk on its aggregate stats. Streak and checkpoint
    cadences count executed windows, quantized up to a chunk boundary.
    `on_lane_quarantine(incident)` is the lane-surgery hook (module
    doc)."""
    from shadow_tpu_torch.core.engine import EngineStats
    from shadow_tpu_torch.net.build import refuse_unported

    refuse_unported(mesh=(mesh, 9), exchange_capacity=(exchange_capacity, 9),
                    elastic=(elastic, 9), dispatch_wrap=(dispatch_wrap, 9),
                    on_mesh_change=(on_mesh_change, 9),
                    warm_start=(warm_start, "11b"))

    def say(msg):
        if log is not None:
            log(msg)

    rebuild_fn = rebuild if rebuild is not None \
        else getattr(bundle, "rebuild", None)
    run_id = run_id or uuid.uuid4().hex[:12]
    t_chain0 = _time.monotonic()   # max_run_wallclock origin

    total_saved = []
    attempt = 0
    retries_used = 0
    escalation_restarts = 0
    escalations: list = []
    grows_used = 0
    resume_sim = None
    resume_time = 0
    resumed_from = None
    resume_of = None
    base_stats = {}                    # chain totals at the resume point
    lane_incidents: list = []          # chain-wide, one per lane
    lanes_seen: set = set()            # lanes already surgeried

    if resume_from is not None:
        leaves, meta = ckpt.load_leaves(resume_from)
        resume_sim, resume_time, extra = escalate_mod.transplant(
            leaves, meta, bundle.sim)
        base_stats = dict(extra.get("stats", {}))
        resume_of = extra.get("run_id")
        escalations = [escalate_mod.Escalation.from_dict(d)
                       for d in extra.get("escalations", [])]
        grows_used = len(escalations)
        resumed_from = resume_from
        say(f"supervisor: resuming chain {resume_of or '?'} from "
            f"{resume_from} (t={resume_time})")

    def _ckpt_extra(acc: dict) -> dict:
        stats = {k: base_stats.get(k, 0) + acc.get(k, 0)
                 for k in _STAT_KEYS}
        return {"stats": stats, "run_id": run_id,
                "escalations": [e.as_dict() for e in escalations]}

    def _lane_surgery(h, detected_ns):
        """Record newly quarantined lanes (once per lane, chain-wide)
        and cut each lane's slice out of the last clean snapshot —
        every snapshot predates the trip (health precedes every save),
        so the salvage is the lane's best pre-corruption evidence."""
        if not h.lanes_total:
            return
        caps = ckpt.capacities_of_sim(bundle.sim)
        # resident programs (core/lanes.LaneAdmission): a lane with no
        # live lease holds no tenant — there is nothing to salvage or
        # requeue, and the lease table (fleet/admission.py) owns the
        # lane's lifecycle; raising an incident for it would fabricate
        # a tenant failure out of an empty vessel
        inactive = {d["lane"] for d in getattr(h, "admission", ())
                    if not d.get("active")}
        for d in h.lanes:
            if not d.get("quarantined") or d["lane"] in lanes_seen:
                continue
            if d["lane"] in inactive:
                lanes_seen.add(d["lane"])
                continue
            lanes_seen.add(d["lane"])
            bits = int(d.get("trip_bits", 0))
            salvage, src = None, None
            if total_saved:
                src = total_saved[-1][0]
                try:
                    leaves, meta = ckpt.load_leaves(src)
                    ll, lm = escalate_mod.extract_lane(
                        leaves, meta, d["lane"], h.lanes_total)
                    lm["trip_bits"] = bits
                    lm["trip"] = list(d.get("trip", []))
                    lm["quarantined_at_ns"] = d.get("quarantined_at_ns")
                    salvage = ckpt.save_salvage(
                        f"{checkpoint_path}.lane{d['lane']}.salvage",
                        ll, lm)
                except (OSError, ValueError, KeyError) as e:
                    say(f"supervisor: lane {d['lane']} salvage "
                        f"failed: {e}")
            inc = LaneIncident(
                lane=int(d["lane"]),
                time_ns=int(d.get("quarantined_at_ns") or 0),
                detected_ns=int(detected_ns), trip_bits=bits,
                trip=tuple(d.get("trip", ())),
                flushed=int(d.get("flushed", 0)),
                salvage=salvage, salvaged_from=src,
                regrow=escalate_mod.plan_lane_regrow(bits, caps))
            lane_incidents.append(inc)
            say(f"supervisor: lane {inc.lane} quarantined at "
                f"t={inc.time_ns} (trip={list(inc.trip)}), "
                f"{inc.flushed} event(s) flushed"
                + (f"; salvage {salvage}" if salvage
                   else "; no snapshot to salvage"))
            if on_lane_quarantine is not None:
                on_lane_quarantine(inc)

    def _save(sim, t, acc):
        p = ckpt.save(f"{checkpoint_path}.{t}", sim, time_ns=t,
                      config_digest=config_digest, extra=_ckpt_extra(acc))
        total_saved.append((p, t))
        return p

    while True:
        attempt += 1
        # per-attempt telemetry the chunk closure mutates
        tele = {"zero_streak": 0, "worst_streak": 0, "regressed": False,
                "wstart": None, "since_ckpt": 0, "acc": {},
                "dispatch_windows": []}

        def _gather(sim):
            return health_mod.gather(
                sim, window_start=tele["wstart"],
                stalled_windows=tele["worst_streak"],
                stall_limit=stall_windows,
                time_regression=tele["regressed"],
                # flow-ring overruns ride the same observability
                # warning: results exact, the recorder has gaps
                telemetry_lost=(harvester.records_lost
                                + harvester.flow_lost
                                if harvester is not None else 0),
                trace_warnings=tuple(
                    getattr(feeder, "warnings", ()) or ()))

        def _on_chunk(sim, wstats, wstart, wend, next_min):
            tele["wstart"] = wstart
            ws = wstats.as_dict()
            for k, v in ws.items():
                tele["acc"][k] = tele["acc"].get(k, 0) + v
            tele["dispatch_windows"].append(ws["windows"])
            # streaks count executed WINDOWS, so the stall limit keeps
            # its meaning at any chunk size
            if ws["events_processed"] == 0:
                tele["zero_streak"] += ws["windows"]
                tele["worst_streak"] = max(tele["worst_streak"],
                                           tele["zero_streak"])
            else:
                tele["zero_streak"] = 0
            # runahead may legally schedule inside the current window
            # (next_min < wend); only a start-regression is corrupt
            if next_min < wstart:
                tele["regressed"] = True
            if harvester is not None:
                harvester.drain(sim)
            h = _gather(sim)
            # lane surgery BEFORE the fatal check: even the
            # all-lanes-quarantined abort leaves salvage behind
            _lane_surgery(h, wend)
            if h.fatal:
                # before the user hooks: a tripped round's state is
                # corrupt and will be replayed after the heal
                raise LatchTrip(h, sim)
            # health precedes every save: snapshots are always clean,
            # which is what makes escalation transplants exact
            tele["since_ckpt"] += ws["windows"]
            if (tele["since_ckpt"] >= checkpoint_every_windows
                    and next_min < simtime.INVALID):
                _save(sim, next_min, tele["acc"])
                tele["since_ckpt"] = 0
            if on_round is not None:
                on_round(sim, wstats, wstart, wend, next_min)
            if on_window is not None:
                on_window(sim, wend)
            # preemption polls LAST: the round is complete and every
            # observer has seen it
            if stop is not None and stop() and next_min < simtime.INVALID:
                raise Preempted(_save(sim, next_min, tele["acc"]),
                                next_min, sim)
            if max_run_wallclock is not None \
                    and next_min < simtime.INVALID:
                el = _time.monotonic() - t_chain0
                if el >= max_run_wallclock:
                    raise DeadlineExceeded(
                        _save(sim, next_min, tele["acc"]), next_min, sim,
                        elapsed_s=el)

        def _result(ok, sim, h, **kw):
            return SupervisorResult(
                ok=ok, sim=sim, health=h, attempts=attempt,
                resumed_from=resumed_from,
                checkpoints=tuple(total_saved),
                retries_used=retries_used,
                escalation_restarts=escalation_restarts,
                escalations=tuple(escalations),
                run_id=run_id, resume_of=resume_of,
                dispatches=len(tele["dispatch_windows"]),
                dispatch_windows=tuple(tele["dispatch_windows"]),
                lane_incidents=tuple(lane_incidents), **kw)

        def _chain_stats(sim):
            return EngineStats.from_dict(_ckpt_extra(tele["acc"])["stats"],
                                         device=sim.events.time.device)

        try:
            sim, stats, _ = ckpt.run_windows(
                bundle, app_handlers, end_time=end_time,
                start_time=resume_time, sim=resume_sim, fault_fn=fault_fn,
                on_chunk=_on_chunk,
                stats0=(EngineStats.from_dict(
                    base_stats, device=bundle.sim.events.time.device)
                    if base_stats else None),
                windows_per_dispatch=windows_per_dispatch,
                adaptive_jump=adaptive_jump, feeder=feeder, device=device)
            if harvester is not None:
                harvester.drain(sim)
            h = _gather(sim)
            _lane_surgery(h, tele["wstart"] or 0)
            if h.fatal:
                raise LatchTrip(h, sim)
            return _result(True, sim, h, stats=stats)
        except DeadlineExceeded as d:
            say(f"supervisor: wallclock deadline after "
                f"{d.elapsed_s:.1f}s: {d}")
            h = dataclasses.replace(_gather(d.sim), deadline_exceeded=True)
            return _result(False, d.sim, h, stats=_chain_stats(d.sim),
                           deadline_exceeded=True, final_checkpoint=d.path)
        except Preempted as p:
            say(f"supervisor: {p}")
            # the preempting round passed its health check before the
            # final save — report that healthy snapshot
            return _result(False, p.sim, _gather(p.sim),
                           stats=_chain_stats(p.sim), preempted=True,
                           final_checkpoint=p.path)
        except LatchTrip as trip:
            say(f"supervisor: latch trip on attempt {attempt}: {trip}")
            healed = False
            if escalation is not None and rebuild_fn is not None:
                try:
                    caps = ckpt.capacities_of_sim(bundle.sim)
                    t0 = total_saved[-1][1] if total_saved else 0
                    grow, events = escalate_mod.plan_growth(
                        trip.health, caps, escalation, grows_used,
                        time_ns=t0)
                    healed = True
                except (ValueError, escalate_mod.GrowBudgetExceeded) as e:
                    say(f"supervisor: escalation unavailable: {e}")
            if healed:
                for ev in events:
                    say(f"supervisor: escalating {ev.knob} "
                        f"{ev.old} -> {ev.new} ({ev.latch})")
                    if harvester is not None:
                        harvester.mark_escalation(ev)
                old_telem = getattr(bundle.sim, "telem", None)
                old_inject = getattr(bundle.sim, "inject", None)
                old_lanes = getattr(bundle.sim, "lanes", None)
                old_caps = getattr(bundle, "caps", None)
                bundle = rebuild_fn(grow)
                if old_lanes is not None:
                    # lane isolation at the grown shapes FIRST (the ring
                    # sizes its per-lane planes off sim.lanes), so the
                    # transplant finds the .lanes and overflow-plane
                    # leaves and containment survives the heal
                    from shadow_tpu_torch.core import lanes as lanes_mod

                    bundle.sim = lanes_mod.attach(
                        bundle.sim, old_lanes.replicas,
                        stall_limit=old_lanes.stall_limit)
                if old_telem is not None:
                    # the ring at the grown shapes, so the transplant
                    # finds the snapshot's .telem leaves
                    from shadow_tpu_torch.telemetry.ring import attach

                    bundle.sim = attach(bundle.sim,
                                        capacity=old_telem.capacity)
                if old_inject is not None:
                    # the staging buffer at the same lane count, so the
                    # transplant finds the .inject leaves and the
                    # feeder's sync() resumes the trace without replay
                    from shadow_tpu_torch.inject.staging import attach \
                        as inject_attach

                    bundle.sim = inject_attach(bundle.sim,
                                               old_inject.lanes)
                if old_caps is not None:
                    # re-derive the capability vector at the grown
                    # shapes (growth cannot change it: the reliability
                    # table and the handler set do not depend on
                    # capacity), after every attachment, so the
                    # transplant finds the snapshot's guard leaves and
                    # the healed program stays trimmed
                    from shadow_tpu_torch.compile import specialize

                    bundle = specialize.apply(
                        bundle, app_handlers,
                        app_bulk=getattr(bundle, "app_bulk", None))
                # a caller-supplied fault_fn closes over the OLD
                # shapes; run_windows re-resolves from the rebuilt
                # bundle's installed plan
                fault_fn = None
                escalations.extend(events)
                grows_used += len(events)
                escalation_restarts += 1
                if total_saved:
                    path, t = total_saved[-1]
                    say(f"supervisor: transplanting {path} (t={t}) "
                        f"into grown shapes")
                    leaves, meta = ckpt.load_leaves(path)
                    resume_sim, resume_time, extra = \
                        escalate_mod.transplant(leaves, meta, bundle.sim)
                    base_stats = dict(extra.get("stats", {}))
                    resumed_from = path
                else:
                    say("supervisor: no snapshot yet, rebooting at "
                        "grown capacity")
                    resume_sim, resume_time = None, 0
                    base_stats = {}
                continue  # a heal consumes no retry and sleeps never
            if retries_used >= max_retries:
                # carry the tripped sim so the caller can still report
                return _result(False, trip.sim, trip.health, stats=None)
            retries_used += 1
            if total_saved:
                path, t = total_saved[-1]
                say(f"supervisor: resuming from {path} (t={t}) after "
                    f"backoff")
                resume_sim, resume_time, extra = ckpt.load(path, bundle.sim)
                base_stats = dict(extra.get("stats", {}))
                resumed_from = path
            else:
                say("supervisor: no snapshot yet, restarting from boot")
                resume_sim, resume_time = None, 0
                resumed_from = None
                base_stats = {}
            sleep(backoff_s * (2 ** (retries_used - 1)))
