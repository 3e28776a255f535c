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

On a mesh (`mesh`, parallel.shard.Mesh) every rank runs the same
supervisor over the sharded loop of checkpoint.run_windows: the
barrier's health read, the cadences and the recovery decisions see the
global Sim, so the ranks decide alike; rank 0 alone writes each
snapshot and every rank waits for it, so a retry or a heal reads the
same file everywhere.

Elastic degraded-mesh recovery (`elastic`, parallel/elastic.py): a
DEVICE_LOST (a classified dispatch or collective error) or a
SHARD_DIVERGENCE latch steps the ladder — retry the same width, shrink
to the next-pow2-down survivors, fall back to serial on the rank's own
card — resuming from the last VERIFIED snapshot. A process group cannot
drop a member in place, so every rank tears its group down
(Mesh.abort, bounded) and the live ranks meet again at a file-store
rendezvous beside the checkpoints (elastic.Rendezvous); the first
next_pow2_down(live) of them, in old-rank order, form the new group,
and the rest retire (`SupervisorResult.retired`). Every rung is a
function of replicated state and of the sealed membership, so the
ranks take the same one. A retry needs every rank: when the rendezvous
finds one missing, the ladder takes the next rung. The new rank 0
replans and writes the snapshots and the result; `on_mesh_change` fires
there once. `warm_start` serves each attempt's dispatch program from
the persistent program store (compile/serve.py), and
`SupervisorResult.compile_info` carries the final attempt's `compile`
block.
"""

from __future__ import annotations

import dataclasses
import time as _time
import uuid
from typing import Optional

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.faults import escalate as escalate_mod
from shadow_tpu_torch.faults import health as health_mod
from shadow_tpu_torch.parallel import elastic as elastic_mod
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
    # elastic degraded-mesh recovery: losses, divergences, the ladder
    # steps and the mesh transitions — the manifest's `elastic` block;
    # None when no ElasticPolicy was installed and nothing tripped
    elastic: Optional[dict] = None
    # a rank the ladder left out of the shrunk mesh (or the serial
    # rung): it stopped cleanly and holds no result (sim, stats None)
    retired: bool = False
    # this rank writes the run's report: rank 0 of the final mesh, the
    # rank that carries the serial rung, or a serial run
    reports: bool = True
    # the FINAL attempt's program-store block ({key, warm, hit, ...};
    # compile/serve.py) — None when nothing filled it
    compile_info: Optional[dict] = None

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
        if self.elastic is not None:
            rep["elastic"] = dict(self.elastic)
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
                   elastic: elastic_mod.ElasticPolicy | None = None,
                   dispatch_wrap=None, on_mesh_change=None,
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
    `sleep` is injectable for tests. On a mesh, pass `stop` and
    `max_run_wallclock` alike on every rank: their flags are reduced
    over the ranks at each barrier.

    `windows_per_dispatch` / `adaptive_jump` (default: the bundle cfg's
    knobs) select the chunked loop: the barrier — health latches,
    harvest, checkpoint cadence, stop/deadline polls, on_round — runs
    once per chunk on its aggregate stats. Streak and checkpoint
    cadences count executed windows, quantized up to a chunk boundary.
    `on_lane_quarantine(incident)` is the lane-surgery hook (module
    doc).

    `elastic` (parallel/elastic.ElasticPolicy) arms degraded-mesh
    recovery (module doc): every dispatch is wrapped in guard_dispatch,
    so a lost device or rank surfaces as a typed DeviceLossError and
    steps the ladder; a SHARD_DIVERGENCE latch (attach_sentinel) steps
    the same ladder, resuming no later than its verified frontier.
    Ladder steps consume no failure retries and are bounded by
    `max_losses`; a DEVICE_LOST without a policy re-raises.
    `dispatch_wrap` composes INSIDE the guard (chaos poison sees the
    dispatch first, the classifier its error); `on_mesh_change(
    old_shards, new_shards, cause)` fires on every width change, on
    the rank that reports."""
    from shadow_tpu_torch.core.engine import EngineStats

    def say(msg):
        if log is not None:
            log(msg)

    rebuild_fn = rebuild if rebuild is not None \
        else getattr(bundle, "rebuild", None)
    run_id = run_id or uuid.uuid4().hex[:12]
    t_chain0 = _time.monotonic()   # max_run_wallclock origin
    # elastic recovery makes the mesh MUTABLE chain state: a ladder step
    # may re-form it narrower (or drop to serial) between attempts
    cur_mesh = mesh if mesh is not None and mesh.size > 1 else None
    cur_shards = mesh.size if mesh is not None else 1
    plain_mesh = mesh if cur_mesh is None else None   # a one-rank mesh
    shards0 = cur_shards
    losses: list = []              # DeviceLossError records, chain-wide
    divergences: list = []         # sentinel trips, chain-wide
    ladder_steps: list = []        # one per loss/divergence handled
    same_mesh_used: dict = {}      # mesh width -> same-mesh retries spent
    owned_mesh = None              # a mesh the ladder formed (closed here)
    generation = 0
    rdv_prefix = None
    # a serial rung runs on the rank's own device
    run_device = device if device is not None else (
        mesh.device if mesh is not None else None)
    if elastic is not None and cur_mesh is not None:
        # one id for the whole mesh (rank 0's), so the rendezvous files
        # of every generation have one name on every rank; rank 0 clears
        # a former run's files of that name before the gather (a barrier)
        run_id = cur_mesh.all_gather_object(run_id)[0]
        rdv_prefix = f"{checkpoint_path}.{run_id}.mesh"
        if cur_mesh.rank == 0:
            elastic_mod.Rendezvous.clear(rdv_prefix)
        cur_mesh.barrier()
        elastic_mod.Rendezvous.publish_pids(rdv_prefix, cur_mesh.rank)

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
        p = f"{checkpoint_path}.{t}.npz"
        if cur_mesh is None or cur_mesh.rank == 0:
            ckpt.save(p, sim, time_ns=t, config_digest=config_digest,
                      extra=_ckpt_extra(acc), shards=cur_shards)
        if cur_mesh is not None:
            cur_mesh.barrier()
        total_saved.append((p, t))
        return p

    def _verified_snapshot(limit_ns: int | None = None):
        """Newest checkpoint the elastic ladder may resume from: its
        elastic stamp (checkpoint.elastic_meta) shows zero sentinel
        trips — or it carries none, and the health check that preceded
        the save is the verifier. `limit_ns` (a divergence's
        verified_through) additionally caps the resume time. Returns
        (path, time_ns, meta) or None."""
        for path, t in reversed(total_saved):
            if limit_ns is not None and t > limit_ns:
                continue
            try:
                _, meta = ckpt.load_leaves(path)
            except (OSError, ValueError, KeyError) as e:
                say(f"supervisor: skipping unreadable snapshot "
                    f"{path}: {e}")
                continue
            el = meta.get("elastic")
            rep = el.get("sentinel") if isinstance(el, dict) else None
            if rep and rep.get("trips"):
                continue
            return path, t, meta
        return None

    def _elastic_block():
        if elastic is None and not losses and not divergences:
            return None
        return {
            "policy": elastic.as_dict() if elastic is not None else None,
            "initial_shards": shards0,
            "final_shards": cur_shards,
            "losses": [dict(d) for d in losses],
            "divergences": [dict(d) for d in divergences],
            "ladder_steps": [dict(s) for s in ladder_steps],
            "mesh_transitions": [dict(s) for s in ladder_steps
                                 if s["from"] != s["to"]],
        }

    def _decide_rung():
        """retry / shrink / serial from replicated chain state (the
        reference's order), or None when the ladder is exhausted."""
        if same_mesh_used.get(cur_shards, 0) < elastic.same_mesh_retries:
            same_mesh_used[cur_shards] = \
                same_mesh_used.get(cur_shards, 0) + 1
            return "retry"
        if (elastic.allow_shrink and cur_mesh is not None
                and cur_shards > max(elastic.min_shards, 1)):
            return "shrink"
        if elastic.allow_serial and cur_mesh is not None:
            return "serial"
        return None

    def _reform(action: str, shard: int):
        """Tear the group down and meet the live ranks again; returns
        (action, new_mesh, new_shards), with new_shards 0 when this rank
        retires and None when the ladder cannot go on."""
        nonlocal generation
        old = cur_mesh
        if not old.abort():
            raise RuntimeError(
                "supervisor: the process group did not tear down within "
                "its bound after the loss; a new group cannot start in "
                "this process")
        generation += 1
        rdv = elastic_mod.Rendezvous(rdv_prefix, generation, old.size,
                                     deadline_s=old.timeout_s + 5.0)
        named = 0 <= shard < old.size
        out = action != "retry" and named and shard == old.rank
        live = rdv.meet(old.rank, join=not out)
        say(f"supervisor: rendezvous {generation}: live ranks {live} of "
            f"{old.size}")
        if out or old.rank not in live:
            return action, None, 0
        if action == "retry" and len(live) < old.size:
            # a retry needs every rank: take the next rung
            action = ("shrink" if elastic.allow_shrink
                      and old.size > max(elastic.min_shards, 1)
                      else "serial" if elastic.allow_serial else None)
            if action is None:
                return None, None, None
        if action == "retry":
            from shadow_tpu_torch.parallel.shard import Mesh

            new = Mesh(old.size, live.index(old.rank),
                       init_method=rdv.group_init(), device=old.device,
                       axis=old.axis, timeout_s=old.timeout_s)
            return action, new, old.size
        ranks = elastic_mod.survivor_ranks(old.size, shard, live)
        if action == "shrink" and (len(ranks) < 2
                                   or len(ranks) < elastic.min_shards):
            if not elastic.allow_serial:
                say("supervisor: survivors cannot carry a mesh and "
                    "serial fallback is disabled")
                return None, None, None
            action = "serial"
        if action == "serial":
            return action, None, (1 if ranks[:1] == [old.rank] else 0)
        new, n = elastic_mod.survivor_mesh(old, old.axis, shard, live=live,
                                           rendezvous=rdv)
        return action, new, n

    def _elastic_step(cause: str, shard: int, limit_ns=None):
        """One rung of the degradation ladder: decides retry / shrink /
        serial, re-forms the mesh, finds the verified resume point
        (replanning its shard stamp when the width changes) and mutates
        the chain's mesh state. Returns "continue", "retired" or
        "exhausted"."""
        nonlocal cur_mesh, cur_shards, resume_sim, resume_time
        nonlocal resumed_from, base_stats, owned_mesh
        if len(losses) + len(divergences) > elastic.max_losses:
            say(f"supervisor: elastic budget exhausted "
                f"({elastic.max_losses} losses)")
            return "exhausted"
        action = _decide_rung()
        if action is None:
            say(f"supervisor: ladder exhausted at {cur_shards} "
                f"shard(s) ({cause})")
            return "exhausted"
        new_mesh, new_shards = cur_mesh, cur_shards
        if cur_mesh is not None:
            action, new_mesh, new_shards = _reform(action, shard)
            if action is None:
                say(f"supervisor: ladder exhausted at {cur_shards} "
                    f"shard(s) ({cause})")
                return "exhausted"
        step = {"action": action, "cause": cause, "shard": int(shard),
                "from": cur_shards, "to": max(new_shards, 1),
                "resume_time_ns": 0, "attempt": attempt}
        if new_shards == 0:
            say(f"supervisor: elastic {action} ({cause}, shard {shard}): "
                f"this rank retires")
            if owned_mesh is not None and owned_mesh is not new_mesh:
                owned_mesh.close()
            ladder_steps.append(step)
            cur_mesh, cur_shards = None, max(step["to"], 1)
            return "retired"
        if owned_mesh is not None and owned_mesh is not new_mesh:
            owned_mesh.close()
        owned_mesh = new_mesh
        writer = new_mesh is None or new_mesh.rank == 0
        # --- verified resume point ---------------------------------
        found = _verified_snapshot(limit_ns)
        t = 0
        if found is not None:
            path, t, _meta = found
            if new_shards != cur_shards:
                err = None
                if writer:
                    try:
                        # digest-verified restamp: the per-shard sha256
                        # ledger checked at the OLD width, restamped at
                        # the NEW one
                        ckpt.replan_shards(path, new_shards,
                                           template_sim=bundle.sim)
                    except (ValueError, OSError, KeyError) as e:
                        err = str(e)
                if new_mesh is not None:
                    err = new_mesh.all_gather_object(err)[0]
                if err is not None:
                    say(f"supervisor: replan of {path} failed ({err}); "
                        f"rebooting at {new_shards} shard(s)")
                    path = None
            if path is not None:
                resume_sim, resume_time, extra = ckpt.load(path,
                                                           bundle.sim)
                base_stats = dict(extra.get("stats", {}))
                resumed_from = path
            else:
                resume_sim, resume_time, base_stats = None, 0, {}
                t = 0
        else:
            say("supervisor: no verified snapshot, rebooting from t=0")
            resume_sim, resume_time, base_stats = None, 0, {}
        ladder_steps.append(dict(step, resume_time_ns=int(t)))
        say(f"supervisor: elastic {action} ({cause}, shard {shard}): "
            f"{cur_shards} -> {new_shards} shard(s), resuming at "
            f"t={int(t)}")
        if new_shards != cur_shards and on_mesh_change is not None \
                and writer:
            on_mesh_change(cur_shards, new_shards, cause)
        cur_mesh, cur_shards = new_mesh, new_shards
        return "continue"

    def _wrap_dispatch(fn):
        """Compose the caller's dispatch_wrap (chaos poison — it must
        see the dispatch first so its injected error reaches the
        classifier) inside the device-loss guard."""
        if dispatch_wrap is not None:
            fn = dispatch_wrap(fn)
        if elastic is not None:
            fn = elastic_mod.guard_dispatch(
                fn, shards=cur_shards,
                deadline_s=elastic.dispatch_deadline_s)
        return fn

    def _close_owned():
        if owned_mesh is not None:
            owned_mesh.close()

    while True:
        attempt += 1
        # per-attempt telemetry the chunk closure mutates
        tele = {"zero_streak": 0, "worst_streak": 0, "regressed": False,
                "wstart": None, "since_ckpt": 0, "acc": {},
                "dispatch_windows": []}
        # Filled by run_windows' warm wrapper at the first dispatch of
        # this attempt; the FINAL attempt's block lands in the result
        # (an escalation restart builds a new program — that is the one
        # the manifest should report).
        cinfo: dict = {}

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
            # observer has seen it. On a mesh the ranks decide together
            # (one max-reduce of both flags a barrier), so a stop or a
            # deadline seen by one rank snapshots every rank at the
            # same barrier
            halt = stop is not None and bool(stop())
            el = (_time.monotonic() - t_chain0
                  if max_run_wallclock is not None else 0.0)
            late = max_run_wallclock is not None \
                and el >= max_run_wallclock
            if cur_mesh is not None and (stop is not None
                                         or max_run_wallclock is not None):
                halt, late = (bool(v) for v in cur_mesh.all_reduce_ints(
                    [int(halt), int(late)], "max"))
            if halt and next_min < simtime.INVALID:
                raise Preempted(_save(sim, next_min, tele["acc"]),
                                next_min, sim)
            if late and next_min < simtime.INVALID:
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
                lane_incidents=tuple(lane_incidents),
                compile_info=(dict(cinfo) if cinfo else None),
                elastic=_elastic_block(),
                reports=(not kw.get("retired") and (
                    cur_mesh.rank == 0 if cur_mesh is not None
                    else mesh is None or mesh.size == 1
                    or bool(ladder_steps))), **kw)

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
                adaptive_jump=adaptive_jump, feeder=feeder,
                warm_start=warm_start, compile_info=cinfo,
                device=run_device if cur_mesh is None else None,
                mesh=cur_mesh if cur_mesh is not None else plain_mesh,
                mesh_axis=mesh_axis,
                exchange_capacity=exchange_capacity,
                dispatch_wrap=(_wrap_dispatch
                               if (dispatch_wrap is not None
                                   or elastic is not None) else None))
            if harvester is not None:
                harvester.drain(sim)
            h = _gather(sim)
            _lane_surgery(h, tele["wstart"] or 0)
            if h.fatal:
                raise LatchTrip(h, sim)
            _close_owned()
            return _result(True, sim, h, stats=stats)
        except DeadlineExceeded as d:
            say(f"supervisor: wallclock deadline after "
                f"{d.elapsed_s:.1f}s: {d}")
            h = dataclasses.replace(_gather(d.sim), deadline_exceeded=True)
            _close_owned()
            return _result(False, d.sim, h, stats=_chain_stats(d.sim),
                           deadline_exceeded=True, final_checkpoint=d.path)
        except Preempted as p:
            say(f"supervisor: {p}")
            # the preempting round passed its health check before the
            # final save — report that healthy snapshot
            _close_owned()
            return _result(False, p.sim, _gather(p.sim),
                           stats=_chain_stats(p.sim), preempted=True,
                           final_checkpoint=p.path)
        except LatchTrip as trip:
            say(f"supervisor: latch trip on attempt {attempt}: {trip}")
            if elastic is not None and trip.health.shard_divergence:
                # the sentinel's SDC screen: a shard whose replica of
                # the replicated state diverged is a failing device —
                # the SAME ladder, resuming no later than the trip's
                # verified frontier (nothing after it is trusted)
                divergences.append({
                    "fault": "SHARD_DIVERGENCE",
                    "shard": int(trip.health.divergent_shard),
                    "tripped_at_ns": int(trip.health.sentinel_tripped_at),
                    "verified_through_ns":
                        int(trip.health.sentinel_verified_through),
                    "attempt": attempt, "mesh": cur_shards,
                })
                verdict = _elastic_step(
                    "shard_divergence", trip.health.divergent_shard,
                    limit_ns=trip.health.sentinel_verified_through)
                if verdict == "continue":
                    continue
                if verdict == "retired":
                    return _result(True, None, None, stats=None,
                                   retired=True)
                _close_owned()
                return _result(False, trip.sim, trip.health, stats=None)
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
                _close_owned()
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
        except Exception as exc:         # noqa: BLE001 — classify-all
            # a guarded dispatch raises DeviceLossError; with one process
            # a rank, a lost rank may also surface in a collective
            # outside one (a gather for the hooks, a snapshot barrier)
            loss = exc if isinstance(exc, elastic_mod.DeviceLossError) \
                else (elastic_mod.classify(exc, shards=cur_shards)
                      if elastic is not None and cur_mesh is not None
                      else None)
            if loss is None:
                raise
            say(f"supervisor: device loss on attempt {attempt}: {loss}")
            if elastic is None:
                raise
            losses.append(dict(loss.as_dict(), attempt=attempt,
                               mesh=cur_shards))
            # the failed attempt's frames hold the old group's pending
            # work: drop them, so tearing the group down closes its
            # connections and a peer still waiting on this rank fails at
            # once instead of at its timeout
            for e in (exc, loss, loss.__cause__):
                if e is not None:
                    e.__traceback__ = None
            del exc
            verdict = _elastic_step("device_lost", loss.shard)
            if verdict == "continue":
                continue  # a ladder step: no retry, no backoff
            if verdict == "retired":
                return _result(True, None, None, stats=None, retired=True)
            _close_owned()
            h = health_mod.RunHealth(
                device_lost=len(losses),
                lost_shard=loss.shard,
                device_lost_cause=loss.cause)
            return _result(False, None, h, stats=None)
