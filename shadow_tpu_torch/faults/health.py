"""Run-health latches (PyTorch port of shadow_tpu/faults/health.py):
fold the engine's sticky failure counters into one struct with a
verdict instead of leaving them as silent integers in the final report.

Three latches live in device state (sticky: counters only grow):
EventQueue.overflow (a host row was full when push_rows needed a slot),
Outbox.overflow (the cross-host staging buffer) and NetState.rq_overflow
(the upstream router ring wrapped). Two more are computed host-side by
the supervisor from window telemetry it already has: stall (K
consecutive windows with zero events) and time_regression (a window's
next start preceded the current window's *start*).

Those five are fatal: state is corrupt or the clock is broken; the
diagnostics name the knob to grow. Outbox.narrow_miss is a warning
(perf only). RunHealth is the reference's, field for field, so a
failure report reads the same from either package. gather() reads the
lane and admission planes (core/lanes.py): a capacity trip attributed to
quarantined lanes only is CONTAINED — a warning, not fatal, while a
healthy lane remains. The guard and sentinel parts stay zero or empty
here, and gather() refuses a Sim that carries one of those layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

@dataclasses.dataclass
class RunHealth:
    """Host-side snapshot of the latches after (part of) a run."""

    events_overflow: int = 0
    outbox_overflow: int = 0
    rq_overflow: int = 0
    narrow_miss: int = 0
    stalled_windows: int = 0      # longest zero-event streak observed
    stall_limit: int = 0          # K that makes the streak fatal (0 = off)
    time_regression: bool = False
    # window telemetry records overwritten before the host drained them
    # (telemetry/harvest.py) — observability loss only, results exact
    telemetry_lost: int = 0
    # the supervisor's per-run wallclock deadline passed
    # (faults/supervisor.py max_run_wallclock): the run was stopped
    # with a preemption-style final snapshot instead of hanging — the
    # state is healthy, the budget is not
    deadline_exceeded: bool = False
    # open-system injection (inject/staging.py): injected events
    # dropped because the destination row was full. A WARNING, not
    # fatal — external load that was refused is accounted (the
    # injected+dropped+deferred reconciliation still closes), but the
    # results are missing those trace events.
    inject_dropped: int = 0
    # injected events whose window had already run when they merged —
    # the feeder's horizon contract makes this impossible, so any
    # nonzero count means timestamps were perturbed (clamped up)
    inject_late: int = 0
    # torn-tail truncation messages from the binary trace reader
    # (inject/trace.py): the tail frame a dying writer never finished
    # was dropped — a WARNING; everything before it was read intact
    trace_warnings: tuple = ()
    # context for diagnostics
    window_start: Optional[int] = None   # wstart when gathered
    suspect_hosts: tuple = ()            # rows at capacity (global ids)
    # --- lane-isolated runs (core/lanes.py) --------------------------
    # lanes_total > 0 means the sim carried LaneHealth: `lanes` is the
    # per-lane report (core.lanes.lane_report dicts), lanes_quarantined
    # the tripped lane indices, and lane_contained says every capacity
    # / regression trip is attributed to a quarantined lane — the
    # blast radius held, so those trips DEGRADE the run (sick lanes
    # are frozen + requeued) instead of aborting the healthy tenants.
    lanes_total: int = 0
    lanes: tuple = ()
    lanes_quarantined: tuple = ()
    lane_contained: bool = False
    # --- resident programs (core/lanes.py LaneAdmission) -------------
    # resident=True means the sim carried lease planes: `admission` is
    # the per-lane device report (core.lanes.admission_report dicts).
    # A FREE lane is EXPECTED to be empty/idle — supervision must not
    # read an inactive lane's silence as a stall or incident.
    resident: bool = False
    admission: tuple = ()
    # --- specialized programs (compile/specialize.py GuardState) -----
    # guard_watched non-empty means the sim ran as a capability-
    # trimmed variant: the named capabilities were PROVEN dead at
    # build time and omitted from the trace. A nonzero trip counter
    # means a dead capability would have fired anyway (e.g. a
    # restored snapshot carried a lossy reliability table into a
    # loss-trimmed program) — the results are INVALID, always fatal:
    # specialization must never silently change results.
    guard_watched: tuple = ()
    guard_loss_trips: int = 0
    guard_timer_trips: int = 0
    # --- cross-shard integrity sentinel (parallel/elastic.py) --------
    # sentinel_checks > 0 means the sim carried a SentinelState: every
    # window barrier compared a digest of the replicated leaves
    # pmax-vs-pmin across shards. A nonzero trip count is SILENT
    # DIVERGENCE (an SDC, a bad collective, a flipped replicated bit)
    # — always FATAL: results after tripped_at cannot be trusted;
    # resume from a checkpoint whose time <= sentinel_verified_through.
    sentinel_checks: int = 0
    shard_divergence_trips: int = 0
    divergent_shard: int = -1            # offender of the FIRST trip
    sentinel_tripped_at: int = 0
    sentinel_verified_through: int = 0
    # --- device loss (parallel/elastic.py DeviceLossError) -----------
    # A machine fault, not a sim fault: set host-side by the
    # supervisor when a dispatch classified as DEVICE_LOST — the
    # degradation ladder (retry -> shrink -> serial) owns recovery;
    # fatal only if the ladder is exhausted (the supervisor then
    # re-raises, so a RunHealth that still carries it IS the verdict).
    device_lost: int = 0
    lost_shard: int = -1
    device_lost_cause: Optional[str] = None

    @property
    def guard_tripped(self) -> bool:
        return bool(self.guard_loss_trips or self.guard_timer_trips)

    @property
    def shard_divergence(self) -> bool:
        return bool(self.shard_divergence_trips)

    @property
    def fatal(self) -> bool:
        cap_trip = bool(
            self.events_overflow or self.outbox_overflow
            or self.rq_overflow or self.time_regression)
        if cap_trip and self.lanes_total and self.lane_contained:
            # contained trips are survivable — unless no healthy lane
            # remains, in which case the program serves nobody
            cap_trip = len(self.lanes_quarantined) >= self.lanes_total
        return bool(
            cap_trip or self.deadline_exceeded or self.guard_tripped
            or self.shard_divergence or self.device_lost
            or (self.stall_limit and self.stalled_windows >= self.stall_limit))

    def diagnostics(self) -> list:
        """Human-readable findings: (severity, message) pairs, fatal
        first. Empty when the run is clean."""
        out = []
        where = (f" at window t={self.window_start}"
                 if self.window_start is not None else "")
        hosts = (f" (suspect host rows at capacity: "
                 f"{list(self.suspect_hosts)})" if self.suspect_hosts else "")
        # lane-contained capacity trips degrade instead of abort: the
        # sick lanes are frozen + requeued, healthy lanes' results are
        # exact — report as warnings, with per-lane attribution below
        contained = bool(
            self.lanes_total and self.lane_contained
            and len(self.lanes_quarantined) < self.lanes_total)
        cap_sev = "warning" if contained else "fatal"
        cap_sfx = (" [contained: attributed to quarantined lane(s) "
                   f"{list(self.lanes_quarantined)}; healthy lanes "
                   "unaffected]" if contained else "")
        if self.events_overflow:
            out.append((cap_sev,
                        f"event queue overflow x{self.events_overflow}"
                        f"{where}{hosts}: events were dropped — results "
                        f"are invalid; rerun with a larger "
                        f"--event-capacity{cap_sfx}"))
        if self.outbox_overflow:
            out.append((cap_sev,
                        f"outbox overflow x{self.outbox_overflow}{where}: "
                        f"cross-host sends were dropped; rerun with a "
                        f"larger emit/exchange capacity{cap_sfx}"))
        if self.rq_overflow:
            out.append((cap_sev,
                        f"router ring overflow x{self.rq_overflow}{where}: "
                        f"upstream packets were dropped un-modelled; grow "
                        f"the router ring (config router_ring){cap_sfx}"))
        for d in self.lanes:
            if d.get("quarantined"):
                out.append((
                    "fatal" if not contained else "warning",
                    f"lane {d['lane']} quarantined at "
                    f"t={d.get('quarantined_at_ns')} "
                    f"(trip={d.get('trip', [])}): {d.get('flushed', 0)} "
                    f"pending event(s) flushed — the lane's results are "
                    f"discarded; salvage + fleet requeue apply"))
        if (self.lanes_total
                and len(self.lanes_quarantined) >= self.lanes_total):
            out.append(("fatal",
                        f"all {self.lanes_total} lanes quarantined"
                        f"{where}: no healthy tenant remains"))
        if self.time_regression:
            out.append(("fatal",
                        f"simulated time regressed{where}: a window "
                        f"started before its predecessor — engine "
                        f"invariant broken, results invalid"))
        if self.stall_limit and self.stalled_windows >= self.stall_limit:
            out.append(("fatal",
                        f"engine stalled: {self.stalled_windows} "
                        f"consecutive windows processed zero events"
                        f"{where}"))
        if self.deadline_exceeded:
            out.append(("fatal",
                        f"run wallclock deadline exceeded{where}: a "
                        f"final snapshot was taken — state is healthy "
                        f"but the time budget is spent; --resume "
                        f"continues it, or raise --max-run-wallclock"))
        if self.guard_loss_trips:
            out.append(("fatal",
                        f"specialization guard tripped x"
                        f"{self.guard_loss_trips}{where}: the loss "
                        f"capability was trimmed from this program but "
                        f"the reliability table went below 1.0 at "
                        f"runtime — drops were NOT modelled, results "
                        f"are invalid; rerun with --specialize off"))
        if self.guard_timer_trips:
            out.append(("fatal",
                        f"specialization guard tripped x"
                        f"{self.guard_timer_trips}{where}: the timer "
                        f"capability was trimmed from this program but "
                        f"a TIMER event entered the queue — it would "
                        f"never be handled, results are invalid; rerun "
                        f"with --specialize off"))
        if self.shard_divergence:
            out.append(("fatal",
                        f"SHARD_DIVERGENCE: replicated-state digest "
                        f"disagreed across shards x"
                        f"{self.shard_divergence_trips}, first at "
                        f"t={self.sentinel_tripped_at} (suspect shard "
                        f"{self.divergent_shard}) — silent data "
                        f"corruption; results after the trip are "
                        f"invalid, resume from a checkpoint at or "
                        f"before t={self.sentinel_verified_through}"))
        if self.device_lost:
            out.append(("fatal",
                        f"DEVICE_LOST x{self.device_lost}"
                        f"{where}: a mesh device failed underneath the "
                        f"run (shard {self.lost_shard}, cause "
                        f"{self.device_lost_cause}) — the degradation "
                        f"ladder (same-mesh retry -> shrink to "
                        f"survivors -> serial) resumes from the last "
                        f"verified checkpoint"))
        if self.narrow_miss:
            out.append(("warning",
                        f"narrow exchange tier missed {self.narrow_miss} "
                        f"window(s) (full-width fallback): perf only, "
                        f"results remain exact — raise the narrow width "
                        f"if this persists"))
        if self.telemetry_lost:
            out.append(("warning",
                        f"telemetry ring overran: {self.telemetry_lost} "
                        f"window record(s) lost before the host drained "
                        f"them — results remain exact, the trace has "
                        f"gaps; raise --telemetry-capacity or drain "
                        f"more often"))
        if self.inject_dropped:
            out.append(("warning",
                        f"injection drops x{self.inject_dropped}{where}: "
                        f"injected events were refused by full host "
                        f"rows — accounted, but the results are missing "
                        f"those trace events; raise --event-capacity or "
                        f"thin the trace"))
        if self.inject_late:
            out.append(("warning",
                        f"late injections x{self.inject_late}: events "
                        f"merged after their window had run and were "
                        f"clamped forward — the feeder's horizon "
                        f"contract was violated (file a bug); "
                        f"timestamps are perturbed, not lost"))
        for w in self.trace_warnings:
            out.append(("warning", w))
        return out

    def failure_report(self) -> dict:
        """Structured failure payload for the CLI's final JSON."""
        return {
            "fatal": self.fatal,
            "events_overflow": self.events_overflow,
            "outbox_overflow": self.outbox_overflow,
            "rq_overflow": self.rq_overflow,
            "narrow_miss": self.narrow_miss,
            "stalled_windows": self.stalled_windows,
            "stall_limit": self.stall_limit,
            "time_regression": self.time_regression,
            "telemetry_lost": self.telemetry_lost,
            "deadline_exceeded": self.deadline_exceeded,
            "inject_dropped": self.inject_dropped,
            "inject_late": self.inject_late,
            "trace_warnings": list(self.trace_warnings),
            "window_start": self.window_start,
            "suspect_hosts": [int(h) for h in self.suspect_hosts],
            "diagnostics": [m for _, m in self.diagnostics()],
            **({"lanes": {
                "replicas": self.lanes_total,
                "quarantined": [int(r) for r in self.lanes_quarantined],
                "contained": bool(self.lane_contained),
                "per_lane": [dict(d) for d in self.lanes],
            }} if self.lanes_total else {}),
            **({"admission": {
                "per_lane": [dict(d) for d in self.admission],
            }} if self.resident else {}),
            **({"guard": {
                "watched": list(self.guard_watched),
                "loss_trips": self.guard_loss_trips,
                "timer_trips": self.guard_timer_trips,
                "tripped": self.guard_tripped,
            }} if self.guard_watched else {}),
            **({"sentinel": {
                "checks": self.sentinel_checks,
                "trips": self.shard_divergence_trips,
                "shard": self.divergent_shard,
                "tripped_at_ns": self.sentinel_tripped_at,
                "verified_through_ns": self.sentinel_verified_through,
            }} if self.sentinel_checks or self.shard_divergence_trips
               else {}),
            **({"device_lost": {
                "count": self.device_lost,
                "shard": self.lost_shard,
                "cause": self.device_lost_cause,
            }} if self.device_lost else {}),
        }


# Sim layers whose health reports the port does not read yet, and the
# ROADMAP.md Queue 1 item that ports each.
_UNPORTED_LAYERS = {"sentinel": 9}


def gather(sim, *, window_start=None, stalled_windows=0, stall_limit=0,
           time_regression=False, telemetry_lost=0,
           trace_warnings=(), max_suspects=8) -> RunHealth:
    """Pull the device latches into a RunHealth: one host read of the
    four scalars (six with an injection staging buffer: its dropped and
    late counters; two more with a specialization guard: its loss and
    timer trips), plus the queue's fill counts only when it
    overflowed, and the lane and admission reports when the Sim
    carries them. Raises NotImplementedError for a Sim carrying a
    sentinel."""
    for name, item in _UNPORTED_LAYERS.items():
        if getattr(sim, name, None) is not None:
            raise NotImplementedError(
                f"shadow_tpu_torch: health.gather on a Sim carrying "
                f"{name!r} (ROADMAP.md Queue 1 item {item})")
    inj = getattr(sim, "inject", None)
    guard = getattr(sim, "guard", None)
    latches = [sim.events.overflow, sim.outbox.overflow,
               sim.net.rq_overflow, sim.outbox.narrow_miss]
    if inj is not None:
        latches += [inj.dropped, inj.late]
    if guard is not None:
        latches += [guard.loss_trips, guard.timer_trips]
    vals = torch.stack([v.to(torch.int64) for v in latches]).tolist()
    ev, ob, rq, nm = vals[:4]
    inj_dropped, inj_late = vals[4:6] if inj is not None else (0, 0)
    g_watched, g_loss, g_timer = (), 0, 0
    if guard is not None:
        g_watched = guard.watched()
        g_loss, g_timer = vals[-2:]
    suspects = ()
    if ev:
        fill = sim.events.fill_count()
        full = torch.nonzero(fill >= sim.events.capacity).flatten()
        lane = sim.net.lane_id[full[:max_suspects]].tolist()
        suspects = tuple(int(h) for h in lane)
    lanes_total, lane_rep, quar, contained = 0, (), (), False
    if getattr(sim, "lanes", None) is not None:
        from shadow_tpu_torch.core.lanes import lane_report

        lane_rep = tuple(lane_report(sim))
        lanes_total = len(lane_rep)
        quar = tuple(d["lane"] for d in lane_rep if d["quarantined"])
        # contained: no un-quarantined lane carries a latched trip
        contained = not any(
            d["events_overflow"] or d["outbox_overflow"]
            or d["rq_overflow"] or d["time_regression"]
            for d in lane_rep if not d["quarantined"])
    resident, adm_rep = False, ()
    if getattr(sim, "admission", None) is not None:
        from shadow_tpu_torch.core.lanes import admission_report

        resident = True
        adm_rep = tuple(admission_report(sim))
    return RunHealth(
        guard_watched=g_watched,
        guard_loss_trips=int(g_loss),
        guard_timer_trips=int(g_timer),
        lanes_total=lanes_total,
        lanes=lane_rep,
        lanes_quarantined=quar,
        lane_contained=contained,
        resident=resident,
        admission=adm_rep,
        events_overflow=int(ev),
        outbox_overflow=int(ob),
        rq_overflow=int(rq),
        narrow_miss=int(nm),
        stalled_windows=int(stalled_windows),
        stall_limit=int(stall_limit),
        time_regression=bool(time_regression),
        telemetry_lost=int(telemetry_lost),
        inject_dropped=int(inj_dropped),
        inject_late=int(inj_late),
        trace_warnings=tuple(trace_warnings),
        window_start=None if window_start is None else int(window_start),
        suspect_hosts=suspects,
    )
