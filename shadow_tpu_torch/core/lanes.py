"""Lane-scoped health latches and blast-radius containment (PyTorch
port of shadow_tpu/core/lanes.py).

An ensemble-packed program (bench's BENCH_REPLICAS axis) partitions its
H host rows into R contiguous *lanes* of H/R hosts, each lane one
tenant's scenario. The global sticky latches (EventQueue.overflow,
Outbox.overflow, NetState.rq_overflow) stay authoritative, but they
cannot say WHICH tenant tripped; this module makes health lane-scoped:

- per-host attribution planes (`overflow_h` on EventQueue/Outbox,
  `rq_overflow_h` on NetState) ride every latch bump site, invariant
  scalar == sum(plane);
- a LaneHealth struct (Sim.lanes) carries [R]-shaped latch planes and
  a lane quarantine mask;
- window_update() runs at every window barrier (core/engine.py
  step_window, after the route): it reduces the host planes per lane,
  trips sick lanes and FREEZES a quarantined lane's hosts — their
  pending events are flushed (counted in `flushed`, never silently),
  so healthy lanes run to completion.

LaneAdmission (Sim.admission) adds the resident program's lease
planes: a free lane is kept empty, an active lane's events at or past
its lease horizon are flushed, and an active lane that ran dry latches
`completed`.

Opt-in contract: every field defaults to None and adds no leaf;
attach() / attach_admission() are the opt-ins. Lane blocks are
contiguous in host order (lane of host h = h // (H/R)), the replica
blocks apps/phold.py carves out. Single-shard programs only. The
barrier is plain torch (about 40 small ops a window, 10 more with
admission) and reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import _Replace, static
from shadow_tpu_torch.device import resolve_device

I32 = torch.int32
I64 = torch.int64

# Trip-bit vocabulary (LaneHealth.trip_bits; the manifest "lanes" block
# and faults/health.py diagnostics name them).
TRIP_EVENTS = 1    # EventQueue row overflow inside the lane
TRIP_OUTBOX = 2    # Outbox overflow from one of the lane's hosts
TRIP_RQ = 4        # router-ring overflow inside the lane
TRIP_STALL = 8     # lane min-time pinned for >= stall_limit windows
TRIP_REGRESS = 16  # lane pending time behind the window barrier
TRIP_SLO = 32      # admission gate exhausted the degradation ladder
# (set host-side by the fleet's admission layer: quarantine by policy)

TRIP_NAMES = {
    TRIP_EVENTS: "events_overflow",
    TRIP_OUTBOX: "outbox_overflow",
    TRIP_RQ: "rq_overflow",
    TRIP_STALL: "stall",
    TRIP_REGRESS: "time_regression",
    TRIP_SLO: "slo_breach",
}


def trip_names(bits: int) -> list:
    """Human-readable names of the set trip bits."""
    return [n for b, n in sorted(TRIP_NAMES.items()) if int(bits) & b]


@dataclass
class LaneHealth(_Replace):
    """[R]-shaped per-lane latch planes + quarantine mask. The overflow
    planes are cumulative snapshots (re-reduced from the per-host
    planes at each barrier), so they equal the lane share of the
    scalar latches at every window boundary."""

    overflow_events: torch.Tensor  # [R] i32 lane share of events.overflow
    overflow_outbox: torch.Tensor  # [R] i32 lane share of outbox.overflow
    overflow_rq: torch.Tensor      # [R] i32 lane share of net.rq_overflow
    inj_dropped: torch.Tensor      # [R] i64 injected-event drops (warning)
    stall_streak: torch.Tensor     # [R] i32 consecutive no-progress windows
    regress: torch.Tensor          # [R] i32 windows with pending < barrier
    prev_min: torch.Tensor         # [R] i64 lane min pending at last barrier
    quarantined: torch.Tensor      # [R] bool sticky quarantine mask
    quarantined_at: torch.Tensor   # [R] i64 barrier time of the trip
    trip_bits: torch.Tensor        # [R] i32 OR of TRIP_* causes
    flushed: torch.Tensor          # [R] i64 events flushed from frozen rows
    # windows a lane may sit with an unchanged min pending time before
    # the stall latch trips; 0 disables the stall trip
    stall_limit: int = static(0)

    @property
    def replicas(self) -> int:
        return self.quarantined.shape[0]

    @staticmethod
    def create(replicas: int, stall_limit: int = 0,
               device=None) -> "LaneHealth":
        """Fresh planes on `device` (None -> "cuda"; raises without
        CUDA)."""
        dev = resolve_device(device)
        R = int(replicas)

        def z(dt):
            return torch.zeros((R,), dtype=dt, device=dev)

        def inv():
            return torch.full((R,), simtime.INVALID, dtype=I64, device=dev)
        return LaneHealth(
            overflow_events=z(I32), overflow_outbox=z(I32),
            overflow_rq=z(I32), inj_dropped=z(I64), stall_streak=z(I32),
            regress=z(I32), prev_min=inv(), quarantined=z(torch.bool),
            quarantined_at=inv(), trip_bits=z(I32), flushed=z(I64),
            stall_limit=int(stall_limit))


@dataclass
class LaneAdmission(_Replace):
    """[R]-shaped lease planes of a RESIDENT program: the device-visible
    shadow of a host-side lease table, enforced at every barrier — a
    free lane (active False) is kept empty, an active lane's events at
    or after its `lease_end` are flushed, and an active lane that ran
    dry latches `completed` with the barrier time."""

    active: torch.Tensor        # [R] bool lane holds a live lease
    epoch: torch.Tensor         # [R] i32 admissions into this lane so far
    lease_end: torch.Tensor     # [R] i64 lease horizon (INVALID = open)
    admitted_at: torch.Tensor   # [R] i64 barrier time of the live join
    completed: torch.Tensor     # [R] bool active lane ran dry (latched)
    completed_at: torch.Tensor  # [R] i64 barrier time the lane ran dry
    flushed: torch.Tensor       # [R] i64 events flushed by admission rules

    @property
    def replicas(self) -> int:
        return self.active.shape[0]

    @staticmethod
    def create(replicas: int, device=None) -> "LaneAdmission":
        """Every lane FREE, on `device` (None -> "cuda")."""
        dev = resolve_device(device)
        R = int(replicas)

        def inv():
            return torch.full((R,), simtime.INVALID, dtype=I64, device=dev)
        return LaneAdmission(
            active=torch.zeros((R,), dtype=torch.bool, device=dev),
            epoch=torch.zeros((R,), dtype=I32, device=dev),
            lease_end=inv(), admitted_at=inv(),
            completed=torch.zeros((R,), dtype=torch.bool, device=dev),
            completed_at=inv(),
            flushed=torch.zeros((R,), dtype=I64, device=dev))


def attach_admission(sim):
    """Opt a lane-isolated sim into resident admission: every lane
    starts FREE. Requires attach() first."""
    if getattr(sim, "lanes", None) is None:
        raise ValueError(
            "attach_admission requires lane isolation (core.lanes."
            "attach) — admission is lease bookkeeping over lanes")
    return sim.replace(admission=LaneAdmission.create(
        sim.lanes.replicas, device=sim.events.time.device))


def admit_all(sim, at_ns: int = 0):
    """Standalone resident mode (`--resident`): every lane holds an
    OPEN lease from t=at_ns, so the barrier rules, completion latches
    and the manifest "admission" block behave as a resident program
    with a static population."""
    adm = sim.admission
    if adm is None:
        raise ValueError("admit_all requires attach_admission() first")
    return sim.replace(admission=adm.replace(
        active=torch.ones_like(adm.active),
        epoch=torch.ones_like(adm.epoch),
        admitted_at=torch.full_like(adm.admitted_at, int(at_ns))))


def lane_sum(x: torch.Tensor, replicas: int) -> torch.Tensor:
    """Reduce an [H]-leading plane to [R] lane totals (contiguous lane
    blocks). Bool inputs are counted."""
    R = int(replicas)
    if x.dtype == torch.bool:
        x = x.to(I32)
    return x.reshape(R, -1, *x.shape[1:]).sum(dim=1, dtype=x.dtype)


def lane_min(x: torch.Tensor, replicas: int) -> torch.Tensor:
    """[H] -> [R] per-lane minimum (contiguous lane blocks)."""
    return x.reshape(int(replicas), -1).amin(dim=1)


def host_mask(lane_mask: torch.Tensor, num_hosts: int) -> torch.Tensor:
    """[R] bool lane mask -> [H] bool host mask."""
    R = lane_mask.shape[0]
    return lane_mask.repeat_interleave(num_hosts // R)


def lane_of_host(h, num_hosts: int, replicas: int):
    """Lane index of host row h (int or tensor)."""
    return h // (num_hosts // int(replicas))


def attach(sim, replicas: int, stall_limit: int = 0):
    """Opt into lane-isolated health: the per-host attribution planes
    and the LaneHealth struct, on the sim's device. H must divide
    evenly into R contiguous lane blocks."""
    R = int(replicas)
    H = sim.events.num_hosts
    if R < 1 or H % R != 0:
        raise ValueError(
            f"lane isolation needs num_hosts % replicas == 0, got "
            f"H={H} R={R}")
    dev = sim.events.time.device

    def zh():
        return torch.zeros((H,), dtype=I32, device=dev)
    return sim.replace(
        events=sim.events.replace(overflow_h=zh()),
        outbox=sim.outbox.replace(overflow_h=zh()),
        net=sim.net.replace(rq_overflow_h=zh()),
        lanes=LaneHealth.create(R, stall_limit, device=dev),
    )


def _flush(time: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    return torch.where(over, simtime.INVALID, time)


def window_update(sim, wend: int):
    """The per-window lane barrier (after the route): reduce the
    per-host latch planes to [R], trip sick lanes, and freeze
    quarantined lanes by flushing their pending events (counted per
    lane in `flushed`); then, with admission planes, flush free lanes
    and events past each lease horizon and latch completions. Inserts
    are per-row independent, so a sick lane's overflow never perturbs
    another lane's rows."""
    lanes = sim.lanes
    R = lanes.replicas
    H = sim.events.num_hosts
    wend = int(wend)

    ev = lane_sum(sim.events.overflow_h, R)
    ob = lane_sum(sim.outbox.overflow_h, R)
    rq = lane_sum(sim.net.rq_overflow_h, R)

    lmin = lane_min(sim.events.min_time(), R)          # [R] i64
    active = lmin != simtime.INVALID
    # stall: the lane's earliest pending time survived a whole window
    # unchanged (the first barrier never matches: prev_min is INVALID)
    stalled = active & (lmin == lanes.prev_min)
    streak = torch.where(stalled, lanes.stall_streak + 1, 0)
    # time regression: pending work behind the barrier after the
    # fixpoint drained everything < wend
    regressed = active & (lmin < wend)
    regress = lanes.regress + regressed.to(I32)

    trip = ((ev > 0).to(I32) * TRIP_EVENTS
            | (ob > 0).to(I32) * TRIP_OUTBOX
            | (rq > 0).to(I32) * TRIP_RQ
            | regressed.to(I32) * TRIP_REGRESS)
    if lanes.stall_limit > 0:
        trip = trip | (streak >= lanes.stall_limit).to(I32) * TRIP_STALL

    tripped = trip != 0
    newly = tripped & ~lanes.quarantined
    quarantined = lanes.quarantined | tripped
    quarantined_at = torch.where(newly, wend, lanes.quarantined_at)
    trip_bits = lanes.trip_bits | trip

    # freeze: flush every quarantined lane's pending events (cross-lane
    # traffic routed into a frozen lane this window included), counted
    mask_h = host_mask(quarantined, H)                 # [H] bool
    to_flush = sim.events.valid() & mask_h[:, None]    # [H, K]
    flushed = lanes.flushed + lane_sum(to_flush.sum(dim=1, dtype=I64), R)
    q = sim.events.replace(time=_flush(sim.events.time, to_flush))

    lanes = lanes.replace(
        overflow_events=ev, overflow_outbox=ob, overflow_rq=rq,
        stall_streak=streak, regress=regress,
        prev_min=torch.where(quarantined, simtime.INVALID, lmin),
        quarantined=quarantined, quarantined_at=quarantined_at,
        trip_bits=trip_bits, flushed=flushed)
    sim = sim.replace(events=q, lanes=lanes)

    adm = getattr(sim, "admission", None)
    if adm is not None:
        # keep FREE lanes empty and enforce each active lane's lease
        # horizon at this barrier: the route already ran, so a delivery
        # at or past the horizon is flushed the window it arrives
        free_h = host_mask(~adm.active, H)                  # [H] bool
        lease_h = adm.lease_end.repeat_interleave(H // R)   # [H] i64
        over = q.valid() & (free_h[:, None] | (q.time >= lease_h[:, None]))
        adm_flushed = adm.flushed + lane_sum(over.sum(dim=1, dtype=I64), R)
        q = q.replace(time=_flush(q.time, over))
        # completion latch: an active, un-quarantined lane with nothing
        # pending ran its lease dry — record the barrier time once
        quiet = lane_min(q.min_time(), R) == simtime.INVALID
        newly_done = adm.active & quiet & ~adm.completed & ~quarantined
        adm = adm.replace(
            flushed=adm_flushed,
            completed=adm.completed | newly_done,
            completed_at=torch.where(newly_done, wend, adm.completed_at))
        sim = sim.replace(events=q, admission=adm)
    return sim


def lane_events_exec(sim) -> torch.Tensor:
    """[R] i64 cumulative executed-event count per lane (lane share of
    net.ctr_events_exec): the telemetry ring's per-lane plane basis."""
    return lane_sum(sim.net.ctr_events_exec, sim.lanes.replicas)


def _host(planes: dict) -> dict:
    """{name: numpy array} of [R] tensors (one host read each)."""
    return {k: v.cpu().numpy() for k, v in planes.items()}


def lane_report(sim) -> list:
    """Host-side: one dict per lane for the manifest "lanes" block.
    Call between device steps."""
    lanes = sim.lanes
    p = _host({
        "ev": lanes.overflow_events, "ob": lanes.overflow_outbox,
        "rq": lanes.overflow_rq, "inj": lanes.inj_dropped,
        "stall": lanes.stall_streak, "reg": lanes.regress,
        "quar": lanes.quarantined, "qat": lanes.quarantined_at,
        "bits": lanes.trip_bits, "flushed": lanes.flushed,
        "exec": lane_events_exec(sim)})
    out = []
    for r in range(lanes.replicas):
        d = {
            "lane": r,
            "events_overflow": int(p["ev"][r]),
            "outbox_overflow": int(p["ob"][r]),
            "rq_overflow": int(p["rq"][r]),
            "inj_dropped": int(p["inj"][r]),
            "stall_streak": int(p["stall"][r]),
            "time_regression": int(p["reg"][r]),
            "events_exec": int(p["exec"][r]),
            "quarantined": bool(p["quar"][r]),
            "flushed": int(p["flushed"][r]),
        }
        if bool(p["quar"][r]):
            d["quarantined_at_ns"] = int(p["qat"][r])
            d["trip_bits"] = int(p["bits"][r])
            d["trip"] = trip_names(int(p["bits"][r]))
        out.append(d)
    return out


def admission_report(sim) -> list:
    """Host-side: one dict per lane of the LaneAdmission planes (the
    device half of the manifest "admission" block)."""
    adm = sim.admission
    p = _host({"active": adm.active, "epoch": adm.epoch,
               "lease": adm.lease_end, "at": adm.admitted_at,
               "done": adm.completed, "done_at": adm.completed_at,
               "flushed": adm.flushed})
    out = []
    for r in range(adm.replicas):
        d = {
            "lane": r,
            "active": bool(p["active"][r]),
            "epoch": int(p["epoch"][r]),
            "completed": bool(p["done"][r]),
            "flushed": int(p["flushed"][r]),
        }
        if bool(p["active"][r]):
            d["lease_end_ns"] = int(p["lease"][r])
            d["admitted_at_ns"] = int(p["at"][r])
        if bool(p["done"][r]):
            d["completed_at_ns"] = int(p["done_at"][r])
        out.append(d)
    return out


# manifest per-lane key -> Prometheus family name, one row per latch
# the lane report carries
LANE_METRIC_KEYS = (
    ("quarantined", "lane_quarantined"),
    ("flushed", "lane_flushed"),
    ("events_exec", "lane_events_exec"),
    ("events_overflow", "lane_events_overflow"),
    ("outbox_overflow", "lane_outbox_overflow"),
    ("rq_overflow", "lane_rq_overflow"),
    ("inj_dropped", "lane_inj_dropped"),
    ("stall_streak", "lane_stall_streak"),
    ("time_regression", "lane_time_regression"),
)


def lane_metric_families(per_lane) -> dict:
    """Per-lane gauge families from the manifest's lanes.per_lane list,
    in the nested-dict shape export.prometheus_text renders as
    family{key="<lane>"} value."""
    out: dict = {}
    for src_key, family in LANE_METRIC_KEYS:
        fam = {}
        for d in per_lane or []:
            if src_key in d:
                fam[str(d["lane"])] = int(d[src_key])
        if fam:
            out[family] = fam
    return out

