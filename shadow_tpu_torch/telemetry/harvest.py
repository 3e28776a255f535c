"""Host-side telemetry: the window ring's drain and wall-clock phase
timers (PyTorch port of shadow_tpu/telemetry/harvest.py).

The Harvester pulls the device ring (telemetry/ring.py) into plain
Python records between calls — after a whole run, or per window from a
host loop. It detects overruns from the monotonic write counter: count
advancing more than `capacity` since the last drain means records were
overwritten before the host saw them; the total is kept in
`records_lost`, never dropped silently. The same pass drains the flow
ring (telemetry/flows.py) and the causality planes (telemetry/
causality.py: per-host lineage sub-rings, each its own monotonic ring,
and the advance plane), with the same overrun and rewind accounting;
lineage keys come back as the reference's unsigned ints.

PhaseTimers records named wall-clock spans (trace/compile, device
execute, harvest, export) on the host timeline; export.chrome_trace
draws them as wall-time tracks beside the ring's sim-time track.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from shadow_tpu_torch.telemetry.causality import (
    ADVANCE_PLANES,
    LINEAGE_PLANES,
    U64_PLANES,
    AdvanceRecord,
    CausalityRecord,
)
from shadow_tpu_torch.telemetry.flows import FLOW_PLANES, FlowRecord
from shadow_tpu_torch.telemetry.ring import PLANES


@dataclass
class WindowRecord:
    """One harvested per-window record (host-side ints)."""

    index: int        # monotonic window number (ring count at write)
    wstart: int
    wend: int
    events: int
    micro_steps: int
    routed_local: int
    routed_cross: int
    drops: int
    retx: int
    qocc_min: int
    qocc_max: int
    qocc_sum: int
    active_lanes: int  # host rows live at window start
    fastpath: int      # 1 = drained on the compact [S]-lane branch
    injected: int
    inj_dropped: int
    inj_deferred: int
    # lane-isolated runs: events executed per lane this window (the
    # ring's lane_events row); empty without the lane fan-out
    lane_events: tuple = ()


def _drain_ring(count: int, seen: int, capacity: int):
    """(indices to take, records lost) of a monotonic-count ring drained
    at `seen` now holding `count` records."""
    new = count - seen
    take = min(new, capacity)
    return np.arange(count - take, count), max(0, new - capacity)


@dataclass
class Harvester:
    """Incremental ring drain with overrun accounting."""

    seen: int = 0                 # ring count at the last drain
    records: list = field(default_factory=list)
    records_lost: int = 0
    # capacity escalations the supervisor healed (Escalation.as_dict()
    # records, faults/escalate.py), in the order they happened
    escalation_marks: list = field(default_factory=list)
    # the flow ring (flow_enabled latches on the first drain of a sim
    # carrying one)
    flow_enabled: bool = False
    flow_seen: int = 0            # flow ring count at the last drain
    flow_records: list = field(default_factory=list)
    flow_lost: int = 0            # ring overrun (host drained too late)
    flow_lost_clamp: int = 0      # device window-clamp loss (cumulative)
    flow_sampled: int = 0         # device cumulative sampled count
    # the causality planes: per-host lineage counts + the advance plane
    caus_enabled: bool = False
    caus_seen: list = field(default_factory=list)   # [H] per-host counts
    caus_records: list = field(default_factory=list)
    caus_lost: int = 0            # per-host ring overrun total
    caus_sampled: int = 0         # device cumulative kept (sum of counts)
    caus_emitted: int = 0         # device cumulative ALL emissions seen
    adv_seen: int = 0             # advance-plane count at the last drain
    adv_records: list = field(default_factory=list)
    adv_lost: int = 0

    def mark_escalation(self, esc) -> None:
        self.escalation_marks.append(
            esc if isinstance(esc, dict) else esc.as_dict())

    def drain(self, sim) -> int:
        """Pull records written since the last drain; returns how many
        were taken. A count REWIND (a resume from an older state)
        discards already-harvested records past the restored count."""
        self._drain_flows(sim)
        self._drain_causality(sim)
        ring = getattr(sim, "telem", None)
        if ring is None:
            return 0
        c = int(ring.count)
        if c < self.seen:
            self.records = [r for r in self.records if r.index < c]
            self.seen = c
        if c <= self.seen:
            return 0
        idx, lost = _drain_ring(c, self.seen, ring.capacity)
        self.records_lost += lost
        slots = idx % ring.capacity
        cols = [getattr(ring, name).cpu().numpy()[slots].tolist()
                for name, _ in PLANES]
        if ring.lane_events is not None:
            cols.append([tuple(row) for row in
                         ring.lane_events.cpu().numpy()[slots].tolist()])
        self.records.extend(
            WindowRecord(*row) for row in zip(idx.tolist(), *cols))
        self.seen = c
        return len(idx)

    def _drain_flows(self, sim) -> int:
        """The flow ring's drain: the window drain's overrun and rewind
        accounting; the device's cumulative sampled/lost scalars are
        snapshotted as they are."""
        ring = getattr(sim, "flows", None)
        if ring is None:
            return 0
        self.flow_enabled = True
        c, sampled, lost = torch.stack(
            [ring.count, ring.sampled, ring.lost]).tolist()
        self.flow_sampled, self.flow_lost_clamp = int(sampled), int(lost)
        if c < self.flow_seen:
            self.flow_records = [r for r in self.flow_records
                                 if r.index < c]
            self.flow_seen = c
        if c <= self.flow_seen:
            return 0
        idx, lost = _drain_ring(c, self.flow_seen, ring.capacity)
        self.flow_lost += lost
        slots = idx % ring.capacity
        cols = [getattr(ring, name).cpu().numpy()[slots].tolist()
                for name, _ in FLOW_PLANES]
        self.flow_records.extend(
            FlowRecord(*row) for row in zip(idx.tolist(), *cols))
        self.flow_seen = c
        return len(idx)

    def _drain_causality(self, sim) -> int:
        """The causality drain: each host row's lineage sub-ring is its
        own monotonic ring (overrun and rewind accounting per host),
        plus the advance plane. Returns the records taken."""
        ring = getattr(sim, "causality", None)
        if ring is None:
            return 0
        self.caus_enabled = True
        counts = ring.count.cpu().numpy()
        H = counts.shape[0]
        F = ring.capacity
        if len(self.caus_seen) != H:
            self.caus_seen = [0] * H
        self.caus_sampled = int(counts.sum())
        self.caus_emitted = int(ring.seen.sum())
        taken = 0
        planes = None
        for h in range(H):
            c = int(counts[h])
            if c < self.caus_seen[h]:
                self.caus_records = [
                    r for r in self.caus_records
                    if not (r.host == h and r.index >= c)]
                self.caus_seen[h] = c
            if c <= self.caus_seen[h]:
                continue
            if planes is None:
                # one read per plane, shared by every host row; the
                # keys as the reference's unsigned ints
                planes = [
                    (getattr(ring, n).cpu().numpy().view(np.uint64)
                     if n in U64_PLANES else getattr(ring, n).cpu().numpy())
                    for n, _ in LINEAGE_PLANES]
            idx, lost = _drain_ring(c, self.caus_seen[h], F)
            self.caus_lost += lost
            slots = idx % F
            cols = [p[h][slots].tolist() for p in planes]
            self.caus_records.extend(
                CausalityRecord(h, *row)
                for row in zip(idx.tolist(), *cols))
            self.caus_seen[h] = c
            taken += len(idx)
        return taken + self._drain_advance(ring)

    def _drain_advance(self, ring) -> int:
        c = int(ring.adv_count)
        if c < self.adv_seen:
            self.adv_records = [r for r in self.adv_records
                                if r.index < c]
            self.adv_seen = c
        if c <= self.adv_seen:
            return 0
        idx, lost = _drain_ring(c, self.adv_seen, ring.adv_capacity)
        self.adv_lost += lost
        slots = idx % ring.adv_capacity
        cols = [getattr(ring, name).cpu().numpy()[slots].tolist()
                for name, _ in ADVANCE_PLANES]
        self.adv_records.extend(
            AdvanceRecord(*row) for row in zip(idx.tolist(), *cols))
        self.adv_seen = c
        return len(idx)

    def mean_window_ns(self) -> float | None:
        """Mean harvested window span (wend - wstart) in ns, or None
        when nothing was harvested."""
        if not self.records:
            return None
        return float(np.mean([r.wend - r.wstart for r in self.records]))

    def summary(self) -> dict:
        """Aggregates for a run report (the reference's keys)."""
        evs = np.array([r.events for r in self.records], np.int64)
        out = {
            "windows_recorded": len(self.records),
            "records_lost": self.records_lost,
        }
        if len(evs):
            out["events_per_window"] = {
                "p50": float(np.percentile(evs, 50)),
                "p90": float(np.percentile(evs, 90)),
                "p99": float(np.percentile(evs, 99)),
                "mean": float(evs.mean()),
            }
            out["micro_steps_per_window_max"] = int(
                max(r.micro_steps for r in self.records))
            out["qocc_max"] = int(max(r.qocc_max for r in self.records))
            out["fastpath_windows"] = int(
                sum(r.fastpath for r in self.records))
            out["active_lanes_max"] = int(
                max(r.active_lanes for r in self.records))
            out["window_span_ns_mean"] = self.mean_window_ns()
            out["injected_sum"] = int(sum(r.injected for r in self.records))
            out["inj_dropped_sum"] = int(
                sum(r.inj_dropped for r in self.records))
            out["inj_deferred_last"] = int(self.records[-1].inj_deferred)
            if self.records[-1].lane_events:
                R = len(self.records[-1].lane_events)
                out["lane_events_sum"] = [
                    int(sum(r.lane_events[i] for r in self.records
                            if r.lane_events)) for i in range(R)]
        if self.escalation_marks:
            out["escalations"] = len(self.escalation_marks)
        if self.flow_enabled:
            out["flows_sampled"] = int(self.flow_sampled)
            out["flows_harvested"] = len(self.flow_records)
            out["flows_lost_ring"] = int(self.flow_lost)
            out["flows_lost_window_clamp"] = int(self.flow_lost_clamp)
        if self.caus_enabled:
            out["causality_sampled"] = int(self.caus_sampled)
            out["causality_harvested"] = len(self.caus_records)
            out["causality_lost_ring"] = int(self.caus_lost)
            out["causality_windows_attributed"] = len(self.adv_records)
        return out


@dataclass
class Phase:
    name: str
    start_s: float     # offset from the timer origin
    dur_s: float
    shard: int | None  # None = applies to every shard


class PhaseTimers:
    """Named wall-clock spans on one origin, for the wall-time trace
    tracks. `shard=None` spans are drawn on every shard's track."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.phases: list[Phase] = []

    @contextmanager
    def phase(self, name: str, shard: int | None = None):
        s = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append(Phase(
                name=name, start_s=s - self.t0,
                dur_s=time.perf_counter() - s, shard=shard))

    def totals(self) -> dict:
        """phase name -> total seconds (merged over repeats)."""
        out: dict = {}
        for p in self.phases:
            out[p.name] = out.get(p.name, 0.0) + p.dur_s
        return out
