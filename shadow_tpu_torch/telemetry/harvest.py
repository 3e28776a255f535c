"""Host-side telemetry: the window ring's drain and wall-clock phase
timers (PyTorch port of shadow_tpu/telemetry/harvest.py).

The Harvester pulls the device ring (telemetry/ring.py) into plain
Python records between calls — after a whole run, or per window from a
host loop. It detects overruns from the monotonic write counter: count
advancing more than `capacity` since the last drain means records were
overwritten before the host saw them; the total is kept in
`records_lost`, never dropped silently. The reference's flow and
causality drains are not ported: drain() raises when a Sim carries
those rings (ROADMAP.md Queue 1 item 8).

PhaseTimers records named wall-clock spans (trace/compile, device
execute, harvest, export) on the host timeline; export.chrome_trace
draws them as wall-time tracks beside the ring's sim-time track.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

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


@dataclass
class Harvester:
    """Incremental ring drain with overrun accounting."""

    seen: int = 0                 # ring count at the last drain
    records: list = field(default_factory=list)
    records_lost: int = 0
    # capacity escalations the supervisor healed (Escalation.as_dict()
    # records, faults/escalate.py), in the order they happened
    escalation_marks: list = field(default_factory=list)

    def mark_escalation(self, esc) -> None:
        self.escalation_marks.append(
            esc if isinstance(esc, dict) else esc.as_dict())

    def drain(self, sim) -> int:
        """Pull records written since the last drain; returns how many
        were taken. A count REWIND (a resume from an older state)
        discards already-harvested records past the restored count."""
        for name in ("flows", "causality"):
            if getattr(sim, name, None) is not None:
                raise NotImplementedError(
                    f"shadow_tpu_torch: the {name} ring drain is not "
                    "ported yet (ROADMAP.md Queue 1 item 8)")
        ring = getattr(sim, "telem", None)
        if ring is None:
            return 0
        c = int(ring.count)
        if c < self.seen:
            self.records = [r for r in self.records if r.index < c]
            self.seen = c
        new = c - self.seen
        if new <= 0:
            return 0
        W = ring.capacity
        self.records_lost += max(0, new - W)
        take = min(new, W)
        idx = np.arange(c - take, c)
        slots = idx % W
        cols = [getattr(ring, name).cpu().numpy()[slots].tolist()
                for name, _ in PLANES]
        self.records.extend(
            WindowRecord(*row) for row in zip(idx.tolist(), *cols))
        self.seen = c
        return take

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
        if self.escalation_marks:
            out["escalations"] = len(self.escalation_marks)
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
