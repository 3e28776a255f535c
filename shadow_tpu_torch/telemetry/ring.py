"""Device-resident per-window telemetry ring (PyTorch port of
shadow_tpu/telemetry/ring.py; on a mesh the record is reduced over the
ranks, make_telem_fn(axis)).

A fixed-capacity ring of per-window records — one record per window
barrier, written on the device as masked one-hot stores — that the
host drains between calls (telemetry/harvest.py). Writing a record
reads nothing back to the host.

Record fields (one [W] plane each, PLANES order):

- wstart / wend      window bounds in sim-ns
- events             events executed inside the window (bulk pass +
                     fixpoint)
- micro_steps        fixpoint iterations
- routed_local       outbox entries whose destination is on this
                     shard (all of them on one shard)
- routed_cross       outbox entries bound for another shard (0 on one)
- drops              packets dropped this window (net.state.drop_total
                     delta)
- retx               TCP segments retransmitted (sum of tcp.retx_segs
                     delta; 0 without TCP state)
- qocc_min/max/sum   event-queue occupancy across hosts at the end of
                     the window drain (pre-route)
- active_lanes       host rows holding any event < wend when the
                     window fixpoint started (the sparse census input)
- fastpath           1 when the window drained on the compact [S]-lane
                     fast path
- injected / inj_dropped / inj_deferred   open-system injection: the
                     window's merged and row-full-dropped staged events
                     and the staged events still pending past wend
                     (inject/staging.py merge_staged; 0 without a
                     staging buffer)

Overflow: `count` is monotonic and slot = count % capacity; the
harvester detects count advancing more than `capacity` since its last
drain and reports the lost records.

Lane-isolated runs (core/lanes.py, attached BEFORE the ring) also get
the per-lane fan-out of the events plane: lane_events[w, r] is the
events lane r executed in window w (the delta of the lane share of
net.ctr_events_exec).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from shadow_tpu_torch.core.events import _Replace

I32 = torch.int32
I64 = torch.int64

# plane name -> dtype, in record order (harvest.py iterates this)
PLANES = (
    ("wstart", I64),
    ("wend", I64),
    ("events", I64),
    ("micro_steps", I64),
    ("routed_local", I64),
    ("routed_cross", I64),
    ("drops", I64),
    ("retx", I64),
    ("qocc_min", I32),
    ("qocc_max", I32),
    ("qocc_sum", I64),
    ("active_lanes", I64),
    ("fastpath", I32),
    ("injected", I64),
    ("inj_dropped", I64),
    ("inj_deferred", I64),
)

DEFAULT_CAPACITY = 4096


@dataclass
class TelemetryRing(_Replace):
    """Fixed-capacity ring of per-window records ([W] planes) plus the
    running scalars the per-window deltas are computed against."""

    wstart: torch.Tensor        # [W] i64
    wend: torch.Tensor          # [W] i64
    events: torch.Tensor        # [W] i64
    micro_steps: torch.Tensor   # [W] i64
    routed_local: torch.Tensor  # [W] i64
    routed_cross: torch.Tensor  # [W] i64
    drops: torch.Tensor         # [W] i64
    retx: torch.Tensor          # [W] i64
    qocc_min: torch.Tensor      # [W] i32
    qocc_max: torch.Tensor      # [W] i32
    qocc_sum: torch.Tensor      # [W] i64
    active_lanes: torch.Tensor  # [W] i64
    fastpath: torch.Tensor      # [W] i32
    injected: torch.Tensor      # [W] i64
    inj_dropped: torch.Tensor   # [W] i64
    inj_deferred: torch.Tensor  # [W] i64
    # monotonic windows-recorded counter; slot = count % W
    count: torch.Tensor         # [] i64
    # cumulative counters at the previous record
    prev_drops: torch.Tensor    # [] i64
    prev_retx: torch.Tensor     # [] i64
    # lane-isolated runs only (None otherwise: no leaf)
    lane_events: Any = None     # [W, R] i64 events per lane per window
    prev_lane_exec: Any = None  # [R] i64 cumulative at the last record

    @property
    def capacity(self) -> int:
        return self.wstart.shape[0]

    @staticmethod
    def create(capacity: int = DEFAULT_CAPACITY,
               device=None) -> "TelemetryRing":
        if capacity < 1:
            raise ValueError(f"telemetry capacity must be >= 1, got "
                             f"{capacity}")
        planes = {name: torch.zeros((capacity,), dtype=dt, device=device)
                  for name, dt in PLANES}

        def z():
            return torch.zeros((), dtype=I64, device=device)
        return TelemetryRing(count=z(), prev_drops=z(), prev_retx=z(),
                             **planes)


def attach(sim, capacity: int = DEFAULT_CAPACITY):
    """Return `sim` with a telemetry ring on its device attached (no-op
    if one already is). A lane-isolated Sim (core.lanes.attach first)
    gets the per-lane fan-out planes sized off sim.lanes.replicas."""
    if getattr(sim, "telem", None) is not None:
        return sim
    dev = sim.events.time.device
    ring = TelemetryRing.create(capacity, device=dev)
    lanes = getattr(sim, "lanes", None)
    if lanes is not None:
        R = lanes.replicas
        ring = ring.replace(
            lane_events=torch.zeros((capacity, R), dtype=I64, device=dev),
            prev_lane_exec=torch.zeros((R,), dtype=I64, device=dev))
    return sim.replace(telem=ring)


def _record(ring: TelemetryRing, vals: dict) -> TelemetryRing:
    """Masked one-hot store of one record at slot count % W."""
    W = ring.capacity
    sel = torch.arange(W, device=ring.count.device) == ring.count % W
    new = {}
    for k, v in vals.items():
        old = getattr(ring, k)
        # host values stay Python scalars: no host-to-device copy
        v = v.to(old.dtype) if isinstance(v, torch.Tensor) else int(v)
        new[k] = torch.where(sel, v, old)
    return ring.replace(count=ring.count + 1, **new)


def make_telem_fn(axis=None):
    """Build the engine's telem hook ``telem_fn(sim, wstart, wend,
    ev_delta, ms_delta, active_lanes=None, fastpath=None,
    inject_deltas=None) -> sim``. It runs inside step_window after the
    window drain and BEFORE the route, so the outbox still holds the
    window's staged sends. When sim.telem is None it returns `sim`
    untouched.

    `active_lanes` is the window's live-lane count and `fastpath` the
    census-branch indicator (tensors, bools or None = 0).
    `inject_deltas` is the window's (injected, dropped, deferred) from
    inject.merge_staged (None, without a staging buffer, records
    zeros).

    `axis` is the rank's mesh (parallel.shard.Mesh, the port's handle of
    the reference's mesh axis); None records the single-shard values.
    With a mesh every cross-rank reduction rides one sum of a stacked
    i64 vector, one max and one min, as the reference's psum/pmax/pmin:
    events, routed counts, the cumulative drops and retransmits, the
    occupancy sum, the active rows and the injection partials are
    summed; micro-steps and the occupancy maximum are maxed."""
    if axis is not None and not hasattr(axis, "all_reduce"):
        raise TypeError(
            "make_telem_fn(axis=...) takes the rank's parallel.shard.Mesh")
    mesh = axis if axis is not None and axis.size > 1 else None

    def telem_fn(sim, wstart, wend, ev_delta, ms_delta,
                 active_lanes=None, fastpath=None, inject_deltas=None):
        ring = getattr(sim, "telem", None)
        if ring is None:
            return sim

        from shadow_tpu_torch.net.state import drop_total

        out = sim.outbox
        occupied = out.occupied()
        lane = sim.net.lane_id
        Hl = lane.shape[0]
        base = lane[0]
        # local = destined to a host this shard owns; on one shard
        # every valid destination is local
        local = occupied & (out.dst >= base) & (out.dst < base + Hl)
        n_local = local.sum(dtype=I64)
        n_cross = occupied.sum(dtype=I64) - n_local
        drops_cum = drop_total(sim.net).sum(dtype=I64)
        tcp = getattr(sim, "tcp", None)
        retx_cum = (ring.prev_retx if tcp is None
                    else tcp.retx_segs.sum(dtype=I64))
        qmin, qmax, qsum = sim.events.occupancy()
        zero = 0
        inj, inj_drop, inj_def = ((zero, zero, zero)
                                  if inject_deltas is None
                                  else inject_deltas)
        active = zero if active_lanes is None else active_lanes
        if mesh is not None:
            dev = n_local.device

            def i64(v):
                return torch.as_tensor(v, device=dev).to(I64).reshape(())

            sums = mesh.all_reduce(torch.stack([
                i64(ev_delta), n_local, n_cross, i64(drops_cum),
                i64(retx_cum), i64(qsum), i64(active), i64(inj),
                i64(inj_drop)]), "sum")
            maxes = mesh.all_reduce(
                torch.stack([i64(ms_delta), i64(qmax)]), "max")
            qmin = mesh.all_reduce(i64(qmin), "min")
            (ev_delta, n_local, n_cross, drops_cum, retx_cum, qsum,
             active, inj, inj_drop) = sums.unbind(0)
            ms_delta, qmax = maxes.unbind(0)
        ring = _record(ring, dict(
            wstart=wstart,
            wend=wend,
            events=ev_delta,
            micro_steps=ms_delta,
            routed_local=n_local,
            routed_cross=n_cross,
            drops=drops_cum - ring.prev_drops,
            retx=retx_cum - ring.prev_retx,
            qocc_sum=qsum,
            qocc_min=qmin,
            qocc_max=qmax,
            active_lanes=active,
            fastpath=zero if fastpath is None else fastpath,
            injected=inj,
            inj_dropped=inj_drop,
            inj_deferred=inj_def,
        ))
        ring = ring.replace(prev_drops=drops_cum, prev_retx=retx_cum)
        lanes_st = getattr(sim, "lanes", None)
        if ring.lane_events is not None and lanes_st is not None:
            # the per-lane fan-out, into the slot _record just wrote
            from shadow_tpu_torch.core.lanes import lane_sum

            cum = lane_sum(sim.net.ctr_events_exec, lanes_st.replicas)
            W = ring.capacity
            sel = (torch.arange(W, device=cum.device)
                   == (ring.count - 1) % W)
            ring = ring.replace(
                lane_events=torch.where(
                    sel[:, None], (cum - ring.prev_lane_exec)[None, :],
                    ring.lane_events),
                prev_lane_exec=cum)
        return sim.replace(telem=ring)

    return telem_fn
