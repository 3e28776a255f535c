"""Device-resident injection staging buffer (PyTorch port of
shadow_tpu/inject/staging.py).

A bounded ring of host->device injected events, merged into the
EventQueue at every window boundary (core/engine.step_window) before
the window drains — so an injected event with timestamp inside
[wstart, wend) executes in that window under the normal deterministic
(time, src, seq) total order, exactly as if an application had
scheduled it.

Layout: L lanes (power of two), slot = seq % L, where `seq` is the
event's global position in the trace. The slot rule depends only on
the trace, never on window timing, so the staged planes are identical
across chunk sizes for the same feeder state.

Merge bookkeeping, never silent:

- `dropped`: the destination row was full. insert_flat counts the
  drop; the delta is moved OFF the fatal EventQueue.overflow latch
  onto the injection's own sticky counter, which faults/health.py
  latches as a *warning* (the reconciliation injected + dropped +
  deferred == trace length still closes).
- `late`: an event was staged after the window containing its
  timestamp had already run; its time is clamped up to wstart so it
  still executes, but the timestamp was perturbed. The feeder's
  horizon clamp makes this impossible, so a nonzero count means the
  feeder contract was violated — latched as a warning.
- `seq_floor` dedupe: the host may re-stage entries that were already
  merged (refills are built from a host-side mirror without reading
  device state back); the device skips seq < seq_floor, so refills are
  idempotent.

`horizon` is the timestamp of the first trace event NOT yet staged
(simtime.INVALID when the whole remaining trace is staged). The
chunked window loop clamps every wend to it and stops dispatching at
it, which is what keeps `late` at zero under streaming.

The merge is plain torch (a masked select and one insert_flat, whose
select sweep is the mailbox_gather kernel), as the reference's is plain
jnp inside the window body. On a lane-isolated Sim the merge's
row-full drops are diverted per host too: the queue's attribution plane
is restored (it keeps matching the scalar latch) and the drops land on
the lanes' `inj_dropped` counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import _Replace, insert_flat

I32 = torch.int32
I64 = torch.int64

# Injected events' per-source sequence numbers start here: organic
# events use the per-host next_seq counter (small), so injected events
# tie-break AFTER any organic event with the same (time, src). Trace
# positions wrap modulo SEQ_BASE into the i32 queue seq.
SEQ_BASE = 1 << 30


@dataclass
class InjectStaging(_Replace):
    """Bounded staging ring for host->device injected events."""

    time: torch.Tensor       # [L] i64 (simtime.INVALID = empty lane)
    host: torch.Tensor       # [L] i32 global destination host id
    kind: torch.Tensor       # [L] i32 event kind
    seq: torch.Tensor        # [L] i64 global trace position
    words: torch.Tensor      # [L, NWORDS] i32 payload
    # entries with seq < seq_floor were already merged; the host's
    # refill dedupe key
    seq_floor: torch.Tensor  # [] i64
    # timestamp of the first trace event not yet staged; INVALID when
    # the whole remaining trace is on device. Written by the host
    # feeder only; the chunked loop's wend clamp + stop condition.
    horizon: torch.Tensor    # [] i64
    injected: torch.Tensor   # [] i64 events merged into rows
    dropped: torch.Tensor    # [] i64 row-full drops (warning latch)
    late: torch.Tensor       # [] i64 timestamps clamped up to wstart

    @property
    def lanes(self) -> int:
        return self.time.shape[0]

    @staticmethod
    def create(lanes: int, nwords: int, device=None) -> "InjectStaging":
        if lanes < 1 or (lanes & (lanes - 1)) != 0:
            raise ValueError(
                f"inject lanes must be a power of two >= 1, got {lanes} "
                f"(slot = seq % lanes must be a mask)")

        def z64():
            return torch.zeros((), dtype=I64, device=device)
        return InjectStaging(
            time=torch.full((lanes,), simtime.INVALID, dtype=I64,
                            device=device),
            host=torch.zeros((lanes,), dtype=I32, device=device),
            kind=torch.zeros((lanes,), dtype=I32, device=device),
            seq=torch.zeros((lanes,), dtype=I64, device=device),
            words=torch.zeros((lanes, nwords), dtype=I32, device=device),
            seq_floor=z64(),
            horizon=torch.full((), simtime.INVALID, dtype=I64,
                               device=device),
            injected=z64(), dropped=z64(), late=z64(),
        )


def attach(sim, lanes: int):
    """Return `sim` with an injection staging buffer on its device
    attached (no-op when one already is). Sim.inject defaults to None,
    which contributes no leaf, so states and snapshots built without
    injection are untouched."""
    if getattr(sim, "inject", None) is not None:
        return sim
    return sim.replace(inject=InjectStaging.create(
        int(lanes), int(sim.events.words.shape[-1]),
        device=sim.events.time.device))


def staged_pending_min(st: InjectStaging) -> torch.Tensor:
    """[] i64 earliest staged-but-unmerged timestamp (INVALID if none).
    Joins the queue minimum in the window-advance rule so a run whose
    queues went quiet still advances to the next injected event."""
    pend = (st.time != simtime.INVALID) & (st.seq >= st.seq_floor)
    return torch.where(pend, st.time, simtime.INVALID).amin()


def wend_clamp(sim, wend: int) -> int:
    """Clamp a window end (host int) to the staging horizon: a window
    must never cross the first NOT-yet-staged event's timestamp, or
    that event would merge late once the host stages it. Identity when
    injection is off; an INVALID horizon never binds. Reads the
    horizon to the host."""
    st = getattr(sim, "inject", None)
    if st is None:
        return wend
    return min(int(wend), int(st.horizon))


def merge_staged(sim, wstart: int, wend: int, lane_id=None):
    """Merge staged events with timestamp < wend into the EventQueue
    rows. Returns (sim, injected_w, dropped_w, deferred_w): this
    window's injected/dropped deltas and the still-deferred count, []
    i64 tensors (the telemetry ring records them).

    Determinism: the trace is sorted by time with seq = position, so
    `time < wend` selects a seq-contiguous prefix of the pending
    entries and the seq_floor advance equals the taken count. Insertion
    order within a row follows lane order == seq order (insert_flat's
    caller-order contract), and the queue seq SEQ_BASE + trace position
    makes the (time, src, seq) order independent of chunk size."""
    st = sim.inject
    pend = (st.time != simtime.INVALID) & (st.seq >= st.seq_floor)
    take = pend & (st.time < wend)
    late = take & (st.time < wstart)
    t_ins = st.time.clamp(min=int(wstart))

    H = sim.events.num_hosts
    row = st.host if lane_id is None else st.host - lane_id[0].to(I32)
    local = take & (row >= 0) & (row < H)

    ov0, ov0_h = sim.events.overflow, sim.events.overflow_h
    q = insert_flat(
        sim.events, local, row.to(I32), t_ins, st.kind, st.host,
        (SEQ_BASE + st.seq % SEQ_BASE).to(I32), st.words)
    # Row-full drops of injected events latch on the injection's own
    # sticky counter (a health WARNING), not the fatal engine latch
    drop_w = (q.overflow - ov0).to(I64)
    q = q.replace(overflow=ov0)
    if ov0_h is not None:
        # the same diversion on the per-host plane (lane isolation):
        # the merge's per-row drops go to the per-lane injection
        # counter, and the plane is restored to match the scalar
        drop_h = (q.overflow_h - ov0_h).to(I64)
        q = q.replace(overflow_h=ov0_h)
        if getattr(sim, "lanes", None) is not None:
            from shadow_tpu_torch.core.lanes import lane_sum

            sim = sim.replace(lanes=sim.lanes.replace(
                inj_dropped=sim.lanes.inj_dropped
                + lane_sum(drop_h, sim.lanes.replicas)))

    inj_w = local.sum(dtype=I64) - drop_w
    late_w = (late & local).sum(dtype=I64)
    st = st.replace(
        seq_floor=st.seq_floor + take.sum(dtype=I64),
        injected=st.injected + inj_w,
        dropped=st.dropped + drop_w,
        late=st.late + late_w,
    )
    deferred_w = (pend & ~take).sum(dtype=I64)
    return sim.replace(events=q, inject=st), inj_w, drop_w, deferred_w
