"""The conservative windowed-PDES loop (PyTorch port of
shadow_tpu/core/engine.py: EngineStats, window_fixpoint, step_window,
run).

Reference semantics (ref: SURVEY.md §3.2): all events inside the window
[wstart, wend) run, one host's events serially in (time, src, seq)
order and different hosts in parallel; then a barrier, and the next
window starts at the global minimum pending time and spans the minimum
cross-host latency.

The reference's lax.while_loop / lax.cond become Python loops and ifs.
Host syncs: one per micro-step (the popped-valid count and kind
bitmask, read together: they decide whether the fixpoint continues and
which handler families run), and per window the route's two reads
(core/events.py) plus the next window start.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from shadow_tpu_torch.core.events import (
    EmitBuffer,
    _Replace,
    apply_emissions,
    kind_mask,
    pop_earliest,
    route_outbox,
)

I32 = torch.int32
I64 = torch.int64

# The reference's default active-lane budget for its sparse-window fast
# path (core/compact.py, not ported yet).
DEFAULT_SPARSE_LANES = 256


def resolve_sparse_lanes(cfg) -> int:
    """Effective sparse-lane budget S for a config (the reference's
    rule): cfg.sparse_lanes (None -> the default), 0 when it cannot
    narrow anything."""
    v = getattr(cfg, "sparse_lanes", None)
    if v is None:
        v = DEFAULT_SPARSE_LANES
    v = int(v)
    if v <= 0 or v >= int(cfg.num_hosts):
        return 0
    return v


StepFn = Callable


@dataclass
class EngineStats(_Replace):
    events_processed: torch.Tensor  # [] i64
    micro_steps: torch.Tensor       # [] i64
    windows: torch.Tensor           # [] i64
    # sparse-window fast-path accounting of the reference; stays 0
    # here (the fast path is not ported yet)
    fastpath_hit: torch.Tensor      # [] i64
    fastpath_miss: torch.Tensor     # [] i64

    @staticmethod
    def create(device=None) -> "EngineStats":
        def z():
            return torch.zeros((), dtype=I64, device=device)
        return EngineStats(events_processed=z(), micro_steps=z(),
                           windows=z(), fastpath_hit=z(), fastpath_miss=z())

    def as_dict(self) -> dict:
        return {
            "events_processed": int(self.events_processed),
            "micro_steps": int(self.micro_steps),
            "windows": int(self.windows),
            "fastpath_hit": int(self.fastpath_hit),
            "fastpath_miss": int(self.fastpath_miss),
        }


def _popped_summary(popped) -> tuple[int, int]:
    """(number of valid pops, bitmask of their kinds) in one host read."""
    kbits = kind_mask(popped.kind, popped.valid)
    n, kinds = torch.stack([popped.valid.sum(dtype=I64), kbits]).tolist()
    return int(n), int(kinds)


def window_fixpoint(sim, stats: EngineStats, step_fn: StepFn, wend: int,
                    emit_capacity: int = 4, lane_id=None):
    """Drain every event earlier than wend: pop one event per host per
    micro-step, run the handler pipeline, apply its emissions, until no
    host holds an event < wend (handlers may keep emitting same-host
    events inside the window — iterate to fixpoint like the reference's
    pop-until-NULL worker loop)."""
    buf0 = EmitBuffer.create(sim.events.num_hosts, emit_capacity,
                             nwords=sim.events.words.shape[-1],
                             device=sim.events.time.device)
    n_ev = n_ms = 0
    while True:
        q, popped = pop_earliest(sim.events, wend)
        n, kinds = _popped_summary(popped)
        if n == 0:
            # no host holds an event < wend: the pop changed nothing
            break
        sim = sim.replace(events=q)
        sim, buf = step_fn(sim, popped, buf0, kinds=kinds)
        q, out = apply_emissions(sim.events, sim.outbox, buf, lane_id)
        sim = sim.replace(events=q, outbox=out)
        n_ev += n
        n_ms += 1
    stats = stats.replace(events_processed=stats.events_processed + n_ev,
                          micro_steps=stats.micro_steps + n_ms)
    return sim, stats


def step_window(sim, stats: EngineStats, step_fn: StepFn, wend: int,
                emit_capacity: int = 4, lane_id=None):
    """One full round: drain the window, then route cross-host events
    staged in the outbox into destination queues. Returns (sim, stats,
    next window start as a host int: the global minimum pending time,
    INVALID when the queues are empty)."""
    sim, stats = window_fixpoint(sim, stats, step_fn, wend, emit_capacity,
                                 lane_id)
    q, out = route_outbox(sim.events, sim.outbox)
    sim = sim.replace(events=q, outbox=out)
    stats = stats.replace(windows=stats.windows + 1)
    return sim, stats, int(sim.events.min_time().amin())


def run(sim, step_fn: StepFn, *, end_time: int, min_jump: int,
        emit_capacity: int = 4, lane_id=None):
    """Run the whole simulation. Window advance rule is the
    reference's: newStart = minNextEventTime, newEnd = newStart +
    minJump, clamped to end_time + 1 (ref: master.c:450-480)."""
    if min_jump <= 0:
        raise ValueError(f"min_jump must be positive, got {min_jump}")
    end_time = int(end_time)
    jump = max(int(min_jump), 1)
    stats = EngineStats.create(device=sim.events.time.device)
    wstart = int(sim.events.min_time().amin())
    while wstart <= end_time:
        wend = min(wstart + jump, end_time + 1)
        sim, stats, wstart = step_window(sim, stats, step_fn, wend,
                                         emit_capacity, lane_id)
    return sim, stats
