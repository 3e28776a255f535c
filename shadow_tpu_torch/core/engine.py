"""The conservative windowed-PDES loop (PyTorch port of
shadow_tpu/core/engine.py: EngineStats, window_fixpoint, step_window,
make_wend_fn, make_chunk_body, run).

Reference semantics (ref: SURVEY.md §3.2): all events inside the window
[wstart, wend) run, one host's events serially in (time, src, seq)
order and different hosts in parallel; then a barrier, and the next
window starts at the global minimum pending time and spans the minimum
cross-host latency.

The reference's lax.while_loop / lax.cond become Python loops and ifs.
Host syncs: one per micro-step (the popped-valid count and kind
bitmask, read together: they decide whether the fixpoint continues and
which handler families run), and per window the sparse fast path's
active-row count (when armed), the route's two reads (core/events.py),
the injection merge's insert decision (with a staging buffer) and the
next window start; a chunk reads the injection horizon once. The bulk
pass, the telemetry record, the flow and lineage recorders and the lane
barrier read nothing back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.compact import (
    active_indices,
    gather_lanes,
    scatter_lanes,
)
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

# Default active-lane budget S of the sparse-window fast path (the
# reference's): when the rows holding any event < wend fit, the window
# fixpoint runs over a compacted [S]-lane view of the Sim
# (core/compact.py). NetConfig.sparse_lanes overrides; 0 disables.
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
    # sparse-window fast path: windows drained at compact [S] width vs
    # windows that ran full width (census above S, or no live lane);
    # hit + miss == windows when the fast path is armed, both 0 when off
    fastpath_hit: torch.Tensor      # [] i64
    fastpath_miss: torch.Tensor     # [] i64

    @staticmethod
    def create(device=None) -> "EngineStats":
        def z():
            return torch.zeros((), dtype=I64, device=device)
        return EngineStats(events_processed=z(), micro_steps=z(),
                           windows=z(), fastpath_hit=z(), fastpath_miss=z())

    @staticmethod
    def from_dict(d: dict, device=None) -> "EngineStats":
        """EngineStats from host ints (a snapshot's carried totals);
        absent keys are 0."""
        def v(k):
            return torch.tensor(int(d.get(k, 0)), dtype=I64, device=device)
        return EngineStats(events_processed=v("events_processed"),
                           micro_steps=v("micro_steps"),
                           windows=v("windows"),
                           fastpath_hit=v("fastpath_hit"),
                           fastpath_miss=v("fastpath_miss"))

    def add(self, other: "EngineStats") -> "EngineStats":
        """Field-wise sum: running totals across dispatches."""
        return EngineStats(
            events_processed=self.events_processed + other.events_processed,
            micro_steps=self.micro_steps + other.micro_steps,
            windows=self.windows + other.windows,
            fastpath_hit=self.fastpath_hit + other.fastpath_hit,
            fastpath_miss=self.fastpath_miss + other.fastpath_miss,
        )

    def as_dict(self) -> dict:
        """The five counters as host ints, in one host read."""
        keys = ("events_processed", "micro_steps", "windows",
                "fastpath_hit", "fastpath_miss")
        vals = torch.stack([getattr(self, k) for k in keys]).tolist()
        return dict(zip(keys, (int(v) for v in vals)))


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
    if sim.events.overflow_h is not None:
        # lane isolation (core/lanes.py): emission overflow carries
        # per-host attribution too, or the queue plane would drift
        # from the scalar latch at apply_emissions
        buf0 = buf0.replace(overflow_h=torch.zeros(
            (sim.events.num_hosts,), dtype=I32,
            device=sim.events.time.device))
    tracing = getattr(sim, "causality", None) is not None
    # events_processed counts EXECUTED events: the pops the virtual-CPU
    # gate re-queues (net/step.py _cpu_gate) come off through the
    # blocked-counter delta, on the device (no host read), so a
    # repeatedly deferred event counts once. Only a step_fn that carries
    # the gate (make_step_fn sets .cpu_gate) pays for the delta.
    gated = getattr(step_fn, "cpu_gate", False)
    blocked0 = sim.net.ctr_cpu_blocked.sum() if gated else None
    n_ev = n_ms = 0
    while True:
        q, popped = pop_earliest(sim.events, wend)
        n, kinds = _popped_summary(popped)
        if n == 0:
            # no host holds an event < wend: the pop changed nothing
            break
        sim = sim.replace(events=q)
        sim, buf = step_fn(sim, popped, buf0, kinds=kinds)
        if tracing:
            # the lineage recorder must see the PRE-apply next_seq, so
            # each emission hashes with the seq apply_emissions assigns
            from shadow_tpu_torch.telemetry.causality import lineage_update

            sim = lineage_update(sim, popped, buf, lane_id)
        q, out = apply_emissions(sim.events, sim.outbox, buf, lane_id)
        sim = sim.replace(events=q, outbox=out)
        n_ev += n
        n_ms += 1
    ev = stats.events_processed + n_ev
    if gated:
        ev = ev - (sim.net.ctr_cpu_blocked.sum() - blocked0)
    stats = stats.replace(events_processed=ev,
                          micro_steps=stats.micro_steps + n_ms)
    return sim, stats


def _default_route(sim):
    """The single-shard route: staged outbox entries into their rows."""
    q, out = route_outbox(sim.events, sim.outbox)
    return sim.replace(events=q, outbox=out)


def step_window(sim, stats: EngineStats, step_fn: StepFn, wend: int,
                emit_capacity: int = 4, lane_id=None, bulk_fn=None,
                telem_fn=None, wstart: int | None = None,
                sparse_lanes: int = 0, fault_fn=None, flow_fn=None,
                adv_attr=None, route_fn=None, min_fn=None,
                census_fn=None, sentinel_fn=None):
    """One full round: drain the window, then route cross-host events
    staged in the outbox into destination queues. Returns (sim, stats,
    next window start as a host int: the global minimum pending time,
    INVALID when the queues are empty).

    `fault_fn` (faults.apply.make_fault_fn) runs first, at the window
    boundary: it rewrites the latency/reliability tables and applies
    crash resets as a pure function of wend, so every event inside the
    window sees the post-fault network. It runs at full width before
    the bulk pass and the census. A Sim carrying a specialization guard
    (compile/specialize.py) updates it right after, on the device.

    `bulk_fn` (net.bulk.make_bulk_fn) consumes eligible hosts' whole
    windows in one vectorized pass first; its count is added to
    events_processed without a host read.

    `sparse_lanes` S > 0 arms the sparse-window fast path: one host
    read of the count n of rows holding any event < wend decides it.
    hit = 0 < n <= S; on a hit (and S < H) the fixpoint runs over a
    compacted [S]-lane Sim (core/compact.py) and scatters back —
    bit-identical by construction; otherwise it runs full width. A
    window with n == 0 has nothing to drain, so its fixpoint (the
    identity) is skipped.

    `telem_fn` (telemetry.ring.make_telem_fn) records the window after
    the drain and BEFORE the route; its event and micro-step deltas
    count from before the bulk pass. `wstart` is read by it and by the
    injection merge (None records a zero-length window and merges from
    0).

    A Sim carrying an injection staging buffer (inject/staging.py)
    merges its staged events < wend FIRST, before the fault rewrite and
    the bulk/census passes, so an injected event inside the window
    drains exactly like one an application scheduled; the window's
    (injected, dropped, deferred) deltas go to the ring, and the staged
    minimum joins the next window start.

    `flow_fn` (telemetry.flows.make_flow_fn) samples the staged outbox
    after the ring and before the route. `adv_attr` — a (cause, edge_a,
    edge_b, raw_jump) tuple of host ints from a window-end rule's
    `.explain` — latches the window's advance attribution into
    Sim.causality (telemetry/causality.py advance_latch) with the
    window's active-row census; None, and always without causality,
    latches nothing. A lane-isolated Sim (core/lanes.py) runs the lane
    barrier after the route: its deliveries are attributed, and a
    frozen lane stops holding the next window start back.

    The mesh hooks (parallel/shard.py) are the reference's:
    `route_fn(sim) -> sim` replaces the single-shard route (the
    cross-shard exchange), `min_fn(int) -> int` reduces the next window
    start and `census_fn(int) -> int` the active-row count of the sparse
    fast path and the advance latch, over the ranks. Left None, the
    single-shard program runs unchanged.

    `sentinel_fn` (parallel.elastic.make_sentinel_fn) digests the
    replicated leaves after the route and the lane barrier, when the
    replication invariant holds again, and latches a divergence; it
    does nothing on a Sim without a sentinel."""
    ev0, ms0 = stats.events_processed, stats.micro_steps
    inject_deltas = None
    if getattr(sim, "inject", None) is not None:
        from shadow_tpu_torch.inject.staging import merge_staged

        sim, inj_w, drop_w, def_w = merge_staged(
            sim, 0 if wstart is None else wstart, wend, lane_id)
        inject_deltas = (inj_w, drop_w, def_w)
    if fault_fn is not None:
        sim = fault_fn(sim, wend)
    if getattr(sim, "guard", None) is not None:
        # the specialization guard (compile/specialize.py): one device
        # predicate per dropped capability right after the fault rewrite
        # (the only in-window writer of the watched tables); a trip is
        # latched and becomes a fatal health fault at gather time
        from shadow_tpu_torch.compile.specialize import guard_update

        sim = guard_update(sim, wend)
    if bulk_fn is not None:
        sim, n_bulk = bulk_fn(sim, wend)
        stats = stats.replace(
            events_processed=stats.events_processed + n_bulk)

    if adv_attr is not None and getattr(sim, "causality", None) is None:
        adv_attr = None
    S = int(sparse_lanes or 0)
    recording = telem_fn is not None and getattr(sim, "telem", None) \
        is not None
    n_active = None
    n_global = None
    if S > 0 or recording or adv_attr is not None:
        active = sim.events.min_time() < wend
        n_active = active.sum(dtype=I32)
        if census_fn is not None and (S > 0 or adv_attr is not None):
            # the GLOBAL live-row count: every rank takes the same
            # branch and latches the same census
            n_global = census_fn(int(n_active))
    fastpath = False
    if S > 0:
        n = int(n_active) if n_global is None else n_global
        fastpath = 0 < n <= S
        if fastpath and S < sim.events.num_hosts:
            idx = active_indices(active, S)
            lane_c = idx if lane_id is None else lane_id[idx.long()]
            csim, stats = window_fixpoint(
                gather_lanes(sim, idx), stats, step_fn, wend,
                emit_capacity, lane_c)
            sim = scatter_lanes(sim, csim, idx)
        elif n > 0:
            sim, stats = window_fixpoint(sim, stats, step_fn, wend,
                                         emit_capacity, lane_id)
        stats = stats.replace(
            fastpath_hit=stats.fastpath_hit + int(fastpath),
            fastpath_miss=stats.fastpath_miss + int(not fastpath))
    else:
        sim, stats = window_fixpoint(sim, stats, step_fn, wend,
                                     emit_capacity, lane_id)
    if recording:
        sim = telem_fn(sim, wend if wstart is None else wstart, wend,
                       stats.events_processed - ev0,
                       stats.micro_steps - ms0, n_active, fastpath,
                       inject_deltas=inject_deltas)
    w0 = wend if wstart is None else wstart
    if flow_fn is not None:
        sim = flow_fn(sim, w0, wend)
    if adv_attr is not None:
        from shadow_tpu_torch.telemetry.causality import advance_latch

        sim = advance_latch(sim, w0, wend, *adv_attr,
                            n_active if n_global is None else n_global)
    sim = (route_fn or _default_route)(sim)
    if getattr(sim, "lanes", None) is not None:
        from shadow_tpu_torch.core.lanes import window_update

        sim = window_update(sim, wend)
    if sentinel_fn is not None:
        sim = sentinel_fn(sim, wend)
    stats = stats.replace(windows=stats.windows + 1)
    next_min = int(global_min_time(sim))
    return sim, stats, next_min if min_fn is None else min_fn(next_min)


def global_min_time(sim) -> torch.Tensor:
    """[] i64 global minimum pending time: the queue heads joined, when
    injection is live, with the earliest staged-but-unmerged event (a
    quiet queue still advances to the next injected timestamp)."""
    m = sim.events.min_time().amin()
    if getattr(sim, "inject", None) is not None:
        from shadow_tpu_torch.inject.staging import staged_pending_min

        m = torch.minimum(m, staged_pending_min(sim.inject))
    return m


def _next_record(ft, wstart: int) -> int:
    """The first record time > wstart in the sorted array `ft`
    (INVALID when none, or no records)."""
    if ft is None:
        return simtime.INVALID
    i = int(np.searchsorted(ft, wstart, side="right"))
    return int(ft[i]) if i < len(ft) else simtime.INVALID


def _record_times(fault_times):
    if fault_times is None or not len(fault_times):
        return None
    return np.unique(np.asarray(fault_times, np.int64))


def make_wend_fn(*, min_jump: int, end_time: int,
                 pair_mask=None, fault_times=None, table_fn=None):
    """The window-end rule ``wend = wend_fn(sim, wstart)`` shared by the
    chunked runners; wstart and wend are host ints.

    Static (``pair_mask`` None): ``wstart + max(min_jump, 1)`` clamped
    to ``end_time + 1`` (ref: master.c:450-480).

    Adaptive (``pair_mask`` a [V,V] bool array of host-bearing vertex
    pairs, net.build.adaptive_jump_spec): advance by the current
    minimum over the masked pairs of ``sim.net.latency_ns`` whose
    ``reliability`` is > 0 (or of ``table_fn(wstart + 1)``'s tables),
    floored at the static jump and clipped at ``end_time + 1`` (when
    no pair constrains the window any span is conservative).

    Both rules clamp wend at the next ``fault_times`` record > wstart,
    so each record lands on a window boundary. Neither reads the
    injection horizon: the chunk body (make_chunk_body) clamps to it.

    ``wend_fn.explain(sim, wstart) -> (wend, cause, edge_a, edge_b,
    raw_jump)`` gives the window end a chunk runs with its attribution
    (telemetry/causality.py CAUSE_* codes): the binding vertex pair
    under the adaptive rule (the first minimum of the flattened table,
    as jnp.argmin picks it; -1 otherwise) and the jump before the
    record and end clamps. A clamp takes the cause only when it
    strictly lowers wend, in the order floor, record, end, and then
    the injection horizon of a Sim carrying a staging buffer
    (CAUSE_INJECT_HORIZON, as the reference's chunk body attributes
    it; one host read of the horizon).

    The adaptive rule reads its [V,V] table to the host once per
    window."""
    from shadow_tpu_torch.telemetry.causality import (
        CAUSE_ADAPTIVE_EDGE,
        CAUSE_END_TIME,
        CAUSE_FAULT_RECORD,
        CAUSE_INJECT_HORIZON,
        CAUSE_MIN_JUMP,
    )
    if int(min_jump) <= 0:
        raise ValueError(f"min_jump must be positive, got {min_jump}")
    end = int(end_time)
    jump0 = max(int(min_jump), 1)
    ft = _record_times(fault_times)

    def clamps(wend, cause, wstart):
        nxt = _next_record(ft, wstart)
        if nxt < wend:
            cause, wend = CAUSE_FAULT_RECORD, nxt
        if end + 1 < wend:
            cause, wend = CAUSE_END_TIME, end + 1
        return wend, cause

    if pair_mask is None:
        def attribute(sim, wstart):
            wstart = int(wstart)
            wend, cause = clamps(wstart + jump0, CAUSE_MIN_JUMP, wstart)
            return wend, cause, -1, -1, jump0
    else:
        mask = np.asarray(pair_mask, bool)
        V = int(mask.shape[0])

        def table(sim, wstart):
            """[V,V] latencies of the live masked pairs, INVALID
            elsewhere, flattened on the host (one read)."""
            if table_fn is not None:
                lat, rel = table_fn(wstart + 1)
            else:
                lat, rel = sim.net.latency_ns, sim.net.reliability
            lat = torch.as_tensor(lat)
            live = torch.as_tensor(mask, device=lat.device) \
                & (torch.as_tensor(rel, device=lat.device) > 0)
            return torch.where(live, lat.to(torch.int64),
                               simtime.INVALID).cpu().numpy().reshape(-1)

        def attribute(sim, wstart):
            wstart = int(wstart)
            flat = table(sim, wstart)
            k = int(np.argmin(flat))      # first min: deterministic edge
            jump_u = int(flat[k])
            jump = min(max(jump_u, jump0), end + 1)
            # at (or below) the floor the edge is not the constraint
            adaptive = jump_u > jump0
            cause = CAUSE_ADAPTIVE_EDGE if adaptive else CAUSE_MIN_JUMP
            edge_a, edge_b = (k // V, k % V) if adaptive else (-1, -1)
            wend, cause = clamps(wstart + jump, cause, wstart)
            return wend, cause, edge_a, edge_b, jump

    def wend_fn(sim, wstart):
        return attribute(sim, wstart)[0]

    def explain(sim, wstart):
        from shadow_tpu_torch.inject.staging import wend_clamp

        wend, cause, edge_a, edge_b, raw = attribute(sim, wstart)
        clamped = wend_clamp(sim, wend)
        if clamped < wend:
            cause, wend = CAUSE_INJECT_HORIZON, clamped
        return wend, cause, edge_a, edge_b, raw

    wend_fn.explain = explain
    return wend_fn


def make_chunk_body(step_fn: StepFn, *, end_time: int, wend_fn,
                    chunk_windows: int, emit_capacity: int = 4,
                    lane_fn=None, bulk_fn=None, telem_fn=None,
                    sparse_lanes: int = 0, fault_fn=None, flow_fn=None,
                    route_fn=None, min_fn=None, census_fn=None,
                    sentinel_fn=None):
    """Build ``chunk(sim, stats, wstart) -> (sim, stats, wstart')``: up
    to `chunk_windows` step_window rounds while ``wstart <= end_time``,
    each ending at ``wend_fn(sim, wstart)`` (make_wend_fn) — the
    window sequence of `run`. A chunk dispatched past the end (or on
    an empty queue: wstart INVALID) returns its carry unchanged, so
    callers chain chunks without an end check of their own.

    The reference's device while_loop becomes a Python loop. step_window
    already reads each next window start to the host, so no chunk runs
    ahead of the host: the chunk boundary is only where the caller's
    hooks and snapshots run. ``lane_fn(sim)`` gives step_window's
    lane_id, once per chunk; the fault rewrite, the bulk pass, the ring
    and the sparse fast path run per window as in `run`.

    Streamed injection: a Sim carrying a staging buffer clamps every
    wend to its horizon (the first trace event the host has NOT yet
    staged) and stops the chunk at a window that would start there, so
    no event merges late; the host refills and dispatches again. The
    horizon is read to the host once per chunk (only the feeder writes
    it, between chunks); INVALID never binds.

    A Sim carrying `causality` takes each window's end from
    ``wend_fn.explain`` (the same wend, the horizon clamp included) and
    latches its attribution. `flow_fn`, `sentinel_fn` and the mesh
    hooks `route_fn`, `min_fn` and `census_fn` are step_window's."""
    if int(chunk_windows) < 1:
        raise ValueError(
            f"chunk_windows must be >= 1, got {chunk_windows}")
    end = int(end_time)
    K = int(chunk_windows)

    explain = getattr(wend_fn, "explain", None)

    def chunk(sim, stats, wstart):
        wstart = int(wstart)
        lane = None if lane_fn is None else lane_fn(sim)
        st = getattr(sim, "inject", None)
        horizon = simtime.INVALID if st is None else int(st.horizon)
        tracing = (getattr(sim, "causality", None) is not None
                   and explain is not None)
        i = 0
        while i < K and wstart <= end and wstart < horizon:
            adv = None
            if tracing:
                # explain applies the horizon clamp and its cause
                wend, cause, edge_a, edge_b, raw = explain(sim, wstart)
                adv = (cause, edge_a, edge_b, raw)
            else:
                wend = min(wend_fn(sim, wstart), horizon)
            sim, stats, wstart = step_window(
                sim, stats, step_fn, wend, emit_capacity,
                lane, bulk_fn=bulk_fn, telem_fn=telem_fn, wstart=wstart,
                sparse_lanes=sparse_lanes, fault_fn=fault_fn,
                flow_fn=flow_fn, adv_attr=adv, route_fn=route_fn,
                min_fn=min_fn, census_fn=census_fn,
                sentinel_fn=sentinel_fn)
            i += 1
        return sim, stats, wstart

    return chunk


def run(sim, step_fn: StepFn, *, end_time: int, min_jump: int,
        start_time: int = 0, emit_capacity: int = 4, lane_id=None,
        bulk_fn=None, telem_fn=None, sparse_lanes: int = 0,
        fault_times=None, fault_fn=None, flow_fn=None, route_fn=None,
        min_fn=None, census_fn=None, sentinel_fn=None):
    """Run the whole simulation. Window advance rule is the
    reference's: newStart = minNextEventTime, newEnd = newStart +
    minJump, clamped to end_time + 1 (ref: master.c:450-480). The first
    window starts at max(min pending time, start_time). `fault_times`
    (record times) clamps each window at the next record > wstart — the
    rule of make_wend_fn; `fault_fn` is step_window's.

    A Sim carrying an injection staging buffer must hold the whole
    trace (inject.Feeder.fill_all: the run never returns to the host to
    refill); its staged minimum joins the first-window rule, so a
    trace-only run (empty queue) still starts.

    A Sim carrying `causality` latches every window's attribution by
    the static rule of make_wend_fn's explain (floor, record, end; the
    raw jump is the floored min_jump), as the reference's whole-run
    program does. `flow_fn`, `sentinel_fn` and the mesh hooks
    `route_fn`, `min_fn` (which also reduces the first window start)
    and `census_fn` are step_window's."""
    from shadow_tpu_torch.telemetry.causality import (
        CAUSE_END_TIME,
        CAUSE_FAULT_RECORD,
        CAUSE_MIN_JUMP,
    )
    if min_jump <= 0:
        raise ValueError(f"min_jump must be positive, got {min_jump}")
    end_time = int(end_time)
    jump = max(int(min_jump), 1)
    ft = _record_times(fault_times)
    stats = EngineStats.create(device=sim.events.time.device)
    first = int(global_min_time(sim))
    wstart = max(first if min_fn is None else min_fn(first),
                 int(start_time))
    while wstart <= end_time:
        wend, cause = wstart + jump, CAUSE_MIN_JUMP
        nxt = _next_record(ft, wstart)
        if nxt < wend:
            cause, wend = CAUSE_FAULT_RECORD, nxt
        if end_time + 1 < wend:
            cause, wend = CAUSE_END_TIME, end_time + 1
        sim, stats, wstart = step_window(
            sim, stats, step_fn, wend, emit_capacity, lane_id,
            bulk_fn=bulk_fn, telem_fn=telem_fn, wstart=wstart,
            sparse_lanes=sparse_lanes, fault_fn=fault_fn,
            flow_fn=flow_fn, adv_attr=(cause, -1, -1, jump),
            route_fn=route_fn, min_fn=min_fn, census_fn=census_fn,
            sentinel_fn=sentinel_fn)
    return sim, stats
