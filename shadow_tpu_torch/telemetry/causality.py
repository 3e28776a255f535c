"""Causal critical-path profiling: event lineage + advance attribution
(PyTorch port of shadow_tpu/telemetry/causality.py).

Two device-resident planes answer the two "why is it slow" questions a
conservative windowed PDES has (ref: master.c:450-480):

- an **event-lineage recorder**: inside the window fixpoint every
  emitted event is sampled by the flow recorder's hash discipline
  (flows.sample_hash over the event's (time, dst, src, seq) identity)
  and appended into a per-HOST sub-ring with its PARENT event key (the
  popped event whose handler emitted it), destination, kind and depth.
  Appends are row-local one-hot selects. Host-side, (parent key ->
  record key) joins rebuild the longest causal chains.
- a **window-advance attribution plane**: once per window the drivers
  latch WHICH constraint bound wend (CAUSE_* below), the jump against
  the available lookahead, and the active-row census.

The reference's keys are uint64; the port carries the same bits in
int64 (flows.py), and convert.py / the harvester give them back as
uint64. Opt-in like Sim.telem: Sim.causality defaults to None and adds
no leaf; attach_causality() is the opt-in.

Coverage: lineage records the emissions of the window FIXPOINT. Events
a bulk pass (net/bulk.py) consumes never enter the fixpoint and are not
recorded — the reference's own documented behaviour.

Cost: lineage_update is a Python loop over the emission buffer's E
slots of seven one-hot puts over [H, F] planes each, per micro-step;
advance_latch is seven masked stores a window. Neither reads anything
back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core.events import _onehot, _put, _Replace, static
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.telemetry.flows import (
    _pct_sorted,
    hash_mod,
    path_of_host,
    sample_hash,
)

I32 = torch.int32
I64 = torch.int64

DEFAULT_CAPACITY = 64          # lineage records per HOST sub-ring
DEFAULT_ADV_CAPACITY = 4096    # advance-attribution window records
DEFAULT_SAMPLE_PERIOD = 64     # keep 1-in-N emissions (same as flows)

# Window-advance binding causes, in clamp-priority order: each clamp
# that STRICTLY lowers wend overwrites the cause, so ties report the
# earlier (weaker) constraint — deterministic on every path.
CAUSE_MIN_JUMP = 0        # static floor (or adaptive jump at the floor)
CAUSE_ADAPTIVE_EDGE = 1   # live latency table min over pair_mask
CAUSE_FAULT_RECORD = 2    # clamped to the next fault-plan record time
CAUSE_INJECT_HORIZON = 3  # clamped to the injection staging horizon
CAUSE_END_TIME = 4        # clamped to end_time + 1

CAUSE_NAMES = ("min_jump_floor", "adaptive_edge", "fault_record",
               "inject_horizon", "end_time")


def cause_name(code: int) -> str:
    return (CAUSE_NAMES[code] if 0 <= code < len(CAUSE_NAMES)
            else f"unknown_{code}")


# lineage plane name -> dtype, in record order (harvest.py drains in
# this order; CausalityRecord fields are (host, index) + LINEAGE_PLANES).
# key and parent are the reference's uint64, held as int64 here.
LINEAGE_PLANES = (
    ("key", I64),
    ("parent", I64),
    ("dst", I32),
    ("kind", I32),
    ("depth", I64),
    ("t_emit", I64),
    ("t_due", I64),
)
# the planes whose int64 bits are a uint64 in the reference
U64_PLANES = ("key", "parent")

# advance plane name -> dtype (AdvanceRecord fields are (index,) + these)
ADVANCE_PLANES = (
    ("adv_wstart", I64),
    ("adv_wend", I64),
    ("adv_raw", I64),
    ("adv_cause", I32),
    ("adv_edge_a", I32),
    ("adv_edge_b", I32),
    ("adv_active", I64),
)


@dataclasses.dataclass
class CausalityState(_Replace):
    """Per-host lineage sub-rings + the advance plane."""

    # --- lineage: [H, F] row-local planes; appends never leave the row
    key: torch.Tensor      # [H, F] u64 bits  sample_hash of the emission
    parent: torch.Tensor   # [H, F] u64 bits  sample_hash of the parent
    dst: torch.Tensor      # [H, F] i32  destination host
    kind: torch.Tensor     # [H, F] i32  emitted event kind
    depth: torch.Tensor    # [H, F] i64  events executed on this host so far
    t_emit: torch.Tensor   # [H, F] i64  parent execution time
    t_due: torch.Tensor    # [H, F] i64  emitted event timestamp
    count: torch.Tensor    # [H] i64  monotonic per host; slot = count % F
    seen: torch.Tensor     # [H] i64  ALL emissions observed
    execs: torch.Tensor    # [H] i64  events executed per host
    # --- advance attribution: [W]
    adv_wstart: torch.Tensor  # [W] i64
    adv_wend: torch.Tensor    # [W] i64
    adv_raw: torch.Tensor     # [W] i64  available lookahead before clamps
    adv_cause: torch.Tensor   # [W] i32  CAUSE_* code
    adv_edge_a: torch.Tensor  # [W] i32  binding vertex pair (adaptive), -1
    adv_edge_b: torch.Tensor  # [W] i32
    adv_active: torch.Tensor  # [W] i64  active-row census
    adv_count: torch.Tensor   # [] i64  monotonic; slot = adv_count % W
    sample_period: int = static(DEFAULT_SAMPLE_PERIOD)

    @property
    def capacity(self) -> int:
        return self.key.shape[1]

    @property
    def adv_capacity(self) -> int:
        return self.adv_wstart.shape[0]

    @property
    def num_hosts(self) -> int:
        return self.key.shape[0]

    @staticmethod
    def create(num_hosts: int, capacity: int = DEFAULT_CAPACITY,
               sample_period: int = DEFAULT_SAMPLE_PERIOD,
               adv_capacity: int = DEFAULT_ADV_CAPACITY,
               device=None) -> "CausalityState":
        """Empty planes on `device` (None -> "cuda"; raises without
        CUDA)."""
        if capacity < 1:
            raise ValueError(
                f"causality ring capacity must be >= 1, got {capacity}")
        if sample_period < 1:
            raise ValueError(
                f"causality sample period must be >= 1, got "
                f"{sample_period}")
        if adv_capacity < 1:
            raise ValueError(
                f"causality advance capacity must be >= 1, got "
                f"{adv_capacity}")
        dev = resolve_device(device)
        H = int(num_hosts)
        lineage = {n: torch.zeros((H, capacity), dtype=dt, device=dev)
                   for n, dt in LINEAGE_PLANES}
        adv = {n: torch.zeros((adv_capacity,), dtype=dt, device=dev)
               for n, dt in ADVANCE_PLANES}

        def zh():
            return torch.zeros((H,), dtype=I64, device=dev)
        return CausalityState(
            count=zh(), seen=zh(), execs=zh(),
            adv_count=torch.zeros((), dtype=I64, device=dev),
            sample_period=int(sample_period), **lineage, **adv)


def attach_causality(sim, sample_period: int = DEFAULT_SAMPLE_PERIOD,
                     capacity: int = DEFAULT_CAPACITY,
                     adv_capacity: int = DEFAULT_ADV_CAPACITY):
    """Return `sim` with causality tracing on its device attached
    (no-op if it already is)."""
    if getattr(sim, "causality", None) is not None:
        return sim
    return sim.replace(causality=CausalityState.create(
        int(sim.events.num_hosts), capacity, sample_period,
        adv_capacity, device=sim.events.time.device))


def lineage_update(sim, popped, buf, lane_id=None):
    """Record this micro-step's sampled emissions. Called from
    window_fixpoint after step_fn and BEFORE apply_emissions: each
    emission's per-source seq is recomputed exactly as apply_emissions
    will assign it (q.next_seq + the valid earlier slots of the row),
    so the emitted event hashes to the key its execution will hash to
    as a parent. The parent key hashes `lane` — the row's global host
    id, the row index when `lane_id` is None — as the popped event's
    destination. All writes are row-local one-hot selects."""
    cz = sim.causality
    q = sim.events
    H, E = buf.dst.shape
    F = cz.capacity
    P = cz.sample_period
    dev = buf.dst.device
    lane = (torch.arange(H, dtype=I32, device=dev) if lane_id is None
            else lane_id.to(I32))
    # depth counts the parent whose handler just ran, so a same-host
    # child always records a strictly greater depth than its parent
    execs = cz.execs + popped.valid.to(I64)
    parent = torch.where(
        popped.valid,
        sample_hash(popped.time, lane, popped.src, popped.seq), 0)
    key_p, par_p = cz.key, cz.parent
    dst_p, kind_p = cz.dst, cz.kind
    dep_p, te_p, td_p = cz.depth, cz.t_emit, cz.t_due
    count, seen = cz.count, cz.seen
    nvalid = torch.zeros((H,), dtype=I32, device=dev)
    for e in range(E):
        d = buf.dst[:, e]
        v = d >= 0
        seq = q.next_seq + nvalid          # apply_emissions' assignment
        k = sample_hash(buf.time[:, e], d, lane, seq)
        keep = v & (hash_mod(k, P) == 0)
        sel = _onehot(keep, count % F, F)
        key_p = _put(key_p, sel, k)
        par_p = _put(par_p, sel, parent)
        dst_p = _put(dst_p, sel, d)
        kind_p = _put(kind_p, sel, buf.kind[:, e])
        dep_p = _put(dep_p, sel, execs)
        te_p = _put(te_p, sel, popped.time)
        td_p = _put(td_p, sel, buf.time[:, e])
        count = count + keep.to(I64)
        seen = seen + v.to(I64)
        nvalid = nvalid + v.to(I32)
    return sim.replace(causality=cz.replace(
        key=key_p, parent=par_p, dst=dst_p, kind=kind_p, depth=dep_p,
        t_emit=te_p, t_due=td_p, count=count, seen=seen, execs=execs))


def advance_latch(sim, wstart, wend, cause, edge_a, edge_b, raw_jump,
                  n_active):
    """Latch one window's advance attribution (once per window, from
    step_window). The host ints and the census tensor are written as
    masked stores at slot adv_count % W."""
    cz = sim.causality
    W = cz.adv_capacity
    sel = (torch.arange(W, dtype=I64, device=cz.adv_count.device)
           == cz.adv_count % W)

    def put(plane, val):
        if isinstance(val, torch.Tensor):
            val = val.to(plane.dtype)
        return torch.where(sel, val, plane)

    cz = cz.replace(
        adv_wstart=put(cz.adv_wstart, int(wstart)),
        adv_wend=put(cz.adv_wend, int(wend)),
        adv_raw=put(cz.adv_raw, int(raw_jump)),
        adv_cause=put(cz.adv_cause, int(cause)),
        adv_edge_a=put(cz.adv_edge_a, int(edge_a)),
        adv_edge_b=put(cz.adv_edge_b, int(edge_b)),
        adv_active=put(cz.adv_active,
                       -1 if n_active is None else n_active),
        adv_count=cz.adv_count + 1)
    return sim.replace(causality=cz)


# ---------------------------------------------------------------- host

@dataclasses.dataclass
class CausalityRecord:
    """One harvested lineage record (host-side ints). `key` is the
    emitted event's identity hash; `parent` the identity hash of the
    event whose handler emitted it. A chain edge exists where some
    record's key equals another's parent AND the times agree
    (child.t_emit == parent.t_due) — the time check screens out the
    astronomically-unlikely 64-bit hash collision."""

    host: int
    index: int     # per-host monotonic ring index
    key: int
    parent: int
    dst: int
    kind: int
    depth: int
    t_emit: int
    t_due: int


@dataclasses.dataclass
class AdvanceRecord:
    """One harvested window-advance attribution record."""

    index: int
    wstart: int
    wend: int
    raw: int       # available lookahead (ns) before record/end clamps
    cause: int     # CAUSE_* code
    edge_a: int    # binding vertex pair under adaptive jump, else -1
    edge_b: int
    active: int    # global active-lane census at window start, -1 n/a

    @property
    def jump(self) -> int:
        return self.wend - self.wstart

    @property
    def utilization_pct(self) -> int | None:
        """Realized jump as an integer percentage of the available
        lookahead (None when raw is degenerate)."""
        if self.raw <= 0:
            return None
        return max(0, min(100, (self.jump * 100) // self.raw))


def critical_chains(records, top_k: int = 5, max_events: int = 32
                    ) -> list:
    """Reconstruct the longest causal chains from harvested lineage
    records by walking (record.parent -> record.key) joins. Chains only
    link where the parent emission was ITSELF sampled (probability 1/P
    per edge at period P; P=1 records every emission and recovers full
    lineage). Returns up to `top_k` chain dicts, longest first, each
    with per-host / per-kind composition and at most `max_events`
    events (tail-truncated towards the chain head)."""
    by_key: dict = {}
    for r in records:
        # duplicate keys (ring wrap re-harvest or a true collision):
        # keep the first — joins stay deterministic
        by_key.setdefault(r.key, r)

    length: dict = {}
    link: dict = {}

    def resolve(rec):
        # iterative parent walk with memoization; a visited set breaks
        # the (collision-only) possibility of a key cycle
        stack, seen_keys = [], set()
        cur = rec
        while True:
            if cur.key in length:
                break
            par = by_key.get(cur.parent)
            ok = (par is not None and par.key != cur.key
                  and par.key not in seen_keys
                  and par.t_due == cur.t_emit)
            if not ok:
                length[cur.key] = 1
                link[cur.key] = None
                break
            stack.append(cur)
            seen_keys.add(cur.key)
            cur = par
        while stack:
            child = stack.pop()
            par = by_key[child.parent]
            length[child.key] = length[par.key] + 1
            link[child.key] = par.key

    for r in by_key.values():
        resolve(r)

    heads = sorted(by_key.values(),
                   key=lambda r: (-length[r.key], r.t_due, r.host,
                                  r.index))
    chains = []
    used = set()
    for head in heads:
        if len(chains) >= top_k:
            break
        if head.key in used:
            continue
        path = []
        k = head.key
        while k is not None:
            rec = by_key[k]
            path.append(rec)
            used.add(k)
            k = link[k]
        path.reverse()     # root first
        per_host: dict = {}
        per_kind: dict = {}
        for rec in path:
            per_host[str(rec.host)] = per_host.get(str(rec.host), 0) + 1
            per_kind[str(rec.kind)] = per_kind.get(str(rec.kind), 0) + 1
        chains.append({
            "length": len(path),
            "span_ns": int(path[-1].t_due - path[0].t_emit),
            "hosts": len(per_host),
            "per_host": per_host,
            "per_kind": per_kind,
            "events": [{
                "key": int(rec.key), "host": int(rec.host),
                "dst": int(rec.dst), "kind": int(rec.kind),
                "depth": int(rec.depth), "t_emit": int(rec.t_emit),
                "t_due": int(rec.t_due),
            } for rec in path[-max_events:]],
        })
    return chains


def binding_histogram(adv_records) -> dict:
    """{cause name: window count} over harvested advance records."""
    out: dict = {}
    for r in adv_records:
        n = cause_name(r.cause)
        out[n] = out.get(n, 0) + 1
    return out


def binding_edges(adv_records) -> dict:
    """Per-edge binding counts for adaptive windows: how often each
    latency-table vertex pair (a, b) was THE constraint that sized the
    window — binding frequency, the weight the placement pass wants
    (ROADMAP item 1), as opposed to traffic volume."""
    out: dict = {}
    for r in adv_records:
        if r.cause == CAUSE_ADAPTIVE_EDGE and r.edge_a >= 0:
            k = f"v{r.edge_a}->v{r.edge_b}"
            out[k] = out.get(k, 0) + 1
    return out


def lineage_traffic_matrix(records, *, num_hosts: int,
                           path_shards: int) -> list:
    """[S][S] cross-host sampled-emission counts by (src path, dst
    path) — the causality twin of flows.traffic_matrix. Built from the
    same hash-sampled identities, so with equal sample periods and
    zero losses on both sides the two matrices are EQUAL (the lint
    cross-checks this when both blocks are present)."""
    S = max(1, int(path_shards))
    m = [[0] * S for _ in range(S)]
    for r in records:
        if r.dst == r.host:
            continue
        a = path_of_host(r.host, num_hosts, S)
        b = path_of_host(r.dst, num_hosts, S)
        m[a][b] += 1
    return m


def causality_manifest_block(harvester, *, num_hosts: int,
                             shards: int = 1,
                             sample_period: int | None = None,
                             path_shards: int = 1,
                             top_k: int = 5) -> dict | None:
    """Build the manifest's top-level "causality" block from a
    Harvester's drained lineage + advance records. None when the run
    carried no causality state. tools/telemetry_lint.py reconciles
    harvested + lost_ring against sampled, the binding-cause counts
    against the attributed window count, chain time/depth monotonicity,
    and the traffic matrix against the flows block when both are
    present (tools/critpath.py then reads this block for the
    speed-of-light report)."""
    if not getattr(harvester, "caus_enabled", False):
        return None
    recs = harvester.caus_records
    advs = harvester.adv_records
    cross = [r for r in recs if r.dst != r.host]
    out = {
        "sampled": int(harvester.caus_sampled),
        "emitted": int(harvester.caus_emitted),
        "harvested": len(recs),
        "lost_ring": int(harvester.caus_lost),
        "cross_host_harvested": len(cross),
        "windows_attributed": len(advs),
        "windows_lost": int(harvester.adv_lost),
        "path_shards": max(1, int(path_shards)),
    }
    if sample_period is not None:
        out["sample_period"] = int(sample_period)
    out["chains"] = critical_chains(recs, top_k=top_k)
    out["causes"] = binding_histogram(advs)
    out["edges"] = binding_edges(advs)
    # the per-window record list (bounded by the adv ring capacity):
    # tools/trace_view.py draws the jump sparkline from it and
    # tools/critpath.py groups its window cohorts by cause
    out["advances"] = [{
        "wstart": int(r.wstart), "jump": int(r.jump),
        "raw": int(r.raw), "cause": cause_name(r.cause),
        **({"edge": f"v{r.edge_a}->v{r.edge_b}"} if r.edge_a >= 0
           else {}),
        **({"utilization_pct": r.utilization_pct}
           if r.utilization_pct is not None else {}),
        **({"active": int(r.active)} if r.active >= 0 else {}),
    } for r in advs]
    utils = sorted(u for u in (r.utilization_pct for r in advs)
                   if u is not None)
    if utils:
        out["jump_utilization_pct"] = {
            "p50": _pct_sorted(utils, 50),
            "p95": _pct_sorted(utils, 95),
            "p99": _pct_sorted(utils, 99),
            "mean": int(sum(utils) // len(utils)),
        }
    H = max(1, int(num_hosts))
    idles = sorted(max(0, min(100, ((H - r.active) * 100) // H))
                   for r in advs if r.active >= 0)
    if idles:
        out["idle_lane_pct"] = {
            "p50": _pct_sorted(idles, 50),
            "p95": _pct_sorted(idles, 95),
            "p99": _pct_sorted(idles, 99),
        }
    out["traffic_matrix"] = lineage_traffic_matrix(
        cross, num_hosts=num_hosts, path_shards=path_shards)
    return out
