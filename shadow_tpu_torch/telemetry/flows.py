"""Device-resident flow flight-recorder: per-packet latency sampling
(PyTorch port of shadow_tpu/telemetry/flows.py, single shard).

A FlowRing is a fixed-capacity ring of per-packet records appended at
the window barrier from the staged outbox (every cross-host send passes
through the outbox exactly once; same-host deliveries never cross the
fabric and are not sampled).

Record fields (one [F] plane each): src / dst (global host ids), lane
(isolation lane of the src host, 0 without lane isolation), kind,
flags (FLAG_LOOPBACK, FLAG_CROSS_VERTEX, FLAG_CROSS_LANE), t_enq (the
window start), t_route (the window end) and t_deliver (the event's
delivery timestamp).

Sampling is a pure hash of (time, dst, src, seq) — the splitmix64
finalizer, keep when hash % sample_period == 0. The reference computes
it in uint64; the port carries the same 64 bits in int64: XOR and the
low 64 bits of a product are the same, constants at or above 2**63 are
written as their two's complement, right shifts are made logical by a
mask, and the remainder is the unsigned one.

Append order is the (source host, outbox slot) order, and the append
is scatter-free: each ring slot has at most one writing rank, found by
a searchsorted over the keep-cumsum. Per-window appends are clamped to
the capacity; `count` is the monotonic stored-record counter (slot =
count % F), and `sampled` / `lost` keep count + lost == sampled.
The reference's sharded merge (an all_gather of the per-shard counts
and a psum of the plane deltas) waits for the mesh (ROADMAP.md Queue 1
item 9): make_flow_fn refuses an axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core.events import _Replace, static
from shadow_tpu_torch.device import resolve_device

I32 = torch.int32
I64 = torch.int64

# plane name -> dtype, in record order (harvest.py drains in this
# order; FlowRecord fields are (index,) + FLOW_PLANES)
FLOW_PLANES = (
    ("src", I32),
    ("dst", I32),
    ("lane", I32),
    ("kind", I32),
    ("flags", I32),
    ("t_enq", I64),
    ("t_route", I64),
    ("t_deliver", I64),
)

DEFAULT_CAPACITY = 4096
DEFAULT_SAMPLE_PERIOD = 64

FLAG_LOOPBACK = 1       # src == dst (defensive: the outbox is cross-host)
FLAG_CROSS_VERTEX = 2   # src/dst attach to different topology vertices
FLAG_CROSS_LANE = 4     # src/dst in different isolation lanes


@dataclass
class FlowRing(_Replace):
    """Fixed-capacity ring of sampled per-packet records."""

    src: torch.Tensor        # [F] i32
    dst: torch.Tensor        # [F] i32
    lane: torch.Tensor       # [F] i32
    kind: torch.Tensor       # [F] i32
    flags: torch.Tensor      # [F] i32
    t_enq: torch.Tensor      # [F] i64
    t_route: torch.Tensor    # [F] i64
    t_deliver: torch.Tensor  # [F] i64
    count: torch.Tensor      # [] i64 monotonic; slot = count % F
    sampled: torch.Tensor    # [] i64 cumulative (stored + clamped)
    lost: torch.Tensor       # [] i64 count + lost == sampled
    # keep 1-in-N when hash(time, dst, src, seq) % N == 0
    sample_period: int = static(DEFAULT_SAMPLE_PERIOD)

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    @staticmethod
    def create(capacity: int = DEFAULT_CAPACITY,
               sample_period: int = DEFAULT_SAMPLE_PERIOD,
               device=None) -> "FlowRing":
        """An empty ring on `device` (None -> "cuda"; raises without
        CUDA)."""
        if capacity < 1:
            raise ValueError(
                f"flow ring capacity must be >= 1, got {capacity}")
        if sample_period < 1:
            raise ValueError(
                f"flow sample period must be >= 1, got {sample_period}")
        dev = resolve_device(device)
        planes = {n: torch.zeros((capacity,), dtype=dt, device=dev)
                  for n, dt in FLOW_PLANES}

        def z():
            return torch.zeros((), dtype=I64, device=dev)
        return FlowRing(count=z(), sampled=z(), lost=z(),
                        sample_period=int(sample_period), **planes)


def attach_flows(sim, sample_period: int = DEFAULT_SAMPLE_PERIOD,
                 capacity: int = DEFAULT_CAPACITY):
    """Return `sim` with a flow ring on its device attached (no-op if
    one already is). Sim.flows defaults to None, which adds no leaf."""
    if getattr(sim, "flows", None) is not None:
        return sim
    return sim.replace(flows=FlowRing.create(
        capacity, sample_period, device=sim.events.time.device))


def _i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


_M_MIX1 = _i64(0xBF58476D1CE4E5B9)
_M_MIX2 = _i64(0x94D049BB133111EB)
_M_DST = _i64(0x9E3779B97F4A7C15)
_M_SRC = _i64(0xC2B2AE3D27D4EB4F)
_M_SEQ = _i64(0x165667B19E3779F9)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 held in int64 `x`."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (u64 wrap-around arithmetic in int64)."""
    x = (x ^ _srl(x, 30)) * _M_MIX1
    x = (x ^ _srl(x, 27)) * _M_MIX2
    return x ^ _srl(x, 31)


def sample_hash(time, dst, src, seq) -> torch.Tensor:
    """The reference's u64 sampling key over the flow identity, as the
    int64 with the same bits. The inputs widen as the reference's
    casts to uint64 do (an int32 -1 becomes all ones)."""
    k = time.to(I64)
    k = k ^ (dst.to(I64) * _M_DST)
    k = k ^ (src.to(I64) * _M_SRC)
    k = k ^ (seq.to(I64) * _M_SEQ)
    return _mix64(k)


def hash_mod(k: torch.Tensor, period: int) -> torch.Tensor:
    """The unsigned remainder of the u64 held in int64 `k` by
    `period` (>= 1)."""
    P = int(period)
    r = torch.remainder(k, P)
    # a negative k is the u64 k + 2**64
    return torch.where(k < 0, torch.remainder(r + (1 << 64) % P, P), r)


def make_flow_fn(axis: str | None = None):
    """Build the engine's flow_fn(sim, wstart, wend) -> sim hook. It
    runs inside step_window right after telem_fn, after the window
    fixpoint and BEFORE the route, so the outbox still holds the
    window's staged sends. When sim.flows is None it returns `sim`
    untouched. Reads nothing back to the host.

    `axis` (the reference's shard_map mesh axis) is refused: the
    sharded merge waits for the mesh (ROADMAP.md Queue 1 item 9)."""
    if axis is not None:
        raise NotImplementedError(
            "shadow_tpu_torch: the sharded flow merge (axis=...) is not "
            "ported yet (ROADMAP.md Queue 1 item 9)")

    def flow_fn(sim, wstart, wend):
        ring = getattr(sim, "flows", None)
        if ring is None:
            return sim

        out = sim.outbox
        Hl, M = out.dst.shape
        F = ring.capacity
        dev = out.dst.device

        keep = out.occupied() & (hash_mod(sample_hash(
            out.time, out.dst, out.src, out.seq), ring.sample_period) == 0)
        # flattened in (row, slot) order: ascending global host ids
        csum = torch.cumsum(keep.reshape(-1).to(I64), dim=0)
        cnt = csum[-1]

        # Scatter-free append: ring slot s takes the rank
        # r = (s - count) mod F kept entry when r < cnt (r < F is the
        # capacity clamp, true by construction on one shard); that
        # entry's flattened outbox index is the first position whose
        # keep-cumsum reaches r + 1
        s = torch.arange(F, dtype=I64, device=dev)
        r = torch.remainder(s - ring.count, F)
        valid = r < cnt
        i = torch.searchsorted(csum, r + 1).clamp(0, Hl * M - 1)

        src = out.src.reshape(-1)[i]
        dst = out.dst.reshape(-1)[i]
        kind = out.kind.reshape(-1)[i]
        t_del = out.time.reshape(-1)[i]
        voh = sim.net.vertex_of_host
        GH = voh.shape[0]
        lanes_st = getattr(sim, "lanes", None)
        if lanes_st is not None:
            from shadow_tpu_torch.core.lanes import lane_of_host

            R = lanes_st.replicas
            lane_src = lane_of_host(src, GH, R).to(I32)
            lane_dst = lane_of_host(dst, GH, R).to(I32)
        else:
            lane_src = torch.zeros_like(src)
            lane_dst = lane_src
        # the dst == -1 empties are clamped for the gather; those slots
        # are never valid
        vsrc = voh[src.clamp(0, GH - 1).long()]
        vdst = voh[dst.clamp(0, GH - 1).long()]
        flags = ((src == dst).to(I32) * FLAG_LOOPBACK
                 + (vsrc != vdst).to(I32) * FLAG_CROSS_VERTEX
                 + (lane_src != lane_dst).to(I32) * FLAG_CROSS_LANE)

        vals = {"src": src, "dst": dst, "lane": lane_src, "kind": kind,
                "flags": flags, "t_enq": int(wstart),
                "t_route": int(wend), "t_deliver": t_del}
        new = {}
        for n, v in vals.items():
            old = getattr(ring, n)
            v = v.to(old.dtype) if isinstance(v, torch.Tensor) else v
            new[n] = torch.where(valid, v, old)
        appended = torch.clamp(cnt, max=F)
        ring = ring.replace(
            count=ring.count + appended,
            sampled=ring.sampled + cnt,
            lost=ring.lost + (cnt - appended),
            **new)
        return sim.replace(flows=ring)

    return flow_fn


# --- host side: records -> histograms / percentiles / traffic matrix --

@dataclass
class FlowRecord:
    """One harvested flow sample (host-side ints). Field order is
    (index,) + FLOW_PLANES — the harvester constructs positionally."""

    index: int      # monotonic append position (ring count at write)
    src: int
    dst: int
    lane: int
    kind: int
    flags: int
    t_enq: int
    t_route: int
    t_deliver: int

    @property
    def latency_ns(self) -> int:
        """Staging-to-delivery latency: t_enq is the window start, so
        this over-approximates the true span by less than a window."""
        return self.t_deliver - self.t_enq


def path_of_host(h: int, num_hosts: int, path_shards: int) -> int:
    """Contiguous-block shard of a host (shard s owns [s*Hl, (s+1)*Hl)).
    `path_shards` is a host-side choice: the run's shard count, or a
    candidate count to evaluate a placement."""
    if path_shards <= 1 or num_hosts <= 0:
        return 0
    block = max(1, num_hosts // path_shards)
    return min(h // block, path_shards - 1)


def _pct_sorted(vals: list, q: float) -> int:
    """Nearest-rank percentile over a pre-sorted int list (integer
    selection, no interpolation)."""
    if not vals:
        return 0
    i = min(len(vals) - 1, max(0, round(q / 100 * (len(vals) - 1))))
    return vals[i]


def _log2_bucket_lo(lat: int) -> int:
    """Lower bound of the log2 latency bucket holding `lat` ns: bucket
    [2^b, 2^(b+1)) for lat >= 1; lat <= 0 lands in bucket 0."""
    if lat < 1:
        return 0
    return 1 << (int(lat).bit_length() - 1)


def latency_histograms(records, *, num_hosts: int, path_shards: int = 1
                       ) -> dict:
    """Log-bucketed latency histograms keyed by
    "lane<r>/<srcshard>-><dstshard>/k<kind>": count, nearest-rank
    p50/p95/p99 and the sparse bucket map {bucket_lo_ns: count}."""
    lats: dict[str, list] = {}
    for r in records:
        key = (f"lane{r.lane}/"
               f"{path_of_host(r.src, num_hosts, path_shards)}->"
               f"{path_of_host(r.dst, num_hosts, path_shards)}/"
               f"k{r.kind}")
        lats.setdefault(key, []).append(r.latency_ns)
    out = {}
    for key in sorted(lats):
        vs = sorted(lats[key])
        buckets: dict[str, int] = {}
        for v in vs:
            lo = str(_log2_bucket_lo(v))
            buckets[lo] = buckets.get(lo, 0) + 1
        out[key] = {
            "count": len(vs),
            "p50_ns": _pct_sorted(vs, 50),
            "p95_ns": _pct_sorted(vs, 95),
            "p99_ns": _pct_sorted(vs, 99),
            "buckets": {k: buckets[k] for k in sorted(buckets, key=int)},
        }
    return out


def per_lane_latency(records) -> dict:
    """{lane: {count, p50_ns, p95_ns, p99_ns}}."""
    lats: dict[int, list] = {}
    for r in records:
        lats.setdefault(int(r.lane), []).append(r.latency_ns)
    out = {}
    for lane in sorted(lats):
        vs = sorted(lats[lane])
        out[str(lane)] = {
            "count": len(vs),
            "p50_ns": _pct_sorted(vs, 50),
            "p95_ns": _pct_sorted(vs, 95),
            "p99_ns": _pct_sorted(vs, 99),
        }
    return out


def traffic_matrix(records, *, num_hosts: int, path_shards: int) -> list:
    """[S][S] sampled-send counts between contiguous host blocks."""
    S = max(1, path_shards)
    mat = [[0] * S for _ in range(S)]
    for r in records:
        mat[path_of_host(r.src, num_hosts, S)][
            path_of_host(r.dst, num_hosts, S)] += 1
    return mat


def flows_manifest_block(harvester, *, num_hosts: int, shards: int = 1,
                         sample_period: int | None = None) -> dict | None:
    """The manifest's top-level "flows" block from a harvester that
    drained a flow ring; None when no flow tracing ran."""
    if harvester is None or not getattr(harvester, "flow_enabled", False):
        return None
    recs = harvester.flow_records
    S = max(1, int(shards))
    return {
        "sample_period": (int(sample_period)
                          if sample_period is not None else None),
        "sampled": int(harvester.flow_sampled),
        "recorded": int(harvester.flow_seen),
        "harvested": len(recs),
        "lost_ring": int(harvester.flow_lost),
        "lost_window_clamp": int(harvester.flow_lost_clamp),
        "path_shards": S,
        "histograms": latency_histograms(
            recs, num_hosts=num_hosts, path_shards=S),
        "per_lane": per_lane_latency(recs),
        "traffic_matrix": traffic_matrix(
            recs, num_hosts=num_hosts, path_shards=S),
    }
