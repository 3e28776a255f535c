"""Multi-rank execution: hosts sharded over the ranks of a
torch.distributed process group (PyTorch port of
shadow_tpu/parallel/shard.py).

The reference drives all its devices from one program (shard_map over a
jax Mesh). The port runs one process per shard, a rank, each holding
its block of host rows on its own device (or all of them on the one
card of a one-card machine), and the ranks meet in torch.distributed
collectives:

- Host rows (event queues, socket tables, NIC state) shard over
  contiguous blocks [r*Hl, (r+1)*Hl); the global lookup tables (IP
  maps, the latency/reliability matrices), the telemetry and flow
  rings, the injection staging buffer and every scalar replicate.
- The window fixpoint is purely rank-local: each rank drains its own
  hosts' events at its own pace, with no communication.
- Per window: the census of the sparse fast path (a sum, when armed),
  the exchange gate (a max) and exactly one all_to_all of the packed
  cross-shard events (route_outbox_sharded), and the next window start
  (a min). The telemetry ring adds a sum, a max and a min, the flow
  ring an all_gather and two sums.
- At each dispatch boundary (a whole run, a window or a chunk)
  _replicate_scalars sums every scalar leaf's delta over the ranks, so
  the state leaving a runner is replicated wherever the reference
  declares it so.

Determinism: event identity is (time, dst, src, per-source seq) and
pop order is a lexicographic argmin over those keys, and the exchange
inserts arrivals in the global (source row, emission slot) order, so
results are bit-identical for any shard count; only the outbox's
narrow_hit, narrow_miss, max_occupied and route_elided are per shard
count, as in the reference.

Backends (Mesh): NCCL when each rank has a card of its own, gloo on the
CPU and when several ranks share one card (NCCL refuses two ranks on
one device). gloo takes the CUDA tensors themselves (it copies them
through host memory on its own streams). A backend that fails to start
raises; every process group has a timeout of at most MAX_TIMEOUT_S, so
a collective that deadlocks fails.

The runners take the GLOBAL Sim, as built for one shard, and return
global state reassembled on every rank (unshard_sim, one all_gather per
dtype). make_sharded_window and make_sharded_chunk, the building
blocks of host-driven loops, keep the rank's LOCAL Sim between
dispatches: shard_sim / unshard_sim convert at the loop's boundary.

A Sim carrying the integrity sentinel (parallel/elastic.py) runs it at
every window barrier, after the route: one all_gather of the ranks'
digests. Mesh.abort tears a group down without waiting on a dead peer,
so the supervisor's elastic ladder can meet again on fewer ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import threading
import time
import traceback

import torch

from shadow_tpu_torch.convert import sim_tensors
from shadow_tpu_torch.core.engine import (
    EngineStats,
    make_chunk_body,
    resolve_sparse_lanes,
    run as engine_run,
    step_window,
)
from shadow_tpu_torch.core.events import (
    _pack_time,
    _unpack_time,
    clear_outbox,
    insert_flat,
    is_static,
    segment_ranks,
)
from shadow_tpu_torch.device import rank_device
from shadow_tpu_torch.net.state import REPLICATED_FIELDS, NetState
from shadow_tpu_torch.telemetry.flows import make_flow_fn
from shadow_tpu_torch.telemetry.ring import make_telem_fn

I32 = torch.int32
I64 = torch.int64

AXIS = "hosts"
# gloo's default collective timeout is 30 minutes; a deadlocked window
# must fail well before a run's time limit
MAX_TIMEOUT_S = 60.0
# how long each step of tearing a failed group down may take
ABORT_TIMEOUT_S = 10.0


def _bounded(fn, timeout_s: float) -> bool:
    """Run fn in a daemon thread; True when it returned within
    `timeout_s` (a teardown that hangs on a dead peer is left behind,
    never waited on forever)."""
    box = {}

    def run():
        try:
            fn()
        finally:
            box["done"] = True
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(box.get("done"))


def _choose_backend(device: torch.device, size: int) -> str:
    """NCCL when every rank has a card of its own, gloo on the CPU or
    when ranks share a card (NCCL refuses two ranks on one device)."""
    if device.type == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


class Mesh:
    """One rank's view of the port's mesh: the process group, the axis
    name, `size` ranks, this `rank`, and the rank's `device` (None ->
    "cuda": raises without CUDA; "cuda" picks cuda:{rank} on a machine
    with a card per rank and the one card otherwise; device.rank_device).

    A mesh of one rank has no process group and its collectives are
    the identity. A wider one joins a process group at `init_method`
    (``tcp://localhost:<port>``) on the backend _choose_backend names,
    with a `timeout_s` of at most MAX_TIMEOUT_S; a backend that fails
    to start raises. Construction logs the backend once (rank 0,
    stderr).

    Every collective is counted (`calls`, `bytes`) and timed on the
    host clock (`seconds`, which includes the wait for the slowest
    rank); the share of them that reassembled global state
    (unshard_sim) is counted again in `gather_calls`, `gather_bytes`
    and `gather_seconds`. reset_counters() zeroes them."""

    def __init__(self, size: int = 1, rank: int = 0, *, init_method=None,
                 device=None, axis: str = AXIS,
                 timeout_s: float = MAX_TIMEOUT_S):
        size, rank = int(size), int(rank)
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"bad mesh rank {rank} of {size}")
        if not 0 < float(timeout_s) <= MAX_TIMEOUT_S:
            raise ValueError(f"timeout_s must be in (0, {MAX_TIMEOUT_S}]")
        dev = rank_device(rank, device)
        self.size, self.rank, self.axis, self.device = size, rank, axis, dev
        self.shape = {axis: size}
        self.timeout_s = float(timeout_s)
        self.backend = None
        self.group = None
        self.reset_counters()
        if size == 1:
            return
        if init_method is None:
            raise ValueError("a mesh of more than one rank needs "
                             "init_method (tcp://localhost:<port>)")
        import torch.distributed as dist

        self.backend = _choose_backend(dev, size)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if self.backend == "nccl":
            # a failed or timed-out collective aborts the communicators
            # and raises in this process (torch's default tears the
            # process down), so the elastic ladder can classify it
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        dist.init_process_group(
            self.backend, init_method=init_method, world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=float(timeout_s)))
        self.group = dist.group.WORLD
        if rank == 0:
            where = (f"{size} ranks share {dev}"
                     if self.backend == "gloo" and dev.type == "cuda"
                     else f"{size} ranks on {dev.type}")
            print(f"shadow_tpu_torch.parallel: mesh '{axis}' of {size} "
                  f"ranks, backend {self.backend} ({where})",
                  file=sys.stderr, flush=True)

    def reset_counters(self) -> None:
        self.calls = self.gather_calls = 0
        self.bytes = self.gather_bytes = 0
        self.seconds = self.gather_seconds = 0.0

    def close(self) -> None:
        """Leave the process group (a one-rank mesh has none, and a
        mesh torn down by abort() has left it already)."""
        if self.group is not None:
            import torch.distributed as dist

            self.group = None
            if dist.is_initialized():
                dist.destroy_process_group()

    def abort(self) -> bool:
        """Tear the process group down after a failure without waiting
        on a dead peer: NCCL's communicators are aborted first, and
        each step waits at most ABORT_TIMEOUT_S. True when the group is
        gone; False when a step hung (its thread is left behind and the
        group may still hold resources — the caller must not start
        another group in this process then)."""
        if self.group is None:
            return True
        import torch.distributed as dist

        group, self.group = self.group, None
        ok = True
        if self.backend == "nccl":
            abort = getattr(dist.distributed_c10d, "_abort_process_group",
                            None)
            if abort is not None:
                ok = _bounded(lambda: abort(group), ABORT_TIMEOUT_S)
        if ok and dist.is_initialized():
            ok = _bounded(dist.destroy_process_group, ABORT_TIMEOUT_S)
        # free the group now: its connections close with it
        del group
        import gc

        gc.collect()
        return ok
    # -- collectives -------------------------------------------------
    def _comm_device(self) -> torch.device:
        return (torch.device("cpu") if self.backend == "gloo"
                else self.device)

    @staticmethod
    def _stage(t: torch.Tensor) -> torch.Tensor:
        """The buffer a collective works on in place: a private copy
        (bool as uint8, which every backend reduces)."""
        return (t.to(torch.uint8) if t.dtype == torch.bool
                else t.clone()).contiguous()

    @staticmethod
    def _unstage(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(torch.bool) if like.dtype == torch.bool else h

    def _timed(self, nbytes: int, fn):
        t0 = time.perf_counter()
        r = fn()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += int(nbytes)
        return r

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A reduced copy of `t` ("sum", "max" or "min")."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
        h = self._stage(t)
        self._timed(h.numel() * h.element_size(),
                    lambda: dist.all_reduce(h, op=ops[op], group=self.group))
        return self._unstage(h, t)

    def all_reduce_ints(self, vals, op: str = "sum") -> list:
        """A list of host ints reduced over the ranks."""
        if self.size == 1:
            return [int(v) for v in vals]
        t = torch.tensor([int(v) for v in vals], dtype=I64,
                         device=self._comm_device())
        return [int(v) for v in self.all_reduce(t, op).tolist()]

    def all_gather_ints(self, vals) -> list:
        """Every rank's list of host ints, in rank order."""
        if self.size == 1:
            return [[int(v) for v in vals]]
        t = torch.tensor([int(v) for v in vals], dtype=I64,
                         device=self._comm_device())
        return [[int(v) for v in row] for row in self.all_gather(t[None])
                .tolist()]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0, in rank order."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        h = self._stage(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        self._timed(h.numel() * h.element_size() * self.size,
                    lambda: dist.all_gather(parts, h, group=self.group))
        return self._unstage(torch.cat(parts, dim=0), t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """[S, ...] -> [S, ...]: block s goes to rank s; block s of the
        result came from rank s."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        h = self._stage(t)
        out = torch.empty_like(h)
        self._timed(h.numel() * h.element_size(),
                    lambda: dist.all_to_all_single(out, h,
                                                   group=self.group))
        return self._unstage(out, t)

    def barrier(self) -> None:
        if self.size > 1:
            self.all_reduce_ints([0])

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.size
        self._timed(0, lambda: dist.all_gather_object(out, obj,
                                                      group=self.group))
        return out


# --- the Sim's layout over the ranks ---------------------------------

def _names(path: str) -> list:
    return path.lstrip(".").split(".")


def leaf_sharded(path: str, leaf: torch.Tensor, bare_net: bool = False
                 ) -> bool:
    """The reference's sim_specs rule for one leaf (flax field path):
    True when it shards its leading host dimension over the ranks,
    False when it is replicated."""
    names = _names(path)
    # the telemetry and flow rings hold globally reduced records, the
    # injection staging buffer is seen whole by every rank (each merges
    # the rows it owns), and the lane planes are lane-indexed
    if names[0] in ("telem", "inject", "lanes", "flows"):
        return False
    # causality: per-host lineage rows shard; the advance-attribution
    # plane and the scalars are latched from replicated values
    if names[0] == "causality":
        return not (names[-1].startswith("adv_") or leaf.ndim == 0)
    if names[-1] in REPLICATED_FIELDS and (
            names[-2] == "net" if len(names) > 1 else bare_net):
        return False
    return leaf.ndim > 0


def sim_specs(sim, axis: str = AXIS) -> dict:
    """{flax field path: `axis` when the leaf shards, None when it is
    replicated} — the port's form of the reference's PartitionSpec
    tree."""
    bare = isinstance(sim, NetState)
    return {p: (axis if leaf_sharded(p, t, bare) else None)
            for p, t in sim_tensors(sim).items()}


def _map_leaves(obj, fn, prefix: str = ""):
    """`obj` with every tensor leaf replaced by fn(path, leaf); static
    fields and None stay."""
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or is_static(f):
            continue
        path = f"{prefix}.{f.name}"
        upd[f.name] = (_map_leaves(v, fn, path)
                       if dataclasses.is_dataclass(v) else fn(path, v))
    return dataclasses.replace(obj, **upd)


def _check_mesh_sim(sim, mesh: Mesh) -> int:
    """Refusals and the divisibility rule; returns the local rows Hl."""
    if getattr(sim, "lanes", None) is not None and mesh.size > 1:
        raise ValueError("lane isolation (core/lanes.py) is a single-shard "
                         "feature, as in the reference")
    H = sim.events.num_hosts
    if H % mesh.size:
        raise ValueError(f"num_hosts={H} not divisible by {mesh.size} "
                         f"shards")
    return H // mesh.size


def shard_sim(sim, mesh: Mesh):
    """The rank's local Sim cut from a global one: rows
    [rank*Hl, (rank+1)*Hl) of every sharded leaf, the replicated ones
    whole, all on the rank's device."""
    Hl = _check_mesh_sim(sim, mesh)
    lo, hi = mesh.rank * Hl, (mesh.rank + 1) * Hl
    specs = sim_specs(sim)

    def cut(path, leaf):
        leaf = leaf.to(mesh.device)
        return leaf[lo:hi] if specs[path] is not None else leaf

    return _map_leaves(sim, cut)


def unshard_sim(local, mesh: Mesh):
    """The global Sim reassembled on every rank from the ranks' local
    ones: the sharded leaves are gathered (one all_gather per dtype, in
    rank order), the replicated ones kept."""
    if mesh.size == 1:
        return local
    c0, b0, s0 = mesh.calls, mesh.bytes, mesh.seconds
    specs = sim_specs(local)
    leaves = sim_tensors(local)
    Hl = local.events.num_hosts
    groups: dict = {}
    for p, t in leaves.items():
        if specs[p] is not None:
            groups.setdefault(t.dtype, []).append(p)
    full = {}
    for dt, paths in groups.items():
        cols = [leaves[p].reshape(Hl, -1) for p in paths]
        g = mesh.all_gather(torch.cat(cols, dim=1))      # [S*Hl, X]
        at = 0
        for p, c in zip(paths, cols):
            w = c.shape[1]
            full[p] = g[:, at:at + w].reshape(
                (mesh.size * Hl, *leaves[p].shape[1:])).contiguous()
            at += w
    mesh.gather_calls += mesh.calls - c0
    mesh.gather_bytes += mesh.bytes - b0
    mesh.gather_seconds += mesh.seconds - s0
    return _map_leaves(local, lambda p, t: full.get(p, t))


# --- the window-boundary exchange ------------------------------------

def route_outbox_sharded(q, out, mesh: Mesh, base: int,
                         exchange_capacity: int | None = None,
                         narrow: int | None = None):
    """Exchange staged cross-host events across ranks and insert them
    into destination rows: the window-boundary all_to_all of (dst,
    time, kind, src, seq, words) records (SURVEY.md §5.8).

    This rank owns the global host range [base, base + Hl); an event's
    target rank is dst // Hl. Entries are grouped per target rank by a
    stable sort, every plane packed into one [S, C, 6+W] i32 buffer
    (the i64 time as lo/hi words, unwritten slots dst == -1),
    exchanged with ONE all_to_all, then inserted with the same
    insert_flat as the single-shard path ("sort2", whose select sweep
    launches mailbox_gather), in the same global (source row, emission
    slot) order — so the queue state is bit-identical to the
    single-shard route.

    `exchange_capacity` bounds the per-peer buffer (default: the whole
    outbox, Hl*M, which never overflows); entries past it, bad dst
    (>= the global host count) and arrivals outside this rank's block
    are counted in q.overflow, never dropped silently.

    The narrow tier: the exchange and the receive-side insert run at
    C_n = max(M, n // (4*S)) slots per peer (or `narrow`) whenever the
    largest per-target group fits, decided by one max over the ranks of
    the largest group + 1, so every rank takes the same branch; a
    globally empty exchange (the max is 0) elides the collective and
    the insert. Host reads: the local group maximum (one), the gate
    (one collective)."""
    S = mesh.size
    Hl, M = out.dst.shape
    GH = Hl * S
    n = Hl * M
    C_full = n if exchange_capacity is None else min(int(exchange_capacity),
                                                     n)
    dst = out.dst.reshape(n)
    occupied = dst >= 0
    bad = occupied & (dst >= GH)
    valid = occupied & ~bad
    tgt = torch.where(valid, dst // Hl, S).to(I64)
    # the largest per-target group: the rank of its last entry + 1
    groups = torch.bincount(tgt, minlength=S + 1)[:S]
    gmax = mesh.all_reduce_ints([int(groups.max())], "max")[0]
    empty = gmax == 0
    C_n = max(M, n // (4 * S)) if narrow is None else int(narrow)
    if C_n and C_n < C_full:
        hit = gmax <= C_n
        out = out.replace(
            narrow_hit=out.narrow_hit + int(hit),
            narrow_miss=out.narrow_miss + int(not hit),
            max_occupied=torch.clamp(out.max_occupied, min=gmax),
            route_elided=out.route_elided + int(empty))
        C = C_n if hit else C_full
    else:
        out = out.replace(route_elided=out.route_elided + int(empty))
        C = C_full
    nbad = bad.sum(dtype=I32)
    if empty:
        # bad-dst entries never enter the exchange but still owe their
        # overflow accounting
        return q.replace(overflow=q.overflow + nbad), clear_outbox(out)

    order = torch.argsort(tgt, stable=True)
    tgt_s = tgt[order]
    ok = tgt_s < S
    rank = segment_ranks(tgt_s)
    W = out.words.shape[-1]
    t_lo, t_hi = _pack_time(out.time)
    packed = torch.cat(
        [out.dst[..., None], t_lo[..., None], t_hi[..., None],
         out.kind[..., None], out.src[..., None], out.seq[..., None],
         out.words], dim=2)                              # [Hl, M, 6+W]
    flat = packed.reshape(n, 6 + W)[order]
    fits = ok & (rank < C)
    xofl = (ok & ~fits).sum(dtype=I32)
    row = torch.where(fits, tgt_s, S)
    slot = torch.where(fits, rank, C)
    sb = torch.zeros((S + 1, C + 1, 6 + W), dtype=I32, device=dst.device)
    sb[..., 0] = -1
    sb[row, slot] = flat
    rb = mesh.all_to_all(sb[:S, :C].contiguous())

    ri = rb.reshape(S * C, 6 + W)
    rdst = ri[:, 0]
    occupied_r = rdst >= 0
    local_row = rdst - int(base)
    # an arrival outside [base, base+Hl) means the lane assignment broke
    # the contiguous-block contract: count it loudly
    misrouted = occupied_r & ((local_row < 0) | (local_row >= Hl))
    rvalid = occupied_r & ~misrouted
    q = insert_flat(
        q, rvalid, torch.where(rvalid, local_row, Hl),
        _unpack_time(ri[:, 1], ri[:, 2]), ri[:, 3].contiguous(),
        ri[:, 4].contiguous(), ri[:, 5].contiguous(),
        ri[:, 6:].contiguous())
    q = q.replace(overflow=q.overflow + nbad + xofl
                  + misrouted.sum(dtype=I32))
    return q, clear_outbox(out)


# --- replication at the dispatch boundary ----------------------------

# scalars that are already identical on every rank (decided by a
# collective, or latched from replicated values): maxed, not summed
_PINNED_MAX = (".outbox.narrow_hit", ".outbox.narrow_miss",
               ".outbox.max_occupied", ".outbox.route_elided")
# replicated scalars kept as they are: the telemetry and flow rings
# (globally reduced at the barrier), the integrity sentinel (a pure
# function of the gathered digests), the injection floor and horizon
# (a pure function of replicated planes) and the causality advance
# count (every rank latches the same windows)
_PINNED_PREFIXES = (".telem.", ".flows.", ".sentinel.")
_PINNED_KEEP = (".inject.seq_floor", ".inject.horizon",
                ".causality.adv_count")


def _replicate_scalars(sim, initial_sim, stats: EngineStats, mesh: Mesh,
                       stats0: EngineStats | None = None):
    """Sum EVERY scalar leaf's delta (since `initial_sim`) over the
    ranks, so a counter added anywhere in the state tree is aggregated
    instead of returning one rank's share; the delta, because the
    initial value is already replicated. The pins: the four narrow
    counters (maxed), the rings, the injection floor and horizon and
    the causality advance count and the sentinel (kept).
    ctr_path_packets' [V,V] delta
    is summed when track_paths is on. EngineStats: events_processed
    and micro_steps summed (their delta since `stats0`), windows and
    the fast-path counts maxed. One sum and one max collective."""
    if mesh.size == 1:
        return sim, stats
    leaves, init = sim_tensors(sim), sim_tensors(initial_sim)
    summed, maxed = [], list(_PINNED_MAX)
    for p, t in leaves.items():
        if t.ndim or p in _PINNED_MAX or p in _PINNED_KEEP \
                or p.startswith(_PINNED_PREFIXES):
            continue
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise TypeError(f"scalar leaf {p} of dtype {t.dtype}: the "
                            f"delta sum takes integer counters")
        summed.append(p)
    s0 = stats0 if stats0 is not None else EngineStats.create(
        device=stats.events_processed.device)
    dev = sim.events.time.device
    sums = mesh.all_reduce(torch.stack(
        [(leaves[p] - init[p]).to(I64) for p in summed]
        + [(stats.events_processed - s0.events_processed).to(I64),
           (stats.micro_steps - s0.micro_steps).to(I64)]).to(dev), "sum")
    maxes = mesh.all_reduce(torch.stack(
        [leaves[p].to(I64) for p in maxed]
        + [stats.windows.to(I64), stats.fastpath_hit.to(I64),
           stats.fastpath_miss.to(I64)]).to(dev), "max")
    new = {p: (init[p].to(I64) + sums[i]).to(leaves[p].dtype)
           for i, p in enumerate(summed)}
    new.update({p: maxes[i].to(leaves[p].dtype)
                for i, p in enumerate(maxed)})
    paths = leaves.get(".net.ctr_path_packets")
    if paths is not None and tuple(paths.shape) != (1, 1):
        p0 = init[".net.ctr_path_packets"]
        new[".net.ctr_path_packets"] = p0 + mesh.all_reduce(paths - p0,
                                                            "sum")
    k = len(summed)
    m = len(maxed)
    stats = EngineStats(
        events_processed=s0.events_processed + sums[k],
        micro_steps=s0.micro_steps + sums[k + 1],
        windows=maxes[m], fastpath_hit=maxes[m + 1],
        fastpath_miss=maxes[m + 2])
    return _map_leaves(sim, lambda p, t: new.get(p, t)), stats


# --- runners -----------------------------------------------------------

def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")


def mesh_hooks(mesh: Mesh, local_sim, exchange_capacity=None, narrow=None):
    """The engine's mesh hooks for this rank: {route_fn, min_fn,
    census_fn, telem_fn, flow_fn, sentinel_fn}."""
    from shadow_tpu_torch.parallel.elastic import make_sentinel_fn

    base = mesh.rank * local_sim.events.num_hosts

    def route_fn(s):
        q, out = route_outbox_sharded(s.events, s.outbox, mesh, base,
                                      exchange_capacity, narrow)
        return s.replace(events=q, outbox=out)

    return dict(
        route_fn=route_fn,
        min_fn=lambda x: mesh.all_reduce_ints([x], "min")[0],
        census_fn=lambda x: mesh.all_reduce_ints([x], "sum")[0],
        telem_fn=make_telem_fn(mesh), flow_fn=make_flow_fn(mesh),
        sentinel_fn=make_sentinel_fn(mesh))


def sharded_engine_run(mesh: Mesh, axis: str, sim, step_fn, *,
                       end_time: int, min_jump: int, emit_capacity: int = 4,
                       lane_id_fn=None, exchange_capacity: int | None = None,
                       narrow: int | None = None, bulk_fn=None,
                       fault_fn=None, sparse_lanes: int = 0,
                       fault_times=None):
    """engine.run over the mesh, on every rank. `sim` is the GLOBAL
    state (as built for one shard); lane_id_fn(local_sim) gives the
    [Hl] global host ids of the rank's rows (default
    local_sim.net.lane_id). Returns (sim, stats), the global state
    reassembled on every rank."""
    _check_axis(mesh, axis)
    local = shard_sim(sim, mesh)
    lane = (lane_id_fn(local) if lane_id_fn is not None
            else local.net.lane_id)
    out, stats = engine_run(
        local, step_fn, end_time=end_time, min_jump=min_jump,
        emit_capacity=emit_capacity, lane_id=lane, bulk_fn=bulk_fn,
        sparse_lanes=sparse_lanes, fault_times=fault_times,
        fault_fn=fault_fn,
        **mesh_hooks(mesh, local, exchange_capacity, narrow))
    out, stats = _replicate_scalars(out, local, stats, mesh)
    return unshard_sim(out, mesh), stats


def make_sharded_window(mesh: Mesh, axis: str, sim_template, cfg, step_fn,
                        exchange_capacity: int | None = None,
                        narrow: int | None = None, bulk_fn=None,
                        fault_fn=None):
    """``window(local_sim, wstart, wend) -> (local_sim, stats,
    next_min)``: ONE window round on this rank, the building block of
    host-driven loops (checkpoint.run_windows) on a mesh. The Sim is the
    rank's local one (shard_sim) and stays local; its scalars leave
    replicated, next_min is the global minimum (a host int). The
    reference's `donate` has no counterpart: the port never writes a
    tensor in place."""
    _check_axis(mesh, axis)
    _check_mesh_sim(sim_template, mesh)
    sparse = resolve_sparse_lanes(cfg)
    hooks = {}

    def window(local_sim, wstart, wend):
        if not hooks:
            hooks.update(mesh_hooks(mesh, local_sim, exchange_capacity,
                                    narrow))
        stats = EngineStats.create(device=local_sim.events.time.device)
        out, stats, next_min = step_window(
            local_sim, stats, step_fn, int(wend),
            emit_capacity=cfg.emit_capacity,
            lane_id=local_sim.net.lane_id, bulk_fn=bulk_fn,
            wstart=int(wstart), sparse_lanes=sparse, fault_fn=fault_fn,
            **hooks)
        out, stats = _replicate_scalars(out, local_sim, stats, mesh)
        return out, stats, next_min

    return window


def make_sharded_chunk(mesh: Mesh, axis: str, sim_template, cfg, step_fn,
                       *, end_time: int, wend_fn, chunk_windows: int,
                       exchange_capacity: int | None = None,
                       narrow: int | None = None, bulk_fn=None,
                       fault_fn=None):
    """make_sharded_window's chunked sibling: ``chunk(local_sim, stats,
    wstart) -> (local_sim, stats, next_min)`` running up to
    `chunk_windows` rounds (engine.make_chunk_body) with the mesh hooks;
    the scalar replication runs once per chunk against its entry state
    (deltas over K windows compose), and the stats' delta over the
    chunk is summed. `wend_fn` is net.build.resolve_wend_fn's rule."""
    _check_axis(mesh, axis)
    _check_mesh_sim(sim_template, mesh)
    sparse = resolve_sparse_lanes(cfg)
    bodies = []

    def chunk(local_sim, stats, wstart):
        if not bodies:
            bodies.append(make_chunk_body(
                step_fn, end_time=end_time, wend_fn=wend_fn,
                chunk_windows=chunk_windows,
                emit_capacity=cfg.emit_capacity,
                lane_fn=lambda s: s.net.lane_id, bulk_fn=bulk_fn,
                sparse_lanes=sparse, fault_fn=fault_fn,
                **mesh_hooks(mesh, local_sim, exchange_capacity, narrow)))
        out, st, next_min = bodies[0](local_sim, stats, wstart)
        out, st = _replicate_scalars(out, local_sim, st, mesh, stats0=stats)
        return out, st, next_min

    return chunk


def make_sharded_runner(bundle, mesh: Mesh, axis: str = AXIS,
                        app_handlers=(), end_time: int | None = None,
                        exchange_capacity: int | None = None,
                        app_bulk=None, app_tcp_bulk=None,
                        tcp_bulk_lossless: bool = False,
                        fault_fn=None, warm_start: bool | None = None,
                        compile_info: dict | None = None):
    """Multi-rank variant of net.build.make_runner: a reusable
    ``go(sim) -> (sim, stats)`` running the whole window loop on the
    mesh, global state in and out, on every rank. The bundle must lie
    on the rank's device. Capability trims are shard-invariant (the
    guard's counters take the delta sum). `warm_start` and
    `compile_info` are make_runner's, keyed with `shards=N` (the
    example is the global sim each rank is handed)."""
    from shadow_tpu_torch.compile import serve
    from shadow_tpu_torch.net.build import (
        _caps_meta,
        _resolve_bulk_fn,
        _resolve_caps,
        _resolve_fault_fn,
        _runner_device,
        _whole_run_key_fn,
        plan_times,
    )
    from shadow_tpu_torch.net.step import make_step_fn

    _check_axis(mesh, axis)
    _runner_device(bundle, mesh.device)
    caller_fault_fn = fault_fn
    caps = _resolve_caps(bundle, fault_fn)
    step = make_step_fn(bundle.cfg, app_handlers, caps=caps)
    bulk_fn = _resolve_bulk_fn(bundle, app_bulk, app_tcp_bulk,
                               tcp_bulk_lossless, caps=caps)
    fault_fn = _resolve_fault_fn(bundle, fault_fn)
    end = end_time if end_time is not None else bundle.cfg.end_time

    outer = [None]   # the callable handed out: its bulk_fn is read

    def go(sim):
        return sharded_engine_run(
            mesh, axis, sim, step, end_time=end, min_jump=bundle.min_jump,
            emit_capacity=bundle.cfg.emit_capacity,
            exchange_capacity=exchange_capacity, bulk_fn=outer[0].bulk_fn,
            fault_fn=fault_fn,
            sparse_lanes=resolve_sparse_lanes(bundle.cfg),
            fault_times=plan_times(bundle))

    fn = serve.maybe_warm(
        lambda: go,
        _whole_run_key_fn(
            bundle, app_handlers, end=end, path="sharded_whole",
            chunk_windows=0, adaptive=False, fault_fn=caller_fault_fn,
            app_bulk=app_bulk, app_tcp_bulk=app_tcp_bulk,
            tcp_bulk_lossless=tcp_bulk_lossless, shards=mesh.size,
            exchange_capacity=exchange_capacity, caps=caps),
        enabled=serve.warm_enabled(default=bool(warm_start)),
        meta=_caps_meta(caps), info=compile_info)
    fn.bulk_fn = bulk_fn
    outer[0] = fn
    return fn


def run_sharded(bundle, mesh: Mesh, axis: str = AXIS, app_handlers=(),
                end_time: int | None = None,
                exchange_capacity: int | None = None,
                app_bulk=None, app_tcp_bulk=None,
                warm_start: bool | None = None,
                compile_info: dict | None = None):
    """One-shot multi-rank variant of net.build.run."""
    return make_sharded_runner(
        bundle, mesh, axis, app_handlers, end_time, exchange_capacity,
        app_bulk, app_tcp_bulk, warm_start=warm_start,
        compile_info=compile_info)(bundle.sim)


# --- starting ranks ----------------------------------------------------

def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_init() -> str:
    """A rendezvous address for a new process group on this machine."""
    return f"tcp://127.0.0.1:{free_port()}"


# the environment of a rank process that a command started for itself
# (the CLI's --workers, the bench's BENCH_SHARDS)
RANK_ENV, WORLD_ENV, INIT_ENV = ("SHADOW_TORCH_RANK", "SHADOW_TORCH_WORLD",
                                 "SHADOW_TORCH_INIT")
# how long rank 0 waits for the ranks it started once its own part ended
RANK_JOIN_S = 120.0


def rank_env() -> tuple:
    """(rank, world size, rendezvous) of a rank process a command
    started; (0, None, None) in the command itself."""
    r = os.environ.get(RANK_ENV)
    if r is None:
        return 0, None, None
    return int(r), int(os.environ[WORLD_ENV]), os.environ[INIT_ENV]


# the pid of the process that started a rank (RankProcesses)
PARENT_ENV = "SHADOW_TORCH_PARENT"


def die_with_parent() -> None:
    """In a rank RankProcesses started: have the kernel SIGKILL this
    process when the process that started it dies (Linux's
    PR_SET_PDEATHSIG), so the rank never outlives the command or fleet
    worker that started it, even a SIGKILLed one; exit at once when that
    process is already gone. A no-op outside such a rank or where prctl
    is missing."""
    import ctypes
    import signal

    parent = os.environ.get(PARENT_ENV)
    if parent is None:
        return
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return
    prctl(1, int(signal.SIGKILL))             # PR_SET_PDEATHSIG
    if os.getppid() != int(parent):           # it died before the call
        os._exit(1)


class RankProcesses:
    """Ranks 1..world-1 of a command that runs as rank 0 itself: each
    re-runs ``python -m <module> <argv>`` with its rank, the width, the
    rendezvous (`init`) and this process's pid in the environment
    (rank_env; a rank calling die_with_parent() dies with this
    process). Their standard output is discarded (rank 0 reports);
    their errors go to a temporary file each, shown when a rank fails.
    join() waits within RANK_JOIN_S; kill() ends any left."""

    def __init__(self, module: str, argv, world: int):
        import subprocess
        import tempfile

        self.init = free_port_init()
        self.procs = []
        for r in range(1, int(world)):
            err = tempfile.TemporaryFile(mode="w+")
            env = dict(os.environ, **{RANK_ENV: str(r),
                                      WORLD_ENV: str(world),
                                      INIT_ENV: self.init,
                                      PARENT_ENV: str(os.getpid())})
            self.procs.append((r, subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=env,
                stdout=subprocess.DEVNULL, stderr=err), err))

    def alive(self) -> list:
        """The ranks still running."""
        return [r for r, p, _ in self.procs if p.poll() is None]

    def errors(self) -> dict:
        """{rank: the tail of its errors} of every rank that exited
        non-zero."""
        out = {}
        for r, p, err in self.procs:
            if p.poll() not in (None, 0):
                err.seek(0)
                out[r] = err.read()[-4000:]
        return out

    def join(self) -> int:
        """0 when every rank exited 0 within RANK_JOIN_S, else 1 with
        each failed rank's errors on stderr."""
        import subprocess

        code = 0
        t_end = time.monotonic() + RANK_JOIN_S
        for r, p, err in self.procs:
            try:
                rc = p.wait(timeout=max(0.1, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
                print(f"error: rank {r} did not finish within "
                      f"{RANK_JOIN_S} s", file=sys.stderr)
            if rc != 0:
                code = 1
                err.seek(0)
                print(f"error: rank {r} exited {rc}:\n"
                      f"{err.read()[-4000:]}", file=sys.stderr)
        return code

    def kill(self) -> None:
        for _, p, err in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()


def _rank_main(fn, rank, size, init_method, args, results):
    try:
        torch.set_num_threads(1)
        results.put((rank, True, fn(rank, size, init_method, *args)))
    except BaseException:
        # the parent reports the traceback; the rank still fails
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, size: int, *args, deadline_s: float = 300.0,
          may_die=()):
    """Run ``fn(rank, size, init_method, *args)`` in `size` fresh
    processes (multiprocessing "spawn": each imports only what `fn`'s
    module imports) and return their results in rank order. `fn` must
    be a module-level function. Every rank is joined within
    `deadline_s`; a rank that raises, dies or overruns makes spawn kill
    the rest and raise RuntimeError with its traceback — except that a
    rank in `may_die` (a rank a device-loss drill kills on purpose) may
    die without a result: its entry is None. torch runs one intra-op
    thread a rank."""
    may_die = {int(r) for r in may_die}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = free_port_init()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, init, args, results),
                         daemon=True) for r in range(size)]
    for p in procs:
        p.start()
    out, err = {}, None
    t_end = time.monotonic() + float(deadline_s)
    died = set()
    try:
        while len(out) + len(died) < size and err is None:
            left = t_end - time.monotonic()
            if left <= 0:
                err = f"ranks {sorted(set(range(size)) - set(out))} " \
                      f"did not finish within {deadline_s} s"
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and r not in died
                        and p.exitcode not in (None, 0)]
                died.update(r for r in dead if r in may_die)
                dead = [r for r in dead if r not in may_die]
                if dead:
                    err = f"rank {dead[0]} died (exit " \
                          f"{procs[dead[0]].exitcode})"
                continue
            if ok:
                out[rank] = val
            else:
                err = f"rank {rank} failed:\n{val}"
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, t_end - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if err is not None:
        raise RuntimeError(f"parallel.spawn: {err}")
    return [out.get(r) for r in range(size)]
