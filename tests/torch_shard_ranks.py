"""Rank-side helpers of the sharded-port tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_dispatch.py, and the CLI and bench cases).

The functions here run inside ranks started by
shadow_tpu_torch.parallel.spawn, so this module imports the port and
numpy only: never jax or the reference package, which the test modules
themselves import. Each rank function builds its Mesh on the CPU (gloo),
runs its cases and returns host data (numpy leaf dicts by flax field
path, EngineStats as ints); rank 0's result is the one the tests read,
the others are checked equal to it where the state is global.
"""

import numpy as np
import torch

from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.apps import pingpong as tping
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig

SEC = simtime.ONE_SECOND

# tests/test_parallel.py's single-vertex fixture (latency 50 ms)
ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">10240</data><data key="dn">10240</data></node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

PING_H = 8
PING_PORT = 7000


def pingpong(seed=1, overflow0=None, device="cpu"):
    """tests/test_parallel.py's _build in the port: 4 clients ping 4
    servers 5 times, 128 bytes, from 1 s, 5 sim-s."""
    H = PING_H
    cfg = NetConfig(num_hosts=H, end_time=5 * SEC, seed=seed)
    hosts = [tbuild.HostSpec(name=f"client{i}", proc_start_time=SEC)
             for i in range(H // 2)]
    hosts += [tbuild.HostSpec(name=f"server{i}") for i in range(H // 2)]
    b = tbuild.build(cfg, ONE_VERTEX, hosts, device=device)
    server_ip = np.zeros(H, np.int64)
    for i in range(H // 2):
        server_ip[i] = b.ip_of(f"server{i}")
    b.sim = tping.setup(
        b.sim, client_mask=torch.as_tensor(np.arange(H) < H // 2),
        server_mask=torch.as_tensor(np.arange(H) >= H // 2),
        server_ip=torch.as_tensor(server_ip), server_port=PING_PORT,
        count=5, size=128)
    if overflow0 is not None:
        b.sim = b.sim.replace(events=b.sim.events.replace(
            overflow=torch.tensor(overflow0, dtype=torch.int32)))
    return b


def phold(H=16, load=2, end=SEC, seed=1, cap=16, ring=True, flows=None,
          sparse_lanes=None, device="cpu"):
    """bench.py's PHOLD program at test size: one replica of H hosts,
    capacities `cap`, the telemetry ring and (sample period, capacity)
    flow ring when asked."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.bench import ONE_VERTEX as BENCH_VERTEX

    cfg = NetConfig(num_hosts=H, tcp=False, end_time=end, seed=seed,
                    event_capacity=cap, outbox_capacity=cap, router_ring=cap,
                    in_ring=max(16, 2 * load), sparse_lanes=sparse_lanes)
    hosts = [tbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(H)]
    b = tbuild.build(cfg, BENCH_VERTEX, hosts, device=device)
    b.sim = tphold.setup(b.sim, load=load)
    if ring:
        b.sim = telemetry.attach(b.sim)
    if flows is not None:
        b.sim = telemetry.attach_flows(b.sim, sample_period=flows[0],
                                       capacity=flows[1])
    return b


def stats_dict(stats) -> dict:
    return stats.as_dict()


def mesh_for(rank, size, init):
    """The rank's CPU mesh, after checking that the rank process holds
    the port alone (no jax, flax or reference module was imported)."""
    import sys

    from shadow_tpu_torch.parallel import Mesh

    bad = sorted(m for m in sys.modules if m.split(".")[0]
                 in ("jax", "jaxlib", "flax", "shadow_tpu"))
    assert not bad, f"a rank imported {bad[:5]}"
    return Mesh(size, rank, init_method=init, device="cpu")


def check_replicated(mesh, leaves: dict) -> None:
    """Every rank holds the same global state: a digest per leaf,
    compared over the ranks (max == min)."""
    import zlib

    digest = [zlib.crc32(np.ascontiguousarray(leaves[k]).tobytes())
              for k in sorted(leaves)]
    hi = mesh.all_reduce_ints(digest, "max")
    lo = mesh.all_reduce_ints(digest, "min")
    bad = [k for k, a, b in zip(sorted(leaves), hi, lo) if a != b]
    assert not bad, f"ranks disagree on {bad[:5]}"


def sharded_pingpong_cases(rank, size, init):
    """test_torch_parallel.py's whole-run cases at `size` ranks:
    {name: (leaves, stats)} (rank 0's; every rank checks it holds the
    same global state)."""
    from shadow_tpu_torch.parallel import make_sharded_runner

    mesh = mesh_for(rank, size, init)
    out = {}
    b = pingpong()
    go = make_sharded_runner(b, mesh, app_handlers=(tping.handler,))
    cases = [("plain", b.sim), ("overflow3", pingpong(overflow0=3).sim)]
    for name, sim in cases:
        s, st = go(sim)
        leaves = convert.sim_to_numpy(s)
        check_replicated(mesh, leaves)
        out[name] = (leaves, stats_dict(st))
    if size == 2:
        s, st = make_sharded_runner(b, mesh, app_handlers=(tping.handler,),
                                    exchange_capacity=1)(b.sim)
        out["xcap1"] = (convert.sim_to_numpy(s), stats_dict(st))
        out["routes"] = route_cases(mesh)
        # rank 0's port for a second group, of a 1-s timeout
        from shadow_tpu_torch.parallel.shard import free_port

        port = mesh.all_reduce_ints([free_port() if rank == 0 else 0])[0]
        mesh.close()
        out["hung"] = hung_collective(rank, size,
                                      f"tcp://127.0.0.1:{port}", 1.0, 4.0)
        return out if rank == 0 else None
    mesh.close()
    return out if rank == 0 else None


def seeded_outbox(seed, H, M, W, fill, bad=0, misroute=0):
    """A seeded outbox over H global rows of M slots (W words): each
    row's first `fill` slots hold events to random hosts, with `bad`
    entries past the host count; `misroute` rewrites the dst of that
    many occupied slots of the last row to -2 - (their row), which the
    caller turns into a wrong-rank arrival. Returns numpy planes."""
    rng = np.random.default_rng(seed)
    dst = np.full((H, M), -1, np.int32)
    k = min(fill, M)
    dst[:, :k] = rng.integers(0, H, (H, k))
    if bad:
        r = rng.integers(0, H, bad)
        c = rng.integers(0, k, bad)
        dst[r, c] = H + rng.integers(0, 5, bad)
    time = np.where(dst >= 0, rng.integers(0, 10**9, (H, M)),
                    simtime.INVALID).astype(np.int64)
    kind = rng.integers(0, 8, (H, M)).astype(np.int32)
    src = np.repeat(np.arange(H, dtype=np.int32)[:, None], M, 1)
    seq = rng.integers(0, 1000, (H, M)).astype(np.int32)
    words = rng.integers(-2**31, 2**31 - 1, (H, M, W)).astype(np.int32)
    return dict(dst=dst, time=time, kind=kind, src=src, seq=seq,
                words=words)


ROUTE_CASES = {
    # name: (seed, H, M, K, fill, bad, exchange_capacity)
    "narrow": (1, 8, 8, 8, 1, 0, None),
    "full": (2, 8, 8, 8, 6, 0, None),
    "empty": (3, 8, 8, 8, 0, 0, None),
    "bad_dst": (4, 8, 8, 8, 2, 3, None),
    "xcap": (5, 8, 8, 8, 3, 0, 1),
}


def route_queue(H, K, W, device="cpu"):
    from shadow_tpu_torch.core.events import EventQueue

    return EventQueue.create(H, K, nwords=W, device=device)


def route_cases(mesh):
    """route_outbox_sharded on the seeded outboxes of ROUTE_CASES, each
    applied twice (the narrow counters accumulate), plus a misrouted
    arrival: {name: global leaves of (queue, outbox)}."""
    from shadow_tpu_torch.core.events import Outbox
    from shadow_tpu_torch.parallel.shard import (
        route_outbox_sharded,
        shard_sim,
        unshard_sim,
    )

    from dataclasses import dataclass

    from shadow_tpu_torch.core.events import _Replace

    @dataclass
    class Pair(_Replace):
        events: object
        outbox: object

    res = {}
    W = 4
    for name, (seed, H, M, K, fill, bad, xcap) in ROUTE_CASES.items():
        planes = seeded_outbox(seed, H, M, W, fill, bad)
        out = Outbox.create(H, M, nwords=W, device="cpu")
        out = out.replace(**{k: torch.as_tensor(v)
                             for k, v in planes.items()})
        pair = shard_sim(Pair(route_queue(H, K, W), out), mesh)
        Hl = H // mesh.size
        q, ob = pair.events, pair.outbox
        for _ in range(2):
            q, ob2 = route_outbox_sharded(q, ob, mesh, mesh.rank * Hl,
                                          exchange_capacity=xcap)
            ob = ob2.replace(**{k: v for k, v in vars(pair.outbox).items()
                                if k in planes})
        res[name] = gather_pair(Pair(q, ob2), mesh)
    # a misrouted arrival: rank 0 believes it owns the block of rank 1
    planes = seeded_outbox(6, 8, 8, W, 2)
    out = Outbox.create(8, 8, nwords=W, device="cpu").replace(
        **{k: torch.as_tensor(v) for k, v in planes.items()})
    pair = shard_sim(Pair(route_queue(8, 8, W), out), mesh)
    Hl = 8 // mesh.size
    base = (mesh.rank + 1) % mesh.size * Hl
    q = pair.events
    for _ in range(2):
        q, _ = route_outbox_sharded(q, pair.outbox, mesh, base)
    res["misrouted_overflow"] = mesh.all_reduce_ints(
        [int(q.overflow)], "sum")[0]
    return res


def gather_pair(pair, mesh) -> dict:
    """Global planes of a (queue, outbox) pair, and each scalar as its
    [S] per-rank values (a route's scalars are per-rank partials)."""
    from shadow_tpu_torch.parallel.shard import unshard_sim

    full = unshard_sim(pair, mesh)
    out = {}
    for part in ("events", "outbox"):
        for k, v in vars(getattr(full, part)).items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.ndim:
                out[f".{part}.{k}"] = v.numpy().copy()
            else:
                loc = getattr(getattr(pair, part), k)
                out[f".{part}.{k}"] = np.array(
                    [r[0] for r in mesh.all_gather_ints([int(loc)])],
                    np.int64)
    return out


# (wstart, wend) of the flow-merge case's two recorder calls
FLOW_WINDOWS = ((0, 50_000_000), (50_000_000, 100_000_000))
FLOW_RING = (1, 24)          # period 1, capacity 24: clamps and wraps


def with_seeded_outbox(sim, seed=11, fill=2):
    """`sim` with its outbox replaced by seeded_outbox's planes."""
    out = sim.outbox
    H, M = out.dst.shape
    planes = seeded_outbox(seed, H, M, out.words.shape[-1], fill)
    return sim.replace(outbox=out.replace(
        **{k: torch.as_tensor(v) for k, v in planes.items()}))


def flow_merge_case(rank, size, init):
    """The flow recorder's sharded merge (make_flow_fn(mesh)) on a
    seeded outbox of the 16-host PHOLD program, two calls: rank 0
    returns the global `.flows.*` leaves."""
    from shadow_tpu_torch.parallel.shard import shard_sim, unshard_sim
    from shadow_tpu_torch.telemetry.flows import make_flow_fn

    mesh = mesh_for(rank, size, init)
    sim = with_seeded_outbox(phold(ring=False, flows=FLOW_RING).sim)
    local = shard_sim(sim, mesh)
    fn = make_flow_fn(mesh)
    for w0, w1 in FLOW_WINDOWS:
        local = fn(local, w0, w1)
    g = unshard_sim(local, mesh)
    leaves = convert.sim_to_numpy(g)
    check_replicated(mesh, leaves)
    mesh.close()
    if rank:
        return None
    return {k: v for k, v in leaves.items() if k.startswith(".flows.")}


# tests/test_torch_parallel_dispatch.py's program: PHOLD at 16 hosts
# with the ring and the flow recorder, the bulk pass, and a fault plan
# with loss, a crash and restart of host 11 (rank 1's block) and a
# latency spike; its sparse twin (the census and the per-rank
# compaction) runs a 4-row budget without the bulk pass
DISPATCH_END = 1_500_000_000
DISPATCH_FLOWS = (4, 64)
SPARSE_LANES = 4
DISPATCH_PLAN = """{"faults": [
  {"time_s": 0.25, "kind": "loss", "a": 0, "b": 0, "value": 0.02},
  {"time_s": 0.45, "kind": "crash", "a": 11},
  {"time_s": 0.65, "kind": "linkup", "a": 0, "b": 0},
  {"time_s": 0.85, "kind": "restart", "a": 11},
  {"time_s": 1.0, "kind": "latency", "a": 0, "b": 0, "value": 0.02},
  {"time_s": 1.3, "kind": "latency", "a": 0, "b": 0, "value": 0.0}
]}"""
CHECKPOINT_NS = 700_000_000


def dispatch_bundle(device="cpu", sparse=False):
    """The program above; `sparse`: its sparse twin."""
    from shadow_tpu_torch import faults

    b = phold(H=16, load=2, end=DISPATCH_END, flows=DISPATCH_FLOWS,
              sparse_lanes=SPARSE_LANES if sparse else None, device=device)
    faults.install(b, faults.records_from_json(DISPATCH_PLAN))
    b.app_bulk = None if sparse else tphold.BULK
    return b


def dispatch_cases(rank, size, init, snap_dir, snap1):
    """test_torch_parallel_dispatch.py's cases at `size` ranks: the
    window loop at K = 1 and 8, the supervised loop, a run writing
    snapshots, a resume of the one-rank snapshot `snap1`, and the
    sparse twin at K = 8. Rank 0 returns {case: data}."""
    import os

    from shadow_tpu_torch.faults import run_supervised
    from shadow_tpu_torch.utils import checkpoint as ckpt

    mesh = mesh_for(rank, size, init)
    handlers = (tphold.handler,)
    out = {}
    for k in (1, 8):
        b = dispatch_bundle()
        sim, st, _ = ckpt.run_windows(b, handlers, mesh=mesh,
                                      windows_per_dispatch=k)
        leaves = convert.sim_to_numpy(sim)
        check_replicated(mesh, leaves)
        out[f"k{k}"] = (leaves, stats_dict(st))
    b = dispatch_bundle()
    res = run_supervised(b, handlers, mesh=mesh, windows_per_dispatch=8,
                         checkpoint_path=os.path.join(snap_dir, "sup"),
                         checkpoint_every_windows=16)
    out["sup"] = (res.ok, convert.sim_to_numpy(res.sim),
                  stats_dict(res.stats), list(res.checkpoints))
    b = dispatch_bundle()
    _, _, saved = ckpt.run_windows(
        b, handlers, mesh=mesh, checkpoint_every_ns=CHECKPOINT_NS,
        checkpoint_path=os.path.join(snap_dir, "two"))
    out["saved"] = saved
    b = dispatch_bundle()
    sim0, t0, _ = ckpt.load(snap1, b.sim)
    sim, st, _ = ckpt.run_windows(b, handlers, sim=sim0, start_time=t0,
                                  mesh=mesh)
    out["resume_on_2"] = (convert.sim_to_numpy(sim), stats_dict(st))
    b = dispatch_bundle(sparse=True)
    sim, st, _ = ckpt.run_windows(b, handlers, mesh=mesh,
                                  windows_per_dispatch=8)
    out["sparse"] = (convert.sim_to_numpy(sim), stats_dict(st))
    mesh.close()
    return out if rank == 0 else None


def hung_collective(rank, size, init, timeout_s, idle_s):
    """Rank 0 reduces on a mesh of `timeout_s` while rank 1 idles for
    `idle_s` without joining: rank 0 returns (raised, seconds)."""
    import time

    from shadow_tpu_torch.parallel import Mesh

    mesh = Mesh(size, rank, init_method=init, device="cpu",
                timeout_s=timeout_s)
    if rank:
        time.sleep(idle_s)
        mesh.close()
        return None
    t0 = time.monotonic()
    raised = False
    try:
        mesh.all_reduce_ints([1])
    except RuntimeError:
        raised = True
    secs = time.monotonic() - t0
    mesh.close()
    return raised, secs
