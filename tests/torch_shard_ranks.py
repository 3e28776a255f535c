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


# --- elastic degraded-mesh recovery (tests/test_torch_elastic.py) ------

ELASTIC_TIMEOUT_S = 5.0        # a group timeout of a few seconds
ELASTIC_POISON = (10, 11)      # two consecutive dispatches mid-run
ELASTIC_KILL_AT = 10           # the dispatch rank 3 dies at
ELASTIC_VICTIM = 1             # the rank whose replica diverges
ELASTIC_AT_NS = 600_000_000    # from this window end on
ELASTIC_EVERY = 4              # the supervisor's snapshot cadence


def elastic_bundle(device="cpu"):
    """The dispatch program above with the integrity sentinel."""
    from shadow_tpu_torch.parallel import elastic

    b = dispatch_bundle(device=device)
    b.sim = elastic.attach_sentinel(b.sim)
    return b


def elastic_supervised(b, mesh, path, **kw):
    """run_supervised of `b` under an ElasticPolicy at the cadence
    above: (result, host-side summary)."""
    from shadow_tpu_torch.faults import run_supervised
    from shadow_tpu_torch.parallel import elastic

    res = run_supervised(b, (tphold.handler,), mesh=mesh,
                         elastic=elastic.ElasticPolicy(),
                         checkpoint_path=path,
                         checkpoint_every_windows=ELASTIC_EVERY,
                         sleep=lambda s: None, **kw)
    summary = {"retired": res.retired, "reports": res.reports,
               "ok": res.ok, "elastic": res.elastic,
               "retries_used": res.retries_used}
    if res.sim is not None:
        summary["leaves"] = convert.sim_to_numpy(res.sim)
        summary["stats"] = stats_dict(res.stats)
    return summary


def _kill_self_at(n_kill):
    """A dispatch_wrap under which this rank's process SIGKILLs itself
    at dispatch `n_kill` (counted across attempts): a real rank loss."""
    import os
    import signal

    state = {"n": 0}

    def wrap(fn):
        def dispatch(*a, **k):
            state["n"] += 1
            if state["n"] - 1 == n_kill:
                os.kill(os.getpid(), signal.SIGKILL)
            return fn(*a, **k)
        return dispatch
    return wrap


def elastic_cases(rank, size, init, snap_dir):
    """tests/test_torch_elastic.py's mesh cases in one set of 4 ranks:
    the sentinel on a clean run at 4 ranks (K = 1 and 4) and at 2
    (ranks 0 and 1 alone), a divergence on rank ELASTIC_VICTIM, the
    poisoned ladder (retry, then shrink) and, last, rank 3 killing
    itself mid-run (shrink). Each rank returns {case: data}; rank 3
    never returns."""
    import os

    from shadow_tpu_torch.parallel import Mesh, elastic, make_sharded_runner
    from shadow_tpu_torch.utils import checkpoint as ckpt

    mesh = mesh_for(rank, size, init)
    handlers = (tphold.handler,)
    out = {}
    for k in (1, 4):
        sim, st, _ = ckpt.run_windows(elastic_bundle(), handlers, mesh=mesh,
                                      windows_per_dispatch=k)
        leaves = convert.sim_to_numpy(sim)
        check_replicated(mesh, leaves)
        out[f"clean4_k{k}"] = (leaves, stats_dict(st))
    b = elastic_bundle()
    go = make_sharded_runner(b, mesh, app_handlers=handlers,
                             fault_fn=elastic.make_divergence_fault_fn(
                                 mesh, shard=ELASTIC_VICTIM,
                                 at_ns=ELASTIC_AT_NS))
    sim, _ = go(b.sim)
    out["diverged"] = elastic.sentinel_report(sim)
    # the poisoned ladder consumes the mesh: retry on 4, shrink to 2
    out["poison"] = elastic_supervised(
        elastic_bundle(), mesh, os.path.join(snap_dir, "poison"),
        dispatch_wrap=elastic.make_poisoned_dispatch(list(ELASTIC_POISON)))
    mesh.close()
    if rank < 2:
        two = Mesh(2, rank, init_method="file://" + os.path.join(
            snap_dir, "two.group"), device="cpu")
        sim, st, _ = ckpt.run_windows(elastic_bundle(), handlers, mesh=two)
        out["clean2"] = (convert.sim_to_numpy(sim), stats_dict(st))
        two.close()
    four = Mesh(size, rank, init_method="file://" + os.path.join(
        snap_dir, "kill.group"), device="cpu", timeout_s=ELASTIC_TIMEOUT_S)
    out["kill"] = elastic_supervised(
        elastic_bundle(), four, os.path.join(snap_dir, "kill"),
        dispatch_wrap=_kill_self_at(ELASTIC_KILL_AT) if rank == 3 else None)
    four.close()
    return out


# --- ProcessRuntime on a mesh (tests/test_torch_vproc_sharded.py) ------

# tests/test_vproc_sharded.py's graph: clients and servers on two
# vertices, 5 ms within a vertex and 25 ms across
VPROC_GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="type" attr.type="string" for="node" id="ty" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="c"><data key="up">10240</data><data key="dn">10240</data>
      <data key="ty">client</data></node>
    <node id="s"><data key="up">10240</data><data key="dn">10240</data>
      <data key="ty">server</data></node>
    <edge source="c" target="c"><data key="lat">5.0</data></edge>
    <edge source="c" target="s"><data key="lat">25.0</data></edge>
    <edge source="s" target="s"><data key="lat">5.0</data></edge>
  </graph>
</graphml>"""
VPROC_H = 8        # 4 client/server pairs, interleaved c0 s0 c1 s1 ...
VPROC_PORT = 7000


def _vproc_bundle(tcp, device, end_s):
    cfg = NetConfig(num_hosts=VPROC_H, end_time=end_s * SEC, tcp=tcp)
    hosts = []
    for i in range(VPROC_H // 2):
        hosts.append(tbuild.HostSpec(name=f"c{i}", type="client"))
        hosts.append(tbuild.HostSpec(name=f"s{i}", type="server"))
    return tbuild.build(cfg, VPROC_GRAPH, hosts, device=device)


def vproc_udp_echo(mesh=None, device="cpu"):
    """tests/test_vproc_sharded.py's program in the port: each client
    pings its server twice (UDP lengths, 1 s on), the server answers
    with the length plus its host id. Returns (sorted log, events,
    sim) — the log of every rank's hosts."""
    from shadow_tpu_torch.net.state import SocketType
    from shadow_tpu_torch.process import vproc

    b = _vproc_bundle(False, device, 15)
    log = []

    def server(host):
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, VPROC_PORT)
        for _ in range(2):
            sip, spt, n = yield vproc.recvfrom(fd)
            yield vproc.sendto(fd, sip, spt, n + host)
        yield vproc.close(fd)

    def client(sv_ip):
        def go(host):
            fd = yield vproc.socket(SocketType.UDP)
            yield vproc.bind(fd, 0)
            for i in range(2):
                yield vproc.sendto(fd, sv_ip, VPROC_PORT, 50 + i)
                _, _, n = yield vproc.recvfrom(fd)
                t = yield vproc.gettime()
                log.append((host, n, t))
            yield vproc.close(fd)
        return go

    rt = vproc.ProcessRuntime(b, mesh=mesh, device=None if mesh else device)
    for i in range(VPROC_H // 2):
        rt.spawn(b.host_of(f"s{i}"), server)
        rt.spawn(b.host_of(f"c{i}"), client(b.ip_of(f"s{i}")),
                 start_time=SEC)
    sim, stats = rt.run()
    return _all_logs(mesh, log), int(stats.events_processed), sim


def _all_logs(mesh, log):
    if mesh is None:
        return sorted(log)
    return sorted(x for part in mesh.all_gather_object(log) for x in part)


def vproc_shared(mesh=None, device="cpu"):
    """What the hosts share across ranks: every client talks to a
    server on the other rank (client i to server 3 - i). Clients 0 and
    2 send UDP datagrams with content (the payload pool) to a server
    whose echo runs in a thread (thread_create: its pid and the pool
    ids' allocation order); clients 1 and 3 stream 3,000 bytes over TCP
    and read back a digest (the stream FIFOs both ways). Returns
    (sorted log, events, sim, pool ids still live)."""
    import hashlib

    from shadow_tpu_torch.net.state import SocketType
    from shadow_tpu_torch.process import vproc

    b = _vproc_bundle(True, device, 12)
    log = []

    def udp_server(host):
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, VPROC_PORT)

        def worker(h):
            pid = yield vproc.getpid()
            log.append((h, "thread", pid))
            for _ in range(2):
                sip, spt, data = yield vproc.recvfrom_data(fd)
                yield vproc.sendto_data(fd, sip, spt,
                                        data[::-1] + bytes([h]))

        tid = yield vproc.thread_create(worker)
        yield vproc.thread_join(tid)
        yield vproc.close(fd)

    def udp_client(sv_ip):
        def go(host):
            fd = yield vproc.socket(SocketType.UDP)
            yield vproc.bind(fd, 0)
            for k in range(2):
                yield vproc.sendto_data(fd, sv_ip, VPROC_PORT,
                                        f"c{host}-{k}".encode() * 7)
                _, _, data = yield vproc.recvfrom_data(fd)
                log.append((host, "udp", data))
            yield vproc.close(fd)
        return go

    def tcp_server(host):
        fd = yield vproc.socket(SocketType.TCP)
        yield vproc.bind(fd, VPROC_PORT)
        yield vproc.listen(fd)
        child = yield vproc.accept(fd)
        chunks = []
        while True:
            data = yield vproc.recv_data(child)
            if data == b"":
                break
            chunks.append(data)
        yield vproc.send_data(child, hashlib.sha1(b"".join(chunks))
                              .digest())
        yield vproc.close(child)
        yield vproc.close(fd)

    def tcp_client(sv_ip):
        def go(host):
            payload = bytes((host * 7 + i) & 0xFF for i in range(3000))
            fd = yield vproc.socket(SocketType.TCP)
            yield vproc.connect(fd, sv_ip, VPROC_PORT)
            off = 0
            while off < len(payload):
                off += yield vproc.send_data(fd, payload[off:off + 1024])
            yield vproc.shutdown(fd)
            reply = b""
            while True:
                data = yield vproc.recv_data(fd)
                if data == b"":
                    break
                reply += data
            log.append((host, "tcp", reply,
                        reply == hashlib.sha1(payload).digest()))
            yield vproc.close(fd)
        return go

    rt = vproc.ProcessRuntime(b, mesh=mesh, device=None if mesh else device)
    n = VPROC_H // 2
    for i in range(n):
        srv = b.host_of(f"s{n - 1 - i}")
        rt.spawn(srv, udp_server if i % 2 == 0 else tcp_server)
    for i in range(n):
        ip = b.ip_of(f"s{n - 1 - i}")
        rt.spawn(b.host_of(f"c{i}"),
                 udp_client(ip) if i % 2 == 0 else tcp_client(ip),
                 start_time=SEC)
    sim, stats = rt.run()
    return (_all_logs(mesh, log), int(stats.events_processed), sim,
            sorted(rt.pool.live_ids()))


def vproc_cases(rank, size, init):
    """Both programs on this rank's mesh: {name: (log, events, leaves)}
    (rank 0's; every rank checks it holds the same global state)."""
    mesh = mesh_for(rank, size, init)
    out = {}
    for name, fn in (("udp_echo", vproc_udp_echo),
                     ("shared", vproc_shared)):
        log, ev, sim, *rest = fn(mesh)
        leaves = convert.sim_to_numpy(sim)
        check_replicated(mesh, leaves)
        out[name] = (log, ev, leaves, *rest)
    mesh.close()
    return out


def warm_sharded_case(rank, size, init, aot_dir):
    """The warm sharded runner (compile/serve.py) on the 8-host
    pingpong: make_sharded_runner(warm_start=True) twice against one
    program store — a miss, then a hit — and the serial runner's key
    for the same bundle. Returns {"runs": [(leaves, stats)] * 2,
    "infos": [miss, hit], "serial_key"}."""
    import os

    from shadow_tpu_torch.parallel import make_sharded_runner

    os.environ["SHADOW_AOT_DIR"] = aot_dir
    mesh = mesh_for(rank, size, init)
    runs, infos = [], []
    for _ in range(2):
        b = pingpong()
        info: dict = {}
        s, st = make_sharded_runner(b, mesh, app_handlers=(tping.handler,),
                                    warm_start=True,
                                    compile_info=info)(b.sim)
        leaves = convert.sim_to_numpy(s)
        check_replicated(mesh, leaves)
        runs.append((leaves, stats_dict(st)))
        infos.append(info)
    serial: dict = {}
    b = pingpong()
    tbuild.make_runner(b, app_handlers=(tping.handler,), device="cpu",
                       compile_info=serial)
    key_fn = tbuild._whole_run_key_fn(
        b, (tping.handler,), end=b.cfg.end_time, path="whole",
        chunk_windows=0, adaptive=False, fault_fn=None, app_bulk=None,
        app_tcp_bulk=None)
    mesh.close()
    return {"runs": runs, "infos": infos,
            "serial_key": key_fn((b.sim,), {})}


# --- sharded fleet jobs (tests/test_torch_fleet_mesh.py) ---------------

def rank_pid(job_dir, rank=1):
    """The pid a started rank of a sharded fleet job logs first in its
    job dir (fleet/scenario.py rank_main), or None before it does."""
    import os

    path = os.path.join(job_dir, f"rank{rank}.log")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        first = f.readline()
    return int(first.split("pid ")[1]) if "pid " in first else None


def kill_rank_after_checkpoint(job_dir, rank=1, timeout_s=120.0):
    """SIGKILL a started rank of a sharded fleet job once the job's
    first snapshot is on disk and the rank has logged its pid. Returns
    the pid killed (None when neither showed within `timeout_s`)."""
    import glob
    import os
    import signal
    import time

    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        pid = rank_pid(job_dir, rank)
        if pid is not None and glob.glob(os.path.join(job_dir, "ck.*.npz")):
            os.kill(pid, signal.SIGKILL)
            return pid
        time.sleep(0.02)
    return None


def fleet_exhaust_main(job_dir, spec_json) -> int:
    """A sharded job's rank 0 whose ladder cannot go on: the ElasticPolicy
    the job arms allows neither a shrink nor a serial rung, and rank 1
    is SIGKILLed after the first snapshot, so the retry finds a rank
    missing and the ladder is exhausted at 2 shards. Prints the job's
    result as one JSON line. Run as `python -c "import
    torch_shard_ranks as R; R.fleet_exhaust_main(dir, spec)"` from
    tests/."""
    import functools
    import json
    import threading

    from shadow_tpu_torch.fleet.scenario import run_job
    from shadow_tpu_torch.fleet.spec import JobSpec
    from shadow_tpu_torch.parallel import elastic

    elastic.ElasticPolicy = functools.partial(
        elastic.ElasticPolicy, allow_shrink=False, allow_serial=False)
    killed = []
    t = threading.Thread(target=lambda: killed.append(
        kill_rank_after_checkpoint(job_dir)), daemon=True)
    t.start()
    res = run_job(JobSpec.from_dict(json.loads(spec_json)), job_dir,
                  device="cpu")
    t.join(timeout=10)
    print(json.dumps({"killed": killed[0] if killed else None,
                      "result": res}), flush=True)
    return 0
