"""Scale harness (the port's tools/scale_run.py): run the BASELINE.json
workload shapes at scale and report events/s, the resident state's
bytes and the first dispatch's extra wall.

Workloads:
  phold  — PDES scheduler stress (configs #5 shape; default)
  relay  — Tor-relay circuits, 5-hop TCP chains (config #3 shape:
           --hosts 10240 = 2048 concurrent circuits)
  tor    — the shared-relay Tor model (consensus-weighted circuits)
  gossip — Bitcoin block flooding over a K-peer graph (config #4
           shape: --hosts 5120), over UDP or TCP

Usage:
  python -m shadow_tpu_torch.tools.scale_run --workload phold \\
      --hosts 102400 --sim-seconds 2 [--cpu]

It runs on the card unless --cpu asks for the CPU; without CUDA it
fails and names the device. With --shards N it starts ranks 1..N-1 as
processes of this module (parallel/shard.py RankProcesses) and runs
the window loop on an N-rank mesh: gloo on the CPU and for ranks that
share a card, NCCL across cards.

Prints one JSON line with the reference's keys:
  {"hosts", "workload", "topology", "shards", "platform", "events",
   "wall_s", "events_per_sec", "sim_sec_per_wall_sec", "compile_s",
   "device_bytes", "overflow", "verified"}
`platform` is "cuda" or "cpu". `device_bytes` counts the resident
state's tensors as the port holds them (the u32 planes are carried as
int64, so it exceeds the reference's for the same shape). `compile_s`
is the first dispatch's wall less the timed one's: an eager port
compiles no program, so it is the kernels' first-use build, the
allocator's warm-up and the first launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ONE_SECOND = 1_000_000_000   # core.simtime's, without importing torch
ONE_MILLISECOND = 1_000_000

# the capacity escalation's attempts (tight, then doubling)
ATTEMPTS = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="phold",
                    choices=["phold", "relay", "tor", "gossip"])
    ap.add_argument("--slots", type=int, default=8,
                    help="tor: max circuits one relay/server host "
                         "carries (consensus-weighted draw, capacity "
                         "capped); sockets_per_host = 2 + 2*slots")
    ap.add_argument("--gossip-transport", default="udp",
                    choices=["udp", "tcp"],
                    help="gossip: 'tcp' floods blocks over persistent "
                         "peer connections (the Bitcoin shape); 'udp' "
                         "is the datagram model (and the sharded/"
                         "ensemble one)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="ensemble mode: partition --hosts into R "
                         "independent replicas of H/R hosts in ONE "
                         "program. phold/gossip use block-diagonal "
                         "graphs, relay/tor confine circuits to their "
                         "block. Reports AGGREGATE events/s")
    ap.add_argument("--hosts", type=int, default=10240)
    ap.add_argument("--load", type=int, default=8)
    ap.add_argument("--hop", type=int, default=5,
                    help="relay circuit length: 5 = the Tor-relay shape "
                         "(config #3), 2 = pairwise client->server bulk "
                         "transfers (config #2's 1k-host tgen shape)")
    ap.add_argument("--bytes", type=int, default=100_000,
                    help="bytes per relay circuit")
    ap.add_argument("--allow-partial", action="store_true",
                    help="report completion fraction instead of "
                         "failing when transfers are unfinished at "
                         "end_time")
    ap.add_argument("--sim-seconds", type=int, default=2)
    ap.add_argument("--runahead", type=int, default=0,
                    help="minimum window in ms, 0 = the topology's "
                         "honest min path latency. Raising it runs "
                         "fewer, larger windows (events may execute up "
                         "to this much sim-time later than their causal "
                         "earliest point)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cap", type=int, default=0,
                    help="event/outbox/router queue capacity override "
                         "(0 = per-workload default). Overflow is "
                         "counted, so run tight and re-run larger only "
                         "on a nonzero overflow report.")
    ap.add_argument("--chunk", type=int, default=0,
                    help="run N windows per chunk under a host loop "
                         "(net.build.make_chunked_runner; the same "
                         "result as the whole run). 0 = whole run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--no-bulk", action="store_true",
                    help="disable the bulk window pass")
    ap.add_argument("--bulk-lossless", action="store_true",
                    help="the narrow loss-free TCP bulk pass: loss/"
                         "retransmit artifacts STOP a host's scan "
                         "(prefix-commit -> serial) instead of being "
                         "modeled. The same result for any workload")
    ap.add_argument("--topology", default="one",
                    choices=["one", "ref"],
                    help="'one' = the single-vertex 50 ms fixture; "
                         "'ref' = the reference Shadow tree's "
                         "Internet-derived graph, read from "
                         "$SHADOW_REF_TOPOLOGY")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the window loop on an N-rank mesh (0 = "
                         "single shard), one process per rank")
    return ap.parse_args(argv)


def ref_topology_text() -> str:
    """The reference Shadow tree's topology (resource/topology.graphml.
    xml.xz), from $SHADOW_REF_TOPOLOGY; the repo does not carry it."""
    import lzma

    path = os.environ.get("SHADOW_REF_TOPOLOGY")
    if not path:
        raise FileNotFoundError(
            "--topology ref reads the reference Shadow tree's "
            "resource/topology.graphml.xml.xz from $SHADOW_REF_TOPOLOGY, "
            "which is not set")
    if path.endswith(".xz"):
        with lzma.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def topology_text(args) -> str:
    from shadow_tpu_torch.bench import ONE_VERTEX

    return ref_topology_text() if args.topology == "ref" else ONE_VERTEX


def device_of(args):
    """The run's device: the CPU with --cpu, else the card (raises
    without CUDA)."""
    from shadow_tpu_torch.device import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _end_time(sim_s) -> int:
    return int(sim_s * ONE_SECOND)


def _hosts(H, start=ONE_SECOND):
    from shadow_tpu_torch.net.build import HostSpec

    return [HostSpec(name=f"n{i}", proc_start_time=start) for i in range(H)]


def _ring(b, ring):
    if ring:
        from shadow_tpu_torch import telemetry

        b.sim = telemetry.attach(b.sim)
    return b


def build_phold(H, load, sim_s, seed, cap, graph, device, replicas=1,
                ring=False):
    """bench.py's _build_phold as scale_run calls it: capacities `cap`,
    else max(16, 3*load) up to 4,096 hosts and 6*load above."""
    from shadow_tpu_torch.bench import build_phold as bench_phold

    if cap is None:
        cap = max(16, 3 * load) if H <= 4096 else 6 * load
    return bench_phold(H, load, sim_s, seed, cap, graph, device, ring=ring,
                       replica_size=H // replicas if replicas > 1 else None)


def build_relay(H, hop, total, sim_s, seed, cap, graph, device, replicas=1,
                ring=False):
    """Disjoint `hop`-host circuits [r*Hr + c*hop + k], confined to
    their replica block. The circuits ride on `b.circuits`."""
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.build import build
    from shadow_tpu_torch.net.state import NetConfig

    Hr = H // replicas
    cfg = NetConfig(num_hosts=H, seed=seed, end_time=_end_time(sim_s),
                    sockets_per_host=4, event_capacity=cap,
                    outbox_capacity=cap, router_ring=cap)
    b = build(cfg, graph, _hosts(H), device=device)
    circuits = [[r * Hr + c * hop + k for k in range(hop)]
                for r in range(replicas) for c in range(Hr // hop)]
    b.sim = relay.setup(b.sim, circuits=circuits, total_bytes=total)
    b.circuits = circuits
    return _ring(b, ring)


def tor_chains(H, seed, slots, replicas=1, hops=3):
    """60% clients / 30% relays / 10% servers per replica block; one
    `hops`-relay circuit per client, relays drawn by consensus weight
    and shared up to `slots` circuits per host."""
    from shadow_tpu_torch.apps import relay

    rng = np.random.default_rng(seed)
    Hr = H // replicas
    chains = []
    for r in range(replicas):
        base = r * Hr
        n_cl = int(Hr * 0.6)
        n_rl = int(Hr * 0.3)
        chains += relay.consensus_circuits(
            rng, n_circuits=n_cl,
            clients=list(range(base, base + n_cl)),
            relays=list(range(base + n_cl, base + n_cl + n_rl)),
            servers=list(range(base + n_cl + n_rl, base + Hr)),
            hops=hops, max_slots=slots)
    return chains


def build_tor(H, total, sim_s, seed, cap, graph, device, slots=8,
              replicas=1, chains=None, out_ring=8, emit_capacity=None,
              ring=False):
    """The shared-relay Tor shape over `chains` (default tor_chains).
    The chains ride on `b.circuits`."""
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.build import build
    from shadow_tpu_torch.net.state import NetConfig

    if chains is None:
        chains = tor_chains(H, seed, slots, replicas)
    cfg = NetConfig(num_hosts=H, seed=seed, end_time=_end_time(sim_s),
                    sockets_per_host=2 + 2 * slots, event_capacity=cap,
                    outbox_capacity=cap, router_ring=cap, out_ring=out_ring,
                    emit_capacity=emit_capacity)
    b = build(cfg, graph, _hosts(H), device=device)
    b.sim = relay.setup_shared(b.sim, circuits=chains, total_bytes=total,
                               max_slots=slots)
    b.circuits = chains
    return _ring(b, ring)


def gossip_blocks(sim_s) -> int:
    """Block b is mined at b * 2 s; the last needs ~1 s of flood
    headroom before the end, so the count follows the run's length."""
    return max(2, (int(sim_s) - 3) // 2 + 1)


def build_gossip(H, sim_s, seed, cap, graph, device, tcp=False, replicas=1,
                 blocks=None, peers=8, sockets=12, emit_capacity=None,
                 ring=False):
    """Gossip over UDP (in_ring 32, no PROC_START) or over
    persistent TCP peer links (`sockets` per host, out_ring 16, hosts
    started at 1 s); a block every 2 s, `blocks` of them (default
    gossip_blocks)."""
    from shadow_tpu_torch.apps import gossip
    from shadow_tpu_torch.net.build import build
    from shadow_tpu_torch.net.state import NetConfig

    blocks = gossip_blocks(sim_s) if blocks is None else blocks
    kw = dict(num_hosts=H, seed=seed, end_time=_end_time(sim_s),
              event_capacity=cap, outbox_capacity=cap, router_ring=cap)
    interval = 2 * ONE_SECOND
    if tcp:
        cfg = NetConfig(sockets_per_host=sockets, out_ring=16,
                        emit_capacity=emit_capacity, **kw)
        b = build(cfg, graph, _hosts(H), device=device)
        b.sim = gossip.setup_tcp(b.sim, peers_per_host=peers,
                                 block_interval=interval, max_blocks=blocks)
    else:
        cfg = NetConfig(tcp=False, in_ring=32, emit_capacity=emit_capacity,
                        **kw)
        b = build(cfg, graph, _hosts(H, start=None), device=device)
        b.sim = gossip.setup(b.sim, peers_per_host=peers,
                             block_interval=interval, max_blocks=blocks,
                             replica_size=H // replicas if replicas > 1
                             else None)
    b.blocks = blocks
    return _ring(b, ring)


def runner_kwargs(workload, bulk=True, lossless=False,
                  transport="udp") -> dict:
    """make_runner's keywords for `workload`: its handler, and its bulk
    pass unless `bulk` is False (--no-bulk; the narrow TCP pass with
    `lossless`, --bulk-lossless). `transport` is gossip's
    (--gossip-transport)."""
    if workload == "phold":
        from shadow_tpu_torch.apps import phold

        return dict(app_handlers=(phold.handler,),
                    app_bulk=phold.BULK if bulk else None)
    if workload == "gossip":
        from shadow_tpu_torch.apps import gossip

        return dict(app_handlers=(gossip.tcp_handler if transport == "tcp"
                                  else gossip.handler,))
    from shadow_tpu_torch.apps import relay

    tor = workload == "tor"
    kw = dict(app_handlers=(relay.mux_handler if tor else relay.handler,))
    if bulk:
        kw["app_tcp_bulk"] = relay.MUX_TCP_BULK if tor else relay.TCP_BULK
        if lossless:
            kw["tcp_bulk_lossless"] = True
    return kw


def build_workload(args, seed, cap, device=None, graph=None, **extra):
    """(bundle, runner kwargs, verify(sim) -> bool) of the workload
    `args` names, at `seed` and queue capacity `cap` (None = the
    workload's default), on `device` (None -> the device of `args`:
    the CPU with --cpu, else the card). `graph` replaces the topology
    of `args`; `extra` goes to the workload's builder (ring, and the
    shape overrides each builder names). verify.fraction is the
    completion share where the workload has one."""
    device = device_of(args) if device is None else device
    graph = topology_text(args) if graph is None else graph
    H = args.hosts
    R = max(args.replicas, 1)
    if H % R:
        raise SystemExit(f"--replicas {R} must divide --hosts {H}")
    sim_s = args.sim_seconds
    kw = runner_kwargs(args.workload, bulk=not args.no_bulk,
                       lossless=args.bulk_lossless,
                       transport=args.gossip_transport)
    if args.workload == "phold":
        b = build_phold(H, args.load, sim_s, seed, cap, graph, device,
                        replicas=R, **extra)
        return b, kw, lambda sim: int(sim.app.rcvd.sum()) > 0
    if args.workload == "relay":
        from shadow_tpu_torch.apps import relay

        total = args.bytes
        b = build_relay(H, args.hop, total, sim_s, seed, cap, graph, device,
                        replicas=R, **extra)

        def verify(sim):
            rcvd = sim.app.rcvd.cpu().numpy()
            servers = sim.app.role.cpu().numpy() == relay.ROLE_SERVER
            verify.fraction = float(
                np.minimum(rcvd[servers] / total, 1.0).mean())
            return bool((rcvd[servers] == total).all())
        return b, kw, verify
    if args.workload == "tor":
        b = build_tor(H, args.bytes, sim_s, seed, cap, graph, device,
                      slots=args.slots, replicas=R, **extra)
        want = float(len(b.circuits) * args.bytes)

        def verify(sim):
            got = float(sim.app.rcvd.sum())
            verify.fraction = min(got / want, 1.0) if want else 1.0
            return got == want
        return b, kw, verify
    if sim_s < 5 and "blocks" not in extra:
        raise SystemExit("gossip needs --sim-seconds >= 5")
    if args.gossip_transport == "tcp":
        if R > 1:
            raise SystemExit("gossip tcp transport has no ensemble mode; "
                             "use udp")
        b = build_gossip(H, sim_s, seed, cap, graph, device, tcp=True,
                         **extra)
        last = b.blocks - 1

        def verify(sim):
            tips = sim.app.tip.cpu().numpy()
            verify.fraction = float((tips == last).mean())
            return bool((tips == last).all())
        return b, kw, verify
    b = build_gossip(H, sim_s, seed, cap, graph, device, replicas=R, **extra)
    last = b.blocks - 1
    return b, kw, lambda sim: bool((sim.app.tip == last).all())


def overflow_of(sim) -> int:
    """Events dropped for want of room: the event queue's, the
    outbox's and the router queue's counters."""
    return (int(sim.events.overflow) + int(sim.outbox.overflow)
            + int(sim.net.rq_overflow))


def state_bytes(sim) -> int:
    """The bytes of one resident state's tensors, as the port holds
    them."""
    from shadow_tpu_torch import convert

    return sum(t.numel() * t.element_size()
               for t in convert.sim_tensors(sim).values())


def make_shard_aware_runner(b, mesh, device, **kw):
    """make_runner, or make_sharded_runner on `mesh` when it has more
    than one rank (bench.py's selection)."""
    if mesh is not None and mesh.size > 1:
        from shadow_tpu_torch.parallel import make_sharded_runner

        return make_sharded_runner(b, mesh, **kw)
    from shadow_tpu_torch.net.build import make_runner

    return make_runner(b, device=device, **kw)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(args, device, mesh=None, say=None) -> tuple:
    """The escalating warm-up and timed runs: (the JSON row, the timed
    run's final state, the final event capacity). Tight capacity first
    (a clean overflow == 0 run at a tight capacity is sound and fast),
    doubled on a counted overflow; the warm-up on --seed, the timed run
    on --seed + 1."""
    from shadow_tpu_torch.net.build import make_chunked_runner

    say = say or (lambda m: print(m, flush=True))
    cap = args.cap or (0 if args.workload == "phold" else 64)
    for _ in range(ATTEMPTS):
        b, kw, verify = build_workload(args, args.seed, cap or None, device)
        if args.runahead:
            # raise-only: below the topology's honest minimum there is
            # no fidelity to regain, only more windows
            b.min_jump = max(b.min_jump, args.runahead * ONE_MILLISECOND)
        if args.chunk:
            fn = make_chunked_runner(b, chunk_windows=args.chunk,
                                     device=device, **kw)
        else:
            fn = make_shard_aware_runner(b, mesh, device, **kw)
        _sync(device)
        t0 = time.perf_counter()
        sim, stats = fn(b.sim)
        _sync(device)
        first = time.perf_counter() - t0
        if overflow_of(sim):
            cap = (cap or b.cfg.event_capacity) * 2
            say(f"# overflow at capacity {b.cfg.event_capacity}; "
                f"retrying at {cap}")
            continue
        b2, _, verify = build_workload(args, args.seed + 1, cap or None,
                                       device)
        _sync(device)
        t0 = time.perf_counter()
        sim, stats = fn(b2.sim)
        ev = int(stats.events_processed)
        wall = time.perf_counter() - t0
        if not overflow_of(sim):
            break
        cap = (cap or b.cfg.event_capacity) * 2
        say(f"# overflow on timed seed at capacity "
            f"{b.cfg.event_capacity}; retrying at {cap}")
    else:
        raise SystemExit("still overflowing after capacity escalation")
    verified = verify(sim)
    fraction = getattr(verify, "fraction", 1.0 if verified else 0.0)
    row = {
        **({"completion_fraction": round(fraction, 4)}
           if fraction < 1.0 else {}),
        "hosts": args.hosts,
        "workload": args.workload,
        **({"replicas": args.replicas} if args.replicas > 1 else {}),
        **({"runahead_ms": args.runahead} if args.runahead else {}),
        "topology": args.topology,
        "shards": args.shards,
        "platform": device.type,
        "events": ev,
        "wall_s": round(wall, 3),
        "events_per_sec": round(ev / wall, 1),
        "sim_sec_per_wall_sec": round(args.sim_seconds / wall, 3),
        "compile_s": round(first - wall, 1),
        "device_bytes": state_bytes(sim),
        "overflow": overflow_of(sim),
        "verified": verified,
    }
    return row, sim, b.cfg.event_capacity


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.bulk_lossless and (
            args.no_bulk or args.workload in ("phold", "gossip")):
        raise SystemExit(
            "--bulk-lossless only applies to the TCP bulk pass "
            "(relay/tor workloads, without --no-bulk)")
    if args.chunk and args.shards > 1:
        raise SystemExit(
            "--chunk is not implemented for the sharded runner; "
            "drop --shards or run the whole run (--chunk 0)")
    from shadow_tpu_torch.parallel.shard import (RankProcesses,
                                                 die_with_parent, rank_env)

    device = device_of(args)
    rank, world, init = rank_env()
    mesh = ranks = None
    if args.shards > 1:
        import atexit

        from shadow_tpu_torch.parallel import Mesh

        if world is None:
            ranks = RankProcesses(
                "shadow_tpu_torch.tools.scale_run",
                list(sys.argv[1:] if argv is None else argv), args.shards)
            atexit.register(ranks.kill)
            init = ranks.init
        else:
            die_with_parent()
        mesh = Mesh(args.shards, rank, init_method=init, device=device)
        device = mesh.device
    try:
        row, _, _ = run(args, device, mesh)
    finally:
        if mesh is not None:
            mesh.close()
    code = 0 if ranks is None else ranks.join()
    if rank:
        return code
    print(json.dumps(row))
    if not row["verified"] and args.allow_partial:
        return code
    assert row["verified"], "workload did not complete correctly"
    return code


if __name__ == "__main__":
    raise SystemExit(main())
