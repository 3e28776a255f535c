#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (shadow_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py              # what the acceptance check runs
    python3 chip_smoke.py --profile    # also a torch.profiler window

Phases, in order; any failure exits non-zero and prints no result:

1. the device (nvidia-smi name and power limit, torch's device name);
2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the card, exact
   int32 equality, at the main path's shape and at a ragged shape (and
   mailbox_gather again at the TCP relay's width, P = 22, at the Tor
   cell's widest route, 10,240 hosts x 256 columns, and at the gossip
   cells' route shapes, 5,120 hosts x 24 and 64 columns at P = 11 and
   22), with CUDA-event timings of the kernel, the plain version and
   one PyTorch library call computing the same function (one event
   pair around many calls that cycle through input sets larger than
   the L2) at the main shape, the relay's and the Tor cell's;
4. the main path at full width: bench.py's default PHOLD program —
   10,240 hosts, load 8, the one-vertex 50 ms topology, capacities 48
   and in_ring 16 as bench.py settles them, 5 simulated seconds, the
   bulk window pass (phold.BULK), the default sparse-lane budget (256)
   and the telemetry ring — with the launch counters reset just before
   and read just after; checks zero overflow, sent == H*load + rcvd,
   hit + miss == windows and the ring against EngineStats;
   4a. the serial path (no bulk pass, sparse_lanes=0, no ring) at full
   width for 1 simulated second;
   4b. the bulk program in both EventOrder forms ("cube", the card's
   default, and "sort") at full width for 1 simulated second: equal
   EngineStats and every leaf equal, with the bulk pass's time per
   window (CUDA-event pair and host clock) and launches per call;
   4c. bench.py's sparse shape (10,240 hosts, 64 active, no bulk pass)
   for 1 simulated second with sparse_lanes=256 and 0: the fast path
   hits, every leaf equal, EngineStats equal apart from hit/miss;
5. small runs on CUDA and on the CPU inside the port — PHOLD at 64
   hosts serial, with the bulk pass and ring, and with 4 active and
   sparse_lanes=16; the TCP relay serial at 10 hosts (2 circuits x 5
   hops, 15,000 bytes, ring on) and at 4 hosts (2 circuits x 2 hops,
   25,000 bytes, 1% loss), and through the TCP bulk pass at 10 hosts
   with 30,000 bytes and at the 4-host shape with
   tcp_bulk_lossless=True — each with equal EngineStats and
   every state leaf equal (tolerance zero — the state is integer apart
   from bit-exact f32 draws);
6. the TCP relay at full width as tools/scale_run.py runs it by default
   (--workload relay --hosts 10240): BASELINE config #3 — 2,048
   disjoint 5-hop circuits, 100,000 bytes each, the one-vertex 50 ms
   topology, 4 sockets per host, capacities 64, PROC_START at 1 s, the
   default sparse budget and the ring, 4 simulated seconds, the TCP
   bulk pass (relay.TCP_BULK) — checking every transfer complete, the
   reference's counts (894,976 events, 22 windows, 6 micro-steps), zero
   overflow, hit + miss == windows, the ring's events and retx planes
   against EngineStats and tcp.retx_segs, and mailbox_gather launched;
   it prints the pass's iterations per window, its ms per iteration on
   the device clock (a CUDA-event pair per call) and the host clock,
   and replays one mid-transfer window's call: with debug=True (the
   share of hosts that commit, the abort bits of those that stopped)
   and under torch.profiler (launches and cudaStreamSynchronize per
   iteration, device-busy share);
   6s. the same cell serial (scale_run's --no-bulk), with the
   reference's counts (281 micro-steps), held against phase 6 under the
   reference's bulk-vs-serial contract (tests/test_tcp_bulk.py) with
   fewer micro-steps with the pass;
   6a. the same shape lossy with the TCP bulk pass: 5,120 two-hop
   circuits, 50,000 bytes each, 1% loss on the self-edge, every
   transfer complete, and the serial path's counters (351,064 events,
   62 windows, 2,310 retransmitted segments, 1,421 fast-recovery
   entries); 6as the lossy cell serial and with the pass, both cut to
   1.8 sim-s, held to each other under the contract;

7. UDP gossip, BASELINE config #4, as tools/scale_run.py --workload
   gossip --hosts 5120 --sim-seconds 5 builds it (K = 8 peers, 2
   blocks, capacities 64, in_ring 32), plus the ring, at full width and
   depth: every tip at the last block, the reference's counts (174,144
   events, 17 windows, 199 micro-steps), zero overflow, hit + miss ==
   windows, the ring against EngineStats, mailbox_gather launched
   and equal to its plain version on the inputs the run's route gave
   it;
8. the shared-relay Tor model as tools/scale_run.py --workload tor
   --hosts 10240 builds it (6,144 three-relay circuits drawn by
   consensus weight, 8 slots, 18 sockets, out_ring 8, 100,000 bytes,
   relay.MUX_TCP_BULK), with capacities 256 and emit_capacity 40 (see
   TOR_CAP), plus the ring, cut to 1.25 sim-s: the reference's counts
   for that end time (92,246 events, 6 windows, 41 micro-steps), the
   checks of 7, the TCP bulk pass's iterations per window and a debug
   replay of one window's call (commit share);
9. CUDA against CPU inside the port at the reference tests' small
   shapes: the Tor model at 10 hosts to 10 sim-s (serial and with the
   TCP bulk pass, every stream complete, then held to each other under
   the reference's contract), UDP gossip at 64 hosts and TCP gossip at
   8 hosts (cut to 4 sim-s);
10. TCP gossip as tools/scale_run.py --workload gossip
   --gossip-transport tcp --hosts 5120 builds it (K = 8, 12 sockets,
   out_ring 16), with emit_capacity 40, plus the ring, cut to 2
   sim-s (the mesh handshakes): the reference's counts (67,323 events,
   5 windows, 38 micro-steps) and the checks of 7;
11. bench.py's pingpong workload as `python -m shadow_tpu_torch.bench`
   runs it with BENCH_WORKLOAD=pingpong (through its runner; its JSON
   row printed): 10,240 hosts, 5,120 client/server pairs, 20 UDP
   pings each, __graft_entry__'s one-vertex 50 ms graph, 5 sim-s —
   every host at 20 received, the reference's counts scaled per pair
   (209,920 events, 41 windows, 41 micro-steps), zero overflow, every
   client's RTT sum 2 s, mailbox_gather launched and equal to its plain
   version on the run's route inputs, one window replayed;
12. chunked and checkpointed dispatch on bench's default PHOLD program
   (10,240 hosts, load 8, capacities 48, bulk pass, ring) to 1 sim-s:
   make_runner, make_chunked_runner (K = 8), run_windows at K = 1 with
   a snapshot at 0.5 s, then the snapshot loaded on the card and
   resumed to the end, and run_windows at K = 16 with the adaptive
   rule — equal EngineStats and every leaf equal — and the snapshot
   loaded onto the CPU equal to the card's; its bytes and save and load
   seconds; then PHOLD on bench.py's MIX_VERTICES (~1.1 ms windows) to
   0.1 sim-s through make_runner and run_windows at K = 16, leaf-equal,
   with ms per window;
13. faults at full width: (13a) phase 4's program with
   examples/faultplan_degraded.json installed — at 1,024 hosts the
   reference's exact counts (events, windows, micro-steps, reliability
   drops), then at 10,240 hosts make_runner, make_chunked_runner (K =
   8), run_supervised at K = 1 and K = 8 (a snapshot every 32 windows)
   and a supervised run stopped at the first barrier past 2.2 s and
   resumed from its snapshot: every run leaf-equal to make_runner with
   equal EngineStats, conserve.check clean over every barrier, health
   not fatal, zero overflow, drops > 0, no window straddling a record
   time; the snapshot's bytes and save and load seconds; the fault
   replay's launches, copies and ms in a window before and after a
   record; (13b) pingpong at 10,240 hosts with every 80th server
   crashed at 1.0 s and restarted at 1.5 s — the reference's counts
   scaled per pair, crashed pairs at 0 received, the others at 20 with
   a 2-s RTT sum, and the crash reset's cost per window — and a 3-host
   TCP relay whose relay crashes mid-transfer, CUDA against CPU leaf by
   leaf; (13c) the program with an event queue of 16 (the reference's
   1,024-host run overflows it; here the first barrier does), to 0.3
   sim-s under
   run_supervised(escalation=EscalationPolicy()): healed with no retry,
   zero overflow, tests/test_escalate.py's checks, and leaf-equal to a
   from-scratch run at the grown capacity.

Phases 7, 8, 10 and 11 each replay one window through the engine's own
core.engine.step_window, from the state the run held at its start
(micro-steps timed one by one through a step_fn shim, then the first
again under torch.profiler: launches and cudaStreamSynchronize per
micro-step). The last log line before the results gives each
phase's seconds.

`--profile` also profiles windows 0-2 of phase 4 and windows 10-12 of
phase 6 with the TCP bulk pass.

The last lines are the nvidia-smi line, one JSON object listing every
kernel, and {"ok": true, "device": {...}}. The script imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

# H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12
# Bytes the cold timings cycle through, twice the H100's 50 MB L2.
COLD_BYTES = 100e6

# The main path: bench.py's default workload on an accelerator, with
# the capacities bench settles on at this size.
HOSTS = 10_240
LOAD = 8
SIM_S = 5.0
CAPACITY = 48
IN_RING = 16


# The relay cell: BASELINE config #3 as tools/scale_run.py builds it
# (--workload relay: --hop 5, --bytes 100000, capacities 64, 4 sockets
# per host, PROC_START at 1 s).
RELAY_HOP = 5
RELAY_BYTES = 100_000
RELAY_CAP = 64
RELAY_SIM_S = 4.0
# The reference's counts for the relay cell (its CPU runs of the same
# config at full width): with the TCP bulk pass, and serial.
RELAY_EXPECT = {"events_processed": 894_976, "windows": 22, "micro_steps": 6}
RELAY_SERIAL_EXPECT = dict(RELAY_EXPECT, micro_steps=281)
# The lossy relay (phase 6a): two-hop circuits over a 1% loss self-edge.
LOSSY_HOP = 2
LOSSY_BYTES = 50_000
LOSSY_LOSS = 0.01
LOSSY_SIM_S = 10.0
# The lossy cell's counters on the serial path (the reference's CPU
# run of the same config gives the same).
LOSSY_EXPECT = {"events_processed": 351_064, "windows": 62,
                "retx_segs": 2_310, "fr_entries": 1_421}
# The mid-transfer window whose TCP bulk call is replayed with
# debug=True (and, in phase 6, under the profiler): phase 6's window 9
# (11 iterations: profiling the busiest, 42, costs ~45 s), phase 6a's
# window 12.
RELAY_KEEP_WINDOW = 9
LOSSY_KEEP_WINDOW = 12
# The lossy serial twin 6as runs to a cut depth, beside a run of its
# cell with the TCP bulk pass to the same depth (the contract compares
# like with like): at full depth it took 102 s of a 558-s run on an
# NVIDIA H100 80GB HBM3 at 700 W. 1.8 sim-s holds 108 of the lossy
# cell's 374 serial micro-steps (the first losses, retransmits and
# recoveries); 6a's exact counters cover the rest.
LOSSY_SERIAL_SIM_S = 1.8


# Phase 7: UDP gossip, BASELINE config #4, as tools/scale_run.py
# --workload gossip --hosts 5120 --sim-seconds 5 builds it: K = 8 peers,
# a block every 2 s, max(2, (5 - 3) // 2 + 1) = 2 blocks, tcp=False,
# in_ring 32, capacities 64 (scale_run's first and smallest; no
# overflow), hosts started at 0; plus the telemetry ring.
GOSSIP_HOSTS = 5_120
GOSSIP_K = 8
GOSSIP_BLOCKS = 2
GOSSIP_CAP = 64
GOSSIP_SIM_S = 5.0
# The reference's counts for this config (its CPU run, seed 1).
GOSSIP_EXPECT = {"events_processed": 174_144, "windows": 17,
                 "micro_steps": 199}
# The windows phases 7, 8 and 10 replay for launches and syncs per
# micro-step (block 0's flood; a data window; a handshake window).
GOSSIP_KEEP_WINDOW = 1
TOR_KEEP_WINDOW = 4
GTCP_KEEP_WINDOW = 1
# Phase 8: the shared-relay Tor model as tools/scale_run.py --workload
# tor --hosts 10240 builds it: 60% clients, 30% relays, 10% servers, one
# 3-relay circuit per client drawn by consensus weight (seed 1), 8
# slots, 18 sockets, out_ring 8, 100,000 bytes, PROC_START at 1 s, the
# TCP bulk pass (relay.MUX_TCP_BULK); plus the ring. Two settings differ
# from scale_run's defaults. emit_capacity is 40, not nic_drain + 6 =
# 10: the PROC_START micro-step issues one tcp_connect per slot (8), so
# the default buffer overflows in the reference itself (counted in
# events.overflow), and scale_run's escalation raises only the queue
# capacities, which cannot help. Capacities are 256: with emit_capacity
# 40 the reference's 100-host run still overflows its queues at 128 and
# runs clean at 256, as its 1,024-host run does (their CPU runs).
TOR_HOSTS = 10_240
TOR_SLOTS = 8
TOR_HOPS = 3
TOR_BYTES = 100_000
TOR_CAP = 256
TOR_EMIT = 40
# Depth cut to 1.25 sim-s: the connect/accept windows and the first
# data windows (a full-depth run is ~2,400 serial-heavy micro-steps).
TOR_SIM_S = 1.25
# The reference's counts for this config to that end time (its CPU run
# at 10,240 hosts; no overflow of any kind).
TOR_EXPECT = {"events_processed": 92_246, "windows": 6, "micro_steps": 41}
# Phase 10: TCP gossip as tools/scale_run.py --workload gossip
# --gossip-transport tcp --hosts 5120 --sim-seconds 5 builds it: K = 8,
# 12 sockets, out_ring 16, PROC_START at 1 s, 2 blocks every 2 s from
# 2 s; plus the ring. emit_capacity is 40 for the reason of phase 8 (the
# connect burst is one tcp_connect per peer, 8); capacities 64,
# scale_run's first and smallest, stay clean to this end time in the
# reference.
GTCP_HOSTS = 5_120
GTCP_CAP = 64
GTCP_EMIT = 40
# Depth cut to 2 sim-s: the mesh handshakes (8 edges per host) and the
# mining of block 0.
GTCP_SIM_S = 2.0
GTCP_EXPECT = {"events_processed": 67_323, "windows": 5, "micro_steps": 38}
# Phase 9's small shapes: the reference tests' (tests/test_relay_mux.py,
# tests/test_gossip_tcp.py). The mux runs at the test's full depth, 10
# sim-s (the server's EOFs at 1.553 s; 211 serial micro-steps, 57 s on
# the card); TCP gossip is cut from 12 to 4 sim-s so that it takes well
# under a minute on the card (block 0 at every host, block 1 just
# mined).
MUX_SLOTS = 4
MUX_BYTES = 20_000
MUX_SIM_S = 10.0
SMALL_GTCP_SIM_S = 4.0


# Phase 11: bench.py's pingpong (BENCH_WORKLOAD=pingpong) at 10,240
# hosts: __graft_entry__._build with tcp=False, count=20, 5 sim-s. The
# pairs are independent and identical, so the counts scale per pair
# from the reference's CPU run of the 2-host config (41 events, 41
# windows, 41 micro-steps: the PROC_START, 20 pings, 20 echoes, one
# window each); its 1,024-host run gives 20,992 = 512 x 41 events and
# the same 41 windows and micro-steps. Every window holds 5,120 active
# hosts, over the sparse budget of 256: all 41 miss the fast path.
PING_HOSTS = 10_240
PING_COUNT = 20
PING_SIM_S = 5
PING_EXPECT = {"events_processed": PING_HOSTS // 2 * 41, "windows": 41,
               "micro_steps": 41, "fastpath_hit": 0, "fastpath_miss": 41}
# 20 round trips over the 50 ms self-edge (2 x 50 ms each)
PING_RTT_SUM = 20 * 100_000_000
PING_KEEP_WINDOW = 10
# Phase 12: bench's default PHOLD program at full width, cut to 1 sim-s,
# snapshot at 0.5 s; chunks of 8 and 16 windows; MIX_VERTICES to
# 0.1 sim-s (~90 windows of ~1.1 ms).
CK_SIM_S = 1
CK_EVERY_NS = 500_000_000
MIX_SIM_S = 0.1
MIX_CHUNK = 16
# Phase 13: faults. 13a is phase 4's program with bench.py's degraded
# plan installed (loss flaps over [1.0, 1.5) and [3.0, 3.5) s, +20 ms
# latency over [2.0, 2.5) s). The same program at FAULT_SMALL_HOSTS
# gives the reference's exact counts, from its CPU run (run from the
# repository root with jax and this package importable):
#
#   import jax; jax.config.update("jax_platforms", "cpu")
#   from shadow_tpu import faults; from shadow_tpu.apps import phold
#   from shadow_tpu.net.build import HostSpec, build, make_runner
#   from shadow_tpu.net.state import NetConfig
#   from shadow_tpu_torch.bench import ONE_VERTEX
#   H = 1024
#   cfg = NetConfig(num_hosts=H, tcp=False, end_time=5 * 10**9, seed=1,
#                   event_capacity=48, outbox_capacity=48,
#                   router_ring=48, in_ring=16)
#   b = build(cfg, ONE_VERTEX,
#             [HostSpec(name=f"peer{i}", proc_start_time=0)
#              for i in range(H)])
#   b.sim = phold.setup(b.sim, load=8)
#   faults.install(b, faults.records_from_json(
#       open("examples/faultplan_degraded.json").read()))
#   sim, st = make_runner(b, app_handlers=(phold.handler,),
#                         app_bulk=phold.BULK)(b.sim)
#   print(st, int(sim.net.ctr_drop_reliability.sum()))
#
# (98 windows: fewer than the fault-free 101 — the latency spike pushes
# window starts later — in spite of the record clamps.)
FAULT_PLAN = "examples/faultplan_degraded.json"
FAULT_SMALL_HOSTS = 1_024
FAULT_SMALL_EXPECT = {"events_processed": 591_839, "windows": 98,
                      "micro_steps": 47, "fastpath_hit": 6,
                      "fastpath_miss": 92}
FAULT_SMALL_DROPS = 4_222
FAULT_CKPT_WINDOWS = 32
FAULT_CHUNK = 8
FAULT_STOP_NS = 2_200_000_000   # inside the latency spike
# 13b: phase 11's pingpong with every 80th server (64 of 5,120) crashed
# at 1.0 s and restarted at 1.5 s. The pairs are independent, so the
# counts scale per pair from the reference's 2-host runs: a clean pair
# 41 events (phase 11); a crashed pair 3 — its client's PROC_START, the
# crash wakeup and the restart's PROC_START; the ping reaches a server
# that is down and is flushed, so the client waits for ever (0
# received). Windows and micro-steps are the clean pairs' 41. The
# reference's 1,024-host run with every 80th server crashed (7) gives
# 20,726 = 7 x 3 + 505 x 41 events, 41 windows, 41 micro-steps, and its
# 1,280-host run with 8 crashed (the same share as here) 25,936 =
# 8 x 3 + 632 x 41. Its command: __graft_entry__._build(H, end_time_s=5, count=20,
# tcp=False), faults.install with a CRASH record (t_ns=10**9) and a
# RESTART record (t_ns=1.5e9) for each crashed server, then
# make_runner(b, app_handlers=(pingpong.handler,)).
CRASH_EVERY = 80
CRASH_NS, RESTART_NS = 1_000_000_000, 1_500_000_000
CRASH_PAIRS = PING_HOSTS // 2 // CRASH_EVERY
CRASH_EXPECT = {"events_processed": CRASH_PAIRS * 3
                + (PING_HOSTS // 2 - CRASH_PAIRS) * 41,
                "windows": 41, "micro_steps": 41, "fastpath_hit": 0,
                "fastpath_miss": 41}
# the crash reset of TCP rows, CUDA against CPU: a 3-host circuit
# (client, relay, server), 20,000 bytes on a 25 ms 10,240 KiB/s
# self-edge, the relay down over [1.2, 2.0) s (the shape of
# tests/test_torch_faults.py)
RELAY_CRASH_GRAPH = ONE_VERTEX.replace(
    '<data key="lat">50.0</data>', '<data key="lat">25.0</data>').replace(
    "102400", "10240")
# 13c: phase 4's program with the event queue at ESC_CAP, which the
# reference's 1,024-host CPU run shows to overflow (the command of 13a
# with event_capacity=ESC_CAP and no plan: 456 events dropped), cut to
# ESC_SIM_S, under run_supervised(escalation=EscalationPolicy()). At
# 10,240 hosts the initial burst overflows it at the first barrier, so
# the heal reboots at the grown capacity (no snapshot precedes the
# trip); tests/test_torch_supervisor.py transplants a mid-run one.
ESC_CAP = 16
ESC_SIM_S = 0.3
ESC_CKPT_WINDOWS = 4

T0 = time.perf_counter()
# simtime.INVALID: an empty event slot
INVALID_TIME = 2**63 - 1


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *a, flush=True)


def build_phold(H, load, sim_s, seed, device, cap=None, sparse_lanes=0,
                active_hosts=None, ring=False, event_capacity=None):
    """A PHOLD bundle through the port's entry points: build,
    phold.setup, and telemetry.attach when `ring`. `sparse_lanes=None`
    takes the engine default, as bench.py does; `event_capacity`
    overrides `cap` for the event queue alone."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    kw = {}
    if cap is not None:
        kw = dict(event_capacity=cap, outbox_capacity=cap, router_ring=cap)
    if event_capacity is not None:
        kw["event_capacity"] = event_capacity
    cfg = NetConfig(num_hosts=H, tcp=False, seed=seed, in_ring=IN_RING,
                    end_time=int(sim_s * simtime.ONE_SECOND),
                    sparse_lanes=sparse_lanes, **kw)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, ONE_VERTEX, hosts, device=device)
    b.sim = phold.setup(b.sim, load=load, active_hosts=active_hosts)
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b


def one_vertex(loss=0.0):
    """ONE_VERTEX, with `loss` as the self-edge's packetloss."""
    if not loss:
        return ONE_VERTEX
    return ONE_VERTEX.replace(
        '<key attr.name="bandwidthup"',
        '<key attr.name="packetloss" attr.type="double" for="edge" '
        'id="pl" />\n  <key attr.name="bandwidthup"').replace(
        '<data key="lat">50.0</data>',
        f'<data key="lat">50.0</data><data key="pl">{loss}</data>')


def build_relay(H, hop, total, sim_s, seed, device, loss=0.0, ring=True):
    """A relay bundle through the port's entry points, as
    tools/scale_run.py builds --workload relay: disjoint `hop`-host
    circuits [c*hop + k], build, relay.setup, and telemetry.attach when
    `ring`. The sparse budget is the default."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(num_hosts=H, seed=seed,
                    end_time=int(sim_s * simtime.ONE_SECOND),
                    sockets_per_host=4, event_capacity=RELAY_CAP,
                    outbox_capacity=RELAY_CAP, router_ring=RELAY_CAP)
    hosts = [HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = build(cfg, one_vertex(loss), hosts, device=device)
    circuits = [[c * hop + k for k in range(hop)] for c in range(H // hop)]
    b.sim = relay.setup(b.sim, circuits=circuits, total_bytes=total)
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b, circuits


def relay_runner(b, device, tcp_bulk=True, lossless=False):
    """The relay's runner as tools/scale_run.py makes it: the TCP bulk
    pass on unless `tcp_bulk` is False (scale_run's --no-bulk)."""
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.build import make_runner

    return make_runner(b, app_handlers=(relay.handler,),
                       app_tcp_bulk=relay.TCP_BULK if tcp_bulk else None,
                       tcp_bulk_lossless=lossless, device=device)


def main_runner(b, device, bulk=True):
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    return make_runner(b, app_handlers=(phold.handler,),
                       app_bulk=phold.BULK if bulk else None, device=device)


def assert_same_run(label, a, b, skip_stats=()):
    """EngineStats (apart from `skip_stats`) and every state leaf of two
    (stats, sim) results equal, tolerance zero."""
    import numpy as np

    from shadow_tpu_torch import convert

    (sa, sim_a), (sb, sim_b) = a, b
    da = {k: v for k, v in sa.as_dict().items() if k not in skip_stats}
    db = {k: v for k, v in sb.as_dict().items() if k not in skip_stats}
    if da != db:
        raise AssertionError(f"{label}: EngineStats differ: {da} vs {db}")
    la, lb = convert.sim_to_numpy(sim_a), convert.sim_to_numpy(sim_b)
    if la.keys() != lb.keys():
        raise AssertionError(f"{label}: leaf sets differ")
    bad = [k for k in la if la[k].dtype != lb[k].dtype
           or not np.array_equal(la[k], lb[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, first "
                             f"{bad[:5]}")
    return len(la)


def device_ms(fns, reps=200):
    """Device time (ms) of one call, from one CUDA-event pair around
    `reps` calls back to back, cycling through `fns` (one per input
    set). A sleep kernel holds the device while the host enqueues the
    calls, so the host's launch cost stays out of the reading. Returns
    (ms, blocking): `blocking` is True when the calls block the host
    (a call that synchronises), so the host cannot get ahead; the calls
    are then timed as they run, the gaps their syncs leave included."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    cycles = int(1e8)
    for _ in range(2):
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for i in range(reps):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if host_ms < s0.elapsed_time(a):
            return a.elapsed_time(b) / reps, False
        cycles *= 8
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, True


def mailbox_inputs(H, n, Wn, P, seed, device, empty_tail=0):
    """A row-sorted stream and its start table as the select sweep
    hands them to mailbox_gather: per-row arrival counts ~ Poisson(8)
    capped at Wn (the main path's measured mailbox load), `empty_tail`
    trailing rows with no arrivals (start = the valid count), the
    invalid candidates after the valid ones, Wn zero pad rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cnt = np.minimum(rng.poisson(8, H), Wn).astype(np.int64)
    cnt[rng.random(H) < 0.05] = 0
    if empty_tail:
        cnt[-empty_tail:] = 0
    while cnt.sum() > n:
        cnt[cnt.argmax()] -= 1
    start = np.cumsum(cnt) - cnt
    stream = np.zeros((n + Wn, P), np.int32)
    stream[:n] = rng.integers(-2**31, 2**31 - 1, (n, P), dtype=np.int64)
    return (torch.as_tensor(stream, device=device),
            torch.as_tensor(start.astype(np.int32), device=device))


def mailbox_bound(stream, start, Wn):
    """Least time for the gather on this card: the distinct stream rows
    the windows cover read once, the start table read once, the output
    written once, over the memory rate (no arithmetic to speak of).
    Returns (ms, bytes)."""
    import numpy as np

    rows, P = stream.shape
    s = start.cpu().numpy().astype(np.int64)
    cover = np.zeros(rows + 1, np.int64)
    np.add.at(cover, s, 1)
    np.add.at(cover, np.minimum(s + Wn, rows), -1)
    distinct = int((np.cumsum(cover)[:rows] > 0).sum())
    nbytes = distinct * P * 4 + s.size * 4 + s.size * Wn * P * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def assert_gather_equal(label, stream, start, Wn):
    """mailbox_gather == mailbox_gather_ref on (stream, start), exact.
    Returns the max abs error (0)."""
    import torch

    from shadow_tpu_torch.core.insert_kernels import (
        mailbox_gather, mailbox_gather_ref)

    got = mailbox_gather(stream, start, Wn)
    want = mailbox_gather_ref(stream, start, Wn)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"mailbox_gather differs from its plain "
                             f"version at {label} (max abs err {err})")
    log(f"  mailbox_gather == plain at {label}: H={start.numel()} "
        f"rows={stream.shape[0]} Wn={Wn} P={stream.shape[1]}: exact")
    return err


def check_mailbox_gather(device, P, main_n, H=HOSTS, also=()):
    """Phase 3: kernel == plain on the card, plus timings, at row width
    P (5 + the packet words: 11 for UDP's 6, 22 for TCP's 17) and
    `main_n` stream rows for H hosts (the hosts times the outbox
    columns the route inserts: 24 on the narrow tier, else the outbox
    capacity); `also` adds (H, n) shapes checked for equality only.
    `ms`, `plain_ms` and `library_ms` are cold: the calls cycle through
    input sets that together hold twice the L2 (one set when it alone
    is larger), so every call reads its inputs from device memory, like
    the bound. The warm time (one input set, resident in L2) is printed
    beside them."""
    import torch

    from shadow_tpu_torch.core.events import INSERT_SWEEP
    from shadow_tpu_torch.core.insert_kernels import (
        mailbox_gather, mailbox_gather_ref)

    Wn = INSERT_SWEEP
    shapes = [(H, main_n, 0), (1_001, 5_000, 77)]
    shapes += [(h, n, 0) for h, n in also]
    err = 0
    for h, n, tail in shapes:
        stream, start = mailbox_inputs(h, n, Wn, P, seed=h, device=device,
                                       empty_tail=tail)
        err = max(err, assert_gather_equal(
            f"a {'ragged' if tail else 'full'} shape", stream, start, Wn))

    n = main_n
    n_sets = int(COLD_BYTES // ((n + Wn) * P * 4)) + 1
    sets = [mailbox_inputs(H, n, Wn, P, seed=100 + k, device=device)
            for k in range(n_sets)]
    rowidx = [(st.long()[:, None] + torch.arange(Wn, device=device))
              .clamp(max=n + Wn - 1).reshape(-1) for _, st in sets]

    def calls(fn):
        return [lambda k=k: fn(k) for k in range(n_sets)]

    kern = calls(lambda k: mailbox_gather(sets[k][0], sets[k][1], Wn))
    plain = calls(lambda k: mailbox_gather_ref(sets[k][0], sets[k][1], Wn))
    lib = calls(lambda k: torch.index_select(sets[k][0], 0, rowidx[k]))
    times = {label: device_ms(fns) for label, fns in (
        ("kernel", kern), ("plain", plain), ("index_select", lib),
        ("kernel warm", kern[:1]))}
    blocking = [label for label, (_, blk) in times.items() if blk]
    if blocking:
        log(f"  {blocking} block the host: timed with their sync gaps")
    ms, plain_ms, lib_ms, warm_ms = (t for t, _ in times.values())
    bounds = [mailbox_bound(sm, st, Wn) for sm, st in sets]
    bound_ms = statistics.mean(b for b, _ in bounds)
    nbytes = statistics.mean(nb for _, nb in bounds)
    log(f"  mailbox_gather timed shape H={H} P={P} n={n}, {n_sets} input sets "
        f"cycled (cold): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, index_select "
        f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes:.0f} B); "
        f"kernel warm in L2 {warm_ms:.5f} ms")
    return {"name": "mailbox_gather", "route": "cuda",
            "source": "shadow_tpu_torch/csrc/mailbox_gather.cu",
            "replaces": "shadow_tpu/core/insert_pallas.py:98",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": lib_ms}, warm_ms


class KeepGatherInputs:
    """While active, the route's mailbox_gather calls go through a
    wrapper that keeps the inputs of the first call of each stream
    shape, then calls the kernel's wrapper (whose launch count is the
    one read). `check` then holds the kernel against its plain version
    on those inputs: the real streams of the run's routed windows."""

    def __enter__(self):
        from shadow_tpu_torch.core import events

        self.events, self.real, self.kept = events, events.mailbox_gather, {}
        events.mailbox_gather = self.keep
        return self

    def keep(self, stream, start, Wn):
        self.kept.setdefault(tuple(stream.shape), (stream, start, Wn))
        return self.real(stream, start, Wn)

    def __exit__(self, *exc):
        self.events.mailbox_gather = self.real

    def check(self, label):
        """Returns the max abs error over the kept calls (0)."""
        if not self.kept:
            raise AssertionError(f"{label}: no routed window called "
                                 f"mailbox_gather")
        return max(assert_gather_equal(f"{label}'s route", s, st, Wn)
                   for s, st, Wn in self.kept.values())


def drive(label, b, runner, device):
    """One timed run with the launch counters set to 0 just before and
    read just after. Returns (sim, stats, wall s, launches)."""
    import torch

    from shadow_tpu_torch.core.insert_kernels import mailbox_gather

    torch.cuda.synchronize()
    mailbox_gather.launches = 0
    t0 = time.perf_counter()
    sim, stats = runner(b.sim)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mailbox_gather": mailbox_gather.launches}
    st = stats.as_dict()
    w = max(st["windows"], 1)
    log(f"  {label}: EngineStats {st}")
    log(f"  {label}: wall {wall:.3f} s, {st['events_processed'] / wall:.1f} "
        f"events/s, {wall / w * 1e3:.2f} ms/window, "
        f"{st['micro_steps'] / w:.3f} micro-steps/window, "
        f"{wall / max(st['micro_steps'], 1) * 1e3:.3f} ms/micro-step, "
        f"launches {launches}")
    return sim, stats, wall, launches


def check_phold(label, sim, hosts, load, launches):
    """The checks every PHOLD run of the smoke holds: no overflow, every
    message accounted for, and mailbox_gather launched."""
    app = sim.app
    sent, rcvd = int(app.sent.sum()), int(app.rcvd.sum())
    checks = {
        "events.overflow": int(sim.events.overflow),
        "outbox.overflow": int(sim.outbox.overflow),
        "rq_overflow": int(sim.net.rq_overflow),
        "remaining": int(app.remaining.sum()),
    }
    log(f"  {label}: sent {sent} rcvd {rcvd} checks {checks} narrow_hit "
        f"{int(sim.outbox.narrow_hit)} narrow_miss "
        f"{int(sim.outbox.narrow_miss)} max_occupied "
        f"{int(sim.outbox.max_occupied)}")
    for k, v in checks.items():
        if v != 0:
            raise AssertionError(f"{label}: {k} = {v}, expected 0")
    if sent != hosts * load + rcvd:
        raise AssertionError(f"{label}: sent {sent} != H*load + rcvd "
                             f"{hosts * load + rcvd}")
    if rcvd <= 0:
        raise AssertionError(f"{label}: no message was received")
    if launches["mailbox_gather"] <= 0:
        raise AssertionError(f"{label}: mailbox_gather was never launched")


def run_main_path(device):
    """Phase 4: bench.py's default PHOLD program at full width through
    the port's entry points."""
    import torch

    from shadow_tpu_torch import telemetry

    t0 = time.perf_counter()
    b = build_phold(HOSTS, LOAD, SIM_S, seed=1, device=device, cap=CAPACITY,
                    sparse_lanes=None, ring=True)
    runner = main_runner(b, device)
    torch.cuda.synchronize()
    log(f"  built {HOSTS} hosts in {time.perf_counter() - t0:.2f} s")
    sim, stats, wall, launches = drive("main path", b, runner, device)
    check_phold("main path", sim, HOSTS, LOAD, launches)
    st = stats.as_dict()
    h = telemetry.Harvester()
    h.drain(sim)
    ring = sim.telem
    ring_checks = {
        "fastpath_hit + fastpath_miss == windows":
            (st["fastpath_hit"] + st["fastpath_miss"], st["windows"]),
        "ring count == windows": (int(ring.count), st["windows"]),
        "sum(ring.events) == events_processed":
            (int(ring.events.sum()), st["events_processed"]),
        "sum(ring.fastpath) == fastpath_hit":
            (int(ring.fastpath.sum()), st["fastpath_hit"]),
    }
    for k, (got, want) in ring_checks.items():
        if got != want:
            raise AssertionError(f"main path: {k}: {got} != {want}")
    log(f"  main path: ring identities hold ({', '.join(ring_checks)})")
    log(f"  main path: Harvester.summary() {json.dumps(h.summary())}")
    return launches


def run_serial_path(device):
    """Phase 4a: the serial path (no bulk pass, no sparse fast path,
    no ring) at full width, depth cut to 1 simulated second."""
    b = build_phold(HOSTS, LOAD, 1.0, seed=1, device=device, cap=CAPACITY)
    sim, _, _, launches = drive("serial path", b,
                                main_runner(b, device, bulk=False), device)
    check_phold("serial path", sim, HOSTS, LOAD, launches)


def compare_order_forms(device):
    """Phase 4b: the bulk program with the cube and the sort EventOrder
    forms at full width for 1 simulated second (the same config, seed,
    sparse budget and ring): equal EngineStats and every leaf equal.
    Each bulk call is timed with a CUDA-event pair and the host clock;
    one call (window 2) runs under torch.profiler to count its
    launches and is left out of the means."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core.engine import resolve_sparse_lanes, run
    from shadow_tpu_torch.net.bulk import make_bulk_fn
    from shadow_tpu_torch.net.step import make_step_fn
    from shadow_tpu_torch.telemetry import make_telem_fn

    results = {}
    for form in ("cube", "sort"):
        b = build_phold(HOSTS, LOAD, 1.0, seed=3, device=device,
                        cap=CAPACITY, sparse_lanes=None, ring=True)
        fn = make_bulk_fn(b.cfg, phold.BULK, order_impl=form)
        calls = []
        prof_call = []

        def timed(sim, wend, fn=fn, calls=calls, prof_call=prof_call):
            if len(calls) == 2 and not prof_call:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = fn(sim, wend)
                    torch.cuda.synchronize()
                events = raw_events(prof)
                prof_call.append((host_launches(events),
                                  device_busy_us(events) / 1e3))
                calls.append(None)
                return out
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            a.record()
            out = fn(sim, wend)
            z.record()
            calls.append((a, z, time.perf_counter() - t0))
            return out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim, stats = run(b.sim, make_step_fn(b.cfg, (phold.handler,)),
                         end_time=b.cfg.end_time, min_jump=b.min_jump,
                         emit_capacity=b.cfg.emit_capacity,
                         lane_id=b.sim.net.lane_id, bulk_fn=timed,
                         telem_fn=make_telem_fn(),
                         sparse_lanes=resolve_sparse_lanes(b.cfg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed_calls = [c for c in calls if c is not None]
        dev_ms = statistics.mean(a.elapsed_time(z) for a, z, _ in timed_calls)
        host_ms = statistics.mean(h * 1e3 for _, _, h in timed_calls)
        setter = "host" if dev_ms < 1.25 * host_ms else "device"
        n_launch, busy_ms = prof_call[0]
        log(f"  order form {form}: {stats.as_dict()} in {wall:.3f} s; bulk "
            f"pass {dev_ms:.3f} ms/window on the device clock (event pair), "
            f"{host_ms:.3f} ms/window to enqueue on the host clock, "
            f"{len(timed_calls)} calls timed: set by the {setter}; the "
            f"profiled call (window 2): {n_launch} launches, device busy "
            f"{busy_ms:.3f} ms")
        results[form] = (stats, sim)
    n = assert_same_run("cube vs sort", results["cube"], results["sort"])
    log(f"  cube == sort: EngineStats and all {n} leaves equal")


def compare_sparse_shape(device):
    """Phase 4c: bench.py's sparse shape (BENCH_ACTIVE=64: 10,240 hosts,
    64 active, no bulk pass) for 1 simulated second, with the fast path
    armed (sparse_lanes=256) and off (0)."""
    out = {}
    for sparse in (256, 0):
        b = build_phold(HOSTS, LOAD, 1.0, seed=4, device=device,
                        cap=CAPACITY, sparse_lanes=sparse, active_hosts=64)
        sim, stats, _, launches = drive(
            f"sparse shape, sparse_lanes={sparse}", b,
            main_runner(b, device, bulk=False), device)
        check_phold(f"sparse shape, sparse_lanes={sparse}", sim, 64, LOAD,
                    launches)
        out[sparse] = (stats, sim)
    if int(out[256][0].fastpath_hit) <= 0:
        raise AssertionError("sparse shape: the fast path never hit")
    n = assert_same_run("sparse 256 vs 0", out[256], out[0],
                        skip_stats=("fastpath_hit", "fastpath_miss"))
    log(f"  sparse 256 == sparse 0: EngineStats (bar hit/miss) and all {n} "
        f"leaves equal")


def check_relay(label, cfg, sim, stats, circuits, total, launches,
                complete=True, expect=None):
    """The checks every relay run of the smoke holds: every transfer
    complete (unless the run's depth is cut: `complete` False), and
    check_cell's with `expect`. Returns the retransmit and
    fast-recovery totals."""
    import torch

    app, tcp = sim.app, sim.tcp
    servers = torch.as_tensor([c[-1] for c in circuits],
                              device=app.rcvd.device)
    done = {} if not complete else {
        "servers with rcvd == bytes": (
            int((app.rcvd[servers] == total).sum()), len(circuits)),
        "servers at EOF": (int(app.up_eof[servers].sum()), len(circuits)),
        "sum(to_send) + sum(fwd_pending)": (
            int(app.to_send.sum()) + int(app.fwd_pending.sum()), 0),
    }
    check_cell(label, cfg, sim, stats, launches, expect or {}, done)
    retx, fr = int(tcp.retx_segs.sum()), int(tcp.fr_entries.sum())
    log(f"  {label}: retx_segs {retx}, fr_entries {fr}, servers received "
        f"{int(app.rcvd.sum())} bytes, last server EOF at "
        f"{int(app.done_at[servers].max()) / 1e9:.3f} sim-s")
    return retx, fr


def log_micro_steps_by_time(label, ring):
    """The ring's micro-steps per window, cumulated, against each
    window's end (sim-s): where a run's micro-steps fall in simulated
    time, which sets the cost of a cut depth."""
    w = min(int(ring.count), ring.wend.shape[0])
    ends = (ring.wend[:w].cpu() / 1e9).tolist()
    cum = ring.micro_steps[:w].cpu().cumsum(0).tolist()
    log(f"  {label}: cumulative micro-steps by window end (sim-s): "
        + ", ".join(f"{e:.3f}:{c}" for e, c in zip(ends, cum)))


class TimedBulk:
    """Wraps a runner's TCP bulk pass: a CUDA-event pair and the host
    clock around every call, the pass's iterations per call, and the
    input of call `keep` (a mid-transfer window) kept for a replay."""

    def __init__(self, fn, keep):
        self.fn, self.keep = fn, keep
        self.calls = []
        self.kept = None

    def __call__(self, sim, wend):
        import torch

        if len(self.calls) == self.keep:
            self.kept = (sim, wend)
        it0 = self.fn.counters["iterations"]
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        out = self.fn(sim, wend)
        z.record()
        self.calls.append((a, z, time.perf_counter() - t0,
                           self.fn.counters["iterations"] - it0))
        return out

    def per_iteration(self):
        """(iterations, device ms and host ms per iteration)."""
        iters = sum(c[3] for c in self.calls)
        dev_ms = sum(a.elapsed_time(z) for a, z, _, _ in self.calls)
        host_ms = sum(h for _, _, h, _ in self.calls) * 1e3
        return iters, dev_ms / max(iters, 1), host_ms / max(iters, 1)


def why_bits(why, mask):
    """{bit: hosts with that abort bit} over the hosts in `mask`."""
    import torch

    w = why[mask]
    bits = torch.arange(63, device=w.device)
    counts = ((w[:, None] >> bits) & 1).sum(dim=0).tolist()
    return {b: c for b, c in enumerate(counts) if c}


def replay_bulk_call(label, b, fn, kept, profile_call=True, app_bulk=None):
    """One debug=True call of the TCP bulk pass (with the app contract
    `app_bulk`, relay.TCP_BULK when None) on a kept mid-transfer
    window: the share of hosts that commit and the abort-bit histogram
    of the eligible hosts that stopped. Then, with `profile_call`, the
    same call plain, once timed and once under torch.profiler: launches
    and cudaStreamSynchronize per iteration and the device-busy share
    of the call's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.tcp_bulk import make_tcp_bulk_fn

    sim, wend = kept
    dbg = make_tcp_bulk_fn(b.cfg, app_bulk or relay.TCP_BULK, debug=True)
    _, _, d = dbg(sim, wend)
    H = int(d["elig"].numel())
    elig, commit = int(d["elig"].sum()), int(d["commit"].sum())
    stopped = d["elig"] & d["bad"]
    log(f"  {label}: debug call at wend {wend / 1e9:.3f} sim-s: "
        f"{d['iters']} iterations, eligible {elig} of {H}, commit "
        f"{commit} = {commit / H * 100:.2f}% of hosts "
        f"({commit / max(elig, 1) * 100:.2f}% of eligible); abort bits "
        f"of the {int(stopped.sum())} stopped hosts "
        f"{why_bits(d['why'], stopped)}; bits of the ineligible "
        f"{why_bits(d['why'], ~d['elig'])}")
    if not profile_call:
        return
    it0, r0 = fn.counters["iterations"], fn.counters["reads"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(sim, wend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = fn.counters["iterations"] - it0
    reads = fn.counters["reads"] - r0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(sim, wend)
        torch.cuda.synchronize()
    events = raw_events(prof)
    launches = host_launches(events)
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    busy_ms = device_busy_us(events) / 1e3
    log(f"  {label}: that call plain: {iters} iterations in "
        f"{wall * 1e3:.1f} ms unprofiled ({wall * 1e3 / max(iters, 1):.3f} "
        f"ms per iteration); profiled: {launches} launches = "
        f"{launches / max(iters, 1):.0f} per iteration, {syncs} "
        f"cudaStreamSynchronize = {syncs / max(iters, 1):.2f} per "
        f"iteration ({reads / max(iters, 1):.2f} host reads by the pass's "
        f"count); device busy {busy_ms:.2f} ms = "
        f"{busy_ms / (wall * 1e3) * 100:.2f}% of the unprofiled wall")
    return {"commit_share": commit / H, "launches_per_iter":
            launches / max(iters, 1), "syncs_per_iter": syncs / max(iters, 1)}


def relay_cell(label, device, hop, total, sim_s, loss=0.0, tcp_bulk=True,
               keep=None, profile_call=True, complete=True, expect=None):
    """One relay run at full width through the port's entry points
    (build -> relay.setup -> telemetry.attach -> make_runner), checked
    by check_relay (every transfer complete unless `complete` is False,
    for a cut depth; the reference's counts `expect`). With the TCP
    bulk pass, its per-call timings and the replay of window `keep` are
    reported (the profiled replay only with `profile_call`). Returns
    (leaves, stats dict, launches, retx, fr)."""
    import torch

    from shadow_tpu_torch import convert

    t0 = time.perf_counter()
    b, circuits = build_relay(HOSTS, hop, total, sim_s, seed=1,
                              device=device, loss=loss)
    runner = relay_runner(b, device, tcp_bulk=tcp_bulk)
    timed = None
    if tcp_bulk:
        timed = TimedBulk(runner.bulk_fn, keep)
        runner.bulk_fn = timed
    torch.cuda.synchronize()
    log(f"  {label}: built {HOSTS} hosts, {len(circuits)} circuits in "
        f"{time.perf_counter() - t0:.2f} s")
    sim, stats, wall, launches = drive(label, b, runner, device)
    retx, fr = check_relay(label, b.cfg, sim, stats, circuits, total,
                           launches, complete, expect)
    st = stats.as_dict()
    log_micro_steps_by_time(label, sim.telem)
    if timed is not None:
        fn = timed.fn
        iters, dev_ms, host_ms = timed.per_iteration()
        log(f"  {label}: TCP bulk pass {fn.counters}: "
            f"{iters / st['windows']:.3f} iterations per window, "
            f"{st['micro_steps'] / st['windows']:.3f} micro-steps per "
            f"window left; {dev_ms:.3f} ms per iteration on the device "
            f"clock (event pair per call), {host_ms:.3f} ms on the host "
            f"clock; {fn.counters['reads'] / max(iters, 1):.2f} host reads "
            f"per iteration")
        if timed.kept is not None:
            replay_bulk_call(label, b, fn, timed.kept, profile_call)
    return convert.sim_to_numpy(sim), st, launches, retx, fr


# dead storage under the reference's bulk-vs-serial contract
# (tests/test_tcp_bulk.py)
DEAD = {
    "in_src_ip", "in_src_port", "in_len", "in_payref", "in_status",
    "out_words", "out_priority",
    "rq_src", "rq_enq_ts", "rq_words",
}


def assert_contract(label, a, b):
    """The reference's contract between a TCP bulk run and a serial run
    (tests/test_tcp_bulk.py): net leaves outside the dead set, the live
    output-ring regions, every tcp and app leaf, the live event-queue
    slots and the outbox's dst/time/count/overflow equal. `a`, `b`:
    (leaves, stats dict)."""
    import numpy as np

    (la, sa), (lb, sb) = a, b

    def group(leaves, name):
        p = f".{name}."
        return {k[len(p):]: v for k, v in leaves.items() if k.startswith(p)}

    diffs = []

    def check(name, x, y):
        if x.shape != y.shape or not np.array_equal(x, y):
            diffs.append(name)

    na, nb = group(la, "net"), group(lb, "net")
    for f in na:
        if f not in DEAD:
            check(f"net.{f}", na[f], nb[f])
    off = (np.arange(na["out_words"].shape[2])[None, None, :]
           - na["out_head"][..., None]) % na["out_words"].shape[2]
    live = off < na["out_count"][..., None]
    for f in ("out_words", "out_priority"):
        lv = live[..., None] if na[f].ndim == 4 else live
        check(f"net.{f} (live)", np.where(lv, na[f], 0),
              np.where(lv, nb[f], 0))
    for grp in ("tcp", "app"):
        ga, gb = group(la, grp), group(lb, grp)
        for f in ga:
            check(f"{grp}.{f}", ga[f], gb[f])
    qa, qb = group(la, "events"), group(lb, "events")
    va = qa["time"] != INVALID_TIME
    vb = qb["time"] != INVALID_TIME
    for f in ("time", "kind", "src", "seq", "words", "next_seq",
              "overflow"):
        x, y = qa[f], qb[f]
        if f in ("kind", "src", "seq", "words"):
            ma = va[..., None] if f == "words" else va
            mb = vb[..., None] if f == "words" else vb
            x, y = np.where(ma, x, 0), np.where(mb, y, 0)
        check(f"events.{f}", x, y)
    oa, ob = group(la, "outbox"), group(lb, "outbox")
    for f in ("dst", "time", "count", "overflow"):
        check(f"outbox.{f}", oa[f], ob[f])
    for k in ("events_processed", "windows"):
        if sa[k] != sb[k]:
            diffs.append(f"EngineStats.{k} {sa[k]} vs {sb[k]}")
    if diffs:
        raise AssertionError(f"{label}: {len(diffs)} differ, first "
                             f"{diffs[:5]}")
    if not sa["micro_steps"] < sb["micro_steps"]:
        raise AssertionError(f"{label}: {sa['micro_steps']} micro-steps "
                             f"with the pass, {sb['micro_steps']} without")
    log(f"  {label}: equal under the reference's contract; micro-steps "
        f"{sa['micro_steps']} with the TCP bulk pass, {sb['micro_steps']} "
        f"serial")


def compare_bundles_cuda_cpu(label, make):
    """Phases 5 and 9: `make(device) -> (bundle, runner)` run on CUDA and
    on the CPU inside the port: equal EngineStats and every leaf equal
    (tolerance zero). Returns the CPU (stats, sim)."""
    out = {}
    for dev in ("cuda", "cpu"):
        b, runner = make(dev)
        t0 = time.perf_counter()
        sim, stats = runner(b.sim)
        out[dev] = (stats, sim)
        log(f"  {label} {dev}: {stats.as_dict()} in "
            f"{time.perf_counter() - t0:.2f} s")
    n = assert_same_run(label, out["cuda"], out["cpu"])
    log(f"  {label}: cuda == cpu, EngineStats and all {n} leaves equal")
    return out["cpu"]


def compare_relay_cuda_cpu(label, hosts, hop, total, sim_s, loss=0.0,
                           ring=True, tcp_bulk=False, lossless=False):
    """Phase 5, TCP: the relay on CUDA equals the relay on the CPU, leaf
    by leaf (tolerance zero), and completes."""
    from shadow_tpu_torch.apps.relay import ROLE_SERVER

    def make(dev):
        b, _ = build_relay(hosts, hop, total, sim_s, seed=6, device=dev,
                           loss=loss, ring=ring)
        return b, relay_runner(b, dev, tcp_bulk=tcp_bulk, lossless=lossless)

    _, sim = compare_bundles_cuda_cpu(label, make)
    servers = sim.app.role == ROLE_SERVER
    done = int((sim.app.rcvd[servers] == total).sum())
    if done != int(servers.sum()):
        raise AssertionError(f"{label}: {done} of {int(servers.sum())} "
                             f"transfers complete")
    log(f"  {label}: every transfer complete; retx_segs "
        f"{int(sim.tcp.retx_segs.sum())}")


class _Span:
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    """One profiler record with the fields the smoke reads (name,
    device_type, time_range in µs), as FunctionEvent has them."""
    __slots__ = ("name", "device_type", "time_range")

    def __init__(self, e):
        self.name, self.device_type = e.name(), e.device_type()
        self.time_range = _Span(e.start_ns() / 1e3, e.end_ns() / 1e3)


def raw_events(prof):
    """The records of a finished torch.profiler run, read straight from
    its Kineto results: prof.events() builds a FunctionEvent tree first,
    which costs ~0.5 ms per kernel launch recorded."""
    return [_Event(e) for e in prof.profiler.kineto_results.events()]


def device_busy_us(events):
    """Union of the device intervals of profiler events, in µs."""
    from torch.autograd import DeviceType

    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events if e.device_type == DeviceType.CUDA):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us


def host_launches(events):
    """Kernel launches the host issued, from profiler events."""
    from torch.autograd import DeviceType

    return sum(1 for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("cuda") and "Launch" in e.name)


def profile_windows(device, gather_ms):
    """Optional: the main path's first 3 windows (bulk pass, sparse
    default, ring), timed without the profiler and once under
    torch.profiler. Prints the device-busy share (union of the device
    intervals of the profiled run over the unprofiled run's wall time),
    the largest kernels by device time, the host's launch count, and
    mailbox_gather's time in the main path beside its standalone cold
    and warm times (`gather_ms`). Then windows 1-2 alone, which the
    bulk pass drains whole: the runner started from the state window 0
    (the injection window, where the micro-steps are) left behind.
    Each wall is the least of 3 unprofiled runs (the host's noise only
    ever adds time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    def first_windows(skip_window0=False):
        b = build_phold(HOSTS, LOAD, 0.12, seed=2, device=device,
                        cap=CAPACITY, sparse_lanes=None, ring=True)
        sim = b.sim
        if skip_window0:
            sim, _ = make_runner(b, app_handlers=(phold.handler,),
                                 end_time=20_000_000, app_bulk=phold.BULK,
                                 device=device)(sim)
        torch.cuda.synchronize()
        return main_runner(b, device), sim

    def later_windows():
        return first_windows(skip_window0=True)

    def measure(fresh, reps=3):
        walls = []
        for _ in range(reps):
            runner, sim = fresh()
            t0 = time.perf_counter()
            _, stats = runner(sim)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        runner, sim = fresh()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, pstats = runner(sim)
            torch.cuda.synchronize()
        if pstats.as_dict() != stats.as_dict():
            raise AssertionError("profiled run differs from the unprofiled "
                                 "one")
        return stats.as_dict(), min(walls), raw_events(prof)

    st, wall, events = measure(first_windows)
    busy_us = device_busy_us(events)
    launches = host_launches(events)
    log(f"  profile: {st}; wall {wall:.4f} s without the profiler; device "
        f"busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall * 100:.2f}% "
        f"of it")
    by_name: dict[str, list[float]] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        short = (name.replace("void ", "").replace("at::native::", "")
                 .replace("(anonymous namespace)::", ""))
        log(f"    calls {len(ts):6d} device {sum(ts) / 1e3:8.2f} ms  "
            f"{short[:150]}")
    log(f"  profile: {launches} kernel launches from the host, "
        f"{launches / max(st['windows'], 1):.0f} per window "
        f"({st['micro_steps']} micro-steps in {st['windows']} windows)")
    st2, wall2, events2 = measure(later_windows)
    w2 = max(st2["windows"], 1)
    busy2 = device_busy_us(events2) / 1e3
    log(f"  profile: windows 1-2 alone {st2}: wall {wall2 * 1e3 / w2:.3f} "
        f"ms, {host_launches(events2) / w2:.0f} launches and "
        f"{busy2 / w2:.3f} ms device busy per window = "
        f"{busy2 / (wall2 * 1e3) * 100:.2f}% of wall")
    g = [t for name, ts in by_name.items() if "mailbox_gather" in name
         for t in ts]
    if g:
        log(f"  profile: mailbox_gather in the main path {len(g)} launches, "
            f"mean {statistics.mean(g) / 1e3:.5f} ms (standalone cold "
            f"{gather_ms[0]:.5f} ms, warm {gather_ms[1]:.5f} ms)")


def profile_relay(device, first=10, n=3):
    """Optional: windows `first`..`first+n-1` of phase 6 (busy relay
    windows, mid-transfer), with the TCP bulk pass. The run is driven
    window by window with core.engine.step_window, as engine.run does,
    to window `first`; the next `n` windows then run twice from copies
    of that state, once unprofiled (wall) and once under
    torch.profiler: the device-busy share (union of the device
    intervals over the unprofiled wall), launches and host syncs
    (cudaStreamSynchronize calls) per window and per bulk-pass
    iteration plus micro-step, and the top device ops."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.core.engine import (
        EngineStats, resolve_sparse_lanes, step_window)
    from shadow_tpu_torch.net.step import make_step_fn
    from shadow_tpu_torch.net.tcp_bulk import make_tcp_bulk_fn
    from shadow_tpu_torch.telemetry import make_telem_fn

    b, _ = build_relay(HOSTS, RELAY_HOP, RELAY_BYTES, RELAY_SIM_S, seed=1,
                       device=device)
    step = make_step_fn(b.cfg, (relay.handler,))
    bulk = make_tcp_bulk_fn(b.cfg, relay.TCP_BULK)
    telem_fn = make_telem_fn()
    sparse = resolve_sparse_lanes(b.cfg)

    def windows(sim, wstart, count):
        stats = EngineStats.create(device=device)
        for _ in range(count):
            wend = min(wstart + b.min_jump, b.cfg.end_time + 1)
            sim, stats, wstart = step_window(
                sim, stats, step, wend, b.cfg.emit_capacity, sim.net.lane_id,
                bulk_fn=bulk, telem_fn=telem_fn, wstart=wstart,
                sparse_lanes=sparse)
        return sim, stats, wstart

    sim, _, wstart = windows(b.sim, int(b.sim.events.min_time().amin()),
                             first)
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        s0 = copy.deepcopy(sim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st, _ = windows(s0, wstart, n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    s0 = copy.deepcopy(sim)
    torch.cuda.synchronize()
    it0 = bulk.counters["iterations"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pst, _ = windows(s0, wstart, n)
        torch.cuda.synchronize()
    iters = bulk.counters["iterations"] - it0
    st, pst = st.as_dict(), pst.as_dict()
    if st != pst:
        raise AssertionError("relay profile: profiled windows differ")
    events = raw_events(prof)
    wall = min(walls)
    busy_us = device_busy_us(events)
    launches = host_launches(events)
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    ms = max(st["micro_steps"] + iters, 1)
    log(f"  relay profile, windows {first}-{first + n - 1}: {st}, {iters} "
        f"TCP bulk iterations; wall {wall:.4f} s unprofiled (least of "
        f"{len(walls)}), {wall / ms * 1e3:.3f} ms per iteration or "
        f"micro-step; device busy {busy_us / 1e6:.4f} s = "
        f"{busy_us / 1e6 / wall * 100:.2f}% of it")
    log(f"  relay profile: {launches} launches = {launches / n:.0f} per "
        f"window, {launches / ms:.0f} per iteration or micro-step; {syncs} "
        f"cudaStreamSynchronize = {syncs / ms:.2f} per iteration or "
        f"micro-step")
    by_name: dict[str, list[float]] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        short = (name.replace("void ", "").replace("at::native::", "")
                 .replace("(anonymous namespace)::", ""))
        log(f"    calls {len(ts):6d} device {sum(ts) / 1e3:8.2f} ms  "
            f"{short[:150]}")


def compare_cuda_cpu(label, hosts, load, sim_s, bulk=False, ring=False,
                     sparse_lanes=0, active_hosts=None):
    """Phase 5: PHOLD on CUDA equals PHOLD on the CPU, leaf by leaf
    (tolerance zero)."""
    def make(dev):
        b = build_phold(hosts, load, sim_s, seed=5, device=dev,
                        sparse_lanes=sparse_lanes, active_hosts=active_hosts,
                        ring=ring)
        return b, main_runner(b, dev, bulk=bulk)

    compare_bundles_cuda_cpu(label, make)


def build_gossip(H, sim_s, seed, device, tcp=False, cap=GOSSIP_CAP,
                 emit_capacity=None, k=GOSSIP_K, blocks=GOSSIP_BLOCKS,
                 sockets=12, ring=True):
    """A gossip bundle through the port's entry points, as
    tools/scale_run.py builds --workload gossip: UDP (gossip.setup,
    in_ring 32, hosts started at 0) or, with `tcp`, over persistent TCP
    peer links (gossip.setup_tcp, `sockets` per host, out_ring 16,
    PROC_START at 1 s); a block every 2 s; telemetry.attach when
    `ring`. The sparse budget is the default."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import gossip
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    kw = dict(num_hosts=H, seed=seed, end_time=int(sim_s * simtime.ONE_SECOND),
              event_capacity=cap, outbox_capacity=cap, router_ring=cap)
    interval = 2 * simtime.ONE_SECOND
    if tcp:
        cfg = NetConfig(sockets_per_host=sockets, out_ring=16,
                        emit_capacity=emit_capacity, **kw)
        hosts = [HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
                 for i in range(H)]
        b = build(cfg, ONE_VERTEX, hosts, device=device)
        b.sim = gossip.setup_tcp(b.sim, peers_per_host=k,
                                 block_interval=interval, max_blocks=blocks)
    else:
        cfg = NetConfig(tcp=False, in_ring=32, **kw)
        b = build(cfg, ONE_VERTEX, [HostSpec(name=f"n{i}") for i in range(H)],
                  device=device)
        b.sim = gossip.setup(b.sim, peers_per_host=k, block_interval=interval,
                             max_blocks=blocks)
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b


def gossip_runner(b, device, tcp=False, end_time=None):
    from shadow_tpu_torch.apps import gossip
    from shadow_tpu_torch.net.build import make_runner

    return make_runner(b, app_handlers=(
        gossip.tcp_handler if tcp else gossip.handler,), end_time=end_time,
        device=device)


def build_tor(H, sim_s, seed, device, ring=True):
    """The shared-relay Tor bundle through the port's entry points, as
    tools/scale_run.py builds --workload tor (with phase 8's capacities
    and emit_capacity). Returns (bundle, chains)."""
    import numpy as np

    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    rng = np.random.default_rng(seed)
    n_cl, n_rl = int(H * 0.6), int(H * 0.3)
    chains = relay.consensus_circuits(
        rng, n_circuits=n_cl, clients=list(range(n_cl)),
        relays=list(range(n_cl, n_cl + n_rl)),
        servers=list(range(n_cl + n_rl, H)), hops=TOR_HOPS,
        max_slots=TOR_SLOTS)
    cfg = NetConfig(num_hosts=H, seed=seed,
                    end_time=int(sim_s * simtime.ONE_SECOND),
                    sockets_per_host=2 + 2 * TOR_SLOTS, event_capacity=TOR_CAP,
                    outbox_capacity=TOR_CAP, router_ring=TOR_CAP, out_ring=8,
                    emit_capacity=TOR_EMIT)
    hosts = [HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = build(cfg, ONE_VERTEX, hosts, device=device)
    b.sim = relay.setup_shared(b.sim, circuits=chains, total_bytes=TOR_BYTES,
                               max_slots=TOR_SLOTS)
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b, chains


def build_mux_small(device, sim_s, loss=0.0):
    """The reference test's mux shape (tests/test_relay_mux.py): 10 hosts,
    4 two-relay circuits over relays 6-8 to server 9 (consensus draw,
    seed 5), MUX_SLOTS slots, 2 + 2*MUX_SLOTS sockets, capacities 64."""
    import numpy as np

    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    chains = relay.consensus_circuits(
        np.random.default_rng(5), n_circuits=4, clients=list(range(6)),
        relays=[6, 7, 8], servers=[9], hops=2, max_slots=MUX_SLOTS)
    cfg = NetConfig(num_hosts=10, seed=1,
                    end_time=int(sim_s * simtime.ONE_SECOND),
                    sockets_per_host=2 + 2 * MUX_SLOTS, event_capacity=64,
                    outbox_capacity=64, router_ring=64)
    hosts = [HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(10)]
    b = build(cfg, one_vertex(loss), hosts, device=device)
    b.sim = relay.setup_shared(b.sim, circuits=chains, total_bytes=MUX_BYTES,
                               max_slots=MUX_SLOTS)
    return b, chains


def mux_runner(b, device, tcp_bulk=True, end_time=None):
    """The Tor model's runner as tools/scale_run.py makes it: the TCP
    bulk pass on unless `tcp_bulk` is False (scale_run's --no-bulk)."""
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.build import make_runner

    return make_runner(b, app_handlers=(relay.mux_handler,),
                       app_tcp_bulk=relay.MUX_TCP_BULK if tcp_bulk else None,
                       end_time=end_time, device=device)


def state_at_window(runner_to, b, ring, k):
    """(The state at the start of window k, its wend) for a replay: the
    cell's runner, `runner_to(end_time)`, again from the boot state to
    the end of window k-1, read from the first run's ring."""
    wends = ring.wend[:k + 1].tolist()
    sim, _ = runner_to(wends[k - 1] - 1)(b.sim)
    return sim, wends[k]


class StepShim:
    """The step_fn of a replayed window: the host clock at every
    micro-step's handler call (the engine's host read of the popped
    summary comes just before it, so each mark follows a drained
    stream), and, with `prof`, torch.profiler running from the first
    call to the second: one whole micro-step."""

    def __init__(self, step, prof=None):
        self.step, self.prof, self.marks = step, prof, []

    def __call__(self, sim, popped, buf, kinds=None):
        self.marks.append(time.perf_counter())
        if self.prof is not None and len(self.marks) == 1:
            self.prof.start()
        elif self.prof is not None and len(self.marks) == 2:
            self.prof.stop()
        return self.step(sim, popped, buf, kinds=kinds)


def replay_window(label, b, handler, kept, app_tcp_bulk=None, min_steps=2):
    """Window `kept` = (the state at its start, wend) again, from copies
    of that state, through core.engine.step_window as the engine drives
    it (the TCP bulk pass with `app_tcp_bulk`, the sparse fast path at
    the config's budget, the fixpoint, the route) with a StepShim as its
    step_fn: each micro-step's wall from one handler call to the next
    (the last one's includes the route). Then again with the profiler
    over its first micro-step: launches and cudaStreamSynchronize
    calls, and the device-busy share (union of the profiled device
    intervals over that micro-step's unprofiled wall). A window of one
    micro-step (`min_steps=1`) is profiled whole, its route included."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.core.engine import (
        EngineStats, resolve_sparse_lanes, step_window)
    from shadow_tpu_torch.net.step import make_step_fn
    from shadow_tpu_torch.net.tcp_bulk import make_tcp_bulk_fn

    sim0, wend = kept
    cfg = b.cfg
    step = make_step_fn(cfg, (handler,))
    bulk = (make_tcp_bulk_fn(cfg, app_tcp_bulk) if app_tcp_bulk is not None
            else None)

    def window(shim):
        sim = copy.deepcopy(sim0)
        it0 = bulk.counters["iterations"] if bulk is not None else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats, _ = step_window(
            sim, EngineStats.create(device=sim.events.time.device), shim,
            wend, cfg.emit_capacity, sim.net.lane_id, bulk_fn=bulk,
            sparse_lanes=resolve_sparse_lanes(cfg))
        torch.cuda.synchronize()
        iters = (bulk.counters["iterations"] - it0 if bulk is not None
                 else 0)
        return t0, time.perf_counter(), stats.as_dict(), iters

    timed = StepShim(step)
    t0, end, st, iters = window(timed)
    marks = timed.marks + [end]
    walls = [(y - x) * 1e3 for x, y in zip(marks, marks[1:])]
    if len(walls) < min_steps:
        raise AssertionError(f"{label}: the replayed window ran "
                             f"{len(walls)} micro-steps; pick a busier one")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    shim = StepShim(step, prof)
    window(shim)
    if len(shim.marks) == 1:
        # a one-micro-step window: the profile ends with the window
        # (the route included), as its wall does
        prof.stop()
    events = raw_events(prof)
    launches = host_launches(events)
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    busy_ms = device_busy_us(events) / 1e3
    width = "compacted: fast path hit" if st["fastpath_hit"] else \
        "at full width"
    log(f"  {label}: window ending {wend / 1e9:.3f} sim-s replayed through "
        f"core.engine.step_window ({width}): "
        f"{iters} TCP bulk iterations and the first pop in "
        f"{(timed.marks[0] - t0) * 1e3:.1f} ms, then {len(walls)} "
        f"micro-steps of {', '.join(f'{w:.1f}' for w in walls)} ms (the "
        f"last with the route; mean of the others "
        f"{statistics.mean(walls[:-1]) if len(walls) > 1 else 0:.1f} ms); "
        f"its first micro-step "
        f"profiled: {launches} launches, {syncs} cudaStreamSynchronize, "
        f"device busy {busy_ms:.2f} ms = {busy_ms / walls[0] * 100:.2f}% of "
        f"its {walls[0]:.1f} ms")


def check_cell(label, cfg, sim, stats, launches, expect, extra=None):
    """The checks the relay cells and phases 7, 8 and 10 hold: `expect`
    (the reference's counts for the config: events, windows,
    micro-steps), `extra` ({name: (got, want)}), zero overflow of any
    kind (events.overflow also counts the emit buffer's), the sparse
    census and the ring against EngineStats, mailbox_gather launched."""
    from shadow_tpu_torch.core.engine import resolve_sparse_lanes

    st = stats.as_dict()
    armed = resolve_sparse_lanes(cfg) > 0
    checks = {k: (st[k], v) for k, v in expect.items()}
    checks.update(extra or {})
    checks.update({
        "events.overflow": (int(sim.events.overflow), 0),
        "outbox.overflow": (int(sim.outbox.overflow), 0),
        "rq_overflow": (int(sim.net.rq_overflow), 0),
        "fastpath_hit + fastpath_miss == windows when armed": (
            st["fastpath_hit"] + st["fastpath_miss"],
            st["windows"] if armed else 0),
        "ring count == windows": (int(sim.telem.count), st["windows"]),
        "sum(ring.events) == events_processed": (
            int(sim.telem.events.sum()), st["events_processed"]),
        "sum(ring.fastpath) == fastpath_hit": (
            int(sim.telem.fastpath.sum()), st["fastpath_hit"]),
    })
    if sim.tcp is not None:
        checks["sum(ring.retx) == sum(retx_segs)"] = (
            int(sim.telem.retx.sum()), int(sim.tcp.retx_segs.sum()))
    for k, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"{label}: {k}: {got} != {want}")
    if launches["mailbox_gather"] <= 0:
        raise AssertionError(f"{label}: mailbox_gather was never launched")
    log(f"  {label}: checks hold ({', '.join(checks)})")


def gossip_cell(device):
    """Phase 7: UDP gossip at full width and full depth; mailbox_gather
    held to its plain version on the run's route inputs, and window
    GOSSIP_KEEP_WINDOW replayed. Returns (launches, max abs err)."""
    import torch

    t0 = time.perf_counter()
    b = build_gossip(GOSSIP_HOSTS, GOSSIP_SIM_S, seed=1, device=device)
    torch.cuda.synchronize()
    log(f"  gossip: built {GOSSIP_HOSTS} hosts in "
        f"{time.perf_counter() - t0:.2f} s")
    runner = gossip_runner(b, device)
    with KeepGatherInputs() as gathered:
        sim, stats, _, launches = drive("gossip", b, runner, device)
    check_cell("gossip", b.cfg, sim, stats, launches, GOSSIP_EXPECT)
    err = gathered.check("gossip")
    del gathered
    at_last = sim.app.tip == GOSSIP_BLOCKS - 1
    if not bool(at_last.all()):
        raise AssertionError(f"gossip: {int(at_last.sum())} of "
                             f"{GOSSIP_HOSTS} tips at the last block")
    log(f"  gossip: every tip at block {GOSSIP_BLOCKS - 1}; dup_rx "
        f"{int(sim.app.dup_rx.sum())}, relays {int(sim.app.relays.sum())}")
    from shadow_tpu_torch.apps import gossip

    kept = state_at_window(lambda end: gossip_runner(b, device, end_time=end),
                           b, sim.telem, GOSSIP_KEEP_WINDOW)
    replay_window("gossip", b, gossip.handler, kept)
    return launches, err


def tor_cell(device):
    """Phase 8: the shared-relay Tor model at full width, cut depth,
    with the TCP bulk pass; mailbox_gather held to its plain version on
    the run's route inputs, the pass's iterations per window, and window
    TOR_KEEP_WINDOW replayed (its pass call with debug=True, then the
    whole window). Returns (launches, max abs err)."""
    import torch

    from shadow_tpu_torch.apps import relay

    t0 = time.perf_counter()
    b, chains = build_tor(TOR_HOSTS, TOR_SIM_S, seed=1, device=device)
    runner = mux_runner(b, device)
    timed = TimedBulk(runner.bulk_fn, TOR_KEEP_WINDOW)
    runner.bulk_fn = timed
    torch.cuda.synchronize()
    log(f"  tor: built {TOR_HOSTS} hosts, {len(chains)} circuits, "
        f"{int(b.sim.app.nslots.sum())} slots (at most "
        f"{int(b.sim.app.nslots.max())} a host) in "
        f"{time.perf_counter() - t0:.2f} s")
    with KeepGatherInputs() as gathered:
        sim, stats, wall, launches = drive("tor", b, runner, device)
    check_cell("tor", b.cfg, sim, stats, launches, TOR_EXPECT)
    err = gathered.check("tor")
    del gathered
    app, st = sim.app, stats.as_dict()
    live = app.s_role != relay.ROLE_NONE
    log(f"  tor: {int((app.connected & live).sum())} of "
        f"{int((app.down_sock >= 0).sum())} downstream connects issued, "
        f"{int((app.up_conn >= 0).sum())} upstream children matched, "
        f"servers received {int(app.rcvd.sum())} bytes by "
        f"{TOR_SIM_S} sim-s; retx_segs {int(sim.tcp.retx_segs.sum())}")
    fn = timed.fn
    iters, dev_ms, host_ms = timed.per_iteration()
    serial_ms = (wall * 1e3 - sum(a.elapsed_time(z) for a, z, _, _
                                  in timed.calls)) / max(st["micro_steps"], 1)
    log(f"  tor: TCP bulk pass {fn.counters}: {iters / st['windows']:.3f} "
        f"iterations per window, {st['micro_steps'] / st['windows']:.3f} "
        f"micro-steps per window left; {dev_ms:.3f} ms per iteration on "
        f"the device clock, {host_ms:.3f} ms on the host clock; the rest "
        f"of the wall {serial_ms:.1f} ms per micro-step")
    replay_bulk_call("tor", b, fn, timed.kept, profile_call=False,
                     app_bulk=relay.MUX_TCP_BULK)
    replay_window("tor", b, relay.mux_handler, timed.kept,
                  app_tcp_bulk=relay.MUX_TCP_BULK)
    return launches, err


def gossip_tcp_cell(device):
    """Phase 10: TCP gossip at full width, cut depth; as phase 7.
    Returns (launches, max abs err)."""
    import torch

    t0 = time.perf_counter()
    b = build_gossip(GTCP_HOSTS, GTCP_SIM_S, seed=1, device=device, tcp=True,
                     cap=GTCP_CAP, emit_capacity=GTCP_EMIT)
    torch.cuda.synchronize()
    log(f"  gossip tcp: built {GTCP_HOSTS} hosts, "
        f"{int((b.sim.app.conn >= 0).sum())} connecting edges in "
        f"{time.perf_counter() - t0:.2f} s")
    runner = gossip_runner(b, device, tcp=True)
    with KeepGatherInputs() as gathered:
        sim, stats, _, launches = drive("gossip tcp", b, runner, device)
    check_cell("gossip tcp", b.cfg, sim, stats, launches, GTCP_EXPECT)
    err = gathered.check("gossip tcp")
    del gathered
    app = sim.app
    log(f"  gossip tcp: {int(app.est.sum())} edge ends usable, "
        f"{int((app.conn >= 0).sum())} edge sockets, blocks mined "
        f"{int(app.blocks_mined.sum())}, relays {int(app.relays.sum())}")
    from shadow_tpu_torch.apps import gossip

    kept = state_at_window(
        lambda end: gossip_runner(b, device, tcp=True, end_time=end), b,
        sim.telem, GTCP_KEEP_WINDOW)
    replay_window("gossip tcp", b, gossip.tcp_handler, kept)
    return launches, err


def compare_new_apps_cuda_cpu():
    """Phase 9: the reference tests' small shapes of the Tor model
    (serial and with the TCP bulk pass, then held to each other under
    the reference's contract) and of UDP and TCP gossip."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.apps import relay

    runs = {}
    for bulk in (False, True):
        label = f"mux 10 hosts {'TCP bulk' if bulk else 'serial'}"

        def make(dev, bulk=bulk):
            b, _ = build_mux_small(dev, MUX_SIM_S)
            return b, mux_runner(b, dev, tcp_bulk=bulk)

        stats, sim = compare_bundles_cuda_cpu(label, make)
        live = sim.app.s_role == relay.ROLE_SERVER
        streams = sim.app.rcvd[live].tolist()
        if streams != [MUX_BYTES] * 4 or not bool(
                (sim.app.done_at[live] >= 0).all()):
            raise AssertionError(f"{label}: server streams {streams}, EOF "
                                 f"at {sim.app.done_at[live].tolist()}")
        log(f"  {label}: the server's 4 streams complete, EOF at "
            f"{sim.app.done_at[live].tolist()} ns")
        runs[bulk] = (convert.sim_to_numpy(sim), stats.as_dict())
    assert_contract("mux bulk vs serial", runs[True], runs[False])

    def make_udp(dev):
        b = build_gossip(64, 5.0, seed=1, device=dev)
        return b, gossip_runner(b, dev)

    _, sim = compare_bundles_cuda_cpu("gossip 64 hosts", make_udp)
    if not bool((sim.app.tip == GOSSIP_BLOCKS - 1).all()):
        raise AssertionError("gossip 64 hosts: a tip short of the last block")

    def make_tcp(dev):
        b = build_gossip(8, SMALL_GTCP_SIM_S, seed=3, device=dev, tcp=True,
                         k=3, blocks=3, sockets=10, ring=False)
        return b, gossip_runner(b, dev, tcp=True)

    _, sim = compare_bundles_cuda_cpu("gossip tcp 8 hosts", make_tcp)
    if not bool((sim.app.tip >= 0).all()):
        raise AssertionError("gossip tcp 8 hosts: block 0 did not reach "
                             "every host")


def pingpong_cell(device):
    """Phase 11: bench.py's pingpong at 10,240 hosts through the bench
    module's runner (one warm-up call, then the timed call with the
    launch counter set to 0 just before it); the reference's counts
    scaled per pair, every host at 20 received, zero overflow, equal RTT
    sums, mailbox_gather equal to its plain version on the route's
    inputs, window PING_KEEP_WINDOW replayed. Returns (launches, max abs
    err)."""
    import torch

    from shadow_tpu_torch import bench, telemetry
    from shadow_tpu_torch.apps import pingpong
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.net.build import make_runner

    t0 = time.perf_counter()
    runner = bench.pingpong_runner(PING_HOSTS, PING_SIM_S, device)
    torch.cuda.synchronize()
    log(f"  pingpong: built {PING_HOSTS} hosts in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    runner()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    mailbox_gather.launches = 0
    with KeepGatherInputs() as gathered:
        m = bench.timed(runner, device)
    launches = {"mailbox_gather": mailbox_gather.launches}
    sim, stats = runner.last_sim, runner.last_stats
    row = bench.make_row(
        f"events_per_sec_per_chip@{PING_HOSTS}hosts_udp_pingpong",
        PING_HOSTS, m, stats, device, warmup_s)
    log(f"  pingpong: bench row {json.dumps(row)}")
    st = stats.as_dict()
    app = sim.app
    half = PING_HOSTS // 2
    rtt = app.rtt_sum[:half]
    checks = {k: (st[k], v) for k, v in PING_EXPECT.items()}
    checks.update({
        "clients and servers at 20 received": (
            int((app.rcvd == PING_COUNT).sum()), PING_HOSTS),
        "clients at 20 sent": (int((app.sent[:half] == PING_COUNT).sum()),
                               half),
        "clients' rtt_sum == 2 s": (int((rtt == PING_RTT_SUM).sum()), half),
        "events.overflow": (int(sim.events.overflow), 0),
        "outbox.overflow": (int(sim.outbox.overflow), 0),
        "rq_overflow": (int(sim.net.rq_overflow), 0),
    })
    for k, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"pingpong: {k}: {got} != {want}")
    if launches["mailbox_gather"] <= 0:
        raise AssertionError("pingpong: mailbox_gather was never launched")
    log(f"  pingpong: checks hold ({', '.join(checks)})")
    err = gathered.check("pingpong")
    del gathered
    log(f"  pingpong: wall {m['wall_s']:.3f} s, "
        f"{m['events'] / m['wall_s']:.1f} events/s, "
        f"{m['wall_s'] / st['micro_steps'] * 1e3:.2f} ms per micro-step "
        f"(one a window, route included), launches {launches}")
    b = runner.state["bundle"]

    def runner_to(end):
        return make_runner(b, app_handlers=(pingpong.handler,),
                           end_time=end, device=device)

    ringed, _ = runner_to(None)(telemetry.attach(b.sim))
    kept = state_at_window(runner_to, b, ringed.telem, PING_KEEP_WINDOW)
    replay_window("pingpong", b, pingpong.handler, kept, min_steps=1)
    return launches, err


def dispatch_cell(device):
    """Phase 12: bench's default PHOLD program (10,240 hosts, load 8,
    capacities 48, bulk pass, ring) to CK_SIM_S through make_runner,
    make_chunked_runner (K = 8), run_windows at K = 1 with a snapshot
    at 0.5 s, the snapshot loaded on the card and resumed, and
    run_windows at K = 16 with the adaptive rule: equal EngineStats and
    every leaf equal. The snapshot loaded onto the CPU equals the card's.
    Then MIX_VERTICES to MIX_SIM_S, make_runner against run_windows at
    K = 16. Returns the chunked run's launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core.engine import EngineStats
    from shadow_tpu_torch.net.build import make_chunked_runner
    from shadow_tpu_torch.utils import checkpoint

    def bundle(graph=bench.ONE_VERTEX, sim_s=CK_SIM_S):
        b = bench.build_phold(HOSTS, LOAD, sim_s, 1, CAPACITY, graph, device)
        b.app_bulk = phold.BULK
        return b

    def windows(**kw):
        """A runner for drive(): run_windows on the sim it is given."""
        def go(sim):
            out, stats, go.saved = checkpoint.run_windows(
                b, (phold.handler,), sim=sim, device=device, **kw)
            return out, stats
        return go

    def run(label, runner):
        sim, stats, wall, launches = drive(label, b, runner, device)
        check_phold(label, sim, HOSTS, LOAD, launches)
        return (stats, sim), wall, launches

    b = bundle()
    first, _, _ = run("make_runner", main_runner(b, device))
    chunked, _, launches = run("make_chunked_runner K=8", make_chunked_runner(
        b, app_handlers=(phold.handler,), app_bulk=phold.BULK,
        chunk_windows=8, device=device))
    assert_same_run("make_chunked_runner K=8", first, chunked)
    del chunked

    # the stats of the windows before the snapshot (those starting
    # before the cadence point), carried into the resume
    pre = [EngineStats.create(device=device)]

    def before_snapshot(sim, stats, wstart, wend, nm):
        if wstart < CK_EVERY_NS:
            pre[0] = pre[0].add(stats)

    with tempfile.TemporaryDirectory(prefix="shadow_ckpt_") as d:
        go = windows(checkpoint_every_ns=CK_EVERY_NS,
                     checkpoint_path=os.path.join(d, "ck"),
                     on_round=before_snapshot)
        k1, _, _ = run("run_windows K=1 with snapshots", go)
        assert_same_run("run_windows K=1", first, k1)
        del k1
        if not go.saved:
            raise AssertionError("run_windows: no snapshot was written")
        path, t_ck = go.saved[0]
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        sim_ck, t_load, _ = checkpoint.load(path, b.sim)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if t_load != t_ck or sim_ck.events.time.device != \
                b.sim.events.time.device:
            raise AssertionError(f"load: time {t_load} != {t_ck}, or the sim "
                                 f"is not on the template's device")
        t0 = time.perf_counter()
        checkpoint.save(os.path.join(d, "again.npz"), sim_ck, time_ns=t_ck)
        save_s = time.perf_counter() - t0
        card_leaves = convert.sim_to_numpy(sim_ck)
        resume = windows(start_time=t_ck, stats0=pre[0])
        # drive() hands the runner the boot state; the resume starts from
        # the loaded one
        resumed, _, _ = run("resume K=1 from the snapshot",
                            lambda _boot: resume(sim_ck))
        assert_same_run("snapshot + load + resume", first, resumed)
        del resumed, sim_ck
        log(f"  snapshot at {t_ck} ns: {nbytes} bytes, save {save_s:.3f} s, "
            f"load {load_s:.3f} s; resumed == make_runner, every leaf")
        template = convert.sim_from_numpy(convert.sim_to_numpy(b.sim),
                                          device="cpu")
        cpu_leaves = convert.sim_to_numpy(checkpoint.load(path, template)[0])
        bad = [k for k in card_leaves if k not in cpu_leaves
               or card_leaves[k].dtype != cpu_leaves[k].dtype
               or not np.array_equal(card_leaves[k], cpu_leaves[k])]
        if bad or card_leaves.keys() != cpu_leaves.keys():
            raise AssertionError(f"the snapshot loaded onto the CPU differs "
                                 f"from the card's: {bad[:5]}")
        log(f"  the snapshot loaded onto the CPU == on the card: all "
            f"{len(cpu_leaves)} leaves")
        del template, cpu_leaves, card_leaves

    k16, _, _ = run("run_windows K=16 adaptive",
                    windows(windows_per_dispatch=16, adaptive_jump=True))
    assert_same_run("run_windows K=16 adaptive (the static partition)",
                    first, k16)
    del k16, first

    b = bundle(bench.MIX_VERTICES, MIX_SIM_S)
    mix, wall, _ = run("MIX_VERTICES make_runner", main_runner(b, device))
    mk, kwall, _ = run(f"MIX_VERTICES run_windows K={MIX_CHUNK}",
                       windows(windows_per_dispatch=MIX_CHUNK))
    n = assert_same_run(f"MIX_VERTICES run_windows K={MIX_CHUNK}", mix, mk)
    w = mix[0].as_dict()["windows"]
    log(f"  MIX_VERTICES: min_jump {b.min_jump} ns, {w} windows; "
        f"make_runner {wall / w * 1e3:.2f} ms/window, run_windows "
        f"K={MIX_CHUNK} {kwall / w * 1e3:.2f} ms/window; all {n} leaves "
        f"equal")
    return launches


def fault_replay_cost(label, fn, sim, wends):
    """One call of a fault_fn at each of `wends`, in order, under
    torch.profiler: host launches and copies, and ms (synchronized).
    Returns [(wend, launches, copies, ms)]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for wend in wends:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim = fn(sim, wend)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        ev = raw_events(prof)
        copies = sum(1 for e in ev if e.device_type == DeviceType.CPU
                     and e.name.startswith("cudaMemcpy"))
        out.append((wend, host_launches(ev), copies, ms))
    log(f"  {label}: fault_fn per window (wend, launches, copies, ms) "
        f"{[(w, n, c, round(t, 3)) for w, n, c, t in out]}")
    return out


def check_record_boundaries(label, ring, plan):
    """No window of the ring straddles a record time: each record lands
    on a window boundary (the record clamp). Returns how many windows
    the clamp cut short."""
    import numpy as np

    ws, we = ring.wstart.cpu().numpy(), ring.wend.cpu().numpy()
    n = int(ring.count)
    ws, we = ws[:n], we[:n]
    t = np.unique(plan.t_ns)
    bad = [int(x) for x in t if ((ws < x) & (x < we)).any()]
    if bad:
        raise AssertionError(f"{label}: windows straddle records {bad}")
    return int(np.isin(we, t).sum())


def faults_cell(device):
    """Phase 13: fault plans, crash and restart, and escalation at full
    width (13a, 13b, 13c; the module docstring). Returns ({"launches_faults",
    "launches_crash", "launches_escalate", "max_abs_err"}, seconds per
    sub-phase)."""
    import os
    import pathlib
    import shutil
    import tempfile

    import torch

    from shadow_tpu_torch import faults, telemetry
    from shadow_tpu_torch.apps import phold, pingpong, relay
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.faults import conserve
    from shadow_tpu_torch.net.build import (
        HostSpec, build, make_chunked_runner, make_runner)
    from shadow_tpu_torch.net.state import NetConfig
    from shadow_tpu_torch.utils import checkpoint

    out, secs = {}, {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = round(now - mark[0], 1)
        mark[0] = now

    plan = faults.records_from_json(
        (pathlib.Path(__file__).resolve().parent / FAULT_PLAN).read_text())

    def bundle(H, sim_s=SIM_S, event_capacity=None, with_plan=True):
        b = build_phold(H, LOAD, sim_s, seed=1, device=device, cap=CAPACITY,
                        sparse_lanes=None, ring=True,
                        event_capacity=event_capacity)
        if with_plan:
            faults.install(b, plan)
        b.app_bulk = phold.BULK
        return b

    # --- 13a: the degraded network -----------------------------------
    bs = bundle(FAULT_SMALL_HOSTS)
    sim, stats = main_runner(bs, device)(bs.sim)
    got = stats.as_dict()
    drops = int(sim.net.ctr_drop_reliability.sum())
    if got != FAULT_SMALL_EXPECT or drops != FAULT_SMALL_DROPS:
        raise AssertionError(f"faults at {FAULT_SMALL_HOSTS} hosts: "
                             f"{got}, drops {drops} != the reference's "
                             f"{FAULT_SMALL_EXPECT}, {FAULT_SMALL_DROPS}")
    log(f"  faults at {FAULT_SMALL_HOSTS} hosts == the reference's counts: "
        f"{got}, reliability drops {drops}")
    del bs, sim
    lap("13a_1024")

    b = bundle(HOSTS)
    with KeepGatherInputs() as gathered:
        sim0, stats0, _, launches = drive("faults make_runner", b,
                                          main_runner(b, device), device)
    out["max_abs_err"] = gathered.check("faults make_runner")
    del gathered
    out["launches_faults"] = launches["mailbox_gather"]
    check_phold("faults make_runner", sim0, HOSTS, LOAD, launches)
    first = (stats0, sim0)
    drops = int(sim0.net.ctr_drop_reliability.sum())
    clamped = check_record_boundaries("faults make_runner", sim0.telem,
                                      b.fault_plan)
    if drops <= 0:
        raise AssertionError("faults make_runner: the loss flaps dropped "
                             "nothing")
    log(f"  faults make_runner: {stats0.as_dict()['windows']} windows "
        f"({clamped} ending at a record time), reliability drops {drops}")
    lap("13a_make_runner")

    sim, stats, _, _ = drive(
        f"faults make_chunked_runner K={FAULT_CHUNK}", b,
        make_chunked_runner(b, app_handlers=(phold.handler,),
                            app_bulk=phold.BULK, chunk_windows=FAULT_CHUNK,
                            device=device), device)
    assert_same_run("faults make_chunked_runner", first, (stats, sim))
    del sim
    lap("13a_chunked")

    ckdir = tempfile.mkdtemp(prefix="shadow_faults_")

    def supervised(label, processed0=0, stop_past=None, **kw):
        """run_supervised on b with a conserve.sample at every barrier,
        preempted at the first barrier whose window ends past
        `stop_past`. Returns (result, samples)."""
        samples, total = [], [processed0]
        if stop_past is not None:
            kw["stop"] = lambda: samples[-1].wend > stop_past

        def on_round(sim, wstats, wstart, wend, next_min):
            total[0] += int(wstats.events_processed)
            samples.append(conserve.sample(
                sim, wstart=wstart, wend=wend, next_min=next_min,
                processed_total=total[0]))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = faults.run_supervised(
            b, (phold.handler,), checkpoint_path=os.path.join(ckdir, label),
            checkpoint_every_windows=FAULT_CKPT_WINDOWS, on_round=on_round,
            device=device, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = res.health
        log(f"  {label}: ok {res.ok} in {wall:.3f} s, {len(samples)} "
            f"barriers, {len(res.checkpoints)} snapshots, health fatal "
            f"{h.fatal} overflow {h.events_overflow}/{h.outbox_overflow}/"
            f"{h.rq_overflow}")
        if h.fatal or h.events_overflow or h.outbox_overflow \
                or h.rq_overflow:
            raise AssertionError(f"{label}: {h.failure_report()}")
        return res, samples

    def conserved(label, samples):
        bad = conserve.check(samples)
        if bad:
            raise AssertionError(f"{label}: conservation: {bad[:3]}")
        log(f"  {label}: conserve.check([] over {len(samples)} barriers)")

    for k in (1, FAULT_CHUNK):
        label = f"run_supervised K={k}"
        res, samples = supervised(f"supervised_k{k}",
                                  windows_per_dispatch=k)
        if not res.ok or not res.checkpoints:
            raise AssertionError(f"{label}: ok {res.ok}, snapshots "
                                 f"{res.checkpoints}")
        conserved(label, samples)
        assert_same_run(f"faults {label}", first, (res.stats, res.sim))
        if k == 1:
            path, t_ck = res.checkpoints[0]
            nbytes = os.path.getsize(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(os.path.join(ckdir, "again.npz"), res.sim,
                            time_ns=t_ck)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint.load(path, b.sim)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            log(f"  faults snapshot at {t_ck} ns: {nbytes} bytes, save "
                f"{save_s:.3f} s, load {load_s:.3f} s")
        del res
        lap(f"13a_supervised_k{k}")

    stopped, before = supervised("supervised_stop", stop_past=FAULT_STOP_NS)
    if not stopped.preempted:
        raise AssertionError("supervised stop: the run was not preempted")
    t_stop = int(stopped.final_checkpoint.rsplit(".", 2)[1])
    resumed, after = supervised(
        "supervised_resume", processed0=before[-1].processed,
        resume_from=stopped.final_checkpoint)
    conserved("stop + resume", conserve.stitch(before, after, t_stop))
    if resumed.resume_of != stopped.run_id or not resumed.ok:
        raise AssertionError("resume: the chain was not continued")
    assert_same_run("faults stop at 2.2 s + resume", first,
                    (resumed.stats, resumed.sim))
    log(f"  stopped at {t_stop} ns (the spike is over [2.0, 2.5) s), "
        f"resumed: == make_runner, every leaf")
    del stopped, resumed, first
    lap("13a_stop_resume")

    fn = faults.fault_fn_for(b)
    t_rec = int(b.fault_plan.t_ns[0])
    fault_replay_cost("faults table replay (warm, before, after the 1.0 s "
                      "record)", fn, b.sim,
                      [b.min_jump, t_rec, t_rec + b.min_jump])
    del b, sim0

    # --- 13b: crash and restart --------------------------------------
    pb = pingpong.build_bench(PING_HOSTS, end_time_s=PING_SIM_S,
                              count=PING_COUNT, tcp=False, device=device)
    half = PING_HOSTS // 2
    servers = list(range(half, PING_HOSTS, CRASH_EVERY))
    recs = ([faults.FaultRecord(t_ns=CRASH_NS, kind=faults.FaultKind.CRASH,
                                a=h) for h in servers]
            + [faults.FaultRecord(t_ns=RESTART_NS,
                                  kind=faults.FaultKind.RESTART, a=h)
               for h in servers])
    faults.install(pb, recs)
    sim, stats, _, launches = drive(
        "crash pingpong", pb,
        make_runner(pb, app_handlers=(pingpong.handler,), device=device),
        device)
    out["launches_crash"] = launches["mailbox_gather"]
    crashed = torch.zeros(PING_HOSTS, dtype=torch.bool, device=device)
    crashed[torch.tensor(servers, device=device)] = True
    crashed[torch.tensor(servers, device=device) - half] = True
    app = sim.app
    clean_rtt = app.rtt_sum[:half][~crashed[:half]]
    checks = {k: (stats.as_dict()[k], v) for k, v in CRASH_EXPECT.items()}
    checks.update({
        "clean hosts at 20 received": (
            int((app.rcvd[~crashed] == PING_COUNT).sum()),
            PING_HOSTS - 2 * len(servers)),
        "crashed pairs at 0 received": (int((app.rcvd[crashed] == 0).sum()),
                                        2 * len(servers)),
        "clean clients' rtt_sum == 2 s": (
            int((clean_rtt == PING_RTT_SUM).sum()), half - len(servers)),
        "events.overflow": (int(sim.events.overflow), 0),
    })
    for k, (g, want) in checks.items():
        if g != want:
            raise AssertionError(f"crash pingpong: {k}: {g} != {want}")
    log(f"  crash pingpong: {len(servers)} servers down over [1.0, 1.5) s; "
        f"checks hold ({', '.join(checks)})")
    fault_replay_cost("crash reset (before, while down, after the restart)",
                      faults.fault_fn_for(pb), pb.sim,
                      [CRASH_NS, CRASH_NS + 200_000_000, RESTART_NS + 1])
    del pb, sim
    lap("13b_pingpong")

    def relay_crash(dev):
        hosts = [HostSpec(name=f"n{i}", proc_start_time=10**9)
                 for i in range(3)]
        rb = build(NetConfig(num_hosts=3, end_time=6 * 10**9,
                             sockets_per_host=4), RELAY_CRASH_GRAPH, hosts,
                   device=dev)
        rb.sim = relay.setup(rb.sim, circuits=[[0, 1, 2]],
                             total_bytes=20_000)
        faults.install(rb, [
            faults.FaultRecord(t_ns=1_200_000_000,
                               kind=faults.FaultKind.CRASH, a=1),
            faults.FaultRecord(t_ns=2_000_000_000,
                               kind=faults.FaultKind.RESTART, a=1)])
        return rb, make_runner(rb, app_handlers=(relay.handler,),
                               device=dev)

    st, sim = compare_bundles_cuda_cpu("relay crash + restart", relay_crash)
    if not 0 < int(sim.app.rcvd[2]) < 20_000:
        raise AssertionError("relay crash: the transfer was not cut short")
    lap("13b_relay_cuda_cpu")

    # --- 13c: escalation ----------------------------------------------
    caps = {"event_capacity": ESC_CAP}

    def rebuild(overrides):
        caps.update(overrides)
        return bundle(HOSTS, ESC_SIM_S, caps["event_capacity"],
                      with_plan=False)

    harv = telemetry.Harvester()
    start = rebuild({})
    torch.cuda.synchronize()
    mailbox_gather.launches = 0
    t0 = time.perf_counter()
    res = faults.run_supervised(
        start, (phold.handler,),
        checkpoint_path=os.path.join(ckdir, "esc"),
        checkpoint_every_windows=ESC_CKPT_WINDOWS, max_retries=0,
        harvester=harv,
        escalation=faults.EscalationPolicy(), rebuild=rebuild,
        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches_escalate"] = mailbox_gather.launches
    rep = res.failure_report()
    checks = {
        "ok": (res.ok, True),
        "retries_used": (res.retries_used, 0),
        "escalated": (res.escalation_restarts >= 1 and bool(res.escalations),
                      True),
        "doubled event_capacity": (all(
            e.knob == "event_capacity" and e.new == 2 * e.old
            for e in res.escalations), True),
        "grown == last new": (caps["event_capacity"],
                              res.escalations[-1].new if res.escalations
                              else None),
        "events.overflow": (int(res.sim.events.overflow), 0),
        "report": ((rep["retries_used"], rep["escalation_restarts"],
                    bool(rep.get("escalations"))),
                   (0, res.escalation_restarts, True)),
        "harvester marks": (len(harv.escalation_marks),
                            len(res.escalations)),
    }
    for k, (g, want) in checks.items():
        if g != want:
            raise AssertionError(f"escalation: {k}: {g} != {want}")
    log(f"  escalation: {[e.as_dict() for e in res.escalations]} in "
        f"{wall:.3f} s, {len(res.checkpoints)} snapshots, healed from "
        f"{res.resumed_from or 'boot (no snapshot before the trip)'}; "
        f"checks hold ({', '.join(checks)})")
    ref = rebuild({})
    sim, stats, _ = checkpoint.run_windows(ref, (phold.handler,),
                                           device=device)
    n = assert_same_run("escalation == the grown capacity from scratch",
                        (stats, sim), (res.stats, res.sim))
    log(f"  escalation: == a from-scratch run at event_capacity "
        f"{caps['event_capacity']}: EngineStats and all {n} leaves")
    lap("13c_escalation")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"  phase 13 seconds per sub-phase {json.dumps(secs)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the main path's first windows")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from shadow_tpu_torch import bench
    from shadow_tpu_torch.core import insert_kernels

    phase_s = {}
    mark = {"name": None, "t": time.perf_counter()}

    def phase(name):
        now = time.perf_counter()
        if mark["name"] is not None:
            phase_s[mark["name"]] = round(now - mark["t"], 1)
        mark.update(name=name, t=now)

    phase("1-3")
    log("[1] device")
    device = torch.device("cuda", 0)
    smi = bench.device_line(device)
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{kind} count {torch.cuda.device_count()}")

    log("[2] build kernels")
    t0 = time.perf_counter()
    path, text = insert_kernels.build_library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in text.strip().splitlines():
        log(f"  [nvcc] {line}")

    log("[3] kernels against their plain versions")
    # the gossip cells' route shapes (narrow tier and full outbox)
    gossip_n = [(GOSSIP_HOSTS, GOSSIP_HOSTS * 24),
                (GOSSIP_HOSTS, GOSSIP_HOSTS * GOSSIP_CAP)]
    row, warm_ms = check_mailbox_gather(device, P=11, main_n=HOSTS * 24,
                                        also=gossip_n)
    tcp_row, _ = check_mailbox_gather(
        device, P=22, main_n=HOSTS * RELAY_CAP,
        also=gossip_n + [(TOR_HOSTS, TOR_HOSTS * 24)])
    tor_row, _ = check_mailbox_gather(device, P=22, H=TOR_HOSTS,
                                      main_n=TOR_HOSTS * TOR_CAP)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    row["max_abs_err"] = max(row["max_abs_err"], tcp_row["max_abs_err"],
                             tor_row["max_abs_err"])
    row["p22"] = {k: tcp_row[k] for k in keys}
    row["p22_tor"] = {k: tor_row[k] for k in keys}

    phase("4")
    log(f"[4] main path: bench.py's default PHOLD, {HOSTS} hosts load "
        f"{LOAD} {SIM_S} sim-s, bulk pass, sparse default, ring")
    launches = run_main_path(device)
    row["launches"] = launches["mailbox_gather"]

    if args.profile:
        phase("4p")
        log("[4p] profile")
        profile_windows(device, (row["ms"], warm_ms))

    phase("4a")
    log("[4a] the serial path: no bulk, sparse_lanes=0, no ring, "
        "1 sim-s")
    run_serial_path(device)

    phase("4b")
    log("[4b] bulk pass: cube and sort order forms, 1 sim-s")
    compare_order_forms(device)

    phase("4c")
    log("[4c] sparse shape: 64 of 10,240 hosts active, 1 sim-s")
    compare_sparse_shape(device)

    phase("5")
    log("[5] CUDA against CPU inside the port")
    compare_cuda_cpu("serial", 64, 4, 1.0)
    compare_cuda_cpu("bulk + ring", 64, 4, 1.0, bulk=True, ring=True)
    compare_cuda_cpu("sparse", 64, 2, 1.0, sparse_lanes=16, active_hosts=4)
    t0 = time.perf_counter()
    compare_relay_cuda_cpu("relay 2x5 hops + ring", 10, 5, 15_000, 3.0)
    compare_relay_cuda_cpu("relay 2x2 hops 1% loss", 4, 2, 25_000, 4.0,
                           loss=0.01, ring=False)
    compare_relay_cuda_cpu("relay 2x5 hops + ring, TCP bulk", 10, 5,
                           30_000, 3.0, tcp_bulk=True)
    compare_relay_cuda_cpu("relay 2x2 hops 1% loss, TCP bulk lossless", 4,
                           2, 25_000, 4.0, loss=0.01, tcp_bulk=True,
                           lossless=True)
    log(f"  the four relay configs took {time.perf_counter() - t0:.1f} s")

    phase("6")
    log(f"[6] TCP relay as tools/scale_run.py runs it: {HOSTS} hosts, "
        f"{HOSTS // RELAY_HOP} circuits x {RELAY_HOP} hops, {RELAY_BYTES} "
        f"bytes, {RELAY_SIM_S} sim-s, TCP bulk pass, sparse default, ring")
    relay = relay_cell("relay", device, RELAY_HOP, RELAY_BYTES, RELAY_SIM_S,
                       keep=RELAY_KEEP_WINDOW, expect=RELAY_EXPECT)
    row["launches_relay"] = relay[2]["mailbox_gather"]
    if args.profile:
        phase("6p")
        log("[6p] relay profile")
        profile_relay(device)

    phase("6s")
    log("[6s] the same cell serial (scale_run's --no-bulk)")
    serial = relay_cell("relay serial", device, RELAY_HOP, RELAY_BYTES,
                        RELAY_SIM_S, tcp_bulk=False,
                        expect=RELAY_SERIAL_EXPECT)
    row["launches_relay_serial"] = serial[2]["mailbox_gather"]
    assert_contract("relay 6 vs 6s", relay[:2], serial[:2])
    del relay, serial

    phase("6a")
    log(f"[6a] lossy relay: {HOSTS // LOSSY_HOP} circuits x {LOSSY_HOP} "
        f"hops, {LOSSY_BYTES} bytes, {LOSSY_LOSS:.0%} loss, "
        f"{LOSSY_SIM_S} sim-s, TCP bulk pass")
    lossy = relay_cell("lossy relay", device, LOSSY_HOP, LOSSY_BYTES,
                       LOSSY_SIM_S, loss=LOSSY_LOSS, keep=LOSSY_KEEP_WINDOW,
                       profile_call=False)
    row["launches_relay_lossy"] = lossy[2]["mailbox_gather"]
    got = {"events_processed": lossy[1]["events_processed"],
           "windows": lossy[1]["windows"], "retx_segs": lossy[3],
           "fr_entries": lossy[4]}
    if got != LOSSY_EXPECT:
        raise AssertionError(f"lossy relay: {got} != {LOSSY_EXPECT}")
    log(f"  lossy relay: counters as the serial path gives them: {got}")
    del lossy
    phase("6as")
    log(f"[6as] the lossy cell serial and with the TCP bulk pass, both cut "
        f"to {LOSSY_SERIAL_SIM_S} sim-s")
    twin = relay_cell("lossy relay to the serial depth", device, LOSSY_HOP,
                      LOSSY_BYTES, LOSSY_SERIAL_SIM_S, loss=LOSSY_LOSS,
                      complete=False)
    serial = relay_cell("lossy relay serial", device, LOSSY_HOP,
                        LOSSY_BYTES, LOSSY_SERIAL_SIM_S, loss=LOSSY_LOSS,
                        tcp_bulk=False, complete=False)
    if serial[3] <= 0:
        raise AssertionError("lossy relay serial: no segment was "
                             "retransmitted by the cut depth")
    assert_contract("lossy relay 6as twins", twin[:2], serial[:2])
    del twin, serial

    phase("7")
    log(f"[7] UDP gossip as tools/scale_run.py runs it: {GOSSIP_HOSTS} "
        f"hosts, K = {GOSSIP_K}, {GOSSIP_BLOCKS} blocks, {GOSSIP_SIM_S} "
        f"sim-s, sparse default, ring")
    launches, err = gossip_cell(device)
    row["launches_gossip"] = launches["mailbox_gather"]
    row["max_abs_err"] = max(row["max_abs_err"], err)

    phase("8")
    log(f"[8] the shared-relay Tor model as tools/scale_run.py runs it: "
        f"{TOR_HOSTS} hosts, {TOR_SLOTS} slots, {TOR_HOPS} relays a "
        f"circuit, cut to {TOR_SIM_S} sim-s, TCP bulk pass, sparse "
        f"default, ring")
    launches, err = tor_cell(device)
    row["launches_tor"] = launches["mailbox_gather"]
    row["max_abs_err"] = max(row["max_abs_err"], err)

    phase("9")
    log("[9] CUDA against CPU inside the port: the Tor model and gossip")
    t0 = time.perf_counter()
    compare_new_apps_cuda_cpu()
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    phase("10")
    log(f"[10] TCP gossip: {GTCP_HOSTS} hosts, K = {GOSSIP_K}, cut to "
        f"{GTCP_SIM_S} sim-s, sparse default, ring")
    launches, err = gossip_tcp_cell(device)
    row["launches_gossip_tcp"] = launches["mailbox_gather"]
    row["max_abs_err"] = max(row["max_abs_err"], err)

    phase("11")
    log(f"[11] pingpong as python -m shadow_tpu_torch.bench runs it: "
        f"{PING_HOSTS} hosts, {PING_HOSTS // 2} pairs, {PING_COUNT} pings, "
        f"{PING_SIM_S} sim-s")
    launches, err = pingpong_cell(device)
    row["launches_pingpong"] = launches["mailbox_gather"]
    row["max_abs_err"] = max(row["max_abs_err"], err)

    phase("12")
    log(f"[12] chunked and checkpointed dispatch: bench's PHOLD, {HOSTS} "
        f"hosts, {CK_SIM_S} sim-s; MIX_VERTICES to {MIX_SIM_S} sim-s")
    launches = dispatch_cell(device)
    row["launches_chunked"] = launches["mailbox_gather"]

    phase("13")
    log(f"[13] faults: the degraded plan on bench's PHOLD ({HOSTS} hosts, "
        f"{SIM_S} sim-s) through every runner; pingpong with "
        f"{CRASH_PAIRS} servers crashed; escalation of an event queue of "
        f"{ESC_CAP}")
    got = faults_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], got.pop("max_abs_err"))
    row.update(got)

    phase(None)
    log(f"  done; seconds per phase {json.dumps(phase_s)}")
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
