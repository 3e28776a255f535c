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
   the L2) at the main shape, the relay's, the Tor cell's and the
   --test example's route (1,001 hosts, P = 22, the narrow tier's 24
   columns; equality also at its full outbox of 4,096);
4. the main path at full width: bench.py's default PHOLD program —
   10,240 hosts, load 8, the one-vertex 50 ms topology, capacities 48
   and in_ring 16 as bench.py settles them, 5 simulated seconds, the
   bulk window pass (phold.BULK), the default sparse-lane budget (256)
   and the telemetry ring — with the launch counters reset just before
   and read just after; checks zero overflow, sent == H*load + rcvd,
   hit + miss == windows and the ring against EngineStats;
   4a. the serial path (no bulk pass, sparse_lanes=0, no ring) at full
   width for 0.5 simulated seconds;
   4b. the bulk program in both EventOrder forms ("cube", the card's
   default, and "sort") at full width for 0.5 simulated seconds: equal
   EngineStats and every leaf equal, with the bulk pass's time per
   window (CUDA-event pair and host clock) and launches per call;
   4c. bench.py's sparse shape (10,240 hosts, 64 active, no bulk pass)
   for 0.5 simulated seconds with sparse_lanes=256 and 0: the fast path
   hits, every leaf equal, EngineStats equal apart from hit/miss;
5. small runs on CUDA and on the CPU inside the port — PHOLD at 64
   hosts serial, with the bulk pass and ring, and with 4 active and
   sparse_lanes=16; the TCP relay serial at 10 hosts (2 circuits x 5
   hops, 4,000 bytes, ring on) and at 4 hosts (2 circuits x 2 hops,
   25,000 bytes, 1% loss), and through the TCP bulk pass at 10 hosts
   and at the 4-host shape with tcp_bulk_lossless=True — the 5-hop pair
   to 1.5 sim-s, the lossy pair to 1.6 sim-s — every transfer complete,
   with equal EngineStats and every state leaf equal (tolerance zero —
   the state is integer apart from bit-exact f32 draws);
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
   6s. the same cell serial (scale_run's --no-bulk) and with the TCP
   bulk pass, both cut to 1.55 sim-s, held to each other under the
   reference's bulk-vs-serial contract (tests/test_tcp_bulk.py) with
   fewer micro-steps with the pass;
   6a. the same shape lossy with the TCP bulk pass: 5,120 two-hop
   circuits, 50,000 bytes each, 1% loss on the self-edge, every
   transfer complete, and the serial path's counters (351,064 events,
   62 windows, 2,310 retransmitted segments, 1,421 fast-recovery
   entries); 6as the lossy cell serial and with the pass, both cut to
   1.55 sim-s, held to each other under the contract;

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
   shapes: the Tor model at 10 hosts to 10 sim-s with the TCP bulk
   pass (every stream complete) and serial cut to 1.25 sim-s
   (mid-transfer), the serial run held under the reference's contract
   to a TCP bulk run on the card to 1.25 sim-s; UDP gossip at 64 hosts
   and TCP gossip at 8 hosts (cut to 4 sim-s);
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
   from-scratch run at the grown capacity;
14. the command-line entry point on reference-format configs: (14a)
   `python -m shadow_tpu_torch.cli <config> --platform gpu` as a
   subprocess on the built-in --test example (1,000 clients upload 330
   KiB each to one server over TCP) cut at 2.05 sim-s, where the
   server's SYN burst begins: its report equal to the reference's
   counts (1,001 events, 2 windows, app_rcvd 0, overflow 0); the same
   bundle in-process through the loader and make_runner (2
   micro-steps), and 4 micro-steps of the burst window that follows
   replayed, the second under torch.profiler; (14b) the example at 2
   clients x 33 KiB, seed 3, through the CLI to full depth (109
   events, 17 windows, every byte received), its CUDA and CPU runs cut
   to 2.2 sim-s leaf-equal with mailbox_gather held to its plain
   version on their route, and the reference's PHOLD test config
   through the CLI (its report equal to the reference CLI's); (14c)
   CUDA against CPU through the loader: pingpong under the RR
   interface qdisc and the SINGLE and STATIC router queues, the
   testtcp echo pair, testdeterminism (randdump) and the ring model;
15. open-system injection at full width: (15a) bench.py's
   BENCH_INJECT_RATE=10240 scenario as `python -m
   shadow_tpu_torch.bench` runs it, as a subprocess — the tgen app on
   10,240 hosts fed 51,200 events over 5 sim-s through 1,024 staging
   lanes, its row printed — then the same program in-process through
   run_supervised (the launch counter set to 0 just before it) with
   the reference's exact counts (112,128 events, 100 windows, 199
   micro-steps; 51,200 injected, 0 dropped, late or deferred,
   backpressure 99; 51,200 sent, 3,276,800 bytes, 50,688 received; zero
   overflow), mailbox_gather held to its plain version on the run's own
   merge and route inputs, and through run_windows at K = 1 (leaf-equal
   to the supervised run) and K = 16 (leaf-equal under the carve-outs
   of tests/test_inject.py; its windows, micro-steps and backpressure
   pinned), with ms per window and per micro-step, the refills' host
   time, and one window profiled (launches, syncs, device busy share,
   the refill's share); the cell cut to 64 hosts through run_windows at
   K = 16, the reference's counts, CUDA against CPU; (15b) the
   supervised run stopped at
   the first barrier past 2.2 sim-s and resumed from its snapshot with
   a fresh feeder, leaf-equal to the straight run with its injection
   block reconciled; (15c) examples/tgen_traffic.shadow.config.xml
   through `python -m shadow_tpu_torch.cli --platform gpu --trace-out
   --metrics-out`: the reference CLI's report and manifest injection
   and telemetry blocks, a Chrome trace that loads and Prometheus text
   that parses; the same config CUDA against CPU inside the port;
16. lane isolation and the flight recorders: (16a) bench.py's
   BENCH_REPLICAS=4 BENCH_LANE_ISOLATION=1 BENCH_FLOW_SAMPLE=64
   BENCH_CAUSALITY=64 row as `python -m shadow_tpu_torch.bench` runs it,
   as a subprocess — phase 4's program packed four times (40,960 rows,
   one lane a replica) with the flow ring and the lineage and advance
   planes — then the same program in-process (the launch counter set
   to 0 just before it): zero overflow, no lane tripped, sent == H*load
   + rcvd globally and per lane, the three latches equal to the sums of
   their planes, the flow ring's count + lost == sampled, lineage count
   <= seen, one advance record a window, the ring's per-lane events
   summing to its events plane every window, mailbox_gather held to its
   plain version on the run's own 983,040-row route and timed there,
   and the first windows profiled; (16b) the program with the recorders
   off equal on every shared leaf, lanes.attach(sim, 1) equal to no
   lanes, a flooded victim lane quarantined on events_overflow alone
   with the healthy lanes byte-identical to a clean run, and the same
   flood under run_supervised with on_lane_quarantine (its salvage
   artifact read back by checkpoint.load) — these cut to 1 sim-s;
   (16c) the program cut to 4 x 256 hosts and 15a's 64-host cut with
   BENCH_CAUSALITY=8 on the card and the CPU: the reference's pinned
   counts on both (lane report, flows, lineage, binding causes), every
   leaf equal; (16d) `python -m shadow_tpu_torch.cli` on the <traffic>
   config with --lane-isolation 4 --resident --flow-sample 8
   --causality-sample 8 --trace-out --metrics-out: the report and the
   manifest's lanes, admission, flows, causality and specialization
   blocks equal to a CPU run's, the manifest accepted by
   tools/telemetry_lint.py;
17. the capability-trimmed programs (compile/specialize.py; the CLI's
   default since the trim was ported, so phases 14-16's CLI runs are
   trimmed too, and 14b's PHOLD config writes a manifest whose
   specialization block tools/telemetry_lint.py checks): (17a) phase
   4's bundle through specialize.apply (loss and timers dropped) and
   make_runner: every leaf but the guard and the EngineStats equal to
   phase 4's run, the guard's counters 0, mailbox_gather launched every
   window and exact against its plain version on the run's own route
   streams (and timed there), and windows 1-3 profiled with and without
   the trim (launches, syncs, device busy a window); (17b) bench.py's
   BENCH_SPECIALIZE=1 row as `python -m shadow_tpu_torch.bench` runs
   it, as a subprocess: its _spec name, 17a's counts and its
   specialize_speedup against the untrimmed twin it times; (17c) the
   guard latch: 17a's bundle with a halved reliability table and with a
   TIMER planted in the queue, each to 0.3 sim-s — health.gather
   reports the trip fatal with the reference's diagnostics; (17d) 6s's
   relay bulk twin trimmed (loss dropped: relay declares no kinds) to
   6s's depth, equal to the untrimmed twin in every leaf but the guard.
18. the netstack's observability settings and native/: the native
   library built from shadow_tpu_torch/native/src into _build/ and
   loaded, a 4,096-record log flush sorted by its logsort_argsort;
   (18a) `python -m shadow_tpu_torch.cli` as a subprocess on a
   reference-format config of PHOLD at 10,240 hosts, load 8, on
   bench.py's MIX_VERTICES graph, every host logpcap="true", with
   --track-paths --cpu-threshold 0 --cpu-precision 10 -l info, to 0.005
   sim-s: the report, the nine path lines, the line count (one log
   flush past 4,096 records, through the native argsort) and the
   10,240 pcap files (sha256 over their bytes) equal to the reference
   CLI's CPU run; (18b) the same bundle in-process to 0.01 sim-s through
   utils/checkpoint.run_windows with a CaptureSession drain every
   window: the reference's EngineStats, blocked events and their
   delay, path matrix, app.rcvd and files, mailbox_gather launched on the run's
   route and exact against its plain version there (and timed), the
   drain timed (ms, records/s, bytes copied a window) and one steady
   window profiled (launches, syncs, device busy); (18c) CUDA against
   CPU: the program at 64 hosts with four CPU speeds (HostSpec
   cpufrequency_khz) to 0.005 sim-s, and 14b's TCP example twin with
   logpcap on the server — every leaf equal, the files byte-equal, the
   reference's pinned counts. 18c runs while 18a's subprocess does.

Phases 7, 8, 10 and 11 each replay one window through the engine's own
core.engine.step_window, from the state the run held at its start
(micro-steps timed one by one through a step_fn shim, then the first
again under torch.profiler: launches and cudaStreamSynchronize per
micro-step). The CPU halves of the CUDA-against-CPU comparisons
(phases 5, 9, 13b, 14b-c, 15c, 16c, 18c) run in two spawned CPU worker
processes, at the same time as their CUDA halves; phases 5 and 9, which
read no launch counter, run their CUDA halves in three spawned card
workers, all of a phase's runs at once. The CLI runs that only counts,
logs and files check run beside untimed work (phase 14's three
together, 15c's beside 15b, 16d's beside 16b-16c, 18a's beside 18c).
Every worker and subprocess stops with the script. The last log line
before the results gives each phase's seconds.

`--profile` also profiles windows 0-2 of phase 4, windows 10-12 of
phase 6 with the TCP bulk pass, and the hooks of phase 16's program
(launches and host ms a call of the lineage and flow recorders, the
advance latch and the lane barrier).

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
# 4a-4c's depth, cut from 1 sim-s to make room for phase 16
PATH_SIM_S = 0.5


# The relay cell: BASELINE config #3 as tools/scale_run.py builds it
# (--workload relay: --hop 5, --bytes 100000, capacities 64, 4 sockets
# per host, PROC_START at 1 s).
RELAY_HOP = 5
RELAY_BYTES = 100_000
RELAY_CAP = 64
RELAY_SIM_S = 4.0
# The reference's counts for the relay cell (its CPU runs of the same
# config at full width) with the TCP bulk pass.
RELAY_EXPECT = {"events_processed": 894_976, "windows": 22, "micro_steps": 6}
# The serial twin 6s runs to a cut depth, beside a run of the cell with
# the TCP bulk pass to the same depth (the contract compares like with
# like): at full depth (281 serial micro-steps, the reference's count)
# it took 58-72 s of a 479-569-s run on an NVIDIA H100 80GB HBM3 at
# 700 W. 1.55 sim-s holds ~50 of them: the circuits' handshakes and the
# first half of the transfers' ramp.
RELAY_SERIAL_SIM_S = 1.55
# Phase 5's four small relay configs, cut in depth (3 and 4 sim-s
# with 15,000 and 30,000 bytes on the 5-hop pair before: 66, 46, 6 and
# 29 micro-steps): the 5-hop pair moves 4,000 bytes a circuit, complete
# by 1.5 sim-s (30 serial micro-steps, 6 with the pass); the lossy 2-hop
# pair completes by 1.6 sim-s after 2 retransmits (37 serial
# micro-steps, 23 with the lossless pass; the port's CPU runs).
RELAY_SMALL_BYTES = 4_000
RELAY_SMALL_SIM_S = 1.5
RELAY_SMALL_LOSSY_SIM_S = 1.6

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
# NVIDIA H100 80GB HBM3 at 700 W. 1.55 sim-s holds 36 of the lossy
# cell's 374 serial micro-steps: the first losses, retransmits and fast
# recoveries, which the run checks are there; 6a's exact counters cover
# the rest.
LOSSY_SERIAL_SIM_S = 1.55


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
# tests/test_gossip_tcp.py). The mux runs with the TCP bulk pass at the
# test's full depth, 10 sim-s (17 micro-steps; the server's EOFs at
# 1.553 s). Serial it is cut to 1.25 sim-s, where the data reaches the
# server (1,434 of the 20,000 bytes at each stream's server; 27
# micro-steps, against 65 to 1.4 s, 185 to the EOFs and 211 to 10 sim-s,
# at ~360 ms each on the card), and held to a bulk run to the same depth
# (17 micro-steps; the port's CPU runs). TCP gossip is cut from 12 to 4 sim-s
# so that it takes well under a minute on the card (block 0 at every
# host, block 1 just mined).
MUX_SLOTS = 4
MUX_BYTES = 20_000
MUX_SIM_S = 10.0
MUX_SERIAL_SIM_S = 1.25
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

# Phase 14: the CLI and the reference-format configs. 14a is the
# built-in `--test` example (1,000 clients upload 330 KiB each to one
# server; shadow_tpu_torch/config/examples.py) at full width, cut at
# 2.05 sim-s where the server's SYN burst begins (the parser's
# int(2.05 * 1e9) = 2,049,999,999 ns). The reference's counts (its CPU
# run, the loader's hints, seed 1): 1,001 events, 2 windows, 2
# micro-steps, app_rcvd 0, overflow 0. The burst's route delivers
# 1,000 SYNs to one row, past the sweep's INSERT_SWEEP arrivals, so it
# takes the sorted scatter and launches no mailbox_gather (as the
# reference's "sort2" does); CLI_1K_BURST_STEPS micro-steps of the
# burst window that follows are replayed.
CLI_1K_CLIENTS = 1000
CLI_1K_STOP = 2.05
CLI_1K_EXPECT = {"events": 1_001, "windows": 2, "app_rcvd": 0,
                 "overflow": 0}
CLI_1K_MICRO_STEPS = 2
CLI_1K_BURST_STEPS = 4
# 14b: the example at tests/test_example_e2e.py's shape (33 KiB, 40
# sim-s, seed 3) but 2 clients instead of its 5, to full depth through
# the CLI; the reference CLI's counts (its CPU run): 109 events, 17
# windows (90 micro-steps), every byte received (5 clients: 268, 28,
# 211 micro-steps). Its CUDA/CPU twin is cut to CLI_TWIN_STOP.
CLI_EX_CLIENTS = 2
CLI_EX_KIB = 33
CLI_EX_SEED = 3
CLI_EX_EXPECT = {"events": 109, "windows": 17,
                 "app_rcvd": CLI_EX_CLIENTS * CLI_EX_KIB * 1024,
                 "overflow": 0}
CLI_TWIN_STOP = 2.2
# 14b: the reference's PHOLD test config (tests/test_config_cli.py:
# 10 peers, load 25, 3 s) and the reference CLI's report on the CPU
# (seed 1).
REFERENCE_PHOLD_XML = """<shadow>
  <topology><![CDATA[<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d4" />
  <key attr.name="latency" attr.type="double" for="edge" id="d3" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d2" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d1" />
  <key attr.name="countrycode" attr.type="string" for="node" id="d0" />
  <graph edgedefault="undirected">
    <node id="poi-1">
      <data key="d0">US</data>
      <data key="d1">10240</data>
      <data key="d2">10240</data>
    </node>
    <edge source="poi-1" target="poi-1">
      <data key="d3">50.0</data>
      <data key="d4">0.0</data>
    </edge>
  </graph>
</graphml>
]]></topology>
  <kill time="3"/>
  <plugin id="testphold" path="shadow-plugin-test-phold"/>
  <node id="peer" quantity="10">
    <application plugin="testphold" starttime="1"
      arguments="loglevel=info basename=peer quantity=10 load=25 weightsfilepath=weights.txt"/>
  </node>
</shadow>"""
PHOLD_REF_REPORT = {"events": 10_250, "windows": 41, "sim_seconds": 3.0,
                    "app_rcvd": 10_000, "overflow": 0}
# 14c: queue disciplines and the small apps, CUDA against CPU (bodies
# of reference-format configs over the example's one-vertex graph).
PING_BODY = """  <plugin id="pp" path="tgen-ping"/>
  <host id="server">
    <process plugin="pp" starttime="1" arguments="mode=server port=6000"/>
  </host>
  <host id="client" quantity="7">
    <process plugin="pp" starttime="1"
      arguments="mode=client server=server port=6000 count=5 size=1000"/>
  </host>"""
ECHO_BODY = """  <plugin id="testtcp" path="shadow-plugin-test-tcp"/>
  <host id="testserver">
    <process plugin="testtcp" starttime="1" arguments="blocking server"/>
  </host>
  <host id="testclient" quantity="3">
    <process plugin="testtcp" starttime="2"
      arguments="blocking client testserver"/>
  </host>"""
RANDDUMP_BODY = """  <plugin id="det" path="shadow-plugin-test-determinism"/>
  <host id="det" quantity="16">
    <process plugin="det" starttime="1"/>
  </host>"""
SMALL_STOP = {"ping": 3, "echo": 2.2, "randdump": 1.5}
# Phase 15: open-system injection. 15a is bench.py's BENCH_INJECT_RATE
# scenario at full width: the tgen app on 10,240 hosts fed
# bench._rate_trace(10240, 10240 events/s, 5 sim-s) — 51,200 events,
# round-robin sources, 64-byte datagrams to the next host — through
# tgen.lanes_for(51,200) = 1,024 staging lanes, capacities 64, seed 1,
# the one-vertex 50 ms graph, one window a dispatch. The reference's
# counts, from its CPU run of the same program through
# checkpoint.run_windows(feeder=Feeder(list(events))) (repository root,
# jax and this package importable):
#
#   import jax; jax.config.update("jax_platforms", "cpu")
#   from shadow_tpu.apps import tgen; from shadow_tpu.inject import Feeder
#   from shadow_tpu.net.build import HostSpec, build
#   from shadow_tpu.net.state import NetConfig
#   from shadow_tpu.utils import checkpoint
#   import bench
#   H = 10240; ev = bench._rate_trace(H, 10240.0, 5)
#   cfg = NetConfig(num_hosts=H, tcp=False, end_time=5 * 10**9, seed=1,
#                   event_capacity=64, outbox_capacity=64, router_ring=64,
#                   in_ring=16, inject_lanes=tgen.lanes_for(len(ev)))
#   b = build(cfg, bench.ONE_VERTEX, [HostSpec(name=f"peer{i}",
#             proc_start_time=0) for i in range(H)])
#   b.sim = tgen.setup(b.sim); f = Feeder(list(ev))
#   sim, st, _ = checkpoint.run_windows(b, (tgen.handler,), feeder=f)
#
# 15b stops the supervised run at the first barrier past INJ_STOP_S and
# resumes it with a fresh feeder.
INJ_HOSTS = 10_240
INJ_RATE = 10_240
INJ_SIM_S = 5
INJ_CHUNK = 16
INJ_STOP_S = 2.2
INJ_EXPECT = {"events_processed": 112_128, "windows": 100,
              "micro_steps": 199}
INJ_BLOCK = {"lanes": 1_024, "injected": 51_200, "dropped": 0, "late": 0,
             "deferred": 0, "trace_events": 51_200,
             "staged_cursor": 51_200, "backpressure": 99}
INJ_APP = {"sent": 51_200, "bytes_sent": 3_276_800, "rcvd": 50_688,
           "refused": 0}
# the staging planes are feeder-written scratch (consumed lanes keep
# their residue, the horizon follows the refill pacing); the heap slots
# permute with the refill pacing (the live event multiset is compared);
# the route counters and the ring follow the window partition, which
# the chunked loop's horizon clamp refines — tests/test_inject.py's
# carve-outs
INJ_SCRATCH = {".inject.time", ".inject.host", ".inject.kind",
               ".inject.seq", ".inject.words", ".inject.horizon"}
INJ_SLOTS = {f".events.{n}" for n in ("time", "kind", "src", "seq",
                                      "words")}
INJ_PARTITION = {".outbox.max_occupied", ".outbox.narrow_hit",
                 ".outbox.narrow_miss", ".outbox.route_elided"}
# K = 16's partition-dependent counts at this width: the port's own, on
# an NVIDIA H100 80GB HBM3 at 700 W (no reference run at full width
# exists). The reference's partition at K = 16 is held on the 64-host
# cut below, on the card here and on the CPU in
# tests/test_torch_inject_chunked.py.
INJ_CHUNK_EXPECT = {"windows": 100, "micro_steps": 151, "backpressure": 49}
# 15a's cut of the cell: hosts, rate, sim-s, staging lanes, and the
# reference's counts at K = 16 (its CPU run, seed 1, capacities 64). The
# trace period does not divide the window, as at full width, so K = 16
# partitions it otherwise than K = 1 (195 micro-steps in 98 windows).
INJ_CUT = (64, 321, 5, 32)
INJ_CUT_EXPECT = {"events_processed": 3257, "micro_steps": 152,
                  "windows": 101, "fastpath_hit": 0, "fastpath_miss": 0}
# the window whose barrier and drain 15a profiles
INJ_PROFILE_WINDOW = 40
# 15c: examples/tgen_traffic.shadow.config.xml (16 hosts, one <traffic>
# element: a stream, a pause and a markov phase) through the CLI. The
# reference CLI's report and manifest blocks (its CPU run, seed 1,
# --trace-out --metrics-out):
TRAFFIC_CONFIG = "examples/tgen_traffic.shadow.config.xml"
TRAFFIC_REPORT = {"events": 98, "windows": 32, "sim_seconds": 3.0,
                  "app_rcvd": 41, "overflow": 0}
TRAFFIC_INJECTION = {"lanes": 64, "injected": 41, "dropped": 0, "late": 0,
                     "trace_path": None, "trace_events": 41,
                     "staged_cursor": 41, "backpressure": 0, "deferred": 0}
TRAFFIC_TELEMETRY = {
    "windows_recorded": 32, "records_lost": 0,
    "events_per_window": {"p50": 2.0, "p90": 4.0,
                          "p99": 12.590000000000014, "mean": 3.0625},
    "micro_steps_per_window_max": 3, "qocc_max": 0, "fastpath_windows": 0,
    "active_lanes_max": 16, "window_span_ns_mean": 50000000.0,
    "injected_sum": 41, "inj_dropped_sum": 0, "inj_deferred_last": 0}

# Phase 16: lane isolation and the flight recorders. 16a is bench.py's
# ensemble row BENCH_REPLICAS=4 BENCH_LANE_ISOLATION=1
# BENCH_FLOW_SAMPLE=64 BENCH_CAUSALITY=64: phase 4's program packed four
# times (40,960 rows, one lane a replica) with the flow ring (4,096
# records, 1-in-64) and the lineage sub-rings (64 records a host) and
# advance plane (4,096 windows) attached. 16b's side runs (the recorders
# off apart, which runs to full depth: R = 1 against no lanes, a flooded
# victim lane, the supervised flood) are cut to LANE_SIDE_S or less.
LANE_R = 4
LANE_SAMPLE = 64
LANE_SIDE_S = 1.0
LANE_VICTIM = 1
# the profiled windows of 16a and 16p end here: window 0 and 3 more
LANE_PROFILE_NS = 150_000_000
LANE_NAME = (f"events_per_sec_per_chip@{HOSTS}hosts_phold_load{LOAD}"
             f"_x{LANE_R}replicas_lanes_flow{LANE_SAMPLE}"
             f"_caus{LANE_SAMPLE}")
# 16c: the program cut to 4 x 256 hosts and 2 sim-s (capacities 48)
# and 15a's 64-host cut with BENCH_CAUSALITY=8 (run_windows at K =
# 16), pinned
# from the reference's CPU runs (run from the repository root with jax
# and this package importable):
#
#   import jax; jax.config.update("jax_platforms", "cpu")
#   from shadow_tpu import telemetry; from shadow_tpu.core import lanes
#   from shadow_tpu.apps import phold, tgen
#   from shadow_tpu.inject import Feeder
#   from shadow_tpu.net.build import HostSpec, build, make_runner
#   from shadow_tpu.net.state import NetConfig
#   from shadow_tpu.utils.checkpoint import run_windows
#   from bench import ONE_VERTEX, _rate_trace
#   H = 1024
#   cfg = NetConfig(num_hosts=H, tcp=False, end_time=2 * 10**9, seed=1,
#                   event_capacity=48, outbox_capacity=48,
#                   router_ring=48, in_ring=16)
#   b = build(cfg, ONE_VERTEX, [HostSpec(name=f"peer{i}",
#             proc_start_time=0) for i in range(H)])
#   b.sim = phold.setup(b.sim, load=8, replica_size=256)
#   b.sim = telemetry.attach(lanes.attach(b.sim, 4))
#   b.sim = telemetry.attach_flows(b.sim, sample_period=64)
#   b.sim = telemetry.attach_causality(b.sim, sample_period=64)
#   sim, st = make_runner(b, app_handlers=(phold.handler,),
#                         app_bulk=phold.BULK)(b.sim)
#   h = telemetry.Harvester(); h.drain(sim)
#   print(st, lanes.lane_report(sim), sim.flows.sampled, sim.flows.count,
#         sim.flows.lost, sim.causality.seen.sum(),
#         sim.causality.count.sum(),
#         telemetry.binding_histogram(h.adv_records))
#   # and 15a's cut: H, rate, sim_s, lanes = 64, 321, 5, 32; capacities
#   # 64, in_ring 16, inject_lanes=32, tgen.setup, attach_causality(
#   # sample_period=8), run_windows(b, (tgen.handler,), feeder=Feeder(
#   # _rate_trace(H, rate, sim_s)), windows_per_dispatch=16)
LANE_CUT_HOSTS = 256
LANE_CUT_S = 2.0
LANE_CUT_EXPECT = {
    "stats": {"events_processed": 335_872, "micro_steps": 8,
              "windows": 41, "fastpath_hit": 0, "fastpath_miss": 41},
    "events_exec": [83_968] * 4, "quarantined": [],
    "flows": {"sampled": 5262, "count": 5262, "lost": 0},
    "lineage": {"seen": 15_360, "count": 239},
    "causes": {"min_jump_floor": 40, "end_time": 1}}
INJ_CAUS_SAMPLE = 8
INJ_CAUS_EXPECT = {
    "stats": {"events_processed": 3257, "micro_steps": 152, "windows": 101,
              "fastpath_hit": 0, "fastpath_miss": 0},
    "lineage": {"seen": 1605, "count": 213},
    "causes": {"min_jump_floor": 50, "inject_horizon": 50, "end_time": 1}}
# 16d: the CLI flags on the in-repo <traffic> config (16 hosts)
LANE_CLI_FLAGS = ["--lane-isolation", "4", "--resident", "--flow-sample",
                  "8", "--causality-sample", "8"]

# Phase 17: the capability-trimmed programs (compile/specialize.py).
# 17b's row name (bench.py's, BENCH_SPECIALIZE=1); 17c's tampered runs'
# depth; the windows profiled before and after the trim end at
# LANE_PROFILE_NS, as phase 16's do.
SPEC_NAME = f"events_per_sec_per_chip@{HOSTS}hosts_phold_load{LOAD}_spec"
SPEC_TAMPER_S = 0.3

# Phase 18: the netstack's observability settings (the pcap capture
# ring, per-path counters, the virtual CPU) and native/. 18a/18b: a
# reference-format config of PHOLD at 10,240 hosts, load 8, on bench.py's
# MIX_VERTICES graph (3 vertices, 1.1-3 ms edges: ~1.1 ms windows, a
# real 3 x 3 path matrix), every host logpcap="true", run with
# --track-paths --cpu-threshold 0 --cpu-precision 10: a 30-us charge an
# event (the default 200-us precision rounds it to 0), so any backlog
# blocks. 18b runs in-process to 0.01 sim-s (10 windows); 18a, the CLI
# as a subprocess, to 0.005 sim-s (its first 5 windows: 18b covers the
# rest). The reference's counts on the CPU (the same XML and flags, seed
# 1; its CLI for 18a, run_windows with a drain every window for 18b):
# the report, EngineStats, the blocked events and their delay, the path
# matrix and the pcap files (10,240, one per host; sha256 over their
# bytes in name order).
OBS_HOSTS = 10_240
OBS_LOAD = 8
OBS_STOP = "0.01"
OBS_CLI_STOP = "0.005"
OBS_FLAGS = ("--track-paths", "--cpu-threshold", "0", "--cpu-precision",
             "10")
OBS_OVERRIDES = {"track_paths": True, "cpu_threshold_ns": 0,
                 "cpu_precision_ns": 10_000}
OBS_CLI_REPORT = {"events": 258_374, "windows": 5, "sim_seconds": 0.005,
                  "app_rcvd": 176_454, "overflow": 0}
OBS_CLI_PATHS = [[17_543, 35_514, 17_979], [32_143, 64_096, 32_225],
                 [14_638, 29_568, 14_668]]
OBS_CLI_PCAP = {"files": 10_240, "bytes": 53_294_776,
                "sha256": "79a16b4544b2d1c5dab364caf512ab32ee0e50da08a6f349"
                "858fed3c43964d0d"}
# app.rcvd summed at 0.01 sim-s (the reference CLI's report there)
OBS_APP_RCVD = 385_716
OBS_EXPECT = {"events_processed": 467_636, "micro_steps": 314,
              "windows": 10, "fastpath_hit": 0, "fastpath_miss": 10}
OBS_CPU = {"blocked": 135_511, "delay_ns": 3_737_880_000}
OBS_PATHS = [[30_050, 60_887, 30_617], [58_254, 116_776, 59_404],
             [27_815, 55_702, 28_131]]
OBS_PCAP = {"records": 853_352, "dropped": 0, "files": 10_240,
            "bytes": 104_354_704, "sha256": "8e8241edf2163569a6fc2027a61a4b9e"
            "a33959cb76abeeac9b1a286926b361c3"}
# the reference CLI's stdout at -l info, at 0.005 and at 0.01 sim-s:
# 20,509 lines (the heartbeat's per-host lines), flushed in one batch:
# past the 4,096 records from which the log writer sorts with the native
# argsort
OBS_LOG_LINES = 20_509
# 18b profiles this window (a steady one: the first windows fill)
OBS_PROFILE_WINDOW = 6
# 18c: the same program at 64 hosts to 0.005 sim-s, built through
# net.build with HostSpec.cpufrequency_khz cycling over OBS_CUT_FREQS
# (the XML does not carry it): event costs 30, 60, 40 (37.5 rounded
# half-up) and 150 us;
# and 14b's TCP example twin (2 clients x 33 KiB, seed 3, 2.2 sim-s)
# with logpcap="true" on the server. The reference's counts (its CPU
# runs through run_windows, drained every window).
OBS_CUT_HOSTS = 64
OBS_CUT_STOP = 0.005
OBS_CUT_FREQS = (3_000_000, 1_500_000, 2_400_000, 600_000)
OBS_CUT_EXPECT = {
    "stats": {"events_processed": 1_437, "micro_steps": 166, "windows": 5,
              "fastpath_hit": 0, "fastpath_miss": 0},
    "blocked": 1_054, "delay_ns": 93_980_000, "records": 2_362,
    "files": 64, "bytes": 289_700,
    "sha256": "e2ece62d0fcfe405a27175224beca541579f4616e44f1e28aff2a663a2740359",
    "paths": [[53, 159, 91], [132, 336, 231], [78, 222, 135]],
    "cost": [30_000, 40_000, 60_000, 150_000]}
OBS_TCP_EXPECT = {
    "stats": {"events_processed": 13, "micro_steps": 11, "windows": 5,
              "fastpath_hit": 0, "fastpath_miss": 0},
    "blocked": 0, "delay_ns": 0, "records": 18, "files": 3, "bytes": 7_068,
    "sha256": "c5664400c9e3b73187b5631dce205bb5525837981f3d72784a16f36162cdb392",
    "paths": [[0]], "cost": [0]}

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
    from shadow_tpu_torch import convert

    (sa, sim_a), (sb, sim_b) = a, b
    da = {k: v for k, v in sa.as_dict().items() if k not in skip_stats}
    db = {k: v for k, v in sb.as_dict().items() if k not in skip_stats}
    return assert_same_leaves(label, (da, convert.sim_to_numpy(sim_a)),
                              (db, convert.sim_to_numpy(sim_b)))


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
    the port's entry points. Returns (launches, the bundle, the final
    sim, its EngineStats): phase 17 trims this program and holds it to
    this run."""
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
    return launches, b, sim, stats


def run_serial_path(device):
    """Phase 4a: the serial path (no bulk pass, no sparse fast path,
    no ring) at full width, depth cut to PATH_SIM_S."""
    b = build_phold(HOSTS, LOAD, PATH_SIM_S, seed=1, device=device,
                    cap=CAPACITY)
    sim, _, _, launches = drive("serial path", b,
                                main_runner(b, device, bulk=False), device)
    check_phold("serial path", sim, HOSTS, LOAD, launches)


def compare_order_forms(device):
    """Phase 4b: the bulk program with the cube and the sort EventOrder
    forms at full width for PATH_SIM_S (the same config, seed,
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
        b = build_phold(HOSTS, LOAD, PATH_SIM_S, seed=3, device=device,
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
    64 active, no bulk pass) for PATH_SIM_S, with the fast path
    armed (sparse_lanes=256) and off (0)."""
    out = {}
    for sparse in (256, 0):
        b = build_phold(HOSTS, LOAD, PATH_SIM_S, seed=4, device=device,
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
    (leaves, stats dict, launches, retx, fr, the bundle)."""
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
    return convert.sim_to_numpy(sim), st, launches, retx, fr, b


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


# The CPU halves of the CUDA-against-CPU comparisons run in spawned
# worker processes (the CPU workers never touch the card) while this
# process runs the CUDA half, so the card's run and the CPU's overlap in
# wall time. Phases 5 and 9, which read no launch counter, also send
# their CUDA halves to card workers, several at once. A job is a
# picklable `run(device) -> (sim, stats)` (a module-level function or a
# functools.partial of one) and an optional `extra(sim, stats)`; the
# worker sends back EngineStats, every leaf (numpy) and extra's value.
# Without the workers (main not started) a job runs here.
_TWINS = None
_CARDS = None
CPU_WORKERS = 2
CARD_WORKERS = 3


def _pool(n):
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"))


def start_twins():
    """Start the CPU workers and load the port into them while phases
    1-4 run."""
    global _TWINS
    _TWINS = _pool(CPU_WORKERS)
    for _ in range(CPU_WORKERS):
        _TWINS.submit(_twin_warm, "cpu")


def start_cards():
    """Start the card workers (after phase 2 has built the kernels)."""
    global _CARDS
    _CARDS = _pool(CARD_WORKERS)
    for _ in range(CARD_WORKERS):
        _CARDS.submit(_twin_warm, "cuda")


def stop_twins():
    global _TWINS, _CARDS
    for pool in (_TWINS, _CARDS):
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    _TWINS = _CARDS = None


def _twin_warm(dev):
    import torch

    import shadow_tpu_torch.config.loader  # noqa: F401
    import shadow_tpu_torch.net.build  # noqa: F401

    if dev != "cpu":
        from shadow_tpu_torch.core import insert_kernels

        insert_kernels.build_library()
        torch.zeros(1, device=dev).add_(1).item()


def _twin_job(run, extra, dev="cpu"):
    import torch

    from shadow_tpu_torch import convert

    t0 = time.perf_counter()
    sim, stats = run(torch.device(dev))
    got = None if extra is None else extra(sim, stats)
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return stats.as_dict(), convert.sim_to_numpy(sim), got, wall


def on_cpu(run, extra=None):
    """A future of (EngineStats dict, leaves, extra(sim, stats), wall s)
    of `run` on the CPU, in a CPU worker."""
    return in_worker(_twin_job, run, extra)


def on_card(run):
    """on_cpu's future for `run` on the card, in a card worker."""
    return _submit(_CARDS, _twin_job, run, None, "cuda")


def in_worker(fn, *args):
    """A future of fn(*args) in a CPU worker (here without one)."""
    return _submit(_TWINS, fn, *args)


def _submit(pool, fn, *args):
    import concurrent.futures

    if pool is not None:
        return pool.submit(fn, *args)
    fut = concurrent.futures.Future()
    fut.set_result(fn(*args))
    return fut


def twin_start(label, make):
    """Phases 5 and 9: `make(device) -> (bundle, runner)` (picklable)
    started in a card worker and a CPU worker; twin_finish reads both."""
    import functools

    run = functools.partial(_made_run, make)
    return label, on_card(run), on_cpu(run)


def twin_finish(started):
    """The card's and the CPU's run of twin_start's job: equal
    EngineStats and every leaf equal (tolerance zero). Returns the
    card's (EngineStats dict, leaves)."""
    label, card, cpu = started
    st, leaves, _, wall = card.result(timeout=900)
    log(f"  {label} cuda: {st} in {wall:.2f} s")
    cst, cleaves, _ = cpu_result(label, cpu)
    n = assert_same_leaves(label, (st, leaves), (cst, cleaves))
    log(f"  {label}: cuda == cpu, EngineStats and all {n} leaves equal")
    return st, leaves


def cpu_result(label, fut):
    """The worker's result, logged as the CPU half."""
    st, leaves, extra, wall = fut.result(timeout=900)
    log(f"  {label} cpu: {st} in {wall:.2f} s")
    return st, leaves, extra


def assert_same_leaves(label, a, b):
    """Two (EngineStats dict, leaves) equal, tolerance zero. Returns the
    number of leaves."""
    import numpy as np

    (da, la), (db, lb) = a, b
    if da != db:
        raise AssertionError(f"{label}: EngineStats differ: {da} vs {db}")
    if la.keys() != lb.keys():
        raise AssertionError(f"{label}: leaf sets differ")
    bad = [k for k in la if la[k].dtype != lb[k].dtype
           or not np.array_equal(la[k], lb[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, first "
                             f"{bad[:5]}")
    return len(la)


def _made_run(make, dev):
    b, runner = make(dev)
    return runner(b.sim)


def compare_bundles_cuda_cpu(label, make):
    """Phases 13b, 14 and 15: `make(device) -> (bundle, runner)`
    (picklable: the CPU half runs in a CPU worker) run on CUDA here,
    where the phase reads the launch counters, and on the CPU: equal
    EngineStats and every leaf equal (tolerance zero). Returns the
    card's (stats, sim)."""
    import functools

    from shadow_tpu_torch import convert

    fut = on_cpu(functools.partial(_made_run, make))
    b, runner = make("cuda")
    t0 = time.perf_counter()
    sim, stats = runner(b.sim)
    log(f"  {label} cuda: {stats.as_dict()} in "
        f"{time.perf_counter() - t0:.2f} s")
    st, leaves, _ = cpu_result(label, fut)
    n = assert_same_leaves(label, (stats.as_dict(),
                                   convert.sim_to_numpy(sim)), (st, leaves))
    log(f"  {label}: cuda == cpu, EngineStats and all {n} leaves equal")
    return stats, sim


def _relay_twin(hosts, hop, total, sim_s, loss, ring, tcp_bulk, lossless,
                dev):
    b, _ = build_relay(hosts, hop, total, sim_s, seed=6, device=dev,
                       loss=loss, ring=ring)
    return b, relay_runner(b, dev, tcp_bulk=tcp_bulk, lossless=lossless)


def relay_twin(label, hosts, hop, total, sim_s, loss=0.0, ring=True,
               tcp_bulk=False, lossless=False):
    """Phase 5, TCP: the relay started on the card and on the CPU
    (twin_start); check_relay_twin reads it."""
    import functools

    return twin_start(label, functools.partial(
        _relay_twin, hosts, hop, total, sim_s, loss, ring, tcp_bulk,
        lossless)), total


def check_relay_twin(started):
    """The relay on CUDA equals the relay on the CPU, leaf by leaf
    (tolerance zero), and every transfer completes by its end time."""
    from shadow_tpu_torch.apps.relay import ROLE_SERVER

    (label, *_), total = started
    _, leaves = twin_finish(started[0])
    servers = leaves[".app.role"] == ROLE_SERVER
    done = int((leaves[".app.rcvd"][servers] == total).sum())
    if done != int(servers.sum()):
        raise AssertionError(f"{label}: {done} of {int(servers.sum())} "
                             f"transfers complete")
    log(f"  {label}: every transfer complete; retx_segs "
        f"{int(leaves['.tcp.retx_segs'].sum())}")


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


def phold_twin(label, hosts, load, sim_s, bulk=False, ring=False,
               sparse_lanes=0, active_hosts=None):
    """Phase 5: PHOLD started on the card and on the CPU (twin_start;
    twin_finish holds them leaf by leaf, tolerance zero)."""
    import functools

    return twin_start(label, functools.partial(
        _phold_twin, hosts, load, sim_s, bulk, ring, sparse_lanes,
        active_hosts))


def _phold_twin(hosts, load, sim_s, bulk, ring, sparse_lanes, active_hosts,
                dev):
    b = build_phold(hosts, load, sim_s, seed=5, device=dev,
                    sparse_lanes=sparse_lanes, active_hosts=active_hosts,
                    ring=ring)
    return b, main_runner(b, dev, bulk=bulk)


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
    call to the second: one whole micro-step, after which it raises
    Done to leave the window (the rest is not read)."""

    class Done(Exception):
        pass

    def __init__(self, step, prof=None):
        self.step, self.prof, self.marks = step, prof, []

    def __call__(self, sim, popped, buf, kinds=None):
        self.marks.append(time.perf_counter())
        if self.prof is not None and len(self.marks) == 1:
            self.prof.start()
        elif self.prof is not None and len(self.marks) == 2:
            self.prof.stop()
            raise StepShim.Done
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
        try:
            _, stats, _ = step_window(
                sim, EngineStats.create(device=sim.events.time.device),
                shim, wend, cfg.emit_capacity, sim.net.lane_id,
                bulk_fn=bulk, sparse_lanes=resolve_sparse_lanes(cfg))
        except StepShim.Done:
            stats = None
        torch.cuda.synchronize()
        iters = (bulk.counters["iterations"] - it0 if bulk is not None
                 else 0)
        return (t0, time.perf_counter(),
                None if stats is None else stats.as_dict(), iters)

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


def _mux_twin(bulk, sim_s, dev):
    b, _ = build_mux_small(dev, sim_s)
    return b, mux_runner(b, dev, tcp_bulk=bulk)


def _gossip_twin(tcp, dev):
    if tcp:
        b = build_gossip(8, SMALL_GTCP_SIM_S, seed=3, device=dev, tcp=True,
                         k=3, blocks=3, sockets=10, ring=False)
    else:
        b = build_gossip(64, 5.0, seed=1, device=dev)
    return b, gossip_runner(b, dev, tcp=tcp)


def compare_new_apps_cuda_cpu():
    """Phase 9: the reference tests' small shapes of the Tor model (with
    the TCP bulk pass to the test's 10 sim-s, every stream complete;
    serial cut to MUX_SERIAL_SIM_S and held under the reference's
    contract to a TCP bulk run on the card to the same depth) and of UDP
    and TCP gossip, started together on the workers (twin_start)."""
    import functools

    from shadow_tpu_torch.apps import relay

    label = f"mux 10 hosts TCP bulk to {MUX_SIM_S} sim-s"
    serial_label = f"mux 10 hosts serial to {MUX_SERIAL_SIM_S} sim-s"
    gtcp = twin_start("gossip tcp 8 hosts",
                      functools.partial(_gossip_twin, True))
    mux = twin_start(label, functools.partial(_mux_twin, True, MUX_SIM_S))
    serial = twin_start(serial_label, functools.partial(
        _mux_twin, False, MUX_SERIAL_SIM_S))
    bulk = on_card(functools.partial(_made_run, functools.partial(
        _mux_twin, True, MUX_SERIAL_SIM_S)))
    udp = twin_start("gossip 64 hosts", functools.partial(_gossip_twin, False))

    _, leaves = twin_finish(mux)
    live = leaves[".app.s_role"] == relay.ROLE_SERVER
    streams = leaves[".app.rcvd"][live].tolist()
    done_at = leaves[".app.done_at"][live].tolist()
    if streams != [MUX_BYTES] * 4 or min(done_at) < 0:
        raise AssertionError(f"{label}: server streams {streams}, EOF "
                             f"at {done_at}")
    log(f"  {label}: the server's 4 streams complete, EOF at {done_at} ns")

    stats, leaves = twin_finish(serial)
    st, bleaves, _, wall = bulk.result(timeout=900)
    live = bleaves[".app.s_role"] == relay.ROLE_SERVER
    log(f"  mux 10 hosts TCP bulk to {MUX_SERIAL_SIM_S} sim-s cuda: {st} in "
        f"{wall:.2f} s; the server's streams at "
        f"{bleaves['.app.rcvd'][live].tolist()} bytes")
    assert_contract("mux bulk vs serial", (bleaves, st), (leaves, stats))

    _, leaves = twin_finish(udp)
    if not bool((leaves[".app.tip"] == GOSSIP_BLOCKS - 1).all()):
        raise AssertionError("gossip 64 hosts: a tip short of the last block")

    _, leaves = twin_finish(gtcp)
    if not bool((leaves[".app.tip"] >= 0).all()):
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


def _relay_crash_twin(dev):
    """13b: a 3-host relay whose middle host crashes at 1.2 s and
    restarts at 2 s."""
    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.net.build import HostSpec, build, make_runner
    from shadow_tpu_torch.net.state import NetConfig

    hosts = [HostSpec(name=f"n{i}", proc_start_time=10**9)
             for i in range(3)]
    rb = build(NetConfig(num_hosts=3, end_time=6 * 10**9,
                         sockets_per_host=4), RELAY_CRASH_GRAPH, hosts,
               device=dev)
    rb.sim = relay.setup(rb.sim, circuits=[[0, 1, 2]], total_bytes=20_000)
    faults.install(rb, [
        faults.FaultRecord(t_ns=1_200_000_000,
                           kind=faults.FaultKind.CRASH, a=1),
        faults.FaultRecord(t_ns=2_000_000_000,
                           kind=faults.FaultKind.RESTART, a=1)])
    return rb, make_runner(rb, app_handlers=(relay.handler,), device=dev)


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
    from shadow_tpu_torch.apps import phold, pingpong
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.faults import conserve
    from shadow_tpu_torch.net.build import make_chunked_runner, make_runner
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

    st, sim = compare_bundles_cuda_cpu("relay crash + restart",
                                       _relay_crash_twin)
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


def small_config(body, stoptime):
    """A reference-format config: `body` over the example's one-vertex
    50 ms graph."""
    from shadow_tpu_torch.config.examples import EXAMPLE_GRAPHML

    return (f'<shadow stoptime="{stoptime}">\n  <topology><![CDATA['
            f'{EXAMPLE_GRAPHML}]]></topology>\n{body}\n</shadow>')


def start_proc(label, cmd):
    """Start `cmd` from the repository root, its output captured; the
    smoke goes on while it runs (finish_proc waits for it, stop_proc
    kills it). Each CLI run that only its counts, logs and files check
    starts so, while the card runs work that is not timed."""
    import subprocess
    from pathlib import Path

    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return label, cmd, proc, time.perf_counter()


def stop_proc(started):
    """Kill a started process that is still running."""
    proc = started[2]
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def finish_proc(started):
    """(exit code, stdout, stderr, wall s from its start) of a started
    process."""
    proc, t0 = started[2], started[3]
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        stop_proc(started)
    return proc.returncode, stdout, stderr, time.perf_counter() - t0


def start_cli(label, text, tmp, *flags):
    """Start `python -m shadow_tpu_torch.cli <config> --platform gpu -d
    <dir> [flags]` as a subprocess from the repository root, the config
    written to a file first: the entry point a user calls. finish_cli
    waits for it; several may run at once."""
    import os

    path = os.path.join(tmp, f"{label}.shadow.config.xml")
    with open(path, "w") as f:
        f.write(text)
    return start_proc(label, [
        sys.executable, "-m", "shadow_tpu_torch.cli", path, "--platform",
        "gpu", "-d", os.path.join(tmp, f"{label}.data"), *flags])


def finish_cli(started):
    """(report, wall s from its start, stdout lines) of a started CLI;
    exit code 0 required."""
    label, cmd = started[:2]
    code, stdout, stderr, wall = finish_proc(started)
    lines = stdout.strip().splitlines()
    if code != 0 or not lines:
        raise AssertionError(f"{label}: the CLI exited {code}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    report = json.loads(lines[-1])
    log(f"  {label}: `python -m shadow_tpu_torch.cli {' '.join(cmd[4:])}` "
        f"exit 0 in {wall:.1f} s, {len(lines)} lines; report "
        f"{json.dumps(report)}")
    for ln in lines:
        if "ObjectCounter" in ln:
            log(f"  {label}: {ln}")
    return report, wall, lines


def check_report(label, report, expect):
    """The report's keys as the reference's CLI prints them, and
    `expect`'s counts."""
    keys = {"events", "windows", "sim_seconds", "wall_seconds",
            "events_per_second", "simulated_seconds_per_wall_second",
            "overflow"}
    if not keys <= set(report):
        raise AssertionError(f"{label}: report lacks "
                             f"{sorted(keys - set(report))}")
    got = {k: report.get(k) for k in expect}
    if got != expect:
        raise AssertionError(f"{label}: report {got} != the reference's "
                             f"{expect}")
    log(f"  {label}: report equals the reference's counts {expect}")


def load_config(text, seed, device, overrides=None):
    """(bundle, runner) of a config text through the port's loader and
    make_runner, as the CLI's run branch builds them."""
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config
    from shadow_tpu_torch.net.build import make_runner

    loaded = load(parse_config(text), seed=seed, overrides=overrides,
                  device=device)
    b = loaded.bundle
    return b, make_runner(b, app_handlers=loaded.handlers,
                          app_bulk=b.app_bulk, device=device)


class BurstShim:
    """The step_fn of a replayed burst window: the host clock at every
    micro-step's handler call; torch.profiler over the second micro-step
    (call 2 to call 3); after `steps` micro-steps it raises Enough to
    leave the window (a burst window runs ~1,000 micro-steps)."""

    class Enough(Exception):
        pass

    def __init__(self, step, steps, prof=None):
        self.step, self.steps, self.prof, self.marks = step, steps, prof, []

    def __call__(self, sim, popped, buf, kinds=None):
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        n = len(self.marks)
        if self.prof is not None and n == 2:
            self.prof.start()
        elif self.prof is not None and n == 3:
            self.prof.stop()
        if n > self.steps:
            raise BurstShim.Enough
        return self.step(sim, popped, buf, kinds=kinds)


def replay_burst(label, b, handlers, sim0, wend, steps):
    """The first `steps` micro-steps of the window from `sim0` to `wend`
    through core.engine.step_window (the sparse fast path at the
    config's budget), each timed from one handler call to the next,
    then again with the second one under torch.profiler: launches,
    cudaStreamSynchronize calls and device busy. Returns the profiled
    micro-step's {ms, launches, syncs, busy_ms}."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.core.engine import (
        EngineStats, resolve_sparse_lanes, step_window)
    from shadow_tpu_torch.net.step import make_step_fn

    step = make_step_fn(b.cfg, handlers)

    def window(shim):
        sim = copy.deepcopy(sim0)
        try:
            step_window(sim, EngineStats.create(device=sim.events.time.device),
                        shim, wend, b.cfg.emit_capacity, sim.net.lane_id,
                        sparse_lanes=resolve_sparse_lanes(b.cfg))
        except BurstShim.Enough:
            pass
        else:
            raise AssertionError(f"{label}: the window ended within "
                                 f"{steps} micro-steps")

    timed = BurstShim(step, steps)
    window(timed)
    walls = [(y - x) * 1e3 for x, y in zip(timed.marks, timed.marks[1:])]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window(BurstShim(step, steps, prof))
    events = raw_events(prof)
    launches = host_launches(events)
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    busy_ms = device_busy_us(events) / 1e3
    log(f"  {label}: {steps} micro-steps of the window to "
        f"{wend / 1e9:.3f} sim-s replayed through core.engine.step_window: "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms; the second "
        f"profiled: {launches} launches, {syncs} cudaStreamSynchronize, "
        f"device busy {busy_ms:.2f} ms = {busy_ms / walls[1] * 100:.2f}% "
        f"of its {walls[1]:.1f} ms")
    return {"ms": walls[1], "ms_all": walls, "launches": launches,
            "syncs": syncs, "busy_ms": busy_ms}


def cli_cell(device):
    """Phase 14: the CLI and the reference-format configs on the card,
    one run after another. Returns the kernel row's additions (launches
    on the phase's in-process runs, the burst micro-step's profile) and
    the max abs error of mailbox_gather against its plain version on
    their route inputs."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="shadow_cli_") as tmp:
        return _cli_cell(device, tmp)


def check_spec_manifest(label, data_dir, dropped):
    """The CLI's default trimmed program (--specialize auto): the run
    manifest's specialization block drops `dropped` with the guard at 0,
    and tools/telemetry_lint.py accepts the manifest."""
    import os
    import subprocess
    from pathlib import Path

    path = os.path.join(data_dir, "run_manifest.json")
    with open(path) as fh:
        spec = json.load(fh).get("specialization")
    if (spec is None or spec["mode"] != "auto"
            or spec["dropped"] != dropped
            or spec["guard"]["loss_trips"] + spec["guard"]["timer_trips"]):
        raise AssertionError(f"{label}: manifest specialization {spec}")
    lint = subprocess.run(
        [sys.executable, "tools/telemetry_lint.py", "--manifest", path],
        cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=120)
    if lint.returncode != 0:
        raise AssertionError(f"{label}: telemetry_lint refused the "
                             f"manifest:\n{lint.stdout[-2000:]}"
                             f"{lint.stderr[-2000:]}")
    log(f"  {label}: manifest specialization {json.dumps(spec)}; "
        f"telemetry_lint --manifest: ok")


def _cli_cell(device, tmp):
    import functools
    import os

    import torch

    from shadow_tpu_torch.apps import bulk
    from shadow_tpu_torch.config.examples import example_config
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather

    out = {}
    # the three CLI runs (14a's and 14b's) start together and run side
    # by side; their checks are counts, logs and manifests
    text = example_config(clients=CLI_1K_CLIENTS, stoptime=CLI_1K_STOP)
    ex_label = f"cli-example-{CLI_EX_CLIENTS}"
    ex = example_config(clients=CLI_EX_CLIENTS, kib=CLI_EX_KIB, stoptime=40)
    clis = [start_cli("cli-1k-bulk", text, tmp),
            start_cli(ex_label, ex, tmp, "-s", str(CLI_EX_SEED)),
            start_cli("cli-phold-ref", REFERENCE_PHOLD_XML, tmp,
                      "--telemetry-capacity", "64")]
    try:
        reports = [finish_cli(c)[0] for c in clis]
    finally:
        for c in clis:
            stop_proc(c)
    # ---- 14a: the built-in --test example at full width ----------
    log(f"[14a] the --test example at {CLI_1K_CLIENTS} clients cut to "
        f"{CLI_1K_STOP} sim-s")
    check_report("cli-1k-bulk", reports[0], CLI_1K_EXPECT)
    t0 = time.perf_counter()
    b, runner = load_config(text, seed=1, device=device)
    torch.cuda.synchronize()
    log(f"  cli-1k-bulk in-process: loaded {b.cfg.num_hosts} hosts "
        f"(capacities {b.cfg.event_capacity}, {b.cfg.sockets_per_host} "
        f"sockets) in {time.perf_counter() - t0:.2f} s")
    sim, stats, wall, launches = drive("cli-1k-bulk in-process", b,
                                       runner, device)
    st = stats.as_dict()
    got = {"events": st["events_processed"], "windows": st["windows"],
           "micro_steps": st["micro_steps"],
           "app_rcvd": int(sim.app.rcvd.sum()),
           "overflow": int(sim.events.overflow)
           + int(sim.outbox.overflow) + int(sim.net.rq_overflow)}
    want = dict(CLI_1K_EXPECT, micro_steps=CLI_1K_MICRO_STEPS)
    if got != want:
        raise AssertionError(f"cli-1k-bulk in-process: {got} != {want}")
    if launches["mailbox_gather"] != 0:
        raise AssertionError("cli-1k-bulk: the SYN burst's route took "
                             "the sweep; expected the sorted scatter")
    queued = int((sim.events.time < INVALID_TIME).sum(dim=1).amax())
    log(f"  cli-1k-bulk in-process: counts as the reference's {got}; "
        f"{wall / st['micro_steps'] * 1e3:.1f} ms per micro-step; "
        f"mailbox_gather launched {launches['mailbox_gather']} times "
        f"(the burst route sends {queued} SYNs to one row, past the "
        f"sweep's 32: the sorted scatter)")
    if queued < CLI_1K_CLIENTS:
        raise AssertionError(f"cli-1k-bulk: the server holds {queued} "
                             f"events, expected {CLI_1K_CLIENTS} SYNs")
    out["launches_cli_1k"] = launches["mailbox_gather"]
    out["cli_1k_burst"] = replay_burst(
        "cli-1k-bulk burst", b, (bulk.handler,), sim,
        int(sim.events.min_time().amin()) + b.min_jump, CLI_1K_BURST_STEPS)
    del sim, b, runner

    # ---- 14b: reference-format configs through the CLI -----------
    log(f"[14b] the example at {CLI_EX_CLIENTS} clients x "
        f"{CLI_EX_KIB} KiB to full depth and the reference PHOLD "
        f"config through the CLI, the example's CUDA/CPU twin")
    check_report(ex_label, reports[1], CLI_EX_EXPECT)
    check_report("cli-phold-ref", reports[2], PHOLD_REF_REPORT)
    check_spec_manifest("cli-phold-ref",
                        os.path.join(tmp, "cli-phold-ref.data"),
                        ["loss", "timers"])
    twin = example_config(clients=CLI_EX_CLIENTS, kib=CLI_EX_KIB,
                          stoptime=CLI_TWIN_STOP)
    mailbox_gather.launches = 0
    with KeepGatherInputs() as gathered:
        compare_bundles_cuda_cpu(
            f"{ex_label} cut to {CLI_TWIN_STOP} sim-s",
            functools.partial(load_config, twin, CLI_EX_SEED))
    twin_launches = mailbox_gather.launches
    if twin_launches <= 0:
        raise AssertionError(f"{ex_label} twin: mailbox_gather was "
                             "never launched")
    err = gathered.check(f"{ex_label} twin")
    log(f"  {ex_label} twin: mailbox_gather launched {twin_launches} "
        f"times on the card")

    # ---- 14c: queue disciplines and the small apps ---------------
    log("[14c] queue disciplines and the small apps, CUDA against CPU")
    mailbox_gather.launches = 0
    ping = small_config(PING_BODY, SMALL_STOP["ping"])
    for label, ov in (("ping --interface-qdisc rr",
                       {"interface_qdisc": "rr"}),
                      ("ping --router-qdisc single",
                       {"router_qdisc": "single"}),
                      ("ping --router-qdisc static",
                       {"router_qdisc": "static"})):
        _, sim = compare_bundles_cuda_cpu(
            label, functools.partial(load_config, ping, 1,
                                     overrides=dict(ov)))
        if int(sim.app.rcvd[sim.app.role == 1].sum()) <= 0:
            raise AssertionError(f"{label}: no client got a reply")
    _, sim = compare_bundles_cuda_cpu(
        "testtcp echo", functools.partial(
            load_config, small_config(ECHO_BODY, SMALL_STOP["echo"]), 7))
    if int(sim.app.s_rcvd.sum()) <= 0:
        raise AssertionError("testtcp echo: the server drained nothing")
    _, sim = compare_bundles_cuda_cpu(
        "testdeterminism", functools.partial(
            load_config, small_config(RANDDUMP_BODY, SMALL_STOP["randdump"]),
            11))
    if not bool((sim.app.start_at >= 0).all()):
        raise AssertionError("testdeterminism: a host drew nothing")
    small_launches = mailbox_gather.launches
    ring_cuda_cpu()
    out["launches_cli"] = twin_launches + small_launches
    log(f"  14c: mailbox_gather launched {small_launches} times on the "
        f"card")
    return out, err


def ring_cuda_cpu():
    """apps/ring.py, the smallest program, on CUDA and on the CPU: equal
    EngineStats and every leaf equal."""
    from shadow_tpu_torch.apps import ring
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.core.engine import run

    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sim, stats = run(ring.make(16, device=dev), ring.step,
                         end_time=simtime.ONE_SECOND, min_jump=ring.LATENCY)
        res[dev] = (stats, sim)
        log(f"  ring 16 hosts {dev}: {stats.as_dict()} in "
            f"{time.perf_counter() - t0:.2f} s")
    n = assert_same_run("ring", res["cuda"], res["cpu"])
    if int(res["cpu"][1].hops.sum()) != int(
            res["cpu"][0].events_processed):
        raise AssertionError("ring: hops != events")
    log(f"  ring: cuda == cpu, EngineStats and all {n} leaves equal")


def timed_feeder(events):
    """An inject.Feeder whose refills are timed on the host clock, per
    refill: `t_refill` the whole refill, `t_stage` the mirror's
    bookkeeping (reading, validating and staging trace records),
    `t_planes` the plane build (the mirror's planes in pinned memory)
    and `t_install` the install (the plane build plus the
    host-to-device copies). run_windows' per-window loop refills once on
    entry, then before every window: refill w + 1 is window w's
    barrier."""
    from shadow_tpu_torch.inject import Feeder

    def timed(name, fn):
        def call(self, *a):
            t0 = time.perf_counter()
            out = fn(self, *a)
            getattr(self, name).append(time.perf_counter() - t0)
            return out
        return call

    class TimedFeeder(Feeder):
        refill = timed("t_refill", Feeder.refill)
        _stage_ready = timed("t_stage", Feeder._stage_ready)
        _planes = timed("t_planes", Feeder._planes)
        _install = timed("t_install", Feeder._install)

    f = TimedFeeder(events)
    f.t_refill, f.t_stage, f.t_planes, f.t_install = [], [], [], []
    return f


class WindowProbe:
    """run_windows' on_window hook: the host clock at every window's
    end, and torch.profiler running over window `k` + 1 whole — the
    barrier's refill, the merge, the drain and the route."""

    def __init__(self, k):
        from torch.profiler import ProfilerActivity, profile

        self.k, self.marks = k, []
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __call__(self, sim, wend):
        import torch

        n = len(self.marks)
        if n == self.k + 1:
            torch.cuda.synchronize()
            self.prof.stop()
        self.marks.append(time.perf_counter())
        if n == self.k:
            torch.cuda.synchronize()
            self.marks[-1] = time.perf_counter()
            self.prof.start()


def build_inject(device, ring=True):
    """15a's bundle: bench.py's injection program (shadow_tpu_torch.bench
    build_inject, seed 1, capacities 64) with bench's ring."""
    from shadow_tpu_torch import bench, telemetry
    from shadow_tpu_torch.apps import tgen

    b = bench.build_inject(INJ_HOSTS, INJ_SIM_S, 1, 64,
                           tgen.lanes_for(INJ_HOSTS * INJ_SIM_S),
                           ONE_VERTEX, device)
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b


def check_inject(label, sim, stats, feeder, chunked=False):
    """15a's counts: the reference's EngineStats, injection block and tgen
    sums, zero overflow; when `chunked`, the partition-dependent ones
    (windows, micro-steps, backpressure) are INJ_CHUNK_EXPECT's."""
    from shadow_tpu_torch.inject import manifest_block

    st = stats.as_dict()
    blk = manifest_block(sim, feeder)
    app = {k: int(getattr(sim.app, k).sum()) for k in INJ_APP}

    def want(k, v):
        return INJ_CHUNK_EXPECT.get(k, v) if chunked else v
    checks = {f"block.{k}": (blk[k], want(k, v))
              for k, v in INJ_BLOCK.items()}
    checks.update({f"app.{k}": (app[k], v) for k, v in INJ_APP.items()})
    checks.update({k: (st[k], want(k, v)) for k, v in INJ_EXPECT.items()})
    checks.update({
        "events.overflow": (int(sim.events.overflow), 0),
        "outbox.overflow": (int(sim.outbox.overflow), 0),
        "rq_overflow": (int(sim.net.rq_overflow), 0),
        "ring count == windows": (int(sim.telem.count), st["windows"]),
        "sum(ring.injected) == injected": (int(sim.telem.injected.sum()),
                                           blk["injected"]),
    })
    for k, (got, v) in checks.items():
        if got != v:
            raise AssertionError(f"{label}: {k}: {got} != {v}")
    whose = ("the reference's counts, K = 16's partition as pinned"
             if chunked else "the reference's counts")
    log(f"  {label}: EngineStats {st}; injection {json.dumps(blk)}; tgen "
        f"{app}: {whose}")


def inject_leaves_equal(label, a, b, exclude=()):
    """Every leaf of two injection runs equal apart from `exclude`, and
    their live event multisets equal. Returns the leaves compared."""
    import numpy as np

    from shadow_tpu_torch import convert

    la, lb = convert.sim_to_numpy(a), convert.sim_to_numpy(b)
    if la.keys() != lb.keys():
        raise AssertionError(f"{label}: leaf sets differ")
    bad = [k for k in la if k not in exclude and (
        la[k].dtype != lb[k].dtype or not np.array_equal(la[k], lb[k]))]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, first "
                             f"{bad[:5]}")

    def live(lv):
        t = lv[".events.time"]
        m = t < INVALID_TIME
        cols = [lv[f".events.{n}"][m] for n in ("time", "kind", "src",
                                                "seq")]
        rows = np.nonzero(m)[0]
        words = lv[".events.words"][m].sum(axis=1)
        return sorted(zip(rows.tolist(), *(c.tolist() for c in cols),
                          words.tolist()))
    if live(la) != live(lb):
        raise AssertionError(f"{label}: live event multisets differ")
    return len(la) - len(exclude & la.keys())


def log_run(label, stats, wall):
    st = stats.as_dict()
    log(f"  {label}: wall {wall:.3f} s, {st['events_processed'] / wall:.1f} "
        f"events/s, {wall / st['windows'] * 1e3:.2f} ms per window, "
        f"{wall / st['micro_steps'] * 1e3:.2f} ms per micro-step")


def chunk_cut(device):
    """15a's cut of the cell (INJ_CUT) through run_windows at K =
    INJ_CHUNK on the card and on the CPU: the reference's counts and
    every leaf equal between the two."""
    import numpy as np
    import torch

    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.inject import Feeder, manifest_block
    from shadow_tpu_torch.utils import checkpoint

    H, rate, sim_s, lanes = INJ_CUT
    trace = bench.rate_trace(H, rate, sim_s)
    got = []
    for dev in (device, torch.device("cpu")):
        b = bench.build_inject(H, sim_s, 1, 64, lanes, ONE_VERTEX, dev)
        f = Feeder(list(trace))
        t0 = time.perf_counter()
        sim, stats, _ = checkpoint.run_windows(
            b, (tgen.handler,), feeder=f, windows_per_dispatch=INJ_CHUNK,
            device=dev)
        blk = manifest_block(sim, f)
        st = stats.as_dict()
        if st != INJ_CUT_EXPECT or (blk["injected"], blk["dropped"],
                                    blk["late"], blk["deferred"]) != (
                len(trace), 0, 0, 0):
            raise AssertionError(f"inject cut {dev.type}: {st} {blk} != "
                                 f"the reference's {INJ_CUT_EXPECT}")
        got.append(convert.sim_to_numpy(sim))
        log(f"  inject cut to {H} hosts, K = {INJ_CHUNK}, {dev.type}: the "
            f"reference's counts {st} in {time.perf_counter() - t0:.2f} s")
    a, c = got
    bad = [k for k in a if a[k].dtype != c[k].dtype
           or not np.array_equal(a[k], c[k])]
    if a.keys() != c.keys() or bad:
        raise AssertionError(f"inject cut: cuda != cpu, first {bad[:5]}")
    log(f"  inject cut: cuda == cpu, all {len(a)} leaves equal")


def inject_cell(device):
    """Phase 15: open-system injection. Returns the kernel row's
    additions and the max abs error of mailbox_gather against its plain
    version on the runs' inputs."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="shadow_inj_") as tmp:
        return _inject_cell(device, tmp)


def _inject_cell(device, tmp):
    import os
    import subprocess
    from pathlib import Path

    import torch
    from torch.autograd import DeviceType

    from shadow_tpu_torch import bench, convert, faults, telemetry
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.utils import checkpoint

    out = {}
    root = Path(__file__).resolve().parent
    # ---- 15a: the bench row as a user runs it --------------------------
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_INJECT_RATE"] = str(INJ_RATE)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.bench"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"inject bench exited {done.returncode}:\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    row = json.loads(done.stdout.strip().splitlines()[-1])
    log(f"  inject-10k-rate: `BENCH_INJECT_RATE={INJ_RATE} python -m "
        f"shadow_tpu_torch.bench` exit 0 in {wall:.1f} s: {json.dumps(row)}")
    name = (f"events_per_sec_per_chip@{INJ_HOSTS}hosts_inject_rate"
            f"{INJ_RATE}_chunk1")
    got = {"metric": row["metric"], "events": row["events"],
           "windows": row["windows"], "micro_steps": row["micro_steps"]}
    want = {"metric": name, "events": INJ_EXPECT["events_processed"],
            "windows": INJ_EXPECT["windows"],
            "micro_steps": INJ_EXPECT["micro_steps"]}
    if got != want:
        raise AssertionError(f"inject bench row: {got} != {want}")
    out["inject_bench_row"] = {k: row[k] for k in (
        "value", "wall_s", "warmup_s")}

    # ---- 15a in-process: the same program through the supervised loop
    trace = bench.rate_trace(INJ_HOSTS, INJ_RATE, INJ_SIM_S)
    if len(trace) != INJ_BLOCK["trace_events"]:
        raise AssertionError(f"inject: the trace holds {len(trace)} "
                             f"events")
    t0 = time.perf_counter()
    b = build_inject(device)
    sim0 = b.sim
    torch.cuda.synchronize()
    log(f"  inject: built {INJ_HOSTS} hosts ({b.cfg.inject_lanes} staging "
        f"lanes) in {time.perf_counter() - t0:.2f} s")

    def supervised(feeder, **kw):
        b.sim = sim0
        h = telemetry.Harvester()
        res = faults.run_supervised(
            b, (tgen.handler,), checkpoint_path=os.path.join(tmp, "ck"),
            checkpoint_every_windows=1 << 30, harvester=h, feeder=feeder,
            device=device, **kw)
        return res, h

    torch.cuda.synchronize()
    mailbox_gather.launches = 0
    f_sup = timed_feeder(list(trace))
    t0 = time.perf_counter()
    with KeepGatherInputs() as gathered:
        sup, harvester = supervised(f_sup)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mailbox_gather.launches
    if not sup.ok:
        raise AssertionError(f"inject supervised: "
                             f"{sup.failure_report()}")
    check_inject("inject supervised (K = 1)", sup.sim, sup.stats, f_sup)
    log_run("inject supervised (K = 1)", sup.stats, wall)
    if launches <= 0:
        raise AssertionError("inject: mailbox_gather was never launched")
    refill = sum(f_sup.t_refill)
    log(f"  inject supervised: mailbox_gather launched {launches} times "
        f"(the merges' and the routes' sweeps); {len(f_sup.t_refill)} "
        f"refills took {refill:.3f} s of the {wall:.3f} s "
        f"({refill / wall * 100:.2f}%; staging the mirror "
        f"{sum(f_sup.t_stage):.3f} s, plane builds "
        f"{sum(f_sup.t_planes):.3f} s); health "
        f"{sup.health.failure_report()['diagnostics']}; harvested "
        f"{json.dumps(harvester.summary())}")
    out["launches_inject"] = launches
    err = gathered.check("inject")
    del gathered

    # the same trace through run_windows, one window a dispatch (the
    # profiled window in it) and 16
    runs = {}
    for K in (1, INJ_CHUNK):
        f = timed_feeder(list(trace))
        probe = WindowProbe(INJ_PROFILE_WINDOW) if K == 1 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim, stats, _ = checkpoint.run_windows(
            b, (tgen.handler,), sim=sim0, feeder=f, windows_per_dispatch=K,
            on_window=probe, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[K] = (sim, stats, f, probe)
        check_inject(f"inject run_windows (K = {K})", sim, stats, f,
                     chunked=K > 1)
        log_run(f"inject run_windows (K = {K})", stats, wall)
    n = inject_leaves_equal("inject K = 1 vs supervised", runs[1][0],
                            sup.sim)
    log(f"  inject: run_windows (K = 1) == run_supervised: all {n} leaves")
    n = inject_leaves_equal(
        f"inject K = 1 vs K = {INJ_CHUNK}", runs[1][0], runs[INJ_CHUNK][0],
        exclude=INJ_SCRATCH | INJ_SLOTS | INJ_PARTITION | {
            k for k in convert.sim_tensors(runs[1][0])
            if k.startswith(".telem.")})
    log(f"  inject: K = 1 == K = {INJ_CHUNK}: {n} leaves and the live "
        f"event multiset (staging scratch, heap slots, route marks and "
        f"ring excluded); {runs[INJ_CHUNK][1].as_dict()}")
    chunk_cut(device)

    # one window profiled: barrier refill, merge, drain and route
    _, stats1, f1, probe = runs[1]
    k = INJ_PROFILE_WINDOW
    events = raw_events(probe.prof)
    marks = probe.marks
    unprof_ms = (marks[k] - marks[k - 1]) * 1e3
    prof_ms = (marks[k + 1] - marks[k]) * 1e3
    busy_ms = device_busy_us(events) / 1e3
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize")
    h2d = sum(1 for e in events if e.device_type == DeviceType.CPU
              and e.name == "cudaMemcpyAsync")
    # the profiled window is k + 1: its barrier is refill k + 2
    ref_ms, st_ms, pl_ms, in_ms = (getattr(f1, n)[k + 2] * 1e3 for n in (
        "t_refill", "t_stage", "t_planes", "t_install"))
    mean_ms = {n: statistics.mean(getattr(f1, n)) * 1e3 for n in (
        "t_refill", "t_stage", "t_planes", "t_install")}
    out["inject_window"] = {"launches": host_launches(events),
                            "syncs": syncs, "ms": round(unprof_ms, 3),
                            "busy_ms": round(busy_ms, 3),
                            "refill_ms": round(ref_ms, 3),
                            "stage_ms": round(st_ms, 3)}
    log(f"  inject: window {k + 1} profiled: {host_launches(events)} "
        f"launches, {syncs} cudaStreamSynchronize, {h2d} cudaMemcpyAsync, "
        f"device busy {busy_ms:.2f} ms = {busy_ms / unprof_ms * 100:.2f}% "
        f"of the unprofiled window {k}'s {unprof_ms:.2f} ms ({prof_ms:.2f} "
        f"ms profiled); its barrier's refill {ref_ms:.3f} ms "
        f"({ref_ms / unprof_ms * 100:.2f}% of a window: staging the "
        f"mirror {st_ms:.3f} ms, plane build {pl_ms:.3f} ms, copies "
        f"{in_ms - pl_ms:.3f} ms); refills over the run "
        f"{mean_ms['t_refill']:.3f} ms mean (staging "
        f"{mean_ms['t_stage']:.3f}, planes {mean_ms['t_planes']:.3f}, "
        f"copies {mean_ms['t_install'] - mean_ms['t_planes']:.3f}), "
        f"{max(f1.t_refill) * 1e3:.3f} ms max")
    del runs

    # 15c's CLI run starts here and runs beside 15b (not timed)
    cfg_path = str(root / TRAFFIC_CONFIG)
    d = os.path.join(tmp, "traffic.data")
    trace_out, metrics_out = (os.path.join(tmp, "traffic.trace.json"),
                              os.path.join(tmp, "traffic.prom"))
    traffic = start_proc("cli-tgen-traffic", [
        sys.executable, "-m", "shadow_tpu_torch.cli", cfg_path,
        "--platform", "gpu", "-d", d, "--trace-out", trace_out,
        "--metrics-out", metrics_out])
    try:
        out, err = _inject_tail(device, tmp, out, err, b, sim0, sup, trace,
                                supervised, traffic,
                                (cfg_path, d, trace_out, metrics_out))
    finally:
        stop_proc(traffic)
    return out, err


def _inject_tail(device, tmp, out, err, b, sim0, sup, trace, supervised,
                 traffic, paths):
    """15b, then 15c (its CLI run started by _inject_cell; `paths`: its
    config, data directory, trace and metrics files)."""
    import functools
    import os

    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.inject import Feeder, manifest_block
    from shadow_tpu_torch.utils import checkpoint

    # ---- 15b: supervised stop at INJ_STOP_S, resume with a fresh feeder
    stop = {"v": False}

    def on_round(sim, ws, wstart, wend, nm):
        stop["v"] = nm >= int(INJ_STOP_S * 1e9)
    first, _ = supervised(Feeder(list(trace)), on_round=on_round,
                          stop=lambda: stop["v"])
    if not first.preempted or not first.final_checkpoint:
        raise AssertionError("inject 15b: the run did not stop")
    t_stop = checkpoint.peek_meta(first.final_checkpoint)["time_ns"]
    f2 = Feeder(list(trace))
    b.sim = sim0
    rest = faults.run_supervised(
        b, (tgen.handler,), checkpoint_path=os.path.join(tmp, "ck2"),
        resume_from=first.final_checkpoint, feeder=f2, device=device)
    if not rest.ok:
        raise AssertionError(f"inject 15b resume: "
                             f"{rest.failure_report()}")
    n = inject_leaves_equal("inject 15b resumed vs straight", rest.sim,
                            sup.sim, exclude=INJ_SCRATCH)
    blk = manifest_block(rest.sim, f2)
    if (blk["injected"] + blk["dropped"] + blk["deferred"]
            != blk["trace_events"] or blk["late"]
            or rest.stats.as_dict() != sup.stats.as_dict()):
        raise AssertionError(f"inject 15b: block {blk} stats "
                             f"{rest.stats.as_dict()}")
    log(f"  inject 15b: stopped at t={t_stop}, resumed with a fresh feeder "
        f"(cursor {f2.cursor} after the run): == the straight run "
        f"({n} leaves, staging scratch excluded), injection block "
        f"reconciles {json.dumps(blk)}")
    del first, rest, sup, b, sim0

    # ---- 15c: a <traffic> config through the CLI ----------------------
    cfg_path, d, trace_out, metrics_out = paths
    code, stdout, stderr, wall = finish_proc(traffic)
    lines = stdout.strip().splitlines()
    if code != 0 or not lines:
        raise AssertionError(f"traffic CLI exited {code}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    report = json.loads(lines[-1])
    check_report("cli-tgen-traffic", report, TRAFFIC_REPORT)
    with open(os.path.join(d, "run_manifest.json")) as fh:
        man = json.load(fh)
    for key, want in (("injection", TRAFFIC_INJECTION),
                      ("telemetry", TRAFFIC_TELEMETRY)):
        if report.get(key) != want or man.get(key) != want:
            raise AssertionError(f"cli-tgen-traffic: {key} {report.get(key)}"
                                 f" / manifest {man.get(key)} != the "
                                 f"reference's {want}")
    with open(trace_out) as fh:
        tr = json.load(fh)
    n_win = sum(1 for e in tr["traceEvents"] if e["pid"] == 0
                and e["ph"] == "X")
    with open(metrics_out) as fh:
        prom = fh.read().splitlines()
    for ln in prom:
        if not ln.startswith("# TYPE "):
            name, val = ln.rsplit(" ", 1)
            float(val)
            if not name.startswith("shadow_tpu_"):
                raise AssertionError(f"cli-tgen-traffic: metric line {ln!r}")
    if n_win != TRAFFIC_REPORT["windows"]:
        raise AssertionError(f"cli-tgen-traffic: trace holds {n_win} "
                             f"windows")
    log(f"  cli-tgen-traffic: exit 0 in {wall:.1f} s; report and manifest "
        f"injection and telemetry blocks equal the reference CLI's; Chrome "
        f"trace {len(tr['traceEvents'])} events ({n_win} windows), "
        f"Prometheus text {len(prom)} lines parsed")

    mailbox_gather.launches = 0
    with KeepGatherInputs() as gathered:
        _, sim = compare_bundles_cuda_cpu(
            "tgen traffic config", functools.partial(_traffic_twin, cfg_path))
    if int(sim.app.rcvd.sum()) != TRAFFIC_INJECTION["injected"]:
        raise AssertionError("tgen traffic config: a datagram was lost")
    out["launches_traffic"] = mailbox_gather.launches
    err = max(err, gathered.check("tgen traffic config"))
    return out, err


def _traffic_twin(cfg_path, dev):
    """15c: the <traffic> config's bundle, its trace staged whole."""
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config
    from shadow_tpu_torch.inject import Feeder
    from shadow_tpu_torch.net.build import make_runner

    with open(cfg_path) as fh:
        loaded = load(parse_config(fh.read()), seed=1, device=dev)
    tb = loaded.bundle
    tb.sim = Feeder(list(loaded.inject_events)).fill_all(tb.sim)
    return tb, make_runner(tb, app_handlers=loaded.handlers, device=dev)


def build_lanes(device, hosts=HOSTS, sim_s=SIM_S, lanes=True, recorders=True,
                replicas=LANE_R):
    """16a's program through bench's own builder: phase 4's PHOLD packed
    `replicas` times (one lane a replica when `lanes`), the ring, and
    the flow and causality recorders at 1-in-LANE_SAMPLE when
    `recorders`."""
    from shadow_tpu_torch import bench

    n = LANE_SAMPLE if recorders else 0
    return bench.build_phold(hosts * replicas, LOAD, sim_s, 1, CAPACITY,
                             ONE_VERTEX, device, replica_size=hosts,
                             lanes=lanes, flow_sample=n, causality_sample=n)


def flood_fn(hosts, cap, trig):
    """tests/test_lanes.py's seq-conserving flood: cap+1 far-future
    events into the victim lane's rows in every window past `trig`,
    next_seq bumped per attempt."""
    import torch

    from shadow_tpu_torch.core.events import push_rows

    def flood(sim, wend):
        q = sim.events
        n = q.num_hosts
        if wend <= trig:
            return sim
        ar = torch.arange(n, device=q.time.device)
        mask = (ar >= LANE_VICTIM * hosts) & (ar < (LANE_VICTIM + 1) * hosts)
        t = torch.full((n,), INVALID_TIME - 1, dtype=torch.int64,
                       device=q.time.device)
        z = torch.zeros((n,), dtype=torch.int32, device=q.time.device)
        w = torch.zeros((n, q.words.shape[-1]), dtype=torch.int32,
                        device=q.time.device)
        for _ in range(cap + 1):
            q = push_rows(q, mask, t, z, z, q.next_seq, w)
            q = q.replace(next_seq=q.next_seq + mask.to(torch.int32))
        return sim.replace(events=q)

    return flood


def check_lanes_run(label, sim, stats, hosts, launches):
    """16a's invariants on a finished 4-lane run with the recorders."""
    from shadow_tpu_torch.core.lanes import lane_report

    R = sim.lanes.replicas
    check_phold(label, sim, hosts * R, LOAD, launches)
    sent = sim.app.sent.reshape(R, -1).sum(1).tolist()
    rcvd = sim.app.rcvd.reshape(R, -1).sum(1).tolist()
    if sent != [hosts * LOAD + r for r in rcvd]:
        raise AssertionError(f"{label}: per-lane sent {sent} != H*load + "
                             f"rcvd {rcvd}")
    rep = lane_report(sim)
    if any(d["quarantined"] for d in rep):
        raise AssertionError(f"{label}: a lane tripped: {rep}")
    for name, scalar, plane in (
            ("events", sim.events.overflow, sim.events.overflow_h),
            ("outbox", sim.outbox.overflow, sim.outbox.overflow_h),
            ("rq", sim.net.rq_overflow, sim.net.rq_overflow_h)):
        if int(scalar) != int(plane.sum()):
            raise AssertionError(f"{label}: {name} overflow {int(scalar)} "
                                 f"!= sum of its plane {int(plane.sum())}")
    st = stats.as_dict()
    f, cz, ring = sim.flows, sim.causality, sim.telem
    n = int(ring.count)
    checks = {
        "flows count + lost == sampled":
            (int(f.count + f.lost), int(f.sampled)),
        "lineage count <= seen (hosts over)":
            (int((cz.count > cz.seen).sum()), 0),
        "advance records == windows": (int(cz.adv_count), st["windows"]),
        "ring count == windows": (n, st["windows"]),
        "windows where sum(lane_events) != events": (int(
            (ring.lane_events[:n].sum(1) != ring.events[:n]).sum()), 0),
        "sum(ring.events) == events_processed":
            (int(ring.events.sum()), st["events_processed"]),
    }
    for k, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"{label}: {k}: {got} != {want}")
    log(f"  {label}: zero overflow, no lane tripped, per-lane sent == "
        f"H*load + rcvd {sent}; scalar == sum(plane) for the three "
        f"latches; {', '.join(checks)}; flows sampled {int(f.sampled)} "
        f"stored {int(f.count)} lost {int(f.lost)}; lineage seen "
        f"{int(cz.seen.sum())} kept {int(cz.count.sum())}; per-lane events "
        f"{[d['events_exec'] for d in rep]}")


def profile_lanes_window(b, device, label="lanes profile"):
    """A PHOLD program's windows after window 0 (which holds the run's
    micro-steps) to LANE_PROFILE_NS, from the state window 0 left:
    unprofiled (the least of 3) and once under torch.profiler —
    launches, cudaStreamSynchronize and device busy per window (the
    4-lane program's in phase 16, phase 4's with and without the trim
    in phase 17)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    def runner(end):
        return make_runner(b, app_handlers=(phold.handler,), end_time=end,
                           app_bulk=phold.BULK, device=device)

    sim0, _ = runner(20_000_000)(b.sim)
    later = runner(LANE_PROFILE_NS)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = later(sim0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        later(sim0)
        torch.cuda.synchronize()
    events = raw_events(prof)
    w = max(st.as_dict()["windows"], 1)
    wall_ms = min(walls) * 1e3 / w
    busy_ms = device_busy_us(events) / 1e3 / w
    launches = host_launches(events) / w
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name == "cudaStreamSynchronize") / w
    log(f"  {label}, windows after window 0: {st.as_dict()}: "
        f"{wall_ms:.2f} ms a window unprofiled, {launches:.0f} launches, "
        f"{syncs:.1f} cudaStreamSynchronize, device busy {busy_ms:.3f} ms "
        f"= {busy_ms / wall_ms * 100:.2f}% a window")
    return {"ms": round(wall_ms, 3), "launches": round(launches, 1),
            "syncs": round(syncs, 1), "busy_ms": round(busy_ms, 3)}


def time_gather(label, kept):
    """mailbox_gather on a run's own route inputs, at the narrowest
    stream shape the route gave it (the narrow tier: most windows),
    one input set of more than the L2, so cold: kernel, plain and
    index_select device times and the byte bound."""
    import torch

    from shadow_tpu_torch.core.insert_kernels import (
        mailbox_gather, mailbox_gather_ref)

    stream, start, Wn = min(kept.values(), key=lambda v: v[0].shape[0])
    rows = (start.long()[:, None] + torch.arange(Wn, device=start.device)
            ).clamp(max=stream.shape[0] - 1).reshape(-1)
    ms = {k: device_ms([fn])[0] for k, fn in (
        ("ms", lambda: mailbox_gather(stream, start, Wn)),
        ("plain_ms", lambda: mailbox_gather_ref(stream, start, Wn)),
        ("library_ms", lambda: torch.index_select(stream, 0, rows)))}
    bound_ms, nbytes = mailbox_bound(stream, start, Wn)
    out = {"n": int(stream.shape[0]) - Wn, "H": int(start.numel()),
           "P": int(stream.shape[1]), **ms, "bound_ms": bound_ms,
           "bound_bytes": nbytes}
    log(f"  {label}: mailbox_gather on the route's own stream (H="
        f"{out['H']}, n={out['n']}, P={out['P']}): kernel {ms['ms']:.5f} "
        f"ms, plain {ms['plain_ms']:.5f} ms, index_select "
        f"{ms['library_ms']:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} B)")
    return out


def profile_lane_hooks(device):
    """--profile: what each hook of the 4-lane program costs a call —
    the lineage recorder (window 0's micro-steps), the flow recorder,
    the advance latch and the lane barrier (every window) — as host
    launches and host ms inside a torch.profiler range around each
    call, over the first windows, to LANE_PROFILE_NS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import lanes
    from shadow_tpu_torch.net import build as build_mod
    from shadow_tpu_torch.telemetry import causality, flows

    def ranged(name, fn):
        def hook(*a, **kw):
            with record_function(f"hook:{name}"):
                return fn(*a, **kw)
        return hook

    patches = [(causality, "lineage_update"), (causality, "advance_latch"),
               (lanes, "window_update")]
    real = {name: getattr(mod, name) for mod, name in patches}
    real_make = build_mod.make_flow_fn
    b = build_lanes(device)
    try:
        for mod, name in patches:
            setattr(mod, name, ranged(name, real[name]))
        build_mod.make_flow_fn = lambda: ranged("flow_fn",
                                                flows.make_flow_fn())
        runner = build_mod.make_runner(
            b, app_handlers=(phold.handler,), end_time=LANE_PROFILE_NS,
            app_bulk=phold.BULK, device=device)
        runner(b.sim)                     # warm: first-call costs
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st = runner(b.sim)
            torch.cuda.synchronize()
    finally:
        for mod, name in patches:
            setattr(mod, name, real[name])
        build_mod.make_flow_fn = real_make
    events = raw_events(prof)
    launches = sorted(e.time_range.start for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name.startswith("cuda") and "Launch" in e.name)
    out = {}
    for name in ("lineage_update", "flow_fn", "advance_latch",
                 "window_update"):
        spans = [e.time_range for e in events
                 if e.name == f"hook:{name}"
                 and e.device_type == DeviceType.CPU]
        n = sum(1 for t in launches for r in spans
                if r.start <= t <= r.end)
        ms = sum(r.end - r.start for r in spans) / 1e3
        calls = max(len(spans), 1)
        out[name] = {"calls": len(spans), "launches": round(n / calls, 1),
                     "host_ms": round(ms / calls, 3)}
    log(f"  lanes hooks over {st.as_dict()}: "
        + "; ".join(f"{k} {v['calls']} calls, {v['launches']} launches "
                    f"and {v['host_ms']} ms a call (profiled)"
                    for k, v in out.items()))
    return out


def lanes_cell(device):
    """Phase 16. Returns the kernel row's additions and the max abs
    error of mailbox_gather against its plain version on the run's own
    route inputs."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="shadow_lanes_") as tmp:
        return _lanes_cell(device, tmp)


def _lanes_cell(device, tmp):
    import os
    import subprocess
    from pathlib import Path

    import torch

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    out = {}
    root = Path(__file__).resolve().parent
    hosts = HOSTS

    # ---- 16a: the bench row as a user runs it --------------------------
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_REPLICAS=str(LANE_R), BENCH_LANE_ISOLATION="1",
               BENCH_FLOW_SAMPLE=str(LANE_SAMPLE),
               BENCH_CAUSALITY=str(LANE_SAMPLE))
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.bench"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"lanes bench exited {done.returncode}:\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    row = json.loads(done.stdout.strip().splitlines()[-1])
    log(f"  phold-10k-x4-lanes: `BENCH_REPLICAS={LANE_R} "
        f"BENCH_LANE_ISOLATION=1 BENCH_FLOW_SAMPLE={LANE_SAMPLE} "
        f"BENCH_CAUSALITY={LANE_SAMPLE} python -m shadow_tpu_torch.bench` "
        f"exit 0 in {wall:.1f} s: {json.dumps(row)}")
    fl, cz, ln = row["flows"], row["causality"], row["lanes"]
    checks = {
        "metric": (row["metric"], LANE_NAME),
        "quarantined lanes": (ln["quarantined"], []),
        "lane overflow": (sum(d["events_overflow"] + d["outbox_overflow"]
                              + d["rq_overflow"] for d in ln["per_lane"]),
                          0),
        "per-lane events": (sum(d["events_exec"] for d in ln["per_lane"]),
                            row["events"]),
        "flows recorded + lost_window_clamp == sampled":
            (fl["recorded"] + fl["lost_window_clamp"], fl["sampled"]),
        "flows harvested + lost_ring == recorded":
            (fl["harvested"] + fl["lost_ring"], fl["recorded"]),
        "advance records == windows":
            (cz["windows_attributed"] + cz["windows_lost"], row["windows"]),
        "lineage harvested + lost_ring == sampled":
            (cz["harvested"] + cz["lost_ring"], cz["sampled"]),
    }
    for k, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"lanes bench row: {k}: {got} != {want}")
    out["lanes_bench_row"] = {k: row[k] for k in ("value", "wall_s",
                                                  "warmup_s")}
    out["lanes_bench_row"]["ms_per_window"] = round(
        row["wall_s"] * 1e3 / row["windows"], 3)

    # ---- 16a in-process: the main path of this phase -------------------
    t0 = time.perf_counter()
    b = build_lanes(device)
    torch.cuda.synchronize()
    log(f"  lanes: built {hosts * LANE_R} rows ({LANE_R} lanes) in "
        f"{time.perf_counter() - t0:.2f} s")
    runner = make_runner(b, app_handlers=(phold.handler,),
                         app_bulk=phold.BULK, device=device)
    with KeepGatherInputs() as gathered:
        sim_a, st_a, wall, launches = drive("lanes main path", b, runner,
                                            device)
    check_lanes_run("lanes main path", sim_a, st_a, hosts, launches)
    out["launches_lanes"] = launches["mailbox_gather"]
    err = gathered.check("lanes main path")
    out["lanes_gather"] = time_gather("lanes main path", gathered.kept)
    out["lanes_window"] = profile_lanes_window(b, device)
    del gathered, sim_a

    # 16d's CLI run on the card starts here and runs beside 16b and 16c
    # (neither is timed)
    started = start_lanes_cli(root, tmp)
    try:
        return _lanes_tail(device, root, tmp, out, err, b, started)
    finally:
        stop_proc(started)


def _lanes_tail(device, root, tmp, out, err, b, started):
    """16b-16d (16d's card run started by _lanes_cell)."""
    import copy
    import os

    import numpy as np
    import torch

    from shadow_tpu_torch import convert, faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import lanes
    from shadow_tpu_torch.net.build import make_runner
    from shadow_tpu_torch.utils import checkpoint

    hosts = HOSTS
    # ---- 16b: the recorders off, R = 1, a flooded lane, the supervisor.
    # The variants are A's boot state with planes detached or attached,
    # run to LANE_SIDE_S through A's bundle (one build for all).
    side = int(LANE_SIDE_S * 1e9)

    def side_run(sim, end=side, fault_fn=None, bundle=b):
        out = make_runner(bundle, app_handlers=(phold.handler,),
                          end_time=end, app_bulk=phold.BULK, device=device,
                          fault_fn=fault_fn)(sim)
        torch.cuda.synchronize()
        return out

    off = b.sim.replace(flows=None, causality=None)
    (sim_on, st_on), (clean, st_off) = side_run(b.sim), side_run(off)
    la, lb = convert.sim_to_numpy(sim_on), convert.sim_to_numpy(clean)
    extra = set(la) - set(lb)
    bad = [k for k in lb if not np.array_equal(la[k], lb[k])]
    if st_on.as_dict() != st_off.as_dict() or bad or set(lb) - set(la) or \
            not all(k.startswith((".flows", ".causality")) for k in extra):
        raise AssertionError(f"lanes: the recorders changed the run: "
                             f"{bad[:5]} {sorted(extra)[:5]}")
    log(f"  lanes: recorders off == on to {LANE_SIDE_S} sim-s over all "
        f"{len(lb)} shared leaves ({len(extra)} recorder leaves more); "
        f"EngineStats equal")
    del sim_on, la, lb

    pb = build_lanes(device, lanes=False, recorders=False)
    (p_sim, p_st), (r_sim, r_st) = (
        side_run(sim, side // 2, bundle=pb)
        for sim in (pb.sim, lanes.attach(pb.sim, 1)))
    lp, lr = convert.sim_to_numpy(p_sim), convert.sim_to_numpy(r_sim)
    bad = [k for k in lp if not np.array_equal(lp[k], lr[k])]
    extra = sorted(set(lr) - set(lp))
    if p_st.as_dict() != r_st.as_dict() or bad or set(lp) - set(lr) or \
            not all(k.startswith(".lanes") or k.endswith("overflow_h")
                    for k in extra):
        raise AssertionError(f"lanes: attach(sim, 1) changed the run: "
                             f"{bad[:5]} {extra}")
    log(f"  lanes: lanes.attach(sim, 1) == no lanes to {LANE_SIDE_S / 2} "
        f"sim-s over all {len(lp)} shared leaves (+{extra})")
    del pb, p_sim, r_sim, lp, lr

    cap, trig = b.cfg.event_capacity, side // 2
    flooded, _ = side_run(off, fault_fn=flood_fn(hosts, cap, trig))
    rep = lanes.lane_report(flooded)
    v = rep[LANE_VICTIM]
    if [d["lane"] for d in rep if d["quarantined"]] != [LANE_VICTIM] \
            or v["trip"] != ["events_overflow"] or v["flushed"] <= 0:
        raise AssertionError(f"lanes flood: {rep}")
    healthy = [r for r in range(LANE_R) if r != LANE_VICTIM]
    for plane in ("app.rcvd", "net.ctr_events_exec", "events.time"):
        a = clean
        c = flooded
        for part in plane.split("."):
            a, c = getattr(a, part), getattr(c, part)
        for r in healthy:
            if not torch.equal(a[r * hosts:(r + 1) * hosts],
                               c[r * hosts:(r + 1) * hosts]):
                raise AssertionError(f"lanes flood: lane {r}'s {plane} "
                                     f"differs from the clean run")
    log(f"  lanes flood: lane {LANE_VICTIM} quarantined at "
        f"t={v['quarantined_at_ns']} on {v['trip']}, {v['flushed']} events "
        f"flushed; lanes {healthy}' app.rcvd, ctr_events_exec and "
        f"events.time byte-identical to the clean run")
    del clean, flooded

    seen = []
    sb = copy.copy(b)
    sb.sim, sb.app_bulk = off, phold.BULK
    t0 = time.perf_counter()
    # to 0.6 of the side depth: one snapshot (after window 8, t=0.4 s)
    # before the trip, the salvage's source
    res = faults.run_supervised(
        sb, (phold.handler,), fault_fn=flood_fn(hosts, cap, trig),
        end_time=side * 6 // 10, checkpoint_path=os.path.join(tmp, "ck"),
        checkpoint_every_windows=8, max_retries=0, sleep=lambda s: None,
        on_lane_quarantine=seen.append, device=device)
    if not res.ok or [i.lane for i in seen] != [LANE_VICTIM] \
            or not res.health.lane_contained:
        raise AssertionError(f"lanes supervised: {res.failure_report()}")
    inc = res.lane_incidents[0]
    tmpl = build_lanes(device, lanes=False, recorders=False, replicas=1)
    tmpl.sim = lanes.attach(tmpl.sim, 1)
    salvage, t_salv, _ = checkpoint.load(inc.salvage, tmpl.sim)
    if int(salvage.events.num_hosts) != hosts:
        raise AssertionError("lanes supervised: the salvage holds "
                             f"{salvage.events.num_hosts} rows")
    log(f"  lanes supervised: contained trip, incident "
        f"{json.dumps(inc.as_dict())}; the salvage artifact loads through "
        f"checkpoint.load ({hosts} rows, t={t_salv}) in "
        f"{time.perf_counter() - t0:.2f} s")
    del res, salvage, sb, off, b

    # ---- 16c: the cuts on the card and the CPU, the reference's counts -
    err = max(err, lanes_cuts(device))

    # ---- 16d: the CLI's flags on the <traffic> config ------------------
    out["lanes_cli_s"] = lanes_cli(device, root, tmp, started)
    return out, err


def lane_counts(sim, stats):
    """16c's pinned quantities of a finished run."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.core.lanes import lane_report

    h = telemetry.Harvester()
    h.drain(sim)
    cz = sim.causality
    got = {"stats": stats.as_dict(),
           "lineage": {"seen": int(cz.seen.sum()),
                       "count": int(cz.count.sum())},
           "causes": telemetry.binding_histogram(h.adv_records)}
    if getattr(sim, "lanes", None) is not None:
        rep = lane_report(sim)
        got["events_exec"] = [d["events_exec"] for d in rep]
        got["quarantined"] = [d["lane"] for d in rep if d["quarantined"]]
        f = sim.flows
        got["flows"] = {"sampled": int(f.sampled), "count": int(f.count),
                        "lost": int(f.lost)}
    return got


def _lanes_phold_cut(dev):
    """16c: 16a's program at 4 x LANE_CUT_HOSTS hosts to LANE_CUT_S."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    b = build_lanes(dev, LANE_CUT_HOSTS, sim_s=LANE_CUT_S)
    return make_runner(b, app_handlers=(phold.handler,),
                       app_bulk=phold.BULK, device=dev)(b.sim)


def _lanes_inject_cut(dev):
    """16c: 15a's 64-host cut with BENCH_CAUSALITY=INJ_CAUS_SAMPLE."""
    from shadow_tpu_torch import bench, telemetry
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.inject import Feeder
    from shadow_tpu_torch.utils import checkpoint

    H, rate, sim_s, nl = INJ_CUT
    b = bench.build_inject(H, sim_s, 1, 64, nl, ONE_VERTEX, dev)
    b.sim = telemetry.attach_causality(b.sim, sample_period=INJ_CAUS_SAMPLE)
    sim, stats, _ = checkpoint.run_windows(
        b, (tgen.handler,), feeder=Feeder(list(bench.rate_trace(
            H, rate, sim_s))),
        windows_per_dispatch=INJ_CHUNK, device=dev)
    return sim, stats


def lanes_cuts(device):
    """16c: the 4 x LANE_CUT_HOSTS cut of 16a's program (to LANE_CUT_S)
    and 15a's 64-host cut with BENCH_CAUSALITY=8, each on the card and
    on the CPU: the
    reference's pinned counts on both, every leaf equal between them.
    Returns the max abs error of mailbox_gather on the card run's
    route."""
    import numpy as np
    import torch

    from shadow_tpu_torch import convert

    H = INJ_CUT[0]
    err = 0
    for label, run, expect in (
            (f"{LANE_R} x {LANE_CUT_HOSTS}-host cut", _lanes_phold_cut,
             LANE_CUT_EXPECT),
            (f"injection {H}-host cut, BENCH_CAUSALITY={INJ_CAUS_SAMPLE}",
             _lanes_inject_cut, INJ_CAUS_EXPECT)):
        fut = on_cpu(run, extra=lane_counts)
        t0 = time.perf_counter()
        with KeepGatherInputs() as gathered:
            sim, stats = run(torch.device(device))
        err = max(err, gathered.check(label))
        runs = [(lane_counts(sim, stats), convert.sim_to_numpy(sim),
                 time.perf_counter() - t0)]
        _, leaves, got, wall = fut.result(timeout=900)
        runs.append((got, leaves, wall))
        for dev, (got, _, wall) in zip(("cuda", "cpu"), runs):
            if got != expect:
                raise AssertionError(f"{label} {dev}: {got} != the "
                                     f"reference's {expect}")
            log(f"  {label} {dev}: the reference's counts in "
                f"{wall:.2f} s: {json.dumps(got)}")
        a, c = runs[0][1], runs[1][1]
        bad = [k for k in a if a[k].dtype != c[k].dtype
               or not np.array_equal(a[k], c[k])]
        if a.keys() != c.keys() or bad:
            raise AssertionError(f"{label}: cuda != cpu, first {bad[:5]}")
        log(f"  {label}: {device} == cpu, all {len(a)} leaves equal")
    return err


def lanes_cli_argv(root, tmp, key):
    """16d's CLI arguments and data directory for the `key` run."""
    import os

    d = os.path.join(tmp, f"lanes_cli_{key}")
    return d, [str(root / TRAFFIC_CONFIG), "-d", d, "--trace-out",
               os.path.join(d, "t.json"), "--metrics-out",
               os.path.join(d, "m.prom"), *LANE_CLI_FLAGS]


def start_lanes_cli(root, tmp):
    """Start 16d's card run (a subprocess) while 16b and 16c run."""
    _, argv = lanes_cli_argv(root, tmp, "card")
    return start_proc("lanes CLI", [
        sys.executable, "-m", "shadow_tpu_torch.cli", *argv, "--platform",
        "gpu"])


def lanes_cli(device, root, tmp, started):
    """16d: `python -m shadow_tpu_torch.cli <traffic config>
    --lane-isolation 4 --resident --flow-sample 8 --causality-sample 8
    --trace-out --metrics-out` as a subprocess on `device` (`started` by
    start_lanes_cli) and in-process on the CPU: equal reports
    (wall-clock fields aside) and manifest lanes, admission, flows and
    causality blocks; the manifest passes tools/telemetry_lint.py.
    Returns the subprocess's wall seconds."""
    import contextlib
    import io
    import os
    import subprocess

    from shadow_tpu_torch import cli

    runs = {}
    for key in ("cpu", "card"):
        d, argv = lanes_cli_argv(root, tmp, key)
        t0 = time.perf_counter()
        if key == "card":
            code, stdout, errs, wall = finish_proc(started)
            lines = stdout.strip().splitlines()
        else:
            so, se = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(so), \
                    contextlib.redirect_stderr(se):
                code = cli.main([*argv, "--platform", "cpu"])
            lines, errs = so.getvalue().strip().splitlines(), se.getvalue()
            wall = time.perf_counter() - t0
        if code != 0 or not lines:
            raise AssertionError(f"lanes CLI {key} exited {code}:\n"
                                 f"{errs[-3000:]}")
        with open(os.path.join(d, "run_manifest.json")) as fh:
            runs[key] = (json.loads(lines[-1]), json.load(fh), d, wall)
    (rep, man, d, wall), (crep, cman, _, _) = runs["card"], runs["cpu"]
    wallk = ("wall_seconds", "events_per_second",
             "simulated_seconds_per_wall_second")
    strip = {k: v for k, v in rep.items() if k not in wallk}
    if strip != {k: v for k, v in crep.items() if k not in wallk}:
        raise AssertionError(f"lanes CLI: report {rep} != the CPU's {crep}")
    for block in ("lanes", "admission", "flows", "causality",
                  "specialization"):
        if block not in man or man[block] != cman[block]:
            raise AssertionError(f"lanes CLI: manifest {block} differs from "
                                 f"the CPU run's")
    lint = subprocess.run(
        [sys.executable, "tools/telemetry_lint.py", "--manifest",
         os.path.join(d, "run_manifest.json")], cwd=root,
        capture_output=True, text=True, timeout=120)
    if lint.returncode != 0:
        raise AssertionError(f"lanes CLI: telemetry_lint refused the "
                             f"manifest:\n{lint.stdout[-2000:]}"
                             f"{lint.stderr[-2000:]}")
    log(f"  lanes CLI: exit 0 in {wall:.1f} s on {device}; report "
        f"{json.dumps(strip)}; manifest lanes {man['lanes']['replicas']} "
        f"replicas, admission {man['admission']['admitted']} admitted, "
        f"flows sampled {man['flows']['sampled']}, causality sampled "
        f"{man['causality']['sampled']} — equal to the CPU run's; "
        f"telemetry_lint --manifest: ok")
    return round(wall, 1)


def leaves_equal_but_guard(label, want, got):
    """Every leaf of the trimmed run's `got` ({path: numpy}) but the
    guard's equal to the untrimmed run's `want`, dtype included, and the
    guard's trip counters 0. Returns the number of leaves compared."""
    import numpy as np

    guard = sorted(k for k in got if k.startswith(".guard."))
    if not guard:
        raise AssertionError(f"{label}: the trimmed sim carries no guard")
    if sorted(set(got) - set(guard)) != sorted(want):
        raise AssertionError(f"{label}: leaf sets differ: "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    bad = [k for k in want if want[k].dtype != got[k].dtype
           or not np.array_equal(want[k], got[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ from the "
                             f"untrimmed run, first {bad[:5]}")
    trips = {k: int(got[k]) for k in guard}
    if any(trips.values()):
        raise AssertionError(f"{label}: the guard tripped: {trips}")
    return len(want)


def spec_cell(device, main4, relay6s):
    """Phase 17: the capability-trimmed programs on the card.

    17a: phase 4's bundle through specialize.apply (loss and timers
    dropped) and make_runner, driven once: every leaf but the guard and
    the EngineStats equal to phase 4's untrimmed run (`main4`: bundle,
    final sim, stats), the guard's counters 0, mailbox_gather launched
    every window and held exact to its plain version on this run's own
    route streams (and timed there); one steady window profiled with
    and without the trim. 17b: the BENCH_SPECIALIZE=1 row of `python -m
    shadow_tpu_torch.bench`. 17c: the guard on a halved reliability
    table and on a planted TIMER, each to SPEC_TAMPER_S: health.gather
    reports a fatal trip. 17d: 6s's relay bulk twin (`relay6s`: leaves,
    stats, bundle) trimmed (loss dropped; relay declares no kinds),
    equal to the untrimmed twin. Returns (row fields, max abs err, the
    gather timing on 17a's route)."""
    import os
    import subprocess
    from pathlib import Path

    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.apps import phold, relay
    from shadow_tpu_torch.compile import specialize
    from shadow_tpu_torch.core.events import EventKind
    from shadow_tpu_torch.faults import health
    from shadow_tpu_torch.net.build import make_runner

    out = {}
    b4, sim4, stats4 = main4

    # ---- 17a: phase 4's program, trimmed -------------------------------
    bt = specialize.apply(b4, (phold.handler,), app_bulk=phold.BULK)
    if bt.caps.dropped() != ("loss", "timers"):
        raise AssertionError(f"17a: dropped {bt.caps.dropped()}, expected "
                             f"('loss', 'timers')")
    log(f"  17a: specialize.apply: dropped {bt.caps.dropped()}, key extra "
        f"{bt.caps.key_extra()!r}, guard watching {bt.sim.guard.watched()}")
    with KeepGatherInputs() as gathered:
        sim, stats, wall, launches = drive(
            "17a trimmed main path", bt, main_runner(bt, device), device)
    check_phold("17a trimmed main path", sim, HOSTS, LOAD, launches)
    st = stats.as_dict()
    if st != stats4.as_dict():
        raise AssertionError(f"17a: EngineStats {st} != phase 4's "
                             f"{stats4.as_dict()}")
    if launches["mailbox_gather"] != st["windows"]:
        raise AssertionError(f"17a: mailbox_gather launched "
                             f"{launches['mailbox_gather']} times in "
                             f"{st['windows']} windows")
    n = leaves_equal_but_guard("17a", convert.sim_to_numpy(sim4),
                               convert.sim_to_numpy(sim))
    report = specialize.guard_report(sim)
    log(f"  17a: EngineStats and all {n} leaves equal to phase 4's "
        f"untrimmed run; guard {report}; mailbox_gather launched "
        f"{launches['mailbox_gather']} times in {st['windows']} windows")
    err = gathered.check("17a")
    gather = time_gather("17a", gathered.kept)
    out["launches_spec"] = launches["mailbox_gather"]
    out["spec_wall_s"] = round(wall, 3)
    del sim
    prof = {k: profile_lanes_window(b, device, label=f"17a {k} program")
            for k, b in (("untrimmed", b4), ("trimmed", bt))}
    out["spec_window"] = prof
    log(f"  17a: a steady window drops "
        f"{prof['untrimmed']['launches'] - prof['trimmed']['launches']:.0f}"
        f" launches with the trim ({prof['untrimmed']['launches']:.0f} -> "
        f"{prof['trimmed']['launches']:.0f}), "
        f"{prof['untrimmed']['ms']:.2f} -> {prof['trimmed']['ms']:.2f} ms")

    # ---- 17b: the bench row as a user runs it ----------------------------
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_SPECIALIZE="1")
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.bench"],
                          cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=600)
    bwall = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"spec bench exited {done.returncode}:\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    row = json.loads(done.stdout.strip().splitlines()[-1])
    log(f"  17b: `BENCH_SPECIALIZE=1 python -m shadow_tpu_torch.bench` exit "
        f"0 in {bwall:.1f} s: {json.dumps(row)}")
    checks = {
        "metric": (row["metric"], SPEC_NAME),
        "events": (row["events"], st["events_processed"]),
        "windows": (row["windows"], st["windows"]),
        "micro_steps": (row["micro_steps"], st["micro_steps"]),
        "specialization": (row.get("specialization"),
                           {"dropped": ["loss", "timers"],
                            "key_extra": "no_loss-no_timers"}),
    }
    for k, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"17b: {k}: {got} != {want}")
    log(f"  17b: name, counts and block as 17a's; specialize_speedup "
        f"{row['specialize_speedup']} ({row['value']} against "
        f"{row['events_per_sec_full_program']} events/s)")
    out["spec_row"] = {k: row[k] for k in (
        "value", "events_per_sec_full_program", "specialize_speedup",
        "wall_s")}

    # ---- 17c: the guard latch on the card --------------------------------
    end = int(SPEC_TAMPER_S * 1e9)

    def halve(s):
        return s.replace(net=s.net.replace(
            reliability=s.net.reliability * 0.5))

    def plant(s):
        q = s.events
        if int(q.time[0, 0]) == INVALID_TIME:
            raise AssertionError("17c: host 0's first slot is empty")
        kind = q.kind.clone()
        kind[0, 0] = EventKind.TIMER
        return s.replace(events=q.replace(kind=kind))

    for what, tamper, watch in (("a halved table", halve, "loss"),
                                ("a planted TIMER", plant, "timer")):
        runner = make_runner(bt, app_handlers=(phold.handler,),
                             end_time=end, app_bulk=phold.BULK,
                             device=device)
        tsim, tstats = runner(tamper(bt.sim))
        h = health.gather(tsim)
        fatal = [m for sev, m in h.diagnostics() if sev == "fatal"]
        trips = (h.guard_loss_trips, h.guard_timer_trips)
        want_trip = trips[0] if watch == "loss" else trips[1]
        other = trips[1] if watch == "loss" else trips[0]
        if not (h.fatal and h.guard_tripped and want_trip > 0
                and other == 0 and any(
                    "specialization guard tripped" in m
                    and "--specialize off" in m for m in fatal)):
            raise AssertionError(f"17c {what}: guard trips {trips}, fatal "
                                 f"{h.fatal}, diagnostics {fatal}")
        log(f"  17c {what}: {tstats.as_dict()['windows']} windows; guard "
            f"{specialize.guard_report(tsim)}; fatal: {fatal[0]}")
        del tsim

    # ---- 17d: the TCP trim on 6s's relay bulk twin -------------------------
    leaves6, st6, b6 = relay6s
    bt6 = specialize.apply(b6, (relay.handler,), app_tcp_bulk=relay.TCP_BULK)
    if bt6.caps.dropped() != ("loss",):
        raise AssertionError(f"17d: dropped {bt6.caps.dropped()}, expected "
                             f"('loss',)")
    sim, stats, _, launches = drive("17d trimmed relay", bt6,
                                    relay_runner(bt6, device), device)
    check_cell("17d trimmed relay", bt6.cfg, sim, stats, launches, {})
    if stats.as_dict() != st6:
        raise AssertionError(f"17d: EngineStats {stats.as_dict()} != 6s's "
                             f"{st6}")
    n = leaves_equal_but_guard("17d", leaves6, convert.sim_to_numpy(sim))
    log(f"  17d: dropped {bt6.caps.dropped()}; EngineStats and all {n} "
        f"leaves equal to 6s's untrimmed bulk twin; guard "
        f"{specialize.guard_report(sim)}")
    out["launches_spec_relay"] = launches["mailbox_gather"]
    torch.cuda.synchronize()
    return out, err, gather


def obs_xml(hosts, stop):
    """Phase 18's reference-format config: PHOLD at load OBS_LOAD on
    bench.py's MIX_VERTICES graph, every host logpcap="true"."""
    from shadow_tpu_torch.bench import MIX_VERTICES

    return (f'<shadow stoptime="{stop}">\n  <topology><![CDATA['
            f'{MIX_VERTICES}]]></topology>\n'
            f'  <plugin id="phold" path="phold"/>\n'
            f'  <host id="peer" quantity="{hosts}" logpcap="true">\n'
            f'    <process plugin="phold" starttime="0" '
            f'arguments="load={OBS_LOAD}"/>\n  </host>\n</shadow>')


def pcap_digest(directory):
    """The pcap files of a directory: their count, bytes and sha256 over
    their bytes in name order."""
    import hashlib
    from pathlib import Path

    h, n, files = hashlib.sha256(), 0, sorted(Path(directory).glob("*.pcap"))
    for f in files:
        data = f.read_bytes()
        h.update(data)
        n += len(data)
    return {"files": len(files), "bytes": n, "sha256": h.hexdigest()}


def obs_counts(sim, stats, cap, directory):
    """What phase 18 pins of a run: EngineStats, the CPU counters, the
    path matrix, the capture (records appended, overrun, files) and the
    per-host event costs."""
    net = sim.net
    return {"stats": stats.as_dict(),
            "blocked": int(net.ctr_cpu_blocked.sum()),
            "delay_ns": int(net.ctr_cpu_delay_ns.sum()),
            "records": int(net.cap_count.to(dtype=net.ctr_cpu_blocked.dtype)
                           .sum()),
            "dropped": cap.dropped, **pcap_digest(directory),
            "paths": net.ctr_path_packets.tolist(),
            "cost": sorted(set(net.cpu_cost.tolist())),
            "overflow": int(sim.events.overflow) + int(sim.outbox.overflow)
            + int(net.rq_overflow)}


def check_obs(label, got, expect):
    """`got` (obs_counts) against the reference's pinned counts."""
    bad = {k: (got[k], v) for k, v in expect.items() if got[k] != v}
    if bad or got["overflow"] != 0 or got["dropped"] != 0:
        raise AssertionError(f"{label}: differs from the reference's "
                             f"counts: {bad}; overflow {got['overflow']}, "
                             f"dropped {got['dropped']}")
    log(f"  {label}: the reference's counts: {json.dumps(got)}")


def _obs_udp_cut(dev):
    """18c: PHOLD at OBS_CUT_HOSTS hosts on MIX_VERTICES with the three
    settings, the hosts' CPU speeds cycling over OBS_CUT_FREQS."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.bench import MIX_VERTICES
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(
        num_hosts=OBS_CUT_HOSTS, tcp=False, seed=1,
        end_time=int(OBS_CUT_STOP * 1e9), event_capacity=32,
        outbox_capacity=32, router_ring=32, in_ring=16, pcap=True,
        track_paths=True, cpu_threshold_ns=0, cpu_precision_ns=10_000)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0,
                      cpufrequency_khz=OBS_CUT_FREQS[i % 4])
             for i in range(OBS_CUT_HOSTS)]
    cb = build(cfg, MIX_VERTICES, hosts, device=dev)
    cb.sim = phold.setup(cb.sim, load=OBS_LOAD)
    return cb, (phold.handler,)


def _obs_tcp_twin(dev):
    """18c: 14b's TCP example twin with logpcap on the server."""
    from shadow_tpu_torch.config.examples import example_config
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config

    text = example_config(clients=CLI_EX_CLIENTS, kib=CLI_EX_KIB,
                          stoptime=CLI_TWIN_STOP).replace(
        '<host id="server"', '<host id="server" logpcap="true"')
    tl = load(parse_config(text), seed=CLI_EX_SEED, device=dev)
    return tl.bundle, tl.handlers


def _obs_twin(make, directory, dev):
    """An 18c run: make(dev)'s bundle through run_windows with a pcap
    drain every window into `directory`. Returns (EngineStats dict,
    sim, obs_counts, wall s)."""
    from shadow_tpu_torch.utils.checkpoint import run_windows
    from shadow_tpu_torch.utils.pcap import CaptureSession

    cb, handlers = make(dev)
    c = CaptureSession(cb, directory)
    t0 = time.perf_counter()
    sim, stats, _ = run_windows(cb, app_handlers=handlers,
                                on_window=lambda s, w: c.drain(s),
                                device=dev)
    c.drain(sim)
    c.close()
    return (stats.as_dict(), sim, obs_counts(sim, stats, c, directory),
            time.perf_counter() - t0)


def _obs_twin_cpu(make, directory):
    """_obs_twin on the CPU, in the worker: the leaves as numpy."""
    from shadow_tpu_torch import convert

    st, sim, got, wall = _obs_twin(make, directory, "cpu")
    return st, convert.sim_to_numpy(sim), got, wall


def obs_cell(device):
    """Phase 18: the netstack's observability settings at full width
    and native/. Returns (row fields, max abs err of mailbox_gather on
    18b's route)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="shadow_obs_") as tmp:
        return _obs_cell(device, tmp)


def _obs_cell(device, tmp):
    import io
    import os
    from pathlib import Path

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch import convert, native
    from shadow_tpu_torch.compile import specialize
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.utils.checkpoint import run_windows
    from shadow_tpu_torch.utils.pcap import CaptureSession
    from shadow_tpu_torch.utils.shadowlog import LogLevel, SimLogger

    out = {}
    # ---- native/: built from this checkout's sources, and used -------
    lib = native.require()
    path = Path(native.library_path()).resolve()
    build_dir = (Path(__file__).resolve().parent / "shadow_tpu_torch"
                 / "_build")
    if path.parent != build_dir or not path.name.startswith(
            "libshadow_native-"):
        raise AssertionError(f"18: native library loaded from {path}, not "
                             f"built into {build_dir}")
    lg = SimLogger(level=LogLevel.INFO, stream=io.StringIO(),
                   require_native=True)
    for i in range(4_096):
        lg.info((i * 7919) % 1000, "h", "x")
    lg.flush()
    if lg.native_sorts != 1:
        raise AssertionError("18: a 4,096-record flush did not go "
                             "through logsort_argsort")
    log(f"  18: native library {path.name} built from "
        f"shadow_tpu_torch/native/src into _build/ and loaded ({lib}); a "
        f"4,096-record log flush sorted by logsort_argsort")

    # ---- 18a: the CLI as a user runs it, beside 18c ------------------
    cli = start_cli("obs-cpu-10k", obs_xml(OBS_HOSTS, OBS_CLI_STOP), tmp,
                    "-l", "info", *OBS_FLAGS)
    try:
        # ---- 18c: CUDA against CPU at the cuts (not timed) -----------
        for label, make, expect in (
                (f"18c PHOLD at {OBS_CUT_HOSTS} hosts, 4 CPU speeds, "
                 f"{OBS_CUT_STOP} sim-s", _obs_udp_cut, OBS_CUT_EXPECT),
                (f"18c the TCP example twin with logpcap, {CLI_TWIN_STOP} "
                 f"sim-s", _obs_tcp_twin, OBS_TCP_EXPECT)):
            d = os.path.join(tmp, f"{make.__name__}-")
            fut = in_worker(_obs_twin_cpu, make, d + "cpu")
            st, sim, got, wall = _obs_twin(make, d + "cuda", "cuda")
            log(f"  {label} cuda: {st} in {wall:.2f} s")
            cst, cleaves, cgot, cwall = fut.result(timeout=900)
            log(f"  {label} cpu: {cst} in {cwall:.2f} s")
            n = assert_same_leaves(label, (st, convert.sim_to_numpy(sim)),
                                   (cst, cleaves))
            if got != cgot:
                raise AssertionError(f"{label}: cuda {got} != cpu {cgot}")
            check_obs(label, got, expect)
            log(f"  {label}: cuda == cpu, EngineStats and all {n} leaves "
                f"equal, pcap files byte-equal")
        report, wall, lines = finish_cli(cli)
    finally:
        stop_proc(cli)
    check_report("obs-cpu-10k", report, OBS_CLI_REPORT)
    paths = [[0] * 3 for _ in range(3)]
    for ln in lines:
        if "] path " in ln:
            a, c = ln.split("] path ")[1].split(":")[0].split("->")
            paths[int(a)][int(c)] = int(ln.rsplit(" ", 2)[1])
    if paths != OBS_CLI_PATHS:
        raise AssertionError(f"obs-cpu-10k: path lines {paths} != the "
                             f"reference's {OBS_CLI_PATHS}")
    if any("pcap ring overran" in ln for ln in lines):
        raise AssertionError("obs-cpu-10k: the capture ring overran")
    if len(lines) != OBS_LOG_LINES:
        raise AssertionError(f"obs-cpu-10k: {len(lines)} lines, the "
                             f"reference's CLI prints {OBS_LOG_LINES}")
    digest = pcap_digest(os.path.join(tmp, "obs-cpu-10k.data"))
    if digest != OBS_CLI_PCAP:
        raise AssertionError(f"obs-cpu-10k: pcap files {digest} != the "
                             f"reference's {OBS_CLI_PCAP}")
    log(f"  obs-cpu-10k: the reference's 9 path counts, {len(lines)} log "
        f"lines (one flush past 4,096 records: the native argsort), pcap "
        f"files as the reference's {digest}, in {wall:.1f} s")
    out["obs_cli_wall_s"] = round(wall, 1)

    # ---- 18b: the same bundle in-process ------------------------------
    loaded = load(parse_config(obs_xml(OBS_HOSTS, OBS_STOP)), seed=1,
                  overrides=dict(OBS_OVERRIDES), device=device)
    b = loaded.bundle
    b = specialize.apply(b, loaded.handlers, app_bulk=b.app_bulk)
    cap = CaptureSession(b, os.path.join(tmp, "obs-18b"))
    drain_s, drained, copied, marks, steps = [], [], [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(s, wend):
        k = len(marks) // 2      # this hook follows window k
        if k == OBS_PROFILE_WINDOW:
            prof.stop()
        marks.append(time.perf_counter())
        torch.cuda.synchronize()
        c0, t0 = cap.bytes_copied, time.perf_counter()
        drained.append(cap.drain(s))
        drain_s.append(time.perf_counter() - t0)
        copied.append(cap.bytes_copied - c0)
        if k == OBS_PROFILE_WINDOW - 1:
            prof.start()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    mailbox_gather.launches = 0
    t0 = time.perf_counter()
    with KeepGatherInputs() as gathered:
        sim, stats, _ = run_windows(
            b, app_handlers=loaded.handlers, on_window=hook,
            on_round=lambda s, st, *_: steps.append(int(st.micro_steps)),
            device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mailbox_gather.launches
    tail = cap.drain(sim)
    cap.close()
    got = obs_counts(sim, stats, cap, cap.dir)
    if sum(drained) + tail != got["records"]:
        raise AssertionError(f"18b: drained {sum(drained)} + {tail} of "
                             f"{got['records']} records")
    check_obs("18b", got, {"stats": OBS_EXPECT, "blocked":
                           OBS_CPU["blocked"], "delay_ns":
                           OBS_CPU["delay_ns"], "paths": OBS_PATHS,
                           **OBS_PCAP})
    if int(sim.net.ctr_events_exec.sum()) != OBS_EXPECT["events_processed"]:
        raise AssertionError("18b: ctr_events_exec does not sum to the "
                             "executed events")
    if int(sim.app.rcvd.sum()) != OBS_APP_RCVD:
        raise AssertionError(f"18b: app.rcvd sums to "
                             f"{int(sim.app.rcvd.sum())}, the reference's "
                             f"to {OBS_APP_RCVD}")
    windows = int(stats.as_dict()["windows"])
    if not 0 < launches <= windows:
        raise AssertionError(f"18b: mailbox_gather launched {launches} "
                             f"times in {windows} windows")
    err = gathered.check("18b")
    gather = time_gather("18b", gathered.kept)
    events = raw_events(prof)
    busy_ms = device_busy_us(events) / 1e3
    p_launch = host_launches(events)
    p_sync = sum(1 for e in events if e.device_type == DeviceType.CPU
                 and e.name == "cudaStreamSynchronize")
    # a window's wall: from the end of one drain to the next hook (the
    # drain excluded); with its drain: from one hook to the next
    win_ms = [(marks[2 * k + 2] - marks[2 * k + 1]) * 1e3
              for k in range(windows - 1)]
    hook_ms = [(marks[2 * k + 2] - marks[2 * k]) * 1e3
               for k in range(windows - 1)]
    keep = [k for k in range(windows - 1)
            if k > 0 and k != OBS_PROFILE_WINDOW - 1]
    d_ms = [x * 1e3 for x in drain_s]
    st = stats.as_dict()
    obs = {"wall_s": round(wall, 3),
           "ms_per_window": round(statistics.mean(
               win_ms[k] for k in keep), 3),
           "ms_per_window_with_drain": round(statistics.mean(
               hook_ms[k] for k in keep), 3),
           "micro_steps_per_window": round(
               st["micro_steps"] / st["windows"], 2),
           "drain_ms_per_window": round(statistics.mean(d_ms), 3),
           "drain_share": round(sum(drain_s) / wall, 4),
           "records_per_s_drained": round(sum(drained) / sum(drain_s), 1),
           "bytes_copied_per_window": round(sum(copied) / windows, 1),
           "profiled_window": {
               "window": OBS_PROFILE_WINDOW,
               "micro_steps": steps[OBS_PROFILE_WINDOW],
               "ms": round(win_ms[OBS_PROFILE_WINDOW - 1], 3),
               "launches": p_launch, "syncs": p_sync,
               "busy_ms": round(busy_ms, 3)}}
    log(f"  18b: run_windows with a drain every window: {wall:.2f} s, "
        f"{obs['ms_per_window']:.1f} ms a window after window 0 (the "
        f"profiled window excluded) and its drain on top, "
        f"{obs['ms_per_window_with_drain']:.1f} ms hook to hook; "
        f"{obs['micro_steps_per_window']} micro-steps a window; "
        f"drain {obs['drain_ms_per_window']:.1f} ms a window "
        f"({obs['drain_share'] * 100:.1f}% of 18b's whole run), "
        f"{obs['records_per_s_drained']:.0f} records/s, "
        f"{obs['bytes_copied_per_window']:.0f} bytes copied a window; "
        f"window {OBS_PROFILE_WINDOW} ({steps[OBS_PROFILE_WINDOW]} "
        f"micro-steps) profiled: {p_launch} launches, {p_sync} "
        f"cudaStreamSynchronize, device busy {busy_ms:.2f} ms; "
        f"micro-steps by window {steps}; "
        f"mailbox_gather launched {launches} times in {windows} windows, "
        f"exact on its route")
    out["launches_obs"] = launches
    out["obs"] = obs
    out["obs_gather"] = {k: gather[k] for k in (
        "n", "ms", "plain_ms", "bound_ms", "library_ms")}
    del sim, b, loaded, prof, events

    torch.cuda.synchronize()
    return out, err


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

    start_twins()
    try:
        return run_phases(args, bench, insert_kernels)
    finally:
        stop_twins()


def run_phases(args, bench, insert_kernels) -> int:
    """Phases 1-18 and the result lines (main starts and stops the CPU
    halves' worker around them)."""
    import torch

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
    start_cards()
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
    # the --test example's route (phase 14): 1,001 hosts, P = 22, the
    # narrow tier's 24 columns, and the full outbox of 4,096
    cli_h = CLI_1K_CLIENTS + 1
    cli_row, _ = check_mailbox_gather(device, P=22, H=cli_h,
                                      main_n=cli_h * 24,
                                      also=[(cli_h, cli_h * 4096)])
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    row["max_abs_err"] = max(row["max_abs_err"], tcp_row["max_abs_err"],
                             tor_row["max_abs_err"], cli_row["max_abs_err"])
    row["p22"] = {k: tcp_row[k] for k in keys}
    row["p22_tor"] = {k: tor_row[k] for k in keys}
    row["p22_cli"] = {k: cli_row[k] for k in keys}

    phase("4")
    log(f"[4] main path: bench.py's default PHOLD, {HOSTS} hosts load "
        f"{LOAD} {SIM_S} sim-s, bulk pass, sparse default, ring")
    launches, *main4 = run_main_path(device)
    row["launches"] = launches["mailbox_gather"]

    if args.profile:
        phase("4p")
        log("[4p] profile")
        profile_windows(device, (row["ms"], warm_ms))

    phase("4a")
    log(f"[4a] the serial path: no bulk, sparse_lanes=0, no ring, "
        f"{PATH_SIM_S} sim-s")
    run_serial_path(device)

    phase("4b")
    log(f"[4b] bulk pass: cube and sort order forms, {PATH_SIM_S} sim-s")
    compare_order_forms(device)

    phase("4c")
    log(f"[4c] sparse shape: 64 of 10,240 hosts active, {PATH_SIM_S} "
        f"sim-s")
    compare_sparse_shape(device)

    phase("5")
    log("[5] CUDA against CPU inside the port")
    t0 = time.perf_counter()
    relays = [
        relay_twin("relay 2x5 hops + ring", 10, 5, RELAY_SMALL_BYTES,
                   RELAY_SMALL_SIM_S),
        relay_twin("relay 2x2 hops 1% loss", 4, 2, 25_000,
                   RELAY_SMALL_LOSSY_SIM_S, loss=0.01, ring=False),
        relay_twin("relay 2x5 hops + ring, TCP bulk", 10, 5,
                   RELAY_SMALL_BYTES, RELAY_SMALL_SIM_S, tcp_bulk=True),
        relay_twin("relay 2x2 hops 1% loss, TCP bulk lossless", 4, 2,
                   25_000, RELAY_SMALL_LOSSY_SIM_S, loss=0.01,
                   tcp_bulk=True, lossless=True)]
    started = [
        phold_twin("serial", 64, 4, 1.0),
        phold_twin("bulk + ring", 64, 4, 1.0, bulk=True, ring=True),
        phold_twin("sparse", 64, 2, 1.0, sparse_lanes=16, active_hosts=4)]
    for h in started:
        twin_finish(h)
    for h in relays:
        check_relay_twin(h)
    log(f"  the seven configs took {time.perf_counter() - t0:.1f} s "
        f"({CARD_WORKERS} card and {CPU_WORKERS} CPU workers)")

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

    del relay
    phase("6s")
    log(f"[6s] the same cell serial (scale_run's --no-bulk) and with the "
        f"TCP bulk pass, both cut to {RELAY_SERIAL_SIM_S} sim-s")
    twin = relay_cell("relay to the serial depth", device, RELAY_HOP,
                      RELAY_BYTES, RELAY_SERIAL_SIM_S, complete=False)
    serial = relay_cell("relay serial", device, RELAY_HOP, RELAY_BYTES,
                        RELAY_SERIAL_SIM_S, tcp_bulk=False, complete=False)
    row["launches_relay_serial"] = serial[2]["mailbox_gather"]
    if serial[1]["micro_steps"] <= twin[1]["micro_steps"]:
        raise AssertionError("relay serial: no more micro-steps than the "
                             "TCP bulk pass left by the cut depth")
    assert_contract("relay 6s twins", twin[:2], serial[:2])
    relay6s = (twin[0], twin[1], twin[5])   # phase 17d trims this twin
    del twin, serial

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
    if serial[3] <= 0 or serial[4] <= 0:
        raise AssertionError("lossy relay serial: no segment was "
                             "retransmitted or no fast recovery entered "
                             "by the cut depth")
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

    phase("14")
    log("[14] the CLI and reference-format configs: python -m "
        "shadow_tpu_torch.cli on the --test example and the reference's "
        "configs")
    got, err = cli_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(got)

    phase("15")
    log(f"[15] open-system injection: bench.py's BENCH_INJECT_RATE="
        f"{INJ_RATE} scenario ({INJ_HOSTS} hosts, {INJ_SIM_S} sim-s) "
        f"through the bench, run_supervised and run_windows (K = 1, "
        f"{INJ_CHUNK}); a stop at {INJ_STOP_S} sim-s and resume; a "
        f"<traffic> config through the CLI")
    got, err = inject_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(got)

    phase("16")
    log(f"[16] lane isolation and the recorders: bench.py's BENCH_REPLICAS="
        f"{LANE_R} BENCH_LANE_ISOLATION=1 BENCH_FLOW_SAMPLE={LANE_SAMPLE} "
        f"BENCH_CAUSALITY={LANE_SAMPLE} row ({LANE_R} x {HOSTS} hosts, "
        f"{SIM_S} sim-s); the recorders off, R = 1, a flooded lane and its "
        f"lane surgery to {LANE_SIDE_S} sim-s; the cuts against the "
        f"reference's counts; the CLI's lane and recorder flags")
    got, err = lanes_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    gather = got.pop("lanes_gather")
    row["x4_lanes"] = {k: gather[k] for k in (
        "n", "ms", "plain_ms", "bound_ms", "library_ms")}
    row.update(got)
    if args.profile:
        phase("16p")
        log("[16p] the 4-lane program's hooks, profiled")
        profile_lane_hooks(device)

    phase("17")
    log(f"[17] the capability-trimmed programs: phase 4's PHOLD ({HOSTS} "
        f"hosts, {SIM_S} sim-s) through specialize.apply against phase 4's "
        f"run; bench.py's BENCH_SPECIALIZE=1 row; the guard on a halved "
        f"table and a planted TIMER to {SPEC_TAMPER_S} sim-s; 6s's relay "
        f"bulk twin trimmed to {RELAY_SERIAL_SIM_S} sim-s")
    got, err, gather = spec_cell(device, main4, relay6s)
    del main4, relay6s
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["spec"] = {k: gather[k] for k in (
        "n", "ms", "plain_ms", "bound_ms", "library_ms")}
    row.update(got)

    phase("18")
    log(f"[18] the netstack's observability settings and native/: "
        f"python -m shadow_tpu_torch.cli on PHOLD at {OBS_HOSTS} hosts on "
        f"MIX_VERTICES, every host logpcap, {' '.join(OBS_FLAGS)}, to "
        f"{OBS_CLI_STOP} sim-s; the same bundle in-process with a drain "
        f"every window to {OBS_STOP} sim-s; CUDA against CPU at "
        f"{OBS_CUT_HOSTS} hosts and on the TCP example twin")
    got, err = obs_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(got)
    obs = got["obs"]
    log(f"  phase 18 profile on {smi}: {obs['ms_per_window']} ms a window "
        f"and a drain of {obs['drain_ms_per_window']} ms on top "
        f"({obs['ms_per_window_with_drain']} ms hook to hook), "
        f"{obs['micro_steps_per_window']} micro-steps a window; the "
        f"drains {obs['drain_share'] * 100:.1f}% of 18b's whole run")

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
