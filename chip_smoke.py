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
   reference's pinned counts. 18a's subprocess starts at phase 14,
   beside the other untimed side work, and is checked with 19c-19d's
   CLIs at 19's end; 18b runs first in 18, then 18c, and phase 19's
   untimed work starts there.
19. virtual processes (process/vproc.py ProcessRuntime): (19a) 1,000
   coroutines, tests/test_vproc_scale.py's run at its full width and
   depth (500 UDP pairs, 3 rounds of 64-B sendto/recvfrom, the
   one-vertex 50 ms graph, 30 sim-s): the reference's counts (6,000
   events, 12 windows, 12 micro-steps, 20,000 syscalls, 16 device
   dispatches, 1,500 pongs, zero overflow) and the digest of every
   final leaf, CUDA against CPU leaf by leaf, mailbox_gather launched
   once for each non-empty window and exact against its plain version
   on the run's own route (and timed there), with ms a window,
   syscalls/s and dispatches a window; (19b) the same hosts as 500 TCP
   pairs, each client sending 16 KiB of content that its server reads
   to EOF: the reference's counts (17,500 events, 16 windows, 31
   micro-steps, 16,000 syscalls, 1,011 dispatches) and leaf digest, all
   500 streams sha256-equal, CUDA against CPU, the payload pool empty
   after gc_pool; (19c) the reference's 13 reftests syscall plugins
   from small configs and tests/test_py_plugins.py's .py plugin through
   `python -m shadow_tpu_torch.cli --platform gpu`, each exit 0 with
   the reference CLI's report; (19d) `--host-kernel diff` on hostrun's
   tgen dual workload (tgen_main as a .py plugin) and the epoll
   reftests config: exit 0, the traces agree, the manifest's
   conformance block. 19c-19d's sixteen subprocesses (at a lower CPU
   priority; the two stream-hinted configs at phase 14, the others
   beside 18c) and 19b's CPU half (beside 18c) run on beside 19a and
   19b's card half.
20. the sharded window loop (parallel/shard.py) on the one card:
   (20a) `BENCH_SHARDS=4 BENCH_SIM_SECONDS=1 BENCH_SENTINEL=1
   BENCH_SENTINEL_OVERHEAD=1 python -m shadow_tpu_torch.bench` — phase
   4's program at 10,240 hosts as four gloo ranks of the card, 2,560
   rows each — with mailbox_gather's inputs kept on rank 0; its A/B
   twin without the sentinel is BENCH_SHARDS's own run, 20a: the
   EngineStats equal to the single-shard run of the same input on the
   card (micro-steps summed over the ranks, as the reference sums them)
   and the digest of every final leaf but the per-shard-count ones
   equal, narrow hit + miss == windows, mailbox_gather launched once on
   every rank's non-empty routes and exact against its plain version
   on rank 0's own receive streams (and timed there, five times against
   index_select), with the events/s, ms a window and the collectives'
   ms a window; (20b) the CLI with `--workers 2` on 14b's
   cli-phold-ref: on one card the reference's rule narrows it to 1 with
   its warning, the report the reference's; (20c) faults.run_supervised
   on a mesh of 2 ranks with the degraded plan on 13a's program cut to
   1.2 sim-s: ok, its final state and EngineStats equal to the serial
   supervised run's. 20b and 20c start beside phases 14-19; their
   checks, 20c's serial run and 20a's single-shard run go while the
   bench's ranks start up, before its timed calls.
21. elastic degraded-mesh recovery (parallel/elastic.py and the
   supervisor's ladder) on the one card: (21a) the timed run of 20's
   bench row, with the integrity sentinel: the state equal to the
   single-shard run (the sentinel's leaves aside), the sentinel's 21
   checks, no trip, verified through the run's last window end, one
   more collective a window than 20a, sentinel_overhead_pct reported;
   (21b) run_supervised(elastic=ElasticPolicy()) on 4 ranks on 13a's
   program with the sentinel, cut to 1.2 sim-s, two consecutive
   dispatches poisoned (make_poisoned_dispatch): the ladder retry then
   shrink to 2, resumed from the last verified snapshot replanned by
   replan_shards; (21c) on 2 ranks, rank 1's replica of the latency
   table diverging from 0.6 s (make_divergence_fault_fn): the sentinel
   latches shard 1 at the first window end past it, the ladder retry
   then the serial rung on the card; (21d) on 4 ranks, rank 3 SIGKILLs
   its own process at a dispatch: the survivors classify the loss
   (the seconds from the kill reported), meet again and shrink to 2 —
   21b-21d each ending with the final state and EngineStats (but
   micro-steps) of 20c's serial run, each elastic block and run
   manifest accepted by tools/telemetry_lint.py; (21e) 19a's 1,000
   processes through ProcessRuntime on 2 ranks: its counts and net-leaf
   digest, mailbox_gather on each rank's non-empty routes. 21b-21e run
   in one spawn of 4 ranks started beside phases 14-19.
22. warm-start serving and the scenario fleet: (22a) `BENCH_WARM=1
   python -m shadow_tpu_torch.bench` at full width on a fresh checkout's
   empty build root and program store (SHADOW_BUILD_DIR,
   SHADOW_AOT_DIR): a miss that builds (nvcc, g++) and stores; then
   three processes at once on the kept build root: a hit that loads the
   build root's libraries by their sha256, the same bench with the
   store off, and, on a copy of the store whose <key>.bin has a flipped
   byte, a miss that stores again — no library built after the first,
   each with phase 4's counts and its cold start taken apart
   (interpreter, import torch, CUDA context, libraries, first and steady
   window); (22b) `python -m shadow_tpu_torch.cli fleet run --workers 2`
   on five scenario jobs of 10,240 hosts (load 8, 1 sim-s; seeds 1-3,
   one with the JobSpec docstring's loss record, one undersized with
   auto_grow), a worker SIGKILLed after its job's first checkpoint
   heartbeat: every job's digest equal to the same spec run by
   scenario.run_job on the card, `fleet status` all done,
   tools/telemetry_lint.py clean, a store hit among the jobs, the killed
   job requeued at the same attempt; (22c) `BENCH_RESIDENT=4
   BENCH_SIM_SECONDS=1` at 10,240 hosts a tenant (65,536 rows), alone,
   its warm-up trial cut to one tenant and 0.2 sim-s:
   program_key_stable, 0 retraces, the lane digests of the tenants not
   evicted equal to an undisturbed run's, mailbox_gather launched once
   a non-empty window of both trials, exact on the resident route and
   timed there. 22b and 22c's undisturbed run go in one process started
   beside phases 16-21.
23. the counterfactual sweep, sharded fleet jobs and profiles: (23a)
   `BENCH_SWEEP=1 BENCH_SIM_SECONDS=1 python -m shadow_tpu_torch.bench`
   alone — bench.py's lattice (seed {1, 2} x load {8, 9} x
   event_capacity {24, 32}: 8 points, 2 programs) at 10,240 hosts
   through the port's sweep driver on 2 workers sharing the card, a
   warm-up sweep and the scored one on a fresh dir — both exit 0, the
   lattice conserved, the scored sweep's prewarm hit rate 1.0, every
   point's events and digest, and its mailbox_gather launches, equal to
   the serial oracle (scenario.run_job of each point in process on the
   card, the first point's route held against the kernel's plain version
   and timed there), the ranking and best point the oracle's, its
   points/s; (23b) the lattice's load-8 row (2 points) through `sweep
   run` on one worker, SIGKILLed (its process group) after its first
   completed point, then `--resume`: the completed point leased once,
   every point done once, the ranking byte for byte the one reduce.rank
   gives the oracle's points, each digest the oracle's; (23c) 23a's
   first point as a `shards = 2` job through `fleet run`: on one card a
   lease of 1 (device_lease {requested 2, leased 1}) and the oracle's
   digest, on two or more 2 NCCL ranks with rank 1 SIGKILLed after the
   first snapshot and the oracle's width_digest; the manifest accepted
   by tools/telemetry_lint.py; (23d) `python -m shadow_tpu_torch.cli
   --profile-dir` on 14b's cli-phold-ref (its report, the manifest's
   lint-clean profile block, CUDA kernel events in the trace) and
   `BENCH_SIM_SECONDS=1 python -m shadow_tpu_torch.bench` without and
   with BENCH_PROFILE_DIR (equal counts on the two rows, the profile
   block, CUDA kernel events in the extra call's trace); a missing
   capture fails the phase. The oracle and 23c, and 23b and 23d, go in
   two processes started beside phases 14-21; 23a runs alone after 22.
24. the tools twins (shadow_tpu_torch/tools/): (24a) `python -m
   shadow_tpu_torch.tools.scale_run --workload phold --hosts 102400
   --sim-seconds 2` (parse_args and run in this process, alone after
   23): the row verified, zero overflow, platform "cuda", PHOLD
   conservation (sent == H*load + rcvd) on the timed run's state, its
   events/s, wall, device bytes and the escalation's final capacity;
   mailbox_gather launched once a routed window of the warm-up and
   timed runs, exact against its plain version on the run's own route
   (n = 2,457,600 rows at P = 11) and timed there; (24b) every
   chaos_soak mode once at its tier-1 CPU test's size through the twin's
   main on the card — `--seed 2 --kills 2 --verify`, `--replicas 4`,
   `--device-loss --shards 4` (4 gloo ranks of the card), `--churn`,
   `--sweep --workers 2` and `--jobs 2` (chaos_trial fleet jobs) —
   every report ok and equal to the CPU's; (24c) compcache_ctl
   `prewarm --test` (trimmed, then full), `ls`, `stats`, `gc` down to
   one entry, and `prewarm --sweep` on a 4-point, 2-program spec, cold
   (2 built, 0 hits) then warm (0 built, 2 hits, the same keys; the
   census's affinity keys the reference's). 24b and 24c go in one
   process started at phase 14 at a lower CPU priority.

Phases 7, 8, 10 and 11 each replay one window through the engine's own
core.engine.step_window, from the state the run held at its start
(micro-steps timed one by one through a step_fn shim, then the first
again under torch.profiler: launches and cudaStreamSynchronize per
micro-step). The CPU halves of the CUDA-against-CPU comparisons
(phases 5, 9, 13b, 14b-c, 15c, 16c, 18c, 19a-b) run in two spawned
CPU worker processes, at the same time as their CUDA halves; phases 5
and 9, which read no launch counter, run their CUDA halves in three
spawned card workers, all of a phase's runs at once, and 13a's
chunked, supervised and stop-and-resume runs and 15's K = 16 run and
15b go there too, beside the rest of their phases. The CLI runs that
only counts, logs and files check run beside untimed work (phase 14's
three together, 15c's beside 15b, 16d's beside 16b-16c, 18a's beside
14-19, 19c-19d's beside 18c and 19a-19b, their two long reftests
configs beside 14-19). The side processes started at 14 (20b-21e,
23's, 24b-24c, 18a and 19c's long CLIs) share the card with the kernel
timings and timed rows of phases 14-23.
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

# Phase 19: virtual processes (process/vproc.py). 19a is
# tests/test_vproc_scale.py's run at its full width and depth: 1,000
# hosts, 500 UDP client/server pairs, 3 rounds of 64-B sendto/recvfrom,
# the one-vertex 50 ms graph, tcp=False, 2 sockets, capacities 8, 30
# sim-s. 19b the same hosts as 500 TCP pairs: each client send_data's
# 16 KiB of tests/test_payload.py's pattern, its server recv_data's to
# EOF (4 sockets, capacities 64). The counts and the combined digest of
# every final leaf (leaf_digest) are the reference's CPU run of the same
# coroutines.
VP_HOSTS = 1_000
VP_PORT = 9000
VP_ROUNDS = 3
VP_SIM_S = 30
VP_UDP_EXPECT = {"events_processed": 6_000, "micro_steps": 12,
                 "windows": 12, "syscalls": 20_000, "dispatches": 16,
                 "pongs": 1_500, "overflow": 0}
VP_UDP_LEAVES = "4198a706c3d3473a"
VP_TCP_BYTES = 16_384
VP_TCP_EXPECT = {"events_processed": 17_500, "micro_steps": 31,
                 "windows": 16, "syscalls": 16_000, "dispatches": 1_011,
                 "streams_ok": 500, "overflow": 0}
VP_TCP_LEAVES = "52dbe09c457dc11f"
# 19c: the reference's 13 reftests syscall plugins, each from a small
# config (tests/torch_vproc_parity.py REFTESTS) over the example's
# one-vertex graph to 30 sim-s, and tests/test_py_plugins.py's .py
# plugin echo config: the reference CLI's CPU reports
_VP_ONE = '<host id="testnode"><process plugin="p" starttime="1"/></host>'
VP_REFTESTS = {
    "testbind": _VP_ONE,
    "libshadow-plugin-test-epoll.so": _VP_ONE,
    "test_epoll_writeable": (
        '<host id="testnode"><process plugin="p" starttime="1" '
        'arguments="server"/></host>\n  <host id="client"><process '
        'plugin="p" starttime="2" arguments="client testnode"/></host>'),
    "testpoll": _VP_ONE,
    "libshadow-plugin-test-sockbuf.so": _VP_ONE,
    "testtimerfd": _VP_ONE,
    "libshadow-plugin-test-sleep.so": _VP_ONE,
    "testshutdown": (
        '<host id="testnode"><process plugin="p" starttime="1"/></host>\n'
        '  <host id="other"><process plugin="p" starttime="2"/></host>'),
    "libshadow-plugin-test-file.so": _VP_ONE,
    "testrandom": _VP_ONE,
    "testsignal": _VP_ONE,
    "libshadow-plugin-test-pthreads.so": _VP_ONE,
    "test-unistd": ('<host id="testnode"><process plugin="p" starttime="1" '
                    'arguments="x testnode"/></host>'),
}
# (events, windows) of each config's report, overflow 0
# the reftests configs whose CLI runs longest (the TCP stream ones),
# started at phase 14 with the other side work
VP_LONG = ("test_epoll_writeable", "testshutdown")
# the untimed CLI runs yield the CPU to the timed phases and 19b
VP_NICE = 10
VP_REFTESTS_REPORTS = {
    "testbind": (1, 1),
    "libshadow-plugin-test-epoll.so": (4, 4),
    "test_epoll_writeable": (582, 29),
    "testpoll": (2, 2),
    "libshadow-plugin-test-sockbuf.so": (1, 1),
    "testtimerfd": (4, 4),
    "libshadow-plugin-test-sleep.so": (1, 1),
    "testshutdown": (42, 11),
    "libshadow-plugin-test-file.so": (1, 1),
    "testrandom": (1, 1),
    "testsignal": (1, 1),
    "libshadow-plugin-test-pthreads.so": (1, 1),
    "test-unistd": (1, 1),
}
VP_PY_REPORT = {"events": 14, "windows": 12, "sim_seconds": 20.0,
                "overflow": 0}
# tests/test_py_plugins.py's plugin, config and graph, for the port
VP_PY_PLUGIN = """from shadow_tpu_torch.process import vproc
from shadow_tpu_torch.net.state import SocketType

PORT = 6161


def main(env):
    if env["args"][0] == "server":
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, PORT)
        for _ in range(int(env["args"][1])):
            ip, port, n = yield vproc.recvfrom(fd)
            yield vproc.sendto(fd, ip, port, n)
        yield vproc.close(fd)
    else:
        server_ip = env["resolve"](env["args"][1])
        count = int(env["args"][2])
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, 0)
        got = 0
        for _ in range(count):
            yield vproc.sendto(fd, server_ip, PORT, 64)
            _ip, _port, n = yield vproc.recvfrom(fd)
            got += 1
        yield vproc.close(fd)
        assert got == count, got
"""
VP_PY_CONFIG = """<shadow stoptime="20">
  <topology path="one.graphml.xml"/>
  <plugin id="echoapp" path="echo_plugin.py"/>
  <host id="pclient">
    <process plugin="echoapp" starttime="1"
      arguments="client pserver 3"/>
  </host>
  <host id="pserver">
    <process plugin="echoapp" starttime="1" arguments="server 3"/>
  </host>
</shadow>
"""
VP_PY_GRAPH = ONE_VERTEX.replace("102400", "10240")
# 19d: --host-kernel diff on hostrun's tgen dual workload (apps/tgen.py
# tgen_main as a .py plugin, hostrun/runner.py's placement and its
# 2-host graph, 10 sim-s) and on the epoll reftests plugin (one of
# FAST_DUAL_WORKLOADS) through the loader
VP_TGEN_PLUGIN = "from shadow_tpu_torch.apps.tgen import tgen_main as main\n"
VP_TGEN_CONFIG = """<shadow stoptime="10">
  <topology path="two.graphml.xml"/>
  <plugin id="tg" path="tgen_dual.py"/>
  <host id="client" typehint="client">
    <process plugin="tg" starttime="1" arguments="client server"/>
  </host>
  <host id="server" typehint="server">
    <process plugin="tg" starttime="0" arguments="server"/>
  </host>
</shadow>
"""

# Phase 20: the sharded window loop on the one card. 20a: the port's
# bench entry point with BENCH_SHARDS (phase 4's program at full width
# as gloo ranks of this card), cut to SHARD_SIM_S; 20c: run_supervised
# on a mesh of SUP_MESH_RANKS ranks with the degraded plan, phase 13a's
# program cut to SUP_MESH_SIM_S (past the first loss record at 1.0 s)
SHARDS = 4
SHARD_SIM_S = 1
SUP_MESH_RANKS = 2
SUP_MESH_SIM_S = 1.2
# phase 21: EL_RANKS ranks; EL_K windows a dispatch and a snapshot every
# 2 EL_K windows (EL_K for 21c); 21b poisons dispatches EL_POISON, 21c
# corrupts rank
# EL_VICTIM's replica from EL_DIVERGE_NS, 21d kills rank 3 at dispatch
# EL_KILL_AT; the elastic meshes' group timeout; 21a's kernel readings
EL_RANKS = 4
EL_K = 8
EL_POISON = (2, 3)
EL_VICTIM = 1
EL_DIVERGE_NS = 600_000_000
EL_KILL_AT = 2
EL_TIMEOUT_S = 20.0
EL_READINGS = 5
# the leaves a shard count changes (the reference's narrow counters;
# the ring's per-shard planes), left out of the state digests
PER_SHARD_LEAVES = (".outbox.narrow_hit", ".outbox.narrow_miss",
                    ".outbox.max_occupied", ".outbox.route_elided",
                    ".telem.micro_steps", ".telem.routed_local",
                    ".telem.routed_cross")

T0 = time.perf_counter()
# simtime.INVALID: an empty event slot
# --- phase 22: warm-start serving and the scenario fleet -----------------
# 22a: a fresh `BENCH_WARM=1 python -m shadow_tpu_torch.bench` process
# on an empty build root and store (a fresh checkout), then three at
# once on the kept build root: a hit, the same bench with the store off,
# and a miss on a copy of the store whose <key>.bin has a flipped byte.
# All at phase 4's depth: the program key holds the end time, so a hit
# needs its miss's depth
# 22b: five scenario jobs at full width (load 8, 1 sim-s) on 2 workers;
# s1 checkpoints every 4 windows and loses its worker to SIGKILL after
# its first checkpoint heartbeat; "loss" carries the JobSpec docstring's
# loss record; "grow" starts undersized with auto_grow
FLEET_WORKERS = 2
FLEET_JOBS = (
    {"id": "s1", "seed": 1, "checkpoint_every_windows": 4},
    {"id": "s2", "seed": 2},
    {"id": "s3", "seed": 3},
    {"id": "loss", "seed": 4, "faults": [{"time_s": 0.3, "kind": "loss",
                                          "a": 0, "b": 0, "value": 0.02}]},
    {"id": "grow", "seed": 5, "event_capacity": 8, "auto_grow": True})
FLEET_KILL = "s1"
# 22c: BENCH_RESIDENT=4 at 10,240 hosts a tenant (4 lanes of the 16,384
# bucket: 65,536 rows), cut to 1 sim-s; its warm-up trial cut to
# RES_WARM_NS and one tenant, the churn at half of it
RES_LANES = 4
RES_SIM_S = 1
RES_WARM_NS = 200_000_000
# --- phase 23: the counterfactual sweep, sharded fleet jobs, profiles ----
# 23a: bench.py's BENCH_SWEEP lattice at full width (seed {1, 2} x load
# {8, 9} x event_capacity {24, 32}: 8 points, 2 programs), cut to 1
# sim-s, on 2 workers; its serial oracle runs beside phases 17-21
SWEEP_SIM_S = 1
# 23b: the lattice's load-8, event-capacity-24 row alone (seed {1, 2}:
# 23a's points p0000 and p0004) on one worker, `sweep run` SIGKILLed
# after its first point and resumed
SWEEP_KILL_POINTS = {"p0000": "p0000", "p0001": "p0004"}
# 23c: 23a's p0000 as a `shards = 2` fleet job
SWEEP_MESH = "p0000"
# --- phase 24: the tools twins -------------------------------------------
# 24a: the scale harness's 100k tier (tools/scale_run.py's PHOLD at
# 102,400 hosts, load 8, 2 sim-s; the timed run on seed 2). The
# reference's CPU run of the same command is a full-size CPU run that
# has not been made, so its events are not pinned (None): PHOLD
# conservation (sent == H*load + rcvd) and zero overflow are the gates
SCALE_ARGV = ("--workload", "phold", "--hosts", "102400", "--sim-seconds",
              "2")
SCALE_HOSTS = 102_400
SCALE_LOAD = 8
SCALE_EVENTS = None
# 24b: each chaos_soak mode once at its tier-1 CPU test's size
# (tests/test_torch_chaos_soak.py), in the tools side process
SOAK_MODES = {
    "trial": ["--trials", "1", "--seed", "2", "--kills", "2", "--verify"],
    "replicas": ["--trials", "1", "--seed", "3", "--replicas", "4",
                 "--hosts", "4", "--load", "2"],
    "device_loss": ["--trials", "1", "--seed", "3", "--device-loss",
                    "--shards", "4"],
    "churn": ["--trials", "1", "--seed", "11", "--churn"],
    "sweep": ["--trials", "1", "--seed", "7", "--sweep", "--workers", "2"],
    "jobs": ["--trials", "2", "--seed", "2", "--kills", "2", "--verify",
             "--jobs", "2"],
}
# the reports the CPU gives for them, each the reference's (the tests
# hold the port to it; the device-loss, churn and sweep trials in the
# slow-marked test_trial_equals_reference_in_process): run_trial at
# seeds 2 and 3, the replica and device-loss trials whole, the fields of
# the churn and sweep trials that carry no path, key or kill timing
SOAK_TRIAL = {
    2: {"seed": 2, "ok": True, "segments": 3, "kills": 2, "escalations": [
        {"time_ns": 0, "latch": "events_overflow", "knob": "event_capacity",
         "from": f, "to": 2 * f} for f in (2, 4, 8)],
        "escalation_restarts": 3, "retries_used": 0, "final_capacities": {
            "event_capacity": 16, "outbox_capacity": 32,
            "router_ring": 32}, "windows_sampled": 21, "events": 178,
        "conservation_errors": [], "run_id": "s2.g3", "resume_of": "s2.g2",
        "verified_bit_identical": True},
    3: {"seed": 3, "ok": True, "segments": 3, "kills": 2, "escalations": [
        {"time_ns": 0, "latch": "events_overflow", "knob": "event_capacity",
         "from": f, "to": 2 * f} for f in (1, 2, 4, 8)],
        "escalation_restarts": 4, "retries_used": 0, "final_capacities": {
            "event_capacity": 16, "outbox_capacity": 32,
            "router_ring": 32}, "windows_sampled": 21, "events": 151,
        "conservation_errors": [], "run_id": "s3.g3", "resume_of": "s3.g2",
        "verified_bit_identical": True}}
SOAK_REPLICA = {"seed": 3, "ok": True, "replicas": 4, "victim": 3,
                "victim_trip": ["events_overflow"], "victim_flushed": 1406,
                "lane_events_exec": [168, 168, 168, 88],
                "containment_errors": []}
SOAK_DEVICE_LOSS = {"seed": 3, "ok": True, "shards": 4, "victim": 3,
                    "kill_at_dispatch": 2, "control_dispatches": 21,
                    "final_shards": 2, "ladder": ["retry", "shrink"],
                    "losses": 2, "verified_through_ns": 1000000001,
                    "device_loss_errors": []}
SOAK_CHURN = {"seed": 11, "ok": True, "tenants": 5, "joins": 6, "leaves": 4,
              "evictions": 2, "program_key_stable": True,
              "population_resumed": {"0": ["t-und-prot", "running", 1],
                                     "1": ["t-und-be", "running", 1],
                                     "2": ["t-churn-b", "running", 2],
                                     "3": ["t-churn-a", "running", 2]},
              "slo_evicted": "t-slo", "lease_warnings": [],
              "churn_errors": []}
SOAK_SWEEP = {"seed": 7, "ok": True, "rounds": 3, "points": {
    "expanded": 4, "completed": 1, "failed": 0, "quarantined": 0,
    "pruned": 3, "pending": 0}, "best": "p0001", "ranking_identical": True,
    "sweep_errors": []}
# 24c: compcache_ctl prewarm --sweep on tests/test_torch_compcache_ctl.py's
# 4-point, 2-program spec; the census's affinity keys (the reference's)
CC_SWEEP_SPEC = {
    "sweep": {"id": "accept", "objective": {"metric": "events",
                                            "goal": "max"},
              "search": {"strategy": "grid"}},
    "fleet": {"max_attempts": 3, "backoff_base_s": 0.0,
              "backoff_cap_s": 0.0},
    "template": {"kind": "scenario", "hosts": 4, "sim_s": 1},
    "axes": [{"field": "seed", "values": [1, 2]},
             {"field": "event_capacity", "values": [24, 48]}]}
CC_AFFINITY = ["akc17727775f45153f", "aked18b60de64eaa58"]
# the tools side's CPU priority below the phases' (a nice increment)
TOOLS_NICE = 19

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
    """A relay bundle through the scale_run twin's builder (--workload
    relay): disjoint `hop`-host circuits [c*hop + k] at capacities
    RELAY_CAP, and telemetry.attach when `ring`. The sparse budget is
    the default. Returns (bundle, circuits)."""
    from shadow_tpu_torch.tools import scale_run

    b = scale_run.build_relay(H, hop, total, sim_s, seed, RELAY_CAP,
                              one_vertex(loss), device, ring=ring)
    return b, b.circuits


def scale_runner(b, device, workload, end_time=None, **kw):
    """`workload`'s runner with the scale_run twin's keywords
    (runner_kwargs: bulk=False is --no-bulk, lossless --bulk-lossless,
    transport --gossip-transport)."""
    from shadow_tpu_torch.net.build import make_runner
    from shadow_tpu_torch.tools import scale_run

    return make_runner(b, end_time=end_time, device=device,
                       **scale_run.runner_kwargs(workload, **kw))


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
    runner = scale_runner(b, device, "relay", bulk=tcp_bulk)
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
    return b, scale_runner(b, dev, "relay", bulk=tcp_bulk,
                          lossless=lossless)


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
    """A gossip bundle through the scale_run twin's builder (--workload
    gossip): UDP (in_ring 32) or, with `tcp`, over persistent TCP peer
    links (`sockets` per host, out_ring 16, PROC_START at 1 s); `k`
    peers, a block every 2 s, `blocks` of them; telemetry.attach when
    `ring`. The sparse budget is the default."""
    from shadow_tpu_torch.tools import scale_run

    return scale_run.build_gossip(H, sim_s, seed, cap, ONE_VERTEX, device,
                                  tcp=tcp, blocks=blocks, peers=k,
                                  sockets=sockets,
                                  emit_capacity=emit_capacity, ring=ring)


def build_tor(H, sim_s, seed, device, ring=True):
    """The shared-relay Tor bundle through the scale_run twin's builder
    (--workload tor: TOR_HOPS-relay circuits drawn by consensus weight,
    TOR_SLOTS slots, out_ring 8) with phase 8's capacities and
    emit_capacity. Returns (bundle, chains)."""
    from shadow_tpu_torch.tools import scale_run

    b = scale_run.build_tor(H, TOR_BYTES, sim_s, seed, TOR_CAP, ONE_VERTEX,
                            device, slots=TOR_SLOTS, emit_capacity=TOR_EMIT,
                            ring=ring)
    return b, b.circuits


def build_mux_small(device, sim_s, loss=0.0):
    """The reference test's mux shape (tests/test_relay_mux.py) through
    the scale_run twin's Tor builder: 10 hosts, 4 two-relay circuits
    over relays 6-8 to server 9 (consensus draw, seed 5), MUX_SLOTS
    slots, 2 + 2*MUX_SLOTS sockets, capacities 64, out_ring 16."""
    import numpy as np

    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.tools import scale_run

    chains = relay.consensus_circuits(
        np.random.default_rng(5), n_circuits=4, clients=list(range(6)),
        relays=[6, 7, 8], servers=[9], hops=2, max_slots=MUX_SLOTS)
    b = scale_run.build_tor(10, MUX_BYTES, sim_s, 1, 64, one_vertex(loss),
                            device, slots=MUX_SLOTS, chains=chains,
                            out_ring=16)
    return b, chains


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
    runner = scale_runner(b, device, "gossip")
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

    kept = state_at_window(
        lambda end: scale_runner(b, device, "gossip", end_time=end),
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
    runner = scale_runner(b, device, "tor")
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
    runner = scale_runner(b, device, "gossip", transport="tcp")
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
        lambda end: scale_runner(b, device, "gossip", end_time=end,
                                 transport="tcp"), b,
        sim.telem, GTCP_KEEP_WINDOW)
    replay_window("gossip tcp", b, gossip.tcp_handler, kept)
    return launches, err


def _mux_twin(bulk, sim_s, dev):
    b, _ = build_mux_small(dev, sim_s)
    return b, scale_runner(b, dev, "tor", bulk=bulk)


def _gossip_twin(tcp, dev):
    if tcp:
        b = build_gossip(8, SMALL_GTCP_SIM_S, seed=3, device=dev, tcp=True,
                         k=3, blocks=3, sockets=10, ring=False)
    else:
        b = build_gossip(64, 5.0, seed=1, device=dev)
    return b, scale_runner(b, dev, "gossip",
                          transport="tcp" if tcp else "udp")


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


def faults_bundle(device, H=HOSTS, sim_s=SIM_S, event_capacity=None,
                  with_plan=True):
    """Phase 13's PHOLD bundle: bench's program with the degraded plan
    installed (`with_plan`) and the bulk pass."""
    import pathlib

    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import phold

    b = build_phold(H, LOAD, sim_s, seed=1, device=device, cap=CAPACITY,
                    sparse_lanes=None, ring=True,
                    event_capacity=event_capacity)
    if with_plan:
        faults.install(b, faults.records_from_json(
            (pathlib.Path(__file__).resolve().parent / FAULT_PLAN)
            .read_text()))
    b.app_bulk = phold.BULK
    return b


def _faults_supervised(b, ckdir, label, lines, processed0=0, stop_past=None,
                       **kw):
    """run_supervised on b with a conserve.sample at every barrier,
    preempted at the first barrier whose window ends past `stop_past`.
    Returns (result, samples); `lines` gains its log."""
    import os

    import torch

    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.faults import conserve

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
        device=b.device, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.health
    lines.append(f"  {label}: ok {res.ok} in {wall:.3f} s, {len(samples)} "
                 f"barriers, {len(res.checkpoints)} snapshots, health "
                 f"fatal {h.fatal} overflow {h.events_overflow}/"
                 f"{h.outbox_overflow}/{h.rq_overflow}")
    if h.fatal or h.events_overflow or h.outbox_overflow or h.rq_overflow:
        raise AssertionError(f"{label}: {h.failure_report()}")
    return res, samples


def _faults_conserved(label, samples, lines):
    from shadow_tpu_torch.faults import conserve

    bad = conserve.check(samples)
    if bad:
        raise AssertionError(f"{label}: conservation: {bad[:3]}")
    lines.append(f"  {label}: conserve.check([] over {len(samples)} "
                 f"barriers)")


def _faults_job(kind, ckdir, dev):
    """One of 13a's runs that phase 13 holds to make_runner's, in a card
    worker beside it: "chunked" (make_chunked_runner, K = FAULT_CHUNK),
    "k1" and "k8" (run_supervised; K = 1 also times a snapshot's save
    and load) or "stop_resume" (a supervised run stopped at the first
    barrier past FAULT_STOP_NS and resumed from its snapshot). Returns
    (label, EngineStats dict, leaves, log lines)."""
    import os

    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.faults import conserve
    from shadow_tpu_torch.net.build import make_chunked_runner
    from shadow_tpu_torch.utils import checkpoint

    b = faults_bundle(dev)
    lines = []
    if kind == "chunked":
        sim, stats = make_chunked_runner(
            b, app_handlers=(phold.handler,), app_bulk=phold.BULK,
            chunk_windows=FAULT_CHUNK, device=dev)(b.sim)
        return (f"make_chunked_runner K={FAULT_CHUNK}", stats.as_dict(),
                convert.sim_to_numpy(sim), lines)
    if kind in ("k1", "k8"):
        k = 1 if kind == "k1" else FAULT_CHUNK
        label = f"run_supervised K={k}"
        res, samples = _faults_supervised(b, ckdir, f"supervised_k{k}",
                                          lines, windows_per_dispatch=k)
        if not res.ok or not res.checkpoints:
            raise AssertionError(f"{label}: ok {res.ok}, snapshots "
                                 f"{res.checkpoints}")
        _faults_conserved(label, samples, lines)
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
            lines.append(f"  faults snapshot at {t_ck} ns: {nbytes} bytes, "
                         f"save {save_s:.3f} s, load {load_s:.3f} s")
        return (label, res.stats.as_dict(), convert.sim_to_numpy(res.sim),
                lines)
    stopped, before = _faults_supervised(b, ckdir, "supervised_stop", lines,
                                         stop_past=FAULT_STOP_NS)
    if not stopped.preempted:
        raise AssertionError("supervised stop: the run was not preempted")
    t_stop = int(stopped.final_checkpoint.rsplit(".", 2)[1])
    resumed, after = _faults_supervised(
        b, ckdir, "supervised_resume", lines,
        processed0=before[-1].processed,
        resume_from=stopped.final_checkpoint)
    _faults_conserved("stop + resume", conserve.stitch(before, after,
                                                       t_stop), lines)
    if resumed.resume_of != stopped.run_id or not resumed.ok:
        raise AssertionError("resume: the chain was not continued")
    lines.append(f"  stopped at {t_stop} ns (the spike is over [2.0, 2.5) "
                 f"s), resumed")
    return ("stop at 2.2 s + resume", resumed.stats.as_dict(),
            convert.sim_to_numpy(resumed.sim), lines)


def faults_cell(device):
    """Phase 13: fault plans, crash and restart, and escalation at full
    width (13a, 13b, 13c; the module docstring). Returns ({"launches_faults",
    "launches_crash", "launches_escalate", "max_abs_err"}, seconds per
    sub-phase)."""
    import os
    import shutil
    import tempfile

    import torch

    from shadow_tpu_torch import convert, faults, telemetry
    from shadow_tpu_torch.apps import phold, pingpong
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.net.build import make_runner
    from shadow_tpu_torch.utils import checkpoint

    out, secs = {}, {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = round(now - mark[0], 1)
        mark[0] = now

    def bundle(H, sim_s=SIM_S, event_capacity=None, with_plan=True):
        return faults_bundle(device, H, sim_s, event_capacity, with_plan)

    # 13a's runs held to make_runner's: in the card workers, beside the
    # rest of the phase
    ckdir = tempfile.mkdtemp(prefix="shadow_faults_")
    jobs = []
    for kind in ("chunked", "k1", "k8", "stop_resume"):
        d = os.path.join(ckdir, kind)
        os.makedirs(d)
        jobs.append(_submit(_CARDS, _faults_job, kind, d, "cuda"))

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
    first = (stats0.as_dict(), convert.sim_to_numpy(sim0))
    drops = int(sim0.net.ctr_drop_reliability.sum())
    clamped = check_record_boundaries("faults make_runner", sim0.telem,
                                      b.fault_plan)
    if drops <= 0:
        raise AssertionError("faults make_runner: the loss flaps dropped "
                             "nothing")
    log(f"  faults make_runner: {stats0.as_dict()['windows']} windows "
        f"({clamped} ending at a record time), reliability drops {drops}")

    fn = faults.fault_fn_for(b)
    t_rec = int(b.fault_plan.t_ns[0])
    fault_replay_cost("faults table replay (warm, before, after the 1.0 s "
                      "record)", fn, b.sim,
                      [b.min_jump, t_rec, t_rec + b.min_jump])
    del b, sim0
    lap("13a_make_runner")

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
    for fut in jobs:
        label, st, leaves, lines = fut.result(timeout=900)
        for line in lines:
            log(line)
        assert_same_leaves(f"faults {label}", first, (st, leaves))
        log(f"  faults {label} (a card worker): == make_runner, every leaf")
    lap("13a_workers")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"  phase 13 seconds per sub-phase {json.dumps(secs)}")
    return out


def small_config(body, stoptime):
    """A reference-format config: `body` over the example's one-vertex
    50 ms graph."""
    from shadow_tpu_torch.config.examples import EXAMPLE_GRAPHML

    return (f'<shadow stoptime="{stoptime}">\n  <topology><![CDATA['
            f'{EXAMPLE_GRAPHML}]]></topology>\n{body}\n</shadow>')


def start_proc(label, cmd, nice=0, env=None):
    """Start `cmd` from the repository root, its output captured; the
    smoke goes on while it runs (finish_proc waits for it, stop_proc
    kills it). Each CLI run that only its counts, logs and files check
    starts so, while the card runs work that is not timed. `nice` lowers
    its CPU priority below the phase's own work. A thread reads its
    output as it comes (a full pipe would hold the command until it is
    collected) and stamps the moment it exits."""
    import shutil
    import subprocess
    import threading
    from pathlib import Path

    if nice and shutil.which("nice"):
        # a prefix, not a preexec_fn: that would fork this process (its
        # whole address space) instead of spawning the command
        cmd = ["nice", "-n", str(nice), *cmd]
    # a session of its own, so stop_proc also ends the processes it
    # starts (a command's ranks)
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)
    t0 = time.perf_counter()
    done = {}

    def drain():
        done["out"] = proc.communicate()
        done["t"] = time.perf_counter()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    return label, cmd, proc, t0, reader, done


def stop_proc(started):
    """Kill a started process that is still running, and every process
    left in its group."""
    import os
    import signal

    proc, reader = started[2], started[4]
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    if proc.poll() is None:
        proc.kill()
    reader.join()


def finish_proc(started):
    """(exit code, stdout, stderr, wall s from its start to its exit) of
    a started process."""
    import subprocess

    cmd, proc, t0, reader, done = started[1:]
    reader.join(timeout=600)
    timed_out = reader.is_alive()
    stop_proc(started)
    if timed_out:
        raise subprocess.TimeoutExpired(cmd, 600)
    stdout, stderr = done["out"]
    return proc.returncode, stdout, stderr, done["t"] - t0


def start_cli(label, text, tmp, *flags, nice=0):
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
        "gpu", "-d", os.path.join(tmp, f"{label}.data"), *flags], nice=nice)


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
    args = cmd[cmd.index("shadow_tpu_torch.cli") + 2:]
    log(f"  {label}: `python -m shadow_tpu_torch.cli {' '.join(args)}` "
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
    """Every leaf of two injection runs (sims or their leaves) equal
    apart from `exclude`, and their live event multisets equal. Returns
    the leaves compared."""
    import numpy as np

    from shadow_tpu_torch import convert

    la, lb = (x if isinstance(x, dict) else convert.sim_to_numpy(x)
              for x in (a, b))
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


def _quiet(fn, *args):
    """fn(*args) in a worker with its log captured: (result, the lines
    it logged), for the main process to log."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = fn(*args)
    return got, [ln.split("] ", 1)[-1] for ln in buf.getvalue().splitlines()]


def _inject_k16(dev):
    """15a's trace through run_windows at K = INJ_CHUNK (a card worker):
    checked against the reference's counts and K = 16's pinned
    partition; (EngineStats dict, leaves)."""
    import torch

    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.utils import checkpoint

    b = build_inject(dev)
    f = timed_feeder(bench.rate_trace(INJ_HOSTS, INJ_RATE, INJ_SIM_S))
    t0 = time.perf_counter()
    sim, stats, _ = checkpoint.run_windows(
        b, (tgen.handler,), feeder=f, windows_per_dispatch=INJ_CHUNK,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_inject(f"inject run_windows (K = {INJ_CHUNK})", sim, stats, f,
                 chunked=True)
    log_run(f"inject run_windows (K = {INJ_CHUNK})", stats, wall)
    return stats.as_dict(), convert.sim_to_numpy(sim)


def _inject_stop_resume(tmp, dev):
    """15b in a card worker: 15a's program through run_supervised
    stopped at the first barrier past INJ_STOP_S and resumed from its
    snapshot with a fresh feeder. Returns (EngineStats dict, leaves,
    the injection block, the stop time, the feeder's cursor)."""
    import os

    from shadow_tpu_torch import bench, convert, faults
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.inject import Feeder, manifest_block
    from shadow_tpu_torch.utils import checkpoint

    os.makedirs(tmp, exist_ok=True)
    b = build_inject(dev)
    sim0 = b.sim
    trace = bench.rate_trace(INJ_HOSTS, INJ_RATE, INJ_SIM_S)
    stop = {"v": False}

    def on_round(sim, ws, wstart, wend, nm):
        stop["v"] = nm >= int(INJ_STOP_S * 1e9)
    first = faults.run_supervised(
        b, (tgen.handler,), checkpoint_path=os.path.join(tmp, "ck"),
        checkpoint_every_windows=1 << 30, feeder=Feeder(list(trace)),
        on_round=on_round, stop=lambda: stop["v"], device=dev)
    if not first.preempted or not first.final_checkpoint:
        raise AssertionError("inject 15b: the run did not stop")
    t_stop = checkpoint.peek_meta(first.final_checkpoint)["time_ns"]
    f2 = Feeder(list(trace))
    b.sim = sim0
    rest = faults.run_supervised(
        b, (tgen.handler,), checkpoint_path=os.path.join(tmp, "ck2"),
        resume_from=first.final_checkpoint, feeder=f2, device=dev)
    if not rest.ok:
        raise AssertionError(f"inject 15b resume: "
                             f"{rest.failure_report()}")
    return (rest.stats.as_dict(), convert.sim_to_numpy(rest.sim),
            manifest_block(rest.sim, f2), t_stop, f2.cursor)


def _inject_cut_run(dev):
    """chunk_cut's run on `dev`: (EngineStats dict, injection block,
    leaves, wall s, trace length)."""
    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.inject import Feeder, manifest_block
    from shadow_tpu_torch.utils import checkpoint

    H, rate, sim_s, lanes = INJ_CUT
    trace = bench.rate_trace(H, rate, sim_s)
    b = bench.build_inject(H, sim_s, 1, 64, lanes, ONE_VERTEX, dev)
    f = Feeder(list(trace))
    t0 = time.perf_counter()
    sim, stats, _ = checkpoint.run_windows(
        b, (tgen.handler,), feeder=f, windows_per_dispatch=INJ_CHUNK,
        device=dev)
    return (stats.as_dict(), manifest_block(sim, f),
            convert.sim_to_numpy(sim), time.perf_counter() - t0, len(trace))


def chunk_cut(device):
    """15a's cut of the cell (INJ_CUT) through run_windows at K =
    INJ_CHUNK on the card and on the CPU (in a CPU worker): the
    reference's counts and every leaf equal between the two."""
    import torch

    fut = in_worker(_inject_cut_run, "cpu")
    got = []
    for dev, res in ((device, None), (torch.device("cpu"), fut)):
        st, blk, leaves, wall, n = (_inject_cut_run(dev) if res is None
                                    else res.result(timeout=900))
        if st != INJ_CUT_EXPECT or (blk["injected"], blk["dropped"],
                                    blk["late"], blk["deferred"]) != (
                n, 0, 0, 0):
            raise AssertionError(f"inject cut {dev.type}: {st} {blk} != "
                                 f"the reference's {INJ_CUT_EXPECT}")
        got.append((st, leaves))
        log(f"  inject cut to {INJ_CUT[0]} hosts, K = {INJ_CHUNK}, "
            f"{dev.type}: the reference's counts {st} in {wall:.2f} s")
    n = assert_same_leaves("inject cut", *got)
    log(f"  inject cut: cuda == cpu, all {n} leaves equal")


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
    # profiled window in it)
    f1 = timed_feeder(list(trace))
    probe = WindowProbe(INJ_PROFILE_WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim1, stats1, _ = checkpoint.run_windows(
        b, (tgen.handler,), sim=sim0, feeder=f1, on_window=probe,
        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_inject("inject run_windows (K = 1)", sim1, stats1, f1)
    log_run("inject run_windows (K = 1)", stats1, wall)
    # not timed from here on: K = 16 and 15b in the card workers, the
    # cut's CPU half in a CPU worker
    k16 = _submit(_CARDS, _quiet, _inject_k16, "cuda")
    stop_resume = _submit(_CARDS, _inject_stop_resume,
                          os.path.join(tmp, "15b"), "cuda")
    n = inject_leaves_equal("inject K = 1 vs supervised", sim1, sup.sim)
    log(f"  inject: run_windows (K = 1) == run_supervised: all {n} leaves")
    chunk_cut(device)
    (st16, leaves16), lines = k16.result(timeout=900)
    for line in lines:
        log(line)
    n = inject_leaves_equal(
        f"inject K = 1 vs K = {INJ_CHUNK}", sim1, leaves16,
        exclude=INJ_SCRATCH | INJ_SLOTS | INJ_PARTITION | {
            k for k in convert.sim_tensors(sim1) if k.startswith(".telem.")})
    log(f"  inject: K = 1 == K = {INJ_CHUNK} (a card worker): {n} leaves "
        f"and the live event multiset (staging scratch, heap slots, route "
        f"marks and ring excluded); {st16}")
    del sim1, leaves16

    # one window profiled: barrier refill, merge, drain and route
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
        out, err = _inject_tail(device, out, err, sup, stop_resume,
                                traffic, (cfg_path, d, trace_out,
                                          metrics_out))
    finally:
        stop_proc(traffic)
    return out, err


def _inject_tail(device, out, err, sup, stop_resume, traffic, paths):
    """15b (its run in a card worker, started by _inject_cell), then 15c
    (its CLI run started there too; `paths`: its config, data
    directory, trace and metrics files)."""
    import functools
    import os

    from shadow_tpu_torch.core.insert_kernels import mailbox_gather

    # ---- 15b: supervised stop at INJ_STOP_S, resume with a fresh feeder
    st, leaves, blk, t_stop, cursor = stop_resume.result(timeout=900)
    n = inject_leaves_equal("inject 15b resumed vs straight", leaves,
                            sup.sim, exclude=INJ_SCRATCH)
    if (blk["injected"] + blk["dropped"] + blk["deferred"]
            != blk["trace_events"] or blk["late"]
            or st != sup.stats.as_dict()):
        raise AssertionError(f"inject 15b: block {blk} stats {st}")
    log(f"  inject 15b (a card worker): stopped at t={t_stop}, resumed with "
        f"a fresh feeder (cursor {cursor} after the run): == the straight "
        f"run ({n} leaves, staging scratch excluded), injection block "
        f"reconciles {json.dumps(blk)}")
    del sup, leaves

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
                                    scale_runner(bt6, device, "relay"), device)
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


def obs_cell(device, untimed=None):
    """Phase 18: the netstack's observability settings at full width
    and native/; 18b (timed) first, then 18c, which is not, with
    `untimed()` called as it starts. 18a's CLI runs beside phases 14-19
    (start_obs_cli, checked with 19's untimed work by finish_obs_cli).
    Returns (row fields, max abs err of mailbox_gather on 18b's
    route)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="shadow_obs_") as tmp:
        return _obs_cell(device, tmp, untimed)


def start_obs_cli(tmp):
    """18a: `python -m shadow_tpu_torch.cli` on the obs-cpu-10k config
    as a user runs it, in `tmp`, started at phase 14 beside the other
    untimed work (VP_NICE: below the timed phases' priority)."""
    import os

    os.makedirs(tmp, exist_ok=True)
    return start_cli("obs-cpu-10k", obs_xml(OBS_HOSTS, OBS_CLI_STOP), tmp,
                     "-l", "info", *OBS_FLAGS, nice=VP_NICE)


def finish_obs_cli(cli):
    """18a's checks once its CLI ends: the reference CLI's report, path
    lines, log line count and pcap files. Returns the row fields, the
    CLI's wall from its start to its exit among them."""
    cmd = cli[1]
    report, wall, lines = finish_cli(cli)
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
    # the CLI's data directory: start_cli's -d
    digest = pcap_digest(cmd[cmd.index("-d") + 1])
    if digest != OBS_CLI_PCAP:
        raise AssertionError(f"obs-cpu-10k: pcap files {digest} != the "
                             f"reference's {OBS_CLI_PCAP}")
    log(f"  obs-cpu-10k: the reference's 9 path counts, {len(lines)} log "
        f"lines (one flush past 4,096 records: the native argsort), pcap "
        f"files as the reference's {digest}, the CLI {wall:.1f} s from its "
        f"start to its exit")
    return {"obs_cli_wall_s": round(wall, 1)}


def _obs_cell(device, tmp, untimed):
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

    if untimed is not None:
        untimed()
    # ---- 18c: CUDA against CPU at the cuts (not timed) ---------------
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

    torch.cuda.synchronize()
    return out, err


# --- phase 19: virtual processes -------------------------------------


def leaf_digest(leaves):
    """One digest of every leaf's bytes (a sha256 of "key=sha256-prefix"
    lines in key order), the form the pinned reference digests take."""
    import hashlib

    import numpy as np

    per = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
           .hexdigest()[:16] for k, v in leaves.items()}
    return hashlib.sha256("\n".join(
        f"{k}={per[k]}" for k in sorted(per)).encode()).hexdigest()[:16]


def net_digest(leaves):
    """leaf_digest of the `.net.*` leaves alone."""
    return leaf_digest({k: v for k, v in leaves.items()
                        if k.startswith(".net.")})


def vproc_run(kind, dev, mesh=None):
    """19a ("udp") or 19b ("tcp") on `dev` through ProcessRuntime:
    (runtime, sim, stats, checks) with checks the phase's counts. On a
    `mesh` (21e) each rank runs its own hosts' coroutines and `pongs`
    counts this rank's clients."""
    import hashlib

    import numpy as np

    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig, SocketType
    from shadow_tpu_torch.process import vproc
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    H = VP_HOSTS
    if kind == "udp":
        cfg = NetConfig(num_hosts=H, end_time=VP_SIM_S * simtime.ONE_SECOND,
                        tcp=False, sockets_per_host=2, event_capacity=8,
                        outbox_capacity=8, router_ring=8, in_ring=8)
    else:
        cfg = NetConfig(num_hosts=H, end_time=VP_SIM_S * simtime.ONE_SECOND,
                        tcp=True, sockets_per_host=4, event_capacity=64,
                        outbox_capacity=64, router_ring=64)
    b = build(cfg, ONE_VERTEX, [HostSpec(name=f"n{i}") for i in range(H)],
              device=dev)
    pongs = np.zeros(H, np.int64)
    data = (bytes(range(256)) * 64)[:VP_TCP_BYTES]
    digests = {}

    def udp_client(host):
        peer = b.ip_of(f"n{host + 1}")
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, VP_PORT)
        for _ in range(VP_ROUNDS):
            yield vproc.sendto(fd, peer, VP_PORT, 64)
            _sip, _spt, n = yield vproc.recvfrom(fd)
            assert n == 64
            pongs[host] += 1
        yield vproc.close(fd)

    def udp_server(host):
        fd = yield vproc.socket(SocketType.UDP)
        yield vproc.bind(fd, VP_PORT)
        for _ in range(VP_ROUNDS):
            sip, spt, n = yield vproc.recvfrom(fd)
            yield vproc.sendto(fd, sip, spt, n)
        yield vproc.close(fd)

    def tcp_client(host):
        peer = b.ip_of(f"n{host + 1}")
        fd = yield vproc.socket(SocketType.TCP)
        rc = yield vproc.connect(fd, peer, VP_PORT)
        assert rc == 0
        buf = data
        while buf:
            n = yield vproc.send_data(fd, buf)
            buf = buf[n:]
        yield vproc.close(fd)

    def tcp_server(host):
        ls = yield vproc.socket(SocketType.TCP)
        yield vproc.bind(ls, VP_PORT)
        yield vproc.listen(ls)
        fd = yield vproc.accept(ls)
        got = bytearray()
        while True:
            d = yield vproc.recv_data(fd)
            if not d:
                break
            got += d
        digests[host] = hashlib.sha256(bytes(got)).hexdigest()
        yield vproc.close(fd)
        yield vproc.close(ls)

    client, server = ((udp_client, udp_server) if kind == "udp"
                      else (tcp_client, tcp_server))
    rt = (ProcessRuntime(b, device=dev) if mesh is None
          else ProcessRuntime(b, mesh=mesh))
    for i in range(0, H, 2):
        rt.spawn(i, client)
        rt.spawn(i + 1, server)
    sim, stats = rt.run()
    st = stats.as_dict()
    checks = {k: st[k] for k in ("events_processed", "micro_steps",
                                 "windows")}
    checks.update(syscalls=rt.stat_syscalls,
                  dispatches=rt.stat_device_dispatches,
                  overflow=int(sim.events.overflow) + int(sim.outbox.overflow)
                  + int(sim.net.rq_overflow))
    if kind == "udp":
        checks["pongs"] = int(pongs.sum())
    else:
        want = hashlib.sha256(data).hexdigest()
        checks["streams_ok"] = sum(d == want for d in digests.values())
    if not all(p.done for p in rt.procs):
        raise AssertionError(f"vproc {kind}: a process did not finish")
    return rt, sim, stats, checks


def _vproc_job(kind, dev):
    """The CPU half of 19a/19b in a worker: (EngineStats dict, leaves,
    checks, wall s)."""
    from shadow_tpu_torch import convert

    t0 = time.perf_counter()
    _, sim, stats, checks = vproc_run(kind, dev)
    return (stats.as_dict(), convert.sim_to_numpy(sim), checks,
            time.perf_counter() - t0)


def vproc_card(label, kind, expect, leaves_want, device):
    """19a/19b's card half, the launch counter set to 0 just before and
    read just after, held to the reference's pinned counts and leaf
    digest. Returns (launches, wall s, the checks, KeepGatherInputs,
    runtime, (EngineStats dict, leaves))."""
    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather

    with KeepGatherInputs() as kept:
        torch.cuda.synchronize()
        mailbox_gather.launches = 0
        t0 = time.perf_counter()
        rt, sim, stats, checks = vproc_run(kind, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mailbox_gather.launches
    if checks != expect:
        raise AssertionError(f"{label}: {checks} != the reference's "
                             f"{expect}")
    leaves = convert.sim_to_numpy(sim)
    dig = leaf_digest(leaves)
    if dig != leaves_want:
        raise AssertionError(f"{label}: leaf digest {dig} != the "
                             f"reference's {leaves_want}")
    log(f"  {label} cuda: the reference's counts {checks}, leaf digest "
        f"{dig} (all {len(leaves)} leaves)")
    # one launch per routed window: every route of these runs brings
    # at most 32 arrivals to a row, so "sort2" sweeps with the kernel
    routed = checks["windows"] - int(sim.outbox.route_elided)
    if launches != routed or launches == 0:
        raise AssertionError(f"{label}: mailbox_gather launched {launches} "
                             f"times for {routed} non-empty windows")
    w = checks["windows"]
    log(f"  {label}: wall {wall:.3f} s on the card, {wall / w * 1e3:.1f} ms "
        f"a window, {checks['syscalls'] / wall:.0f} syscalls/s, "
        f"{checks['dispatches'] / w:.2f} device dispatches a window, "
        f"{checks['micro_steps'] / w:.2f} micro-steps a window; "
        f"mailbox_gather launched {launches} times = {routed} non-empty "
        f"windows")
    return launches, wall, checks, kept, rt, (stats.as_dict(), leaves)


def vproc_cpu_equal(label, fut, card, checks):
    """The CPU half (a worker's `_vproc_job` future) equal to the
    card's (EngineStats dict, leaves) and checks."""
    st, cleaves, cchecks, cwall = fut.result(timeout=900)
    n = assert_same_leaves(label, card, (st, cleaves))
    if cchecks != checks:
        raise AssertionError(f"{label}: cpu {cchecks} != cuda {checks}")
    log(f"  {label}: cuda == cpu ({cwall:.1f} s), EngineStats and all {n} "
        f"leaves equal")


def start_reftests_clis(tmp, names, nice=0):
    """19c's reftests configs `names` as CLI subprocesses."""
    started = {}
    for i, name in enumerate(VP_REFTESTS):
        if name in names:
            body = f'  <plugin id="p" path="{name}"/>\n  {VP_REFTESTS[name]}'
            started[f"reftests {name}"] = start_cli(f"vp{i}", small_config(
                body, 30), tmp, nice=nice)
    return started


def start_vproc_clis(tmp):
    """19c and 19d as subprocesses, but for the long reftests configs
    (VP_LONG, started at phase 14): the other reftests configs and the .py
    plugin echo config through `python -m shadow_tpu_torch.cli
    --platform gpu`, and --host-kernel diff on the tgen dual workload
    and the epoll reftests config."""
    import os

    from shadow_tpu_torch.hostrun.runner import GRAPH as TWO_HOSTS

    started = start_reftests_clis(tmp, set(VP_REFTESTS) - set(VP_LONG),
                                  nice=VP_NICE)
    d = os.path.join(tmp, "py")
    os.makedirs(d)
    for fname, text in (("echo_plugin.py", VP_PY_PLUGIN),
                        ("one.graphml.xml", VP_PY_GRAPH),
                        ("shadow.config.xml", VP_PY_CONFIG),
                        ("tgen_dual.py", VP_TGEN_PLUGIN),
                        ("two.graphml.xml", TWO_HOSTS),
                        ("tgen.config.xml", VP_TGEN_CONFIG)):
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    cli = [sys.executable, "-m", "shadow_tpu_torch.cli"]
    started[".py plugin"] = start_proc(".py plugin", cli + [
        os.path.join(d, "shadow.config.xml"), "--platform", "gpu", "-d",
        os.path.join(d, "py.data")], nice=VP_NICE)
    started["host-kernel diff tgen"] = start_proc("host-kernel diff tgen",
                                                  cli + [
        os.path.join(d, "tgen.config.xml"), "--platform", "gpu", "-d",
        os.path.join(d, "tgen.data"), "--host-kernel", "diff"],
                                                  nice=VP_NICE)
    epoll = small_config('  <plugin id="p" path="libshadow-plugin-test-'
                         f'epoll.so"/>\n  {_VP_ONE}', 30)
    path = os.path.join(d, "epoll.config.xml")
    with open(path, "w") as f:
        f.write(epoll)
    started["host-kernel diff epoll"] = start_proc("host-kernel diff epoll",
                                                   cli + [
        path, "--platform", "gpu", "-d", os.path.join(d, "epoll.data"),
        "--host-kernel", "diff"], nice=VP_NICE)
    return started


def start_vproc_untimed(tmp, started):
    """Phase 19's work that nothing times, started beside phase 18's
    untimed runs: 19b's CPU half in a CPU worker (its future), and the
    CLI subprocesses of 19c-19d at a lower priority into `started` (but
    VP_LONG's, which start at phase 14)."""
    fut = in_worker(_vproc_job, "tcp", "cpu")
    started.update(start_vproc_clis(tmp))
    return fut


def finish_vproc_clis(started):
    """Every 19c run exits 0 with the reference CLI's report; both 19d
    diffs exit 0 with "agree": true and a manifest conformance block."""
    for label, st in started.items():
        if label.startswith("host-kernel"):
            code, stdout, stderr, wall = finish_proc(st)
            # the CLI prints its JSON line before the log's flush
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith('{"mode"')]
            if code != 0 or not lines:
                raise AssertionError(f"{label}: exit {code}:\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            rep = json.loads(lines[-1])
            with open(rep["manifest"]) as f:
                conf = json.load(f).get("conformance")
            if not rep.get("agree") or not conf or conf["agree"] != 1:
                raise AssertionError(f"{label}: {rep} conformance {conf}")
            log(f"  {label}: exit 0 in {wall:.1f} s, agree, manifest "
                f"conformance {json.dumps(conf)}")
            continue
        if label == ".py plugin":
            code, stdout, stderr, wall = finish_proc(st)
            lines = stdout.strip().splitlines()
            if code != 0 or not lines:
                raise AssertionError(f"{label}: exit {code}:\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            report = json.loads(lines[-1])
            log(f"  {label}: exit 0 in {wall:.1f} s")
            check_report(label, report, VP_PY_REPORT)
            continue
        report, _, _ = finish_cli(st)
        events, windows = VP_REFTESTS_REPORTS[label[9:]]
        check_report(label, report, {"events": events, "windows": windows,
                                     "overflow": 0})


def vproc_cell(device, tmp, started, tcp_cpu, obs_cli=None):
    """Phase 19, in the directory `tmp`; `started` holds 19c-19d's CLIs
    and `tcp_cpu` is 19b's CPU half, all started beside phase 18's
    untimed runs (start_vproc_untimed); `obs_cli` is 18a's pending CLI,
    checked with them (finish_obs_cli). Returns (kernel-row additions,
    max abs error)."""
    from shadow_tpu_torch import native

    native.require()
    log(f"[19a] vproc-1k-udp: {VP_HOSTS} processes, {VP_HOSTS // 2} UDP "
        f"pairs, {VP_ROUNDS} rounds of 64 B, {VP_SIM_S} sim-s")
    label = "19a vproc-1k-udp"
    fut = in_worker(_vproc_job, "udp", "cpu")
    launches, wall, checks, kept, _, card = vproc_card(
        label, "udp", VP_UDP_EXPECT, VP_UDP_LEAVES, device)
    vproc_cpu_equal(label, fut, card, checks)
    err = kept.check("19a")
    # 21e's oracle: the digest of 19a's net leaves and its counts
    udp_oracle = {"net_digest": net_digest(card[1]), "checks": checks}
    w = checks["windows"]
    udp = {"ms_per_window": round(wall / w * 1e3, 3),
           "syscalls_per_s": round(checks["syscalls"] / wall, 1),
           "dispatches_per_window": round(checks["dispatches"] / w, 3)}
    label = "19b vproc-1k-tcp"
    log(f"[19b] vproc-1k-tcp: {VP_HOSTS // 2} TCP pairs, {VP_TCP_BYTES} B "
        f"each, beside 19c-19d's CLIs")
    tlaunch, _, tchecks, _, rt, card = vproc_card(
        label, "tcp", VP_TCP_EXPECT, VP_TCP_LEAVES, device)
    freed = rt.gc_pool()
    if rt.pool.live_refs() or rt.pool.live_bytes():
        raise AssertionError(f"19b: the pool holds {rt.pool.live_refs()} "
                             f"refs after gc_pool")
    log(f"  19b: all {tchecks['streams_ok']} streams sha256-equal, the "
        f"pool empty after gc_pool ({freed} freed)")
    vproc_cpu_equal(label, tcp_cpu, card, tchecks)
    del rt, card
    log("[19c-d] the reftests configs, the .py plugin and --host-kernel "
        "diff through the CLI")
    finish_vproc_clis(started)
    obs = {} if obs_cli is None else finish_obs_cli(obs_cli)
    # timed alone, once the subprocesses have ended
    gather = time_gather("19a", kept.kept)
    return {"launches_vproc": launches, "launches_vproc_tcp": tlaunch,
            "vproc": {k: gather[k] for k in ("n", "ms", "plain_ms",
                                             "bound_ms", "library_ms")},
            "vproc_udp": udp, "udp_oracle": udp_oracle, **obs}, err


def shards_bench_rank0() -> int:
    """20a's and 21a's bench process: `python -m shadow_tpu_torch.bench`'s
    main as rank 0 of BENCH_SHARDS ranks (it starts the others), with
    BENCH_SENTINEL and its A/B in the environment: the timed run with
    the sentinel (21a) and, its twin without, the plain sharded row
    (20a). mailbox_gather's inputs are kept on this rank; after the
    row, the kernel against its plain version on this rank's own kept
    streams (the exchange's receive side) and EL_READINGS timings on
    the narrowest against index_select. Prints the row, then one
    {"gather_err", "readings"} line. Run as `python3 -c "import
    chip_smoke; chip_smoke.shards_bench_rank0()"`."""
    from shadow_tpu_torch import bench

    with KeepGatherInputs() as kept:
        code = bench.main([])
    if code:
        return code
    err = kept.check("20a rank 0")
    readings = [time_gather(f"20a rank 0 reading {i + 1}", kept.kept)
                for i in range(EL_READINGS)]
    print(json.dumps({"gather_err": err, "readings": readings}),
          flush=True)
    return 0


def supervised_mesh_rank(rank, size, init, ckdir):
    """20c's rank: run_supervised on phase 13a's program (the degraded
    plan, the bulk pass, the ring) cut to SUP_MESH_SIM_S, on a mesh of
    `size` ranks of this machine's card(s), K = 8, a snapshot every 8
    windows into `ckdir` (rank 0 writes). Rank 0 returns the result's
    ok, stats, state digest, snapshots and the mesh's backend."""
    from shadow_tpu_torch import bench, faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.parallel import Mesh

    mesh = Mesh(size, rank, init_method=init)
    b = faults_bundle(mesh.device, HOSTS, SUP_MESH_SIM_S)
    res = faults.run_supervised(
        b, (phold.handler,), mesh=mesh, windows_per_dispatch=8,
        checkpoint_path=f"{ckdir}/sup", checkpoint_every_windows=8)
    out = {"ok": res.ok, "stats": res.stats.as_dict(),
           "digest": bench.state_digest(res.sim),
           "snapshots": len(res.checkpoints), "backend": mesh.backend}
    mesh.close()
    return out if rank == 0 else None


def supervised_mesh_main() -> int:
    """20c's process: SUP_MESH_RANKS spawned ranks of
    supervised_mesh_rank (joined within 600 s); prints rank 0's JSON.
    Run as `python3 -c "import chip_smoke;
    chip_smoke.supervised_mesh_main()"`."""
    import shutil
    import tempfile

    from shadow_tpu_torch.parallel import spawn

    ckdir = tempfile.mkdtemp(prefix="shadow_sup_mesh_")
    try:
        out = spawn(supervised_mesh_rank, SUP_MESH_RANKS, ckdir,
                    deadline_s=600)[0]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


def start_shards_side(tmp):
    """Phase 20's runs that only counts and digests check, started
    beside untimed work: 20b (the CLI with --workers 2 on 14b's
    cli-phold-ref) and 20c (the supervised mesh run)."""
    return {"20b": start_cli("cli-phold-ref-w2", REFERENCE_PHOLD_XML, tmp,
                             "--workers", "2"),
            "20c": start_proc("20c supervised mesh", [
                sys.executable, "-c", "import sys, chip_smoke; "
                "sys.exit(chip_smoke.supervised_mesh_main())"])}


def start_elastic_side():
    """21b-21e's process (elastic_main), started beside phases 14-19."""
    return start_proc("21b-e elastic ranks", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.elastic_main())"])


def _json_line(stdout, prefix):
    """The last line of `stdout` that starts with `prefix`, parsed."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith(prefix)]
    if not lines:
        raise AssertionError(f"no line starting {prefix!r} in:\n"
                             f"{stdout[-3000:]}")
    return json.loads(lines[-1])


def single_shard_twin(device, seed, cap):
    """20a's single-shard run: bench's PHOLD input (`seed`, capacity
    `cap`) at full width to SHARD_SIM_S on the card through make_runner
    with the bulk pass. Returns (EngineStats dict, state digest,
    overflow)."""
    from shadow_tpu_torch import bench
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    b = bench.build_phold(HOSTS, LOAD, SHARD_SIM_S, seed, cap,
                          bench.ONE_VERTEX, device)
    sim, stats = make_runner(b, app_handlers=(phold.handler,),
                             app_bulk=phold.BULK, device=device)(b.sim)
    return (stats.as_dict(), bench.state_digest(sim),
            int(sim.events.overflow) + int(sim.outbox.overflow))


def shards_cell(device, side):
    """Phase 20 (the module docstring): 20a's sharded bench row against
    the single-shard run of the same input, and the checks of 20b and
    20c (started beside earlier work by start_shards_side). The
    in-process work (20b's and 20c's checks, 20c's serial twin, 20a's
    single-shard twin at the input bench settles on at this width: seed
    1, capacity 48) runs while 20a's ranks start; 20a's timed call
    comes after it. Returns ({"launches_shards", "shards", ...}, max
    abs err)."""
    import os
    import tempfile

    import torch

    from shadow_tpu_torch import bench, faults
    from shadow_tpu_torch.apps import phold

    started = start_sharded_bench()

    # --- 20b: the CLI's --workers 2 -----------------------------------
    report, _, lines = finish_cli(side["20b"])
    check_report("cli-phold-ref-w2", report, PHOLD_REF_REPORT)
    cards = torch.cuda.device_count()
    want = ("--workers 2: 2 ranks" if cards >= 2 else
            "--workers 2 does not divide 10 hosts (or exceeds the device "
            "count); using 1")
    if not any(want in ln for ln in lines):
        raise AssertionError(f"20b: no line {want!r} in the CLI's log")
    log(f"  20b: {cards} card(s): the log says {want!r}; the report equals "
        f"the serial CLI's (14b)")

    # --- 20c: run_supervised on a mesh ---------------------------------
    code, stdout, stderr, wall = finish_proc(side["20c"])
    if code != 0:
        raise AssertionError(f"20c: exited {code}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    got = _json_line(stdout, "{")
    with tempfile.TemporaryDirectory(prefix="shadow_sup_one_") as d:
        b = faults_bundle(device, HOSTS, SUP_MESH_SIM_S)
        res = faults.run_supervised(
            b, (phold.handler,), windows_per_dispatch=8, device=device,
            checkpoint_path=f"{d}/sup", checkpoint_every_windows=8)
    one = res.stats.as_dict()
    if not (got["ok"] and res.ok):
        raise AssertionError(f"20c: not ok: {got}")
    if got["digest"] != bench.state_digest(res.sim):
        raise AssertionError("20c: the supervised mesh run's state differs "
                             "from the serial supervised run's")
    for k in ("events_processed", "windows", "fastpath_hit",
              "fastpath_miss"):
        if got["stats"][k] != one[k]:
            raise AssertionError(f"20c: {k} {got['stats'][k]} != {one[k]}")
    if got["snapshots"] != len(res.checkpoints):
        raise AssertionError(f"20c: {got['snapshots']} snapshots, serial "
                             f"{len(res.checkpoints)}")
    log(f"  20c: run_supervised on {SUP_MESH_RANKS} ranks "
        f"({got['backend']}) to {SUP_MESH_SIM_S} sim-s: ok, "
        f"{got['snapshots']} snapshots, the final state and EngineStats "
        f"equal to the serial supervised run's ({one})")
    # 21b-21d's oracle: this serial supervised run
    sup_oracle = {"digest": bench.state_digest(res.sim), "stats": one}
    del b, res
    twins = {(1, CAPACITY): single_shard_twin(device, 1, CAPACITY)}
    torch.cuda.empty_cache()

    # --- 20a: its timed calls alone on the card -----------------------
    code, stdout, stderr, wall = finish_proc(started)
    if code != 0:
        raise AssertionError(f"20a: the sharded bench exited {code}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    for ln in stderr.splitlines():
        if "shadow_tpu_torch" in ln:
            log(f"  20a: {ln.strip()}")
    row = _json_line(stdout, '{"metric"')
    gk = _json_line(stdout, '{"gather_err"')
    log(f"  20a, 21a: `BENCH_SHARDS={SHARDS} BENCH_SIM_SECONDS="
        f"{SHARD_SIM_S} BENCH_SENTINEL=1 BENCH_SENTINEL_OVERHEAD=1 python -m"
        f" shadow_tpu_torch.bench` exit 0 in {wall:.1f} s: "
        f"{json.dumps(row)}")
    if row["metric"] != (f"events_per_sec_per_chip@{HOSTS}hosts_phold_"
                         f"load{LOAD}_sentinel_{SHARDS}shards"):
        raise AssertionError(f"20a: metric {row['metric']}")
    # 20a is the A/B's twin without the sentinel: BENCH_SHARDS's own run
    sh = row["sentinel"]["shards_off"]
    value = row["events_per_sec_sentinel_off"]
    st = sh["stats"]
    if sh["narrow_hit"] + sh["narrow_miss"] != st["windows"]:
        raise AssertionError(f"20a: narrow hit + miss != windows: {sh}")
    routed = st["windows"] - sh["route_elided"]
    if sh["mailbox_gather_launches"] != [routed] * SHARDS:
        raise AssertionError(
            f"20a: mailbox_gather launches {sh['mailbox_gather_launches']}"
            f" on the ranks, not one a non-empty route ({routed})")
    # the single-shard run of the same input (bench's seed and capacity
    # of the timed call) on this card
    key = (sh["seed"], sh["capacity"])
    if key not in twins:
        twins[key] = single_shard_twin(device, *key)
    one, digest, overflow = twins[key]
    for k in ("events_processed", "windows", "fastpath_hit",
              "fastpath_miss"):
        if st[k] != one[k]:
            raise AssertionError(f"20a: {k} {st[k]} on {SHARDS} ranks, "
                                 f"{one[k]} on one")
    if st["micro_steps"] < one["micro_steps"]:
        raise AssertionError("20a: fewer micro-steps summed over the "
                             "ranks than on one")
    if sh["state_digest"] != digest:
        raise AssertionError("20a: the final state differs from the "
                             "single-shard run's")
    if overflow:
        raise AssertionError("20a: overflow")
    log(f"  20a: {SHARDS} ranks ({sh['backend']}) equal to one shard: "
        f"EngineStats {st} (one shard {one}: micro-steps are summed over "
        f"the ranks, as the reference sums them), digest {digest[:16]}; "
        f"{value} events/s, {sh['wall_ms_per_window']} ms a "
        f"window, collectives {sh['collective_ms_per_window']} ms "
        f"({sh['collective_calls_per_window']} calls, "
        f"{sh['collective_bytes_per_window']} B) a window on rank 0, the "
        f"final gather of the global state {sh['gather_ms']} ms "
        f"({sh['gather_bytes']} B); "
        f"mailbox_gather {sh['mailbox_gather_launches']} launches on the "
        f"ranks' {routed} non-empty routes, exact on rank 0's own stream")
    out = {"launches_shards": sh["mailbox_gather_launches"],
           "shards_row": {"metric": row["metric"].replace("_sentinel_",
                                                          "_"),
                          "value": value,
                          "events": row["events"],
                          "windows": row["windows"]},
           "shards": {k: gk["readings"][0][k] for k in (
               "n", "ms", "plain_ms", "bound_ms", "library_ms")}}
    out["shards_row"].update({k: sh[k] for k in (
        "wall_ms_per_window", "collective_ms_per_window",
        "collective_calls_per_window", "collective_bytes_per_window",
        "gather_ms", "gather_bytes")})
    out["oracles"] = {"sup": sup_oracle, "twins": twins,
                      "bench": (row, gk)}
    return out, gk["gather_err"]


def start_sharded_bench():
    """20a's and 21a's bench process (shards_bench_rank0)."""
    import os

    keep = ("BENCH_SHARDS", "BENCH_SIM_SECONDS", "BENCH_SENTINEL",
            "BENCH_SENTINEL_OVERHEAD")
    env = dict(os.environ, BENCH_SHARDS=str(SHARDS),
               BENCH_SIM_SECONDS=str(SHARD_SIM_S), BENCH_SENTINEL="1",
               BENCH_SENTINEL_OVERHEAD="1")
    env = {k: v for k, v in env.items()
           if not k.startswith("BENCH_") or k in keep}
    return start_proc("20a-21a bench BENCH_SHARDS BENCH_SENTINEL", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.shards_bench_rank0())"], env=env)

# --- phase 21: elastic degraded-mesh recovery --------------------------


def load_lint():
    """tools/telemetry_lint.py as the port tests load it (by path; it
    imports no JAX)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tools" / \
        "telemetry_lint.py"
    spec = importlib.util.spec_from_file_location("telemetry_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _elastic_supervised(tag, mesh, ckdir, fault=None, every=2 * EL_K,
                        **kw):
    """run_supervised under ElasticPolicy() on phase 13a's program with
    the integrity sentinel, cut to SUP_MESH_SIM_S, EL_K windows a
    dispatch and a snapshot every `every` windows; `fault(bundle)` gives
    a fault_fn. Returns a host-side summary (the reporting rank's carries
    the state digest, EngineStats, the sentinel report and the run
    manifest; every rank the time it classified a loss)."""
    from shadow_tpu_torch import bench, faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.parallel import elastic
    from shadow_tpu_torch.telemetry import export

    lines = []
    b = faults_bundle(mesh.device, HOSTS, SUP_MESH_SIM_S)
    b.sim = elastic.attach_sentinel(b.sim)
    res = faults.run_supervised(
        b, (phold.handler,), mesh=mesh, elastic=elastic.ElasticPolicy(),
        windows_per_dispatch=EL_K, checkpoint_path=f"{ckdir}/{tag}",
        checkpoint_every_windows=every, sleep=lambda s: None,
        log=lambda m: lines.append((time.time(), m)),
        fault_fn=None if fault is None else fault(b), **kw)
    out = {"retired": res.retired, "reports": res.reports, "ok": res.ok,
           "elastic": res.elastic, "retries_used": res.retries_used,
           "resumed_from": res.resumed_from,
           "detected": [t for t, m in lines if "device loss" in m],
           "log": [m for _, m in lines]}
    if res.reports and res.sim is not None:
        out.update(
            digest=bench.state_digest(res.sim), stats=res.stats.as_dict(),
            sentinel=elastic.sentinel_report(res.sim),
            manifest=json.loads(json.dumps(export.run_manifest(
                cfg=b.cfg, seed=int(b.cfg.seed),
                shards=res.elastic["final_shards"], sim=res.sim,
                stats=res.stats, health=res.health,
                fault_plan=b.fault_plan, run_id=res.run_id,
                elastic=res.elastic))))
    return out


def _wait_files(paths, timeout_s):
    deadline = time.monotonic() + timeout_s
    import os

    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            raise RuntimeError(f"waited {timeout_s} s for {paths}")
        time.sleep(0.2)


def elastic_rank(rank, size, init, ckdir):
    """21b-21e on one set of EL_RANKS ranks of this machine's card(s):
    (21b) two poisoned dispatches on all ranks; (21c) ranks 0 and 1 as a
    mesh of 2, rank EL_VICTIM's replica diverging from EL_DIVERGE_NS;
    (21e) ranks 0 and 1 running 19a's 1,000 processes; (21d) all ranks
    again, rank 3 killing its own process at dispatch EL_KILL_AT. Each
    rank returns {case: summary}; rank 3 never returns."""
    import os
    import signal

    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.net.build import _resolve_fault_fn
    from shadow_tpu_torch.parallel import Mesh, elastic

    out = {}
    mesh = Mesh(size, rank, init_method=init, timeout_s=EL_TIMEOUT_S)
    out["backend"] = mesh.backend
    out["21b"] = _elastic_supervised(
        "21b", mesh, ckdir,
        dispatch_wrap=elastic.make_poisoned_dispatch(list(EL_POISON)))
    mesh.close()
    if rank < 2:
        two = Mesh(2, rank, init_method=f"file://{ckdir}/21c.group",
                   timeout_s=EL_TIMEOUT_S)
        # a snapshot every dispatch: one lies before the divergence
        out["21c"] = _elastic_supervised(
            "21c", two, ckdir, every=EL_K, fault=lambda b: elastic.
            make_divergence_fault_fn(two, shard=EL_VICTIM,
                                     at_ns=EL_DIVERGE_NS,
                                     inner=_resolve_fault_fn(b, None)))
        two.close()
        vm = Mesh(2, rank, init_method=f"file://{ckdir}/21e.group")
        mailbox_gather.launches = 0
        t0 = time.perf_counter()
        rt, sim, stats, checks = vproc_run("udp", vm.device, mesh=vm)
        wall = time.perf_counter() - t0
        from shadow_tpu_torch import convert

        leaves = convert.sim_to_numpy(sim)
        out["21e"] = {
            "checks": checks, "wall": wall,
            "pongs": [r[0] for r in vm.all_gather_ints([checks["pongs"]])],
            "syscalls": [r[0] for r in
                         vm.all_gather_ints([checks["syscalls"]])],
            "net_digest": net_digest(leaves),
            "launches": mailbox_gather.launches,
            "routed": checks["windows"] - int(sim.outbox.route_elided),
            "collectives": vm.calls}
        del rt, sim, stats
        vm.close()
        open(f"{ckdir}/ready.{rank}", "w").close()
    else:
        _wait_files([f"{ckdir}/ready.0", f"{ckdir}/ready.1"], 900)
    four = Mesh(size, rank, init_method=f"file://{ckdir}/21d.group",
                timeout_s=EL_TIMEOUT_S)
    wrap = None
    if rank == 3:
        state = {"n": 0}

        def wrap(fn):
            def dispatch(*a, **k):
                state["n"] += 1
                if state["n"] - 1 == EL_KILL_AT:
                    with open(f"{ckdir}/21d.kill", "w") as f:
                        f.write(repr(time.time()))
                    os.kill(os.getpid(), signal.SIGKILL)
                return fn(*a, **k)
            return dispatch
    out["21d"] = _elastic_supervised("21d", four, ckdir, dispatch_wrap=wrap)
    four.close()
    return out


def elastic_main() -> int:
    """21b-21e's process: EL_RANKS spawned elastic_rank ranks (rank 3
    may die: 21d kills it), joined within 900 s; prints every rank's
    JSON summaries and 21d's kill time. Run as `python3 -c "import sys,
    chip_smoke; sys.exit(chip_smoke.elastic_main())"`."""
    import shutil
    import tempfile

    from shadow_tpu_torch.parallel import spawn

    ckdir = tempfile.mkdtemp(prefix="shadow_elastic_")
    try:
        out = spawn(elastic_rank, EL_RANKS, ckdir, deadline_s=900,
                    may_die=(3,))
        with open(f"{ckdir}/21d.kill") as f:
            killed = float(f.read())
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(json.dumps({"ranks": out, "killed": killed}), flush=True)
    return 0


def _check_ladder(case, ranks, ladder, final, oracle, lint):
    """The reporting rank's summary of `case`: ok, the ladder steps, the
    final width, no failure retry spent, the final state's digest (the
    sentinel's leaves aside) and EngineStats (micro-steps aside) equal
    to 20c's serial run, and the elastic block and the manifest
    accepted by tools/telemetry_lint.py. Returns the summary."""
    got = [r[case] for r in ranks if r is not None and case in r]
    writers = [g for g in got if g["reports"]]
    if len(writers) != 1:
        raise AssertionError(f"{case}: {len(writers)} reporting ranks")
    res = writers[0]
    el = res["elastic"]
    steps = [s["action"] for s in el["ladder_steps"]]
    if not res["ok"] or steps != ladder or el["final_shards"] != final \
            or res["retries_used"]:
        raise AssertionError(f"{case}: ok {res['ok']}, ladder {steps}, "
                             f"final {el['final_shards']}, retries "
                             f"{res['retries_used']}: {res['log']}")
    if res["digest"] != oracle["digest"]:
        raise AssertionError(f"{case}: the final state differs from 20c's "
                             f"serial run")
    for k in ("events_processed", "windows", "fastpath_hit",
              "fastpath_miss"):
        if res["stats"][k] != oracle["stats"][k]:
            raise AssertionError(f"{case}: {k} {res['stats'][k]} != "
                                 f"{oracle['stats'][k]}")
    errs, warns = lint._lint_elastic(el, res["manifest"].get("health"))
    merrs, _ = lint.lint_manifest_obj(res["manifest"])
    if errs or warns or merrs:
        raise AssertionError(f"{case}: telemetry_lint: {errs} {warns} "
                             f"{merrs}")
    if res["sentinel"]["trips"]:
        raise AssertionError(f"{case}: the final sentinel tripped: "
                             f"{res['sentinel']}")
    return res


def sentinel_hook_ms(device, calls=50):
    """The sentinel hook's own cost at 20a's width, on one rank's whole
    table (the serial identity: the digest and the latch, no gather):
    host ms a call around `calls` calls with a synchronize at each end,
    and the digest's device ms (device_ms)."""
    import torch

    from shadow_tpu_torch import bench
    from shadow_tpu_torch.parallel import elastic

    b = bench.build_phold(HOSTS, LOAD, SHARD_SIM_S, 1, CAPACITY,
                          bench.ONE_VERTEX, device)
    sim = elastic.attach_sentinel(b.sim)
    fn = elastic.make_sentinel_fn(None)
    w0 = 50_000_000
    for i in range(3):
        sim = fn(sim, w0 + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        sim = fn(sim, w0 + i)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / calls
    dev, _ = device_ms([lambda: elastic.digest_replicated(sim, w0)])
    return {"hook_ms": round(host, 4), "digest_device_ms": round(dev, 5)}


def elastic_cell(device, side, oracles, udp_oracle):
    """Phase 21 (the module docstring): 21b-21e's checks (their process
    started beside phases 14-19 by start_elastic_side), and 21a's from
    the sentinel row phase 20's bench timed (oracles["bench"]). Returns
    ({"launches_sentinel", "sentinel_row", ...}, max abs err)."""
    import os

    lint = load_lint()
    code, stdout, stderr, wall = finish_proc(side["21"])
    if code != 0:
        raise AssertionError(f"21b-e: exited {code}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    got = _json_line(stdout, '{"ranks"')
    ranks = got["ranks"]
    backend = ranks[0]["backend"]
    sup = oracles["sup"]
    # --- 21b: retry then shrink -----------------------------------------
    res = _check_ladder("21b", ranks, ["retry", "shrink"], 2, sup, lint)
    log(f"  21b: {EL_RANKS} ranks ({backend}), dispatches {list(EL_POISON)}"
        f" poisoned: ladder retry, shrink {EL_RANKS} -> 2, resumed from "
        f"{os.path.basename(res['resumed_from'] or '-')} replanned "
        f"({res['elastic']['ladder_steps'][-1]['resume_time_ns']} ns); "
        f"the final state and EngineStats equal to 20c's serial run; "
        f"lint clean")
    # --- 21c: a divergence ----------------------------------------------
    res = _check_ladder("21c", ranks, ["retry", "serial"], 1, sup, lint)
    div = res["elastic"]["divergences"]
    if [d["shard"] for d in div] != [EL_VICTIM] * 2:
        raise AssertionError(f"21c: divergences {div}")
    if not all(d["tripped_at_ns"] >= EL_DIVERGE_NS
               > d["verified_through_ns"] for d in div):
        raise AssertionError(f"21c: the trip is not at the first window "
                             f"end past {EL_DIVERGE_NS}: {div}")
    for st in res["elastic"]["ladder_steps"]:
        if st["resume_time_ns"] > div[0]["verified_through_ns"]:
            raise AssertionError(f"21c: resumed past the verified "
                                 f"frontier: {st}")
    log(f"  21c: rank {EL_VICTIM} of 2 diverging from {EL_DIVERGE_NS} ns:"
        f" the sentinel latched shard {div[0]['shard']} at "
        f"{div[0]['tripped_at_ns']} ns (verified through "
        f"{div[0]['verified_through_ns']}); ladder retry, serial on the "
        f"card; equal to 20c's serial run; lint clean")
    # --- 21d: a real loss -----------------------------------------------
    res = _check_ladder("21d", ranks, ["shrink"], 2, sup, lint)
    detected = [t for r in ranks[:3] for t in r["21d"]["detected"]]
    if len(detected) != 3:
        raise AssertionError(f"21d: {len(detected)} survivors classified "
                             f"the loss")
    lag = [round(t - got["killed"], 3) for t in detected]
    retired = [r for r in range(3) if ranks[r]["21d"]["retired"]]
    log(f"  21d: rank 3 SIGKILLed at dispatch {EL_KILL_AT}: the "
        f"survivors classified it {lag} s after the kill "
        f"({res['elastic']['losses'][0]['cause']}), met again and shrank "
        f"to 2 (rank(s) {retired} retired); equal to 20c's serial run; "
        f"lint clean")
    # --- 21e: ProcessRuntime on a mesh ----------------------------------
    e = ranks[0]["21e"]
    want = udp_oracle["checks"]
    if e["net_digest"] != udp_oracle["net_digest"]:
        raise AssertionError("21e: the net leaves differ from 19a's")
    if sum(e["pongs"]) != want["pongs"] or sum(e["syscalls"]) \
            != want["syscalls"]:
        raise AssertionError(f"21e: pongs {e['pongs']}, syscalls "
                             f"{e['syscalls']} on the ranks; 19a {want}")
    for k in ("events_processed", "windows", "overflow"):
        if e["checks"][k] != want[k]:
            raise AssertionError(f"21e: {k} {e['checks'][k]} != {want[k]}")
    launches = [ranks[r]["21e"]["launches"] for r in range(2)]
    routed = [ranks[r]["21e"]["routed"] for r in range(2)]
    if launches != routed or not all(launches):
        raise AssertionError(f"21e: mailbox_gather {launches} on the "
                             f"ranks' {routed} non-empty routes")
    log(f"  21e: {VP_HOSTS} processes on 2 ranks: pongs {e['pongs']}, "
        f"syscalls {e['syscalls']}, events and windows and the net-leaf "
        f"digest {e['net_digest']} equal to 19a's; mailbox_gather "
        f"{launches} on the ranks' non-empty routes; {e['wall']:.2f} s, "
        f"{e['collectives']} collectives on rank 0")

    # --- 21a: the sentinel's cost (phase 20's bench row) ------------------
    row, gk = oracles["bench"]
    sh, sn = row["shards"], row["sentinel"]
    off = sn["shards_off"]
    st = sh["stats"]
    key = (sh["seed"], sh["capacity"])
    twins = oracles["twins"]
    if key not in twins:
        twins[key] = single_shard_twin(device, *key)
    one, digest, _ = twins[key]
    for k in ("events_processed", "windows", "fastpath_hit",
              "fastpath_miss"):
        if st[k] != one[k]:
            raise AssertionError(f"21a: {k} {st[k]} != {one[k]} (one shard)")
    if sh["state_digest"] != digest:
        raise AssertionError("21a: the final state (sentinel leaves "
                             "aside) differs from 20a's single-shard run")
    end = int(SHARD_SIM_S * 1_000_000_000) + 1
    if (sn["checks"], sn["trips"], sn["verified_through_ns"]) != (
            st["windows"], 0, end):
        raise AssertionError(f"21a: sentinel {sn}")
    routed = st["windows"] - sh["route_elided"]
    if sh["mailbox_gather_launches"] != [routed] * SHARDS:
        raise AssertionError(f"21a: mailbox_gather launches "
                             f"{sh['mailbox_gather_launches']}")
    extra = round(sh["collective_calls_per_window"]
                  - off["collective_calls_per_window"], 2)
    hook = sentinel_hook_ms(device)
    readings = gk["readings"]
    log(f"  21a: equal to one shard (sentinel leaves aside); sentinel "
        f"checks {sn['checks']} trips 0 verified through "
        f"{sn['verified_through_ns']}; sentinel_overhead_pct "
        f"{row['sentinel_overhead_pct']} ({row['value']} events/s on, "
        f"{row['events_per_sec_sentinel_off']} off); "
        f"{sh['wall_ms_per_window']} ms a window on, "
        f"{off['wall_ms_per_window']} off; the digest's collectives "
        f"{extra} a window (+{round(sh['collective_ms_per_window'] - off['collective_ms_per_window'], 4)} ms); "
        f"the serial hook alone {hook['hook_ms']} ms a call on the host "
        f"clock (synchronized), the digest {hook['digest_device_ms']} "
        f"ms on the device")
    log(f"  21a: mailbox_gather at the sharded route on rank 0, "
        f"{EL_READINGS} readings: kernel "
        f"{[r['ms'] for r in readings]} ms, index_select "
        f"{[r['library_ms'] for r in readings]} ms, bound "
        f"{readings[0]['bound_ms']} ms")
    out = {"launches_sentinel": sh["mailbox_gather_launches"],
           "launches_vproc_mesh": launches,
           "sentinel_row": {
               "overhead_pct": row["sentinel_overhead_pct"],
               "value": row["value"],
               "value_off": row["events_per_sec_sentinel_off"],
               "wall_ms_per_window": sh["wall_ms_per_window"],
               "wall_ms_per_window_off": off["wall_ms_per_window"],
               "collective_calls_per_window_extra": extra,
               "detect_s": lag, **hook},
           "sentinel_route": {k: min(r[k] for r in readings)
                              for k in ("ms", "plain_ms", "library_ms")}}
    out["sentinel_route"].update(n=readings[0]["n"],
                                 bound_ms=readings[0]["bound_ms"],
                                 readings=[{k: r[k] for k in (
                                     "ms", "library_ms")}
                                     for r in readings])
    return out, gk["gather_err"]


# --- phase 22: warm-start serving and the scenario fleet ----------------


def cold_start_main() -> int:
    """22a's bench process: `python -m shadow_tpu_torch.bench`'s main,
    its cold start taken apart — the interpreter's start (from SMOKE_T0,
    the parent's clock at the spawn, to this function), `import torch`,
    the CUDA context, the libraries, and the first and steady windows of
    the warm-up call (the first 12 windows timed with a synchronize on
    each side). With BENCH_WARM=1 the libraries' builds or loads are the
    row's compile block; with the store off the process loads them here,
    before the bench, as its first window would (`libraries_s`). Prints
    the row, then one {"cold_start"} line. Run as `python3 -c "import
    chip_smoke; chip_smoke.cold_start_main()"`."""
    import os

    t_entry = time.time()
    t = time.perf_counter()
    import torch
    import_s = time.perf_counter() - t
    t = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    ctx_s = time.perf_counter() - t
    from shadow_tpu_torch import bench, native
    from shadow_tpu_torch.core import engine, insert_kernels

    libs_s = None
    if os.environ.get("BENCH_WARM") != "1":
        t = time.perf_counter()
        insert_kernels.load_library()
        native.require()
        libs_s = time.perf_counter() - t
    real, times = engine.step_window, []

    def timed_window(*a, **k):
        if len(times) >= 12:
            return real(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.step_window = timed_window
    try:
        code = bench.main([])
    finally:
        engine.step_window = real
    if code:
        return code
    print(json.dumps({"cold_start": {
        "interpreter_s": round(t_entry - float(os.environ["SMOKE_T0"]), 3),
        "import_torch_s": round(import_s, 3),
        "cuda_context_s": round(ctx_s, 3),
        **({"libraries_s": libs_s} if libs_s is not None else {}),
        "first_window_ms": round(times[0], 3),
        "steady_window_ms": round(statistics.median(times[2:]), 3),
        "windows_timed": len(times)}}), flush=True)
    return 0


def start_warm_run(label, aot, build, warm=True):
    """Start one 22a process (cold_start_main) on the store `aot` and the
    build root `build`; with `warm` false, the store is off."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SHADOW_"))}
    env.update(SHADOW_AOT_DIR=aot, SHADOW_BUILD_DIR=build,
               SMOKE_T0=repr(time.time()))
    if warm:
        env["BENCH_WARM"] = "1"
    return start_proc(f"22a {label}", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.cold_start_main())"], env=env)


def finish_warm_run(started, phase4):
    """(row, cold-start parts, wall s) of a 22a process; its counts must
    be phase 4's."""
    label = started[0]
    code, stdout, stderr, wall = finish_proc(started)
    if code != 0:
        raise AssertionError(f"{label}: exit {code}:\n{stdout[-3000:]}"
                             f"\n{stderr[-3000:]}")
    row = _json_line(stdout, '{"metric"')
    parts = _json_line(stdout, '{"cold_start"')["cold_start"]
    got = {k: row[k] for k in ("events", "windows", "micro_steps")}
    want = {"events": phase4["events_processed"],
            "windows": phase4["windows"],
            "micro_steps": phase4["micro_steps"]}
    if got != want:
        raise AssertionError(f"{label}: counts {got} != phase 4's {want}")
    log(f"  {label}: exit 0 in {wall:.1f} s; row {json.dumps(row)}")
    log(f"  {label}: cold start {json.dumps(parts)}")
    return row, parts, wall


def _libraries(build):
    """{file: sha256} of the libraries in a build root."""
    import hashlib
    import os

    out = {}
    for name in sorted(os.listdir(build)):
        if name.endswith(".so"):
            with open(os.path.join(build, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def warm_cell(phase4):
    """22a: a BENCH_WARM=1 bench process on a fresh checkout's empty
    build root and store, a miss that builds (nvcc, g++) and stores;
    then three processes at once on the kept build root: a hit (load_s),
    the same bench with the store off (the libraries loaded as the
    build root keeps them, libraries_s), and a miss that stores again
    on a copy of the store whose <key>.bin has a flipped byte. Every
    run has phase 4's counts; each warm timed call re-resolves and
    hits; after the first run no library is built again."""
    import os
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="shadow_warm_")
    aot, build = os.path.join(root, "aot"), os.path.join(root, "build")
    out = {}

    def check(name, row, parts, wall, miss):
        c = row.get("compile") or {}
        if name == "nostore":
            if c != {"warm": False}:
                raise AssertionError(f"22a no store: compile block {c}")
            first = {}
        else:
            first = c.get("warmup", c)
            ok = first["hit"] is (not miss) and c["hit"] is True
            if name != "miss":
                ok = ok and c["key"] == out["warm_miss"]["key"]
            if miss:
                ok = ok and first["stored"] is True \
                    and first["compile_s"] > 0 and "lower_s" in first
            else:
                ok = ok and first["load_s"] > 0
            if not ok:
                raise AssertionError(f"22a {name}: compile block {c}")
        out[f"warm_{name}"] = {
            "wall_s": round(wall, 3), "value": row["value"],
            "warmup_s": row["warmup_s"], "key": c.get("key"),
            **{k: first[k] for k in ("hit", "lower_s", "compile_s",
                                     "load_s") if k in first},
            **({"timed_load_s": c["load_s"],
                "warm_speedup": c.get("warm_speedup")} if first else {}),
            **parts}

    row, parts, wall = finish_warm_run(
        start_warm_run("22a miss", aot, build), phase4)
    check("miss", row, parts, wall, True)
    libs = _libraries(build)
    if len(libs) != 2:
        raise AssertionError(f"22a miss: the build root holds {libs}")
    key = out["warm_miss"]["key"]
    flip = os.path.join(root, "aot_flip")
    shutil.copytree(aot, flip)
    path = os.path.join(flip, f"{key}.bin")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    log(f"  22a: the build root holds {sorted(libs)}; flipped byte "
        f"{len(blob) // 2} of {key}.bin in a copy of the store")
    started = [start_warm_run("22a hit", aot, build),
               start_warm_run("22a no store", aot, build, warm=False),
               start_warm_run("22a miss after a flipped byte", flip,
                              build)]
    for name, miss, st in zip(("hit", "nostore", "remiss"),
                              (False, False, True), started):
        check(name, *finish_warm_run(st, phase4), miss)
    if _libraries(build) != libs:
        raise AssertionError(f"22a: the kept build root changed: "
                             f"{_libraries(build)} != {libs}")
    hit, cold = out["warm_hit"], out["warm_nostore"]
    log(f"  22a: on the kept build root no library was built again; the "
        f"hit's store load {hit['load_s']:.4f} s against the store-off "
        f"process's library load {cold['libraries_s']:.4f} s; warm-up "
        f"calls {hit['warmup_s']} s and {cold['warmup_s']} s (the three "
        f"processes ran together)")
    shutil.rmtree(root, ignore_errors=True)
    return out


def _fleet_specs():
    from shadow_tpu_torch.fleet.spec import JobSpec

    return [JobSpec.from_dict(dict({"kind": "scenario", "hosts": HOSTS,
                                    "load": LOAD, "sim_s": 1}, **j))
            for j in FLEET_JOBS]


def fleet_side_main(tmp) -> int:
    """22b's process and 22c's undisturbed oracle, beside phases 16-21:
    `python -m shadow_tpu_torch.cli fleet run --workers 2` on FLEET_JOBS
    (the FLEET_KILL job's worker SIGKILLed after that job's first
    checkpoint heartbeat, read from the runner's log), `fleet status`,
    tools/telemetry_lint.py --fleet-manifest; then every spec run
    in-process by scenario.run_job on the card (the serial oracle); then
    bench's resident tenants undisturbed (no churn) on the card. Prints
    one {"fleet"} line. Run as `python3 -c "import chip_smoke;
    chip_smoke.fleet_side_main(tmp)"`."""
    import os
    import signal
    import subprocess
    import threading
    from pathlib import Path

    from shadow_tpu_torch import bench
    from shadow_tpu_torch.fleet.scenario import run_job

    root = Path(__file__).resolve().parent
    jobs = os.path.join(tmp, "jobs.json")
    with open(jobs, "w") as f:
        json.dump({"fleet": {"backoff_base_s": 0.0, "backoff_cap_s": 0.0,
                             "lease_timeout_s": 300.0},
                   "jobs": [s.as_dict() for s in _fleet_specs()]}, f)
    fleet = os.path.join(tmp, "fleet")
    env = dict(os.environ, SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "run",
         "--jobs-file", jobs, "--fleet-dir", fleet, "--workers",
         str(FLEET_WORKERS)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    pids, kill, log_lines = {}, {}, []

    def watch():
        for line in proc.stderr:
            log_lines.append(line.rstrip())
            w = dict(x.split("=", 1) for x in line.split()[2:] if "=" in x)
            if " running " in line and w.get("job") == FLEET_KILL:
                pids[w["worker"]] = int(w["pid"])
            if (" heartbeat " in line and w.get("job") == FLEET_KILL
                    and w.get("checkpoint") not in (None, "None")
                    and not kill and w.get("worker") in pids):
                os.kill(pids[w["worker"]], signal.SIGKILL)
                kill.update(worker=w["worker"], checkpoint=w["checkpoint"],
                            at_s=round(time.perf_counter() - t0, 3))

    outs = []
    readers = [threading.Thread(target=watch, daemon=True),
               threading.Thread(target=lambda: outs.append(
                   proc.stdout.read()), daemon=True)]
    for th in readers:
        th.start()
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
    for th in readers:
        th.join(timeout=30)
    stdout = outs[0] if outs else ""
    fleet_s = time.perf_counter() - t0
    out = {"fleet_rc": proc.returncode, "fleet_s": round(fleet_s, 3),
           "fleet_out": stdout.strip().splitlines()[-1:] or [""],
           "kill": kill, "log_tail": log_lines[-40:]}
    st = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "status",
         "--fleet-dir", fleet], cwd=root, capture_output=True, text=True,
        timeout=300)
    out["status"] = json.loads(st.stdout) if st.returncode == 0 else None
    lint = subprocess.run(
        [sys.executable, str(root / "tools" / "telemetry_lint.py"),
         "--fleet-manifest", os.path.join(fleet, "fleet_manifest.json")],
        cwd=root, capture_output=True, text=True, timeout=300)
    out["lint"] = [lint.returncode, (lint.stdout + lint.stderr)[-2000:]]
    man_path = os.path.join(fleet, "fleet_manifest.json")
    man = json.load(open(man_path)) if os.path.exists(man_path) else {}
    out["jobs"] = {}
    for jid, j in (man.get("jobs") or {}).items():
        res = j.get("result") or {}
        jm = (json.load(open(res["manifest"])) if res.get("manifest")
              else {})
        out["jobs"][jid] = {
            "verdict": j.get("verdict"), "digest": res.get("digest"),
            "counters": res.get("counters"),
            "attempt_history": j.get("attempt_history"),
            "worker_losses": j.get("worker_losses"),
            "executions": j.get("executions"),
            "escalation_restarts": res.get("escalation_restarts"),
            "compile": jm.get("compile")}
    t0 = time.perf_counter()
    out["oracle"] = {}
    for spec in _fleet_specs():
        res = run_job(spec, os.path.join(tmp, "oracle", spec.id))
        out["oracle"][spec.id] = {"ok": res["ok"],
                                  "digest": res.get("digest"),
                                  "counters": res.get("counters"),
                                  "error": res.get("error")}
    out["oracle_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    calm = bench.resident_trial(
        bench.resident_specs(HOSTS, LOAD, RES_SIM_S, RES_LANES),
        os.path.join(tmp, "calm"), RES_LANES, RES_SIM_S, "cuda",
        churn=False)
    out["calm"] = {h["job"]: h["digest"] for h in calm.table.history
                   if h.get("state") == "completed"}
    out["calm_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"fleet": out}), flush=True)
    return 0


def start_fleet_side(tmp):
    """22b's process and 22c's oracle (fleet_side_main), started beside
    phases 16-21."""
    return start_proc("22b fleet + oracles", [
        sys.executable, "-c", "import sys, chip_smoke; "
        f"sys.exit(chip_smoke.fleet_side_main({tmp!r}))"])


def fleet_cell(started):
    """22b's checks: the fleet exits 0 with every job done, `fleet status`
    folds to all done, the lint is clean, every job's digest and
    counters equal the serial oracle's, at least one job's program was
    a store hit, and the killed job was requeued at the same attempt
    (a continuation: attempt history [1, 1], one worker loss) and ended
    with the oracle's digest."""
    code, stdout, stderr, wall = finish_proc(started)
    if code != 0:
        raise AssertionError(f"22b: exit {code}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    f = _json_line(stdout, '{"fleet"')["fleet"]
    log(f"  22b: `fleet run --workers {FLEET_WORKERS}` exit "
        f"{f['fleet_rc']} in {f['fleet_s']} s: {f['fleet_out'][0]}; "
        f"kill {json.dumps(f['kill'])}; the serial oracle in "
        f"{f['oracle_s']} s; 22c's undisturbed run in {f['calm_s']} s "
        f"(the process {wall:.1f} s from its start)")
    if f["fleet_rc"] != 0 or not f["kill"]:
        raise AssertionError(f"22b: fleet rc {f['fleet_rc']}, kill "
                             f"{f['kill']}:\n" + "\n".join(f["log_tail"]))
    ids = [j["id"] for j in FLEET_JOBS]
    if (f["status"] or {}).get("counts") != {"done": len(ids)}:
        raise AssertionError(f"22b: fleet status {f['status']}")
    if f["lint"][0] != 0:
        raise AssertionError(f"22b: telemetry_lint: {f['lint'][1]}")
    hits = []
    for jid in ids:
        j, o = f["jobs"][jid], f["oracle"][jid]
        if not o["ok"]:
            raise AssertionError(f"22b oracle {jid}: {o}")
        if (j["verdict"], j["digest"], j["counters"]) != (
                "ok", o["digest"], o["counters"]):
            raise AssertionError(f"22b {jid}: {j} != the oracle's {o}")
        hits.append(bool((j["compile"] or {}).get("hit")))
        log(f"  22b {jid}: digest {j['digest'][:16]} = the oracle's; "
            f"counters {j['counters']}; attempts {j['attempt_history']}; "
            f"escalations {j['escalation_restarts']}; compile "
            f"{json.dumps(j['compile'])}")
    k = f["jobs"][FLEET_KILL]
    if (k["attempt_history"], k["worker_losses"], k["executions"]) != (
            [1, 1], 1, 2):
        raise AssertionError(f"22b {FLEET_KILL}: not a continuation: {k}")
    if not any(hits):
        raise AssertionError("22b: no job's program was a store hit")
    if f["jobs"]["grow"]["escalation_restarts"] < 1:
        raise AssertionError("22b grow: no escalation")
    return {"fleet": {"jobs": len(ids), "fleet_s": f["fleet_s"],
                      "oracle_s": f["oracle_s"], "hits": sum(hits),
                      "kill": f["kill"]}}, f["calm"]


def resident_bench_main() -> int:
    """22c's bench process: `python -m shadow_tpu_torch.bench`'s main with
    BENCH_RESIDENT in the environment, its warm-up trial cut to
    RES_WARM_NS and one tenant (the same program: the last tenant
    admitted, evicted and re-admitted, no drain; each tenant's donor
    build is most of a trial's fixed cost) and mailbox_gather's inputs
    kept; after the row, the kernel against its plain version on the
    timed trial's own streams and its times there (the phase 3 method).
    Prints the row, then one {"gather_err", "gather", "launches",
    "routed"} line, `routed` the non-empty windows of both trials. Run as
    `python3 -c "import chip_smoke; chip_smoke.resident_bench_main()"`."""
    from shadow_tpu_torch import bench
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.fleet import admission as adm_mod

    real, trials = bench.resident_trial, []

    def warm_up(specs, workdir, lanes, sim_s, device, churn=True):
        rp = adm_mod.ResidentProgram(
            specs, workdir=workdir, lanes=lanes, horizon_s=2 * sim_s + 1,
            checkpoint_every_events=0, fsync=False, device=device)
        try:
            rp.admit(specs[-1].id)
            rp.advance(until_ns=RES_WARM_NS // 2)
            rp.evict(specs[-1].id, reason="bench churn")
            rp.admit(specs[-1].id)
            rp.advance(until_ns=RES_WARM_NS)
        finally:
            rp.close()
        return rp

    def trial(*a, **k):
        if trials:
            kept.kept.clear()   # the timed trial's own streams
        rp = (warm_up if not trials else real)(*a, **k)
        trials.append(rp)
        return rp

    mailbox_gather.launches = 0
    bench.resident_trial = trial
    try:
        with KeepGatherInputs() as kept:
            code = bench.main([])
    finally:
        bench.resident_trial = real
    if code:
        return code
    launches = mailbox_gather.launches
    routed = [rp.windows - int(rp.sim.outbox.route_elided)
              for rp in trials]
    err = kept.check("22c resident")
    gather = time_gather("22c resident route", kept.kept)
    print(json.dumps({"gather_err": err, "gather": gather,
                      "launches": launches, "routed": routed}), flush=True)
    return 0


def resident_cell(calm):
    """22c: `BENCH_RESIDENT=4 python -m shadow_tpu_torch.bench` at HOSTS
    hosts a tenant, alone: program_key_stable and zero retraces, the
    lease counts of the trial, every tenant that was not evicted with
    the lane_digest of the undisturbed run (`calm`, 22b's process), and
    mailbox_gather exact on the resident route and timed there."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SHADOW_"))}
    env.update(BENCH_RESIDENT=str(RES_LANES),
               BENCH_SIM_SECONDS=str(RES_SIM_S))
    started = start_proc("22c bench BENCH_RESIDENT", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.resident_bench_main())"], env=env)
    code, stdout, stderr, wall = finish_proc(started)
    if code != 0:
        raise AssertionError(f"22c: exit {code}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    row = _json_line(stdout, '{"metric"')
    g = _json_line(stdout, '{"gather_err"')
    log(f"  22c: `BENCH_RESIDENT={RES_LANES} BENCH_SIM_SECONDS={RES_SIM_S}"
        f" python -m shadow_tpu_torch.bench` exit 0 in {wall:.1f} s: "
        f"{json.dumps(row)}")
    r = row["resident"]
    want = {"lanes": RES_LANES, "admitted": RES_LANES + 1,
            "completed": RES_LANES, "evicted": 1, "quarantined": 0,
            "resident": 0, "program_key_stable": True, "retraces": 0,
            "lane_width": 16_384}
    got = {k: r[k] for k in want}
    if got != want:
        raise AssertionError(f"22c: resident block {got} != {want}")
    if g["launches"] != sum(g["routed"]) or g["launches"] == 0:
        raise AssertionError(f"22c: mailbox_gather launched "
                             f"{g['launches']} times for {g['routed']} "
                             f"non-empty windows of the two trials")
    kept = [f"tenant-{k}" for k in range(RES_LANES - 1)]
    bad = [j for j in kept if row["digests"].get(j) != calm.get(j)]
    if bad or len(calm) != RES_LANES:
        raise AssertionError(f"22c: lanes {bad} differ from the "
                             f"undisturbed run ({row['digests']} against "
                             f"{calm})")
    log(f"  22c: tenants {kept} end with the undisturbed run's lane "
        f"digests; program key {r['program_key']} stable over "
        f"{r['admission_events']} admission events, retraces 0; "
        f"mailbox_gather launched {g['launches']} times = the non-empty "
        f"windows of the warm-up and timed trials {g['routed']}")
    gather = dict(g["gather"], launches=g["launches"])
    return {"resident": {k: row[k] for k in (
        "value", "wall_s", "warmup_s", "windows", "dispatches", "events")},
        "resident_gather": gather}, g["gather_err"]


def _sweep_points():
    """23a's SweepSpec (bench.py's lattice at full width) and {pid:
    JobSpec} of its round-0 points."""
    from shadow_tpu_torch import bench
    from shadow_tpu_torch.sweep import plan

    spec = plan.SweepSpec.from_obj(
        bench.sweep_spec_obj(HOSTS, LOAD, SWEEP_SIM_S))
    return spec, {p.pid: spec.point_spec(p, 0) for p in plan.expand(spec)}


def _kill_spec_obj():
    """23b's sweep: 23a's template at load 8 and an event queue of 24,
    swept over the seeds only."""
    from shadow_tpu_torch import bench

    obj = bench.sweep_spec_obj(HOSTS, LOAD, SWEEP_SIM_S)
    obj["sweep"]["id"] = "kill"
    obj["template"].update(load=LOAD, event_capacity=3 * LOAD)
    obj["axes"] = [{"field": "seed", "values": [1, 2]}]
    return obj


def trace_kernels(path) -> dict:
    """{"kernels": CUDA kernel events, "mailbox_gather": those of the
    port's kernel, "cats": events by category} of a Chrome trace that
    torch.profiler exported (its events' "cat" precedes their "name")."""
    import re

    with open(path) as f:
        text = f.read()
    cats: dict = {}
    out = {"kernels": 0, "mailbox_gather": 0}
    for m in re.finditer(r'"cat":\s*"([^"]*)",\s*"name":\s*"([^"]*)"',
                         text):
        cats[m.group(1)] = cats.get(m.group(1), 0) + 1
        if m.group(1) == "kernel":
            out["kernels"] += 1
            out["mailbox_gather"] += "mailbox_gather" in m.group(2)
    out["cats"] = cats
    return out


def _one_trace(directory):
    import glob
    import os

    found = glob.glob(os.path.join(directory, "torch_trace.*.json"))
    if len(found) != 1:
        raise AssertionError(f"23d: {len(found)} traces in {directory}")
    return found[0]


def _sweep_run(root, sweep_dir, env, err, *extra):
    """`python -m shadow_tpu_torch.cli sweep run` on one worker in a
    session of its own, its log (a line a fleet event) into the file
    `err`."""
    import subprocess

    return subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "sweep", "run",
         "--sweep-dir", sweep_dir, "--workers", "1", *extra], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        start_new_session=True)


def _fleet_status(fleet_dir) -> dict:
    from shadow_tpu_torch.fleet import journal

    recs, _ = journal.replay(fleet_dir + "/journal.log")
    st: dict = {}
    for r in recs:
        if r.get("job"):
            st.setdefault(r["job"], []).append(r["ev"])
    return st


def mesh_job(tmp, spec, env) -> dict:
    """23c: `python -m shadow_tpu_torch.cli fleet run` of `spec` as a
    `shards = 2` job on one worker; on two or more cards its rank 1 is
    SIGKILLed once the job's first snapshot is on disk (the pid its log
    line names). Returns the exit code, the card count, the pid killed,
    the job's manifest entry, tools/telemetry_lint.py's verdict on the
    fleet manifest and the seconds."""
    import os
    import signal
    import subprocess
    import threading
    from pathlib import Path

    import torch

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    jobs = os.path.join(tmp, "mesh_jobs.json")
    with open(jobs, "w") as f:
        json.dump({"fleet": {"backoff_base_s": 0.0, "backoff_cap_s": 0.0,
                             "lease_timeout_s": 300.0},
                   "jobs": [dict(spec.as_dict(), id="mesh", shards=2,
                                 checkpoint_every_windows=4)]}, f)
    fleet = os.path.join(tmp, "mesh_fleet")
    cards = torch.cuda.device_count()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "run",
         "--jobs-file", jobs, "--fleet-dir", fleet, "--workers", "1"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    killed = []

    def kill_rank():
        import glob

        job_dir = os.path.join(fleet, "jobs", "mesh")
        t_end = time.monotonic() + 600
        while time.monotonic() < t_end and proc.poll() is None:
            log_path = os.path.join(job_dir, "rank1.log")
            if os.path.exists(log_path) and glob.glob(
                    os.path.join(job_dir, "ck.*.npz")):
                with open(log_path) as f:
                    first = f.readline()
                if "pid " in first:
                    pid = int(first.split("pid ")[1])
                    os.kill(pid, signal.SIGKILL)
                    killed.append(pid)
                    return
            time.sleep(0.05)

    if cards >= 2:
        threading.Thread(target=kill_rank, daemon=True).start()
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
    man_path = os.path.join(fleet, "fleet_manifest.json")
    man = json.load(open(man_path)) if os.path.exists(man_path) else {}
    lint = subprocess.run(
        [sys.executable, str(root / "tools" / "telemetry_lint.py"),
         "--fleet-manifest", man_path], cwd=root, capture_output=True,
        text=True, timeout=300)
    return {"rc": proc.returncode, "cards": cards, "killed": killed,
            "job": (man.get("jobs") or {}).get("mesh"),
            "lint": [lint.returncode, (lint.stdout + lint.stderr)[-2000:]],
            "tail": stderr.strip().splitlines()[-20:],
            "s": round(time.perf_counter() - t0, 3)}


def check_mesh_job(m, o) -> dict:
    """23c's checks of mesh_job's result `m` against the oracle point
    `o`: exit 0, the job done, the manifest lint-clean, the oracle's
    events; on one card a lease of 1 and the oracle's digest, on two or
    more a killed rank, a lease of 2 and the oracle's width_digest.
    Returns the job's result."""
    j = m["job"] or {}
    res = j.get("result") or {}
    lease = res.get("device_lease") or {}
    ok = (m["rc"] == 0 and j.get("verdict") == "ok" and m["lint"][0] == 0
          and res.get("counters", {}).get("events_processed")
          == o["counters"]["events_processed"])
    if m["cards"] >= 2:
        ok = ok and bool(m["killed"]) and lease.get("leased") == 2 and \
            res.get("width_digest") == o["width_digest"]
    else:
        ok = ok and lease == {"requested": 2, "leased": 1,
                              "devices": ["cuda:0"], "final_shards": 1} \
            and res.get("digest") == o["digest"]
    if not ok:
        raise AssertionError(f"23c: {json.dumps(m)[-4000:]}")
    log(f"  23c: `fleet run` of {SWEEP_MESH} as a shards = 2 job on "
        f"{m['cards']} card(s): lease {json.dumps(lease)}, elastic "
        f"{json.dumps(res.get('elastic'))[:600]}, the oracle's "
        f"{'width_digest' if m['cards'] >= 2 else 'digest'}, the manifest "
        f"lint-clean; mailbox_gather "
        f"{res['kernel_launches']['mailbox_gather']} launches on the "
        f"reporting rank")
    return res


def oracle_side_main(tmp) -> int:
    """23a's serial oracle and 23c, beside phases 14-21: every point of
    the lattice by scenario.run_job in process on the card, its
    mailbox_gather launches counted, the first point's route inputs kept
    (the kernel against its plain version there, and timed); then
    mesh_job of p0000. Prints one {"sweep_side"} line. Run as `python3
    -c "import chip_smoke; chip_smoke.oracle_side_main(tmp)"`."""
    import os

    from shadow_tpu_torch.fleet.scenario import run_job

    env = dict(os.environ, SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    out = {}
    _, points = _sweep_points()
    t0 = time.perf_counter()
    out["oracle"], gather, err = {}, None, 0
    for pid, spec in points.items():
        with KeepGatherInputs() as kept:
            res = run_job(spec, os.path.join(tmp, "oracle", pid),
                          device="cuda")
        out["oracle"][pid] = {
            k: res.get(k) for k in ("ok", "digest", "width_digest",
                                    "counters", "kernel_launches",
                                    "health_verdict", "error")}
        if gather is None:
            err = kept.check("23a oracle p0000")
            gather = time_gather("23a oracle p0000 route", kept.kept)
    out["oracle_s"] = round(time.perf_counter() - t0, 3)
    out["gather"], out["gather_err"] = gather, err
    out["mesh"] = mesh_job(tmp, points[SWEEP_MESH], env)
    print(json.dumps({"sweep_side": out}), flush=True)
    return 0


def _bench_profiled(root, prof):
    """`python -m shadow_tpu_torch.bench` at phase 4's program cut to
    SWEEP_SIM_S, with BENCH_PROFILE_DIR=`prof` when given: {"rc", "row",
    "trace", "tail", "s"}."""
    import os
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SHADOW_"))}
    env.update(BENCH_SIM_SECONDS=str(SWEEP_SIM_S))
    if prof:
        env.update(BENCH_PROFILE_DIR=prof)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.bench"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=900)
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith('{"metric"')]
    return {"rc": r.returncode, "row": json.loads(rows[-1]) if rows else None,
            "trace": (trace_kernels(_one_trace(prof))
                      if prof and r.returncode == 0 else None),
            "tail": r.stderr[-3000:], "s": round(time.perf_counter() - t0, 3)}


def kill_side_main(tmp) -> int:
    """23b and 23d, beside phases 14-21: 23d's CLI with --profile-dir (a
    subprocess, beside the rest); 23b — `sweep run` of _kill_spec_obj
    SIGKILLed after its first completed point, then `--resume`; 23d's
    bench row at SWEEP_SIM_S without and then with BENCH_PROFILE_DIR (the
    rows' counts are compared; their events/s is not claimed). Prints
    one {"sweep_side"} line. Run as `python3 -c "import chip_smoke;
    chip_smoke.kill_side_main(tmp)"`."""
    import os
    import signal
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    out = {}
    prof = os.path.join(tmp, "prof")
    cli = start_cli("cli-phold-ref-prof", REFERENCE_PHOLD_XML, tmp,
                    "--profile-dir", prof, "--telemetry-capacity", "64")
    # ---- 23b: a sweep killed and resumed ----------------------------
    t0 = time.perf_counter()
    spec_path = os.path.join(tmp, "kill.json")
    with open(spec_path, "w") as f:
        json.dump(_kill_spec_obj(), f)
    d = os.path.join(tmp, "kill_sweep")
    logf = open(os.path.join(tmp, "kill_sweep.log"), "w")
    proc = _sweep_run(root, d, env, logf, "--spec", spec_path)
    try:
        done, t_end = [], time.monotonic() + 900
        while time.monotonic() < t_end and not done and proc.poll() is None:
            done = [j for j, evs in _fleet_status(d).items()
                    if "done" in evs]
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate(timeout=60)
    before = sorted(j for j, evs in _fleet_status(d).items()
                    if "done" in evs)
    kill_s = round(time.perf_counter() - t0, 3)
    resumed = _sweep_run(root, d, env, logf, "--resume")
    resumed.communicate(timeout=900)
    logf.close()
    with open(os.path.join(tmp, "kill_sweep.log")) as f:
        r_err = f.read()
    rep_path = os.path.join(d, "sweep_report.json")
    out["kill"] = {"rc": proc.returncode, "resume_rc": resumed.returncode,
                   "before": before, "status": _fleet_status(d),
                   "report": (json.load(open(rep_path))
                              if os.path.exists(rep_path) else None),
                   "jobs": {jid: {k: (j.get("result") or {}).get(k)
                                  for k in ("digest", "counters")}
                            for jid, j in (json.load(open(os.path.join(
                                d, "fleet_manifest.json"))).get("jobs")
                                or {}).items()},
                   "tail": r_err.strip().splitlines()[-20:],
                   "kill_s": kill_s,
                   "s": round(time.perf_counter() - t0, 3)}
    # ---- 23d: the bench row, then the same row with a profiled call --
    bprof = os.path.join(tmp, "bench_prof")
    out["bench"] = {"plain": _bench_profiled(root, None),
                    "profiled": _bench_profiled(root, bprof),
                    "dir": os.path.abspath(bprof)}
    # ---- 23d's CLI ----------------------------------------------------
    report = finish_cli(cli)[0]
    data = os.path.join(tmp, "cli-phold-ref-prof.data", "run_manifest.json")
    man = json.load(open(data))
    lint = load_lint().lint_manifest_obj(man)
    out["cli"] = {"report": report,
                  "profile": man.get("profile"), "lint": lint[0],
                  "trace": trace_kernels(_one_trace(prof)),
                  "dir": os.path.abspath(prof)}
    print(json.dumps({"sweep_side": out}), flush=True)
    return 0


def start_sweep_sides(tmp):
    """Phase 23's untimed runs, in two processes started beside phases
    14-21: {"23o": oracle_side_main, "23k": kill_side_main}, each in a
    directory of its own under `tmp`."""
    import os

    out = {}
    for key, fn in (("23o", "oracle_side_main"), ("23k", "kill_side_main")):
        d = os.path.join(tmp, key)
        os.makedirs(d, exist_ok=True)
        out[key] = start_proc(f"{key} sweep side", [
            sys.executable, "-c", "import sys, chip_smoke; "
            f"sys.exit(chip_smoke.{fn}({d!r}))"])
    return out


def sweep_bench_main() -> int:
    """23a's bench process: `python -m shadow_tpu_torch.bench`'s main
    with BENCH_SWEEP in the environment; after each sweep has returned
    and its wall was read (the row's report() call after run()), its
    fleet manifest's per-point results are kept (the row deletes the
    directories). Prints the row, then one {"sweep_runs"} line. Run as
    `python3 -c "import chip_smoke; chip_smoke.sweep_bench_main()"`."""
    import os

    from shadow_tpu_torch import bench
    from shadow_tpu_torch.sweep import driver as sweep_driver

    real = (sweep_driver.SweepDriver.run, sweep_driver.SweepDriver.report)
    runs = []

    def run(self, **kw):
        rc = real[0](self, **kw)
        self._returned = True
        return rc

    def report(self):
        blk = real[1](self)
        if getattr(self, "_returned", False):
            man = json.load(open(os.path.join(self.sweep_dir,
                                              "fleet_manifest.json")))
            jobs = {}
            for jid, j in man["jobs"].items():
                res = j.get("result") or {}
                jm = (json.load(open(res["manifest"]))
                      if res.get("manifest") else {})
                jobs[jid] = {"status": j.get("status"),
                             "digest": res.get("digest"),
                             "counters": res.get("counters"),
                             "kernel_launches": res.get("kernel_launches"),
                             "hit": (jm.get("compile") or {}).get("hit")}
            runs.append({"ranking": blk["ranking"], "best": blk["best"],
                         "prewarm": blk.get("prewarm"), "jobs": jobs})
        return blk

    sweep_driver.SweepDriver.run, sweep_driver.SweepDriver.report = \
        run, report
    try:
        code = bench.main([])
    finally:
        sweep_driver.SweepDriver.run, sweep_driver.SweepDriver.report = \
            real
    print(json.dumps({"sweep_runs": runs}), flush=True)
    return code


def _oracle_ranking(oracle, pids):
    """The ranking reduce.rank gives the oracle's results of `pids`
    (pid -> oracle pid) as fleet-manifest entries: what an uninterrupted
    sweep of those points ranks, by the reducer's purity."""
    from shadow_tpu_torch.sweep import plan, reduce

    entries = {pid: {"status": "done", "result": {
        "counters": oracle[o]["counters"],
        "health_verdict": oracle[o]["health_verdict"]}}
        for pid, o in pids.items()}
    return reduce.rank(entries, plan.Objective(metric="events", goal="max"))


def sweep_cell(sides, smi):
    """Phase 23's checks: 23b, 23c and 23d from the side processes
    (`sides`); then 23a's bench process alone (its row, each point's
    events and digest equal to the serial oracle's, the best point the
    oracle's, mailbox_gather launched on each point as in the oracle's
    run). Returns (row fields, max abs error of the kernel on the
    sweep's route)."""
    import os
    import shutil
    import signal
    import tempfile

    got, f, walls = {}, {}, {}
    for key, side in sides.items():
        code, stdout, stderr, walls[key] = finish_proc(side)
        if code != 0:
            raise AssertionError(f"{key} side: exit {code}:\n"
                                 f"{stdout[-3000:]}\n{stderr[-3000:]}")
        f.update(_json_line(stdout, '{"sweep_side"')["sweep_side"])
    oracle = f["oracle"]
    bad = {p: o for p, o in oracle.items() if not o["ok"]}
    if bad:
        raise AssertionError(f"23a oracle: {bad}")
    log(f"  23 sides: the serial oracle's {len(oracle)} points in "
        f"{f['oracle_s']} s, then 23c in {f['mesh']['s']} s (the process "
        f"{walls['23o']:.1f} s from its start); 23b in {f['kill']['s']} s, "
        f"23d's two bench rows in {f['bench']['plain']['s']} and "
        f"{f['bench']['profiled']['s']} s (the process "
        f"{walls['23k']:.1f} s from its start)")
    # ---- 23b -----------------------------------------------------------
    k = f["kill"]
    want_rank = _oracle_ranking(oracle, SWEEP_KILL_POINTS)
    rep = k["report"] or {}
    if (k["rc"] != -signal.SIGKILL or k["resume_rc"] != 0
            or len(k["before"]) != 1):
        raise AssertionError(f"23b: {k}")
    first = k["before"][0]
    evs = k["status"][first]
    if evs.count("leased") != 1 or any(
            e.count("done") != 1 for e in k["status"].values()):
        raise AssertionError(f"23b: a point ran again: {k['status']}")
    if json.dumps(rep.get("ranking")) != json.dumps(want_rank) or \
            rep.get("best") != want_rank[0]["point"]:
        raise AssertionError(f"23b: ranking {rep.get('ranking')} != "
                             f"{want_rank}")
    for pid, o in SWEEP_KILL_POINTS.items():
        if k["jobs"][f"r0-{pid}"]["digest"] != oracle[o]["digest"]:
            raise AssertionError(f"23b {pid}: digest != the oracle's {o}")
    log(f"  23b: `sweep run` SIGKILLed {k['kill_s']} s in, after {first} "
        f"completed; `--resume` exit 0, {first} leased once, every point "
        f"done once; ranking and best {rep['best']} byte for byte the "
        f"uninterrupted ranking of the oracle's points "
        f"{sorted(SWEEP_KILL_POINTS.values())}, each digest the oracle's")
    got["sweep_kill"] = {"kill_s": k["kill_s"], "s": k["s"]}
    # ---- 23c -----------------------------------------------------------
    res = check_mesh_job(f["mesh"], oracle[SWEEP_MESH])
    got["launches_sharded"] = res["kernel_launches"]["mailbox_gather"]
    got["sweep_mesh"] = {"lease": res["device_lease"], "s": f["mesh"]["s"]}
    # ---- 23d -----------------------------------------------------------
    c = f["cli"]
    check_report("23d cli-phold-ref --profile-dir", c["report"],
                 PHOLD_REF_REPORT)
    if (c["profile"] != {"dir": c["dir"], "tool": "torch.profiler"}
            or c["lint"] or c["trace"]["kernels"] == 0):
        raise AssertionError(f"23d CLI: {c}")
    log(f"  23d: `python -m shadow_tpu_torch.cli --profile-dir` on "
        f"cli-phold-ref: the report as 14b's ({c['report']['wall_seconds']} "
        f"s of run), the manifest's profile block {c['profile']} "
        f"lint-clean, the trace {c['trace']['kernels']} CUDA kernel events, "
        f"{c['trace']['mailbox_gather']} of mailbox_gather; by category "
        f"{json.dumps(c['trace']['cats'])}")
    tmp = tempfile.mkdtemp(prefix="shadow_sweep_bench_")
    # ---- 23a -----------------------------------------------------------
    log(f"[23a] `BENCH_SWEEP=1 BENCH_SIM_SECONDS={SWEEP_SIM_S} python -m "
        f"shadow_tpu_torch.bench` at {HOSTS} hosts, load {LOAD}, 2 workers")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SHADOW_"))}
    env.update(BENCH_SWEEP="1", BENCH_SIM_SECONDS=str(SWEEP_SIM_S),
               SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    started = start_proc("23a bench BENCH_SWEEP", [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.sweep_bench_main())"], env=env)
    code, stdout, stderr, wall = finish_proc(started)
    if code != 0:
        raise AssertionError(f"23a: exit {code}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    row = _json_line(stdout, '{"metric"')
    runs = _json_line(stdout, '{"sweep_runs"')["sweep_runs"]
    log(f"  23a: exit 0 in {wall:.1f} s: {json.dumps(row)}")
    sw = row["sweep"]
    if (sw["exit_warm"], sw["exit_timed"], sw["lattice_conserved"],
            sw["prewarm_hit_rate"], sw["points"]["completed"]) != (
            0, 0, True, 1.0, len(oracle)):
        raise AssertionError(f"23a: sweep block {sw}")
    if len(runs) != 2:
        raise AssertionError(f"23a: {len(runs)} sweeps reported")
    timed = runs[1]
    launches = 0
    for pid, o in sorted(oracle.items()):
        j = timed["jobs"][f"r0-{pid}"]
        want = (o["counters"]["events_processed"], o["digest"],
                o["kernel_launches"]["mailbox_gather"])
        have = (j["counters"]["events_processed"], j["digest"],
                j["kernel_launches"]["mailbox_gather"])
        if j["status"] != "done" or have != want or not j["hit"]:
            raise AssertionError(f"23a {pid}: {j} against the oracle's "
                                 f"{o}")
        launches += have[2]
        log(f"  23a {pid}: events {have[0]}, digest {have[1][:16]} = the "
            f"oracle's; mailbox_gather {have[2]} launches = the oracle's; "
            f"program a store hit")
    want_rank = _oracle_ranking(oracle, {p: p for p in oracle})
    if json.dumps(timed["ranking"]) != json.dumps(want_rank) or \
            timed["best"] != want_rank[0]["point"]:
        raise AssertionError(f"23a: ranking {timed['ranking']} != the "
                             f"oracle's {want_rank}")
    if launches == 0:
        raise AssertionError("23a: no point launched mailbox_gather")
    log(f"  23a on {smi}: {row['value']} points/s ({row['wall_seconds']} s "
        f"for {sw['points']['completed']} points on 2 workers; the warm-up "
        f"sweep {row['compile_s']} s), prewarm {sw['prewarm_hits']}/"
        f"{sw['prewarm_hits'] + sw['prewarm_compiled']} hits, best "
        f"{sw['best']} = the oracle's; mailbox_gather {launches} launches "
        f"over the scored sweep's points")
    got["sweep"] = {k: row[k] for k in ("value", "wall_seconds",
                                        "compile_s", "compile_cache")}
    got["sweep"].update(best=sw["best"], prewarm_hits=sw["prewarm_hits"],
                        distinct=sw["distinct_programs"],
                        warm_prewarm=runs[0]["prewarm"])
    got["launches_sweep"] = launches
    # ---- 23d's bench ---------------------------------------------------
    bb = f["bench"]
    for k in ("plain", "profiled"):
        if bb[k]["rc"] != 0 or bb[k]["row"] is None:
            raise AssertionError(f"23d bench ({k}): exit {bb[k]['rc']}:\n"
                                 f"{bb[k]['tail']}")
    brow, tk = bb["profiled"]["row"], bb["profiled"]["trace"]
    counts = {k: brow[k] for k in ("metric", "events", "windows",
                                   "micro_steps")}
    want = {k: bb["plain"]["row"][k] for k in counts}
    if counts != want:
        raise AssertionError(f"23d bench: counts {counts} != the "
                             f"unprofiled row's {want}")
    if brow.get("profile") != {"dir": bb["dir"], "tool": "torch.profiler"}:
        raise AssertionError(f"23d bench: no capture: {brow}\n"
                             f"{bb['profiled']['tail']}")
    if tk["kernels"] == 0:
        raise AssertionError(f"23d bench: the trace holds no CUDA kernel "
                             f"event: {tk}")
    log(f"  23d: `BENCH_SIM_SECONDS={SWEEP_SIM_S} python -m "
        f"shadow_tpu_torch.bench` with BENCH_PROFILE_DIR exit 0 in "
        f"{bb['profiled']['s']} s (beside phases 14-21): the row's counts "
        f"those of the same row without it, {want}; the profiled extra "
        f"call's trace {tk['kernels']} CUDA kernel events, "
        f"{tk['mailbox_gather']} of mailbox_gather; by category "
        f"{json.dumps(tk['cats'])}")
    got["profile"] = {"cli": c["trace"], "bench": tk,
                      "bench_s": bb["profiled"]["s"]}
    shutil.rmtree(tmp, ignore_errors=True)
    gather = dict(f["gather"], launches=launches)
    got["sweep_route"] = {k: gather[k] for k in (
        "n", "ms", "plain_ms", "bound_ms", "library_ms", "launches")}
    return got, f["gather_err"]


def _tool_main(fn, argv):
    """(exit code, stdout lines, seconds) of a tool twin's main(argv)
    run in this process, its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv))
    return rc, buf.getvalue().splitlines(), round(time.perf_counter() - t0, 3)


def _summary_json(lines):
    """The last top-level JSON object of a tool's printed lines."""
    text = "\n".join(lines)
    return json.loads(text[text.rindex("\n{") + 1:] if "\n{" in text
                      else text[text.index("{"):])


def tools_side_main(tmp) -> int:
    """24b and 24c beside phases 14-23: every chaos_soak mode of
    SOAK_MODES through the twin's main() on the card (the side process's
    mailbox_gather launches over them counted; the device-loss ranks,
    the sweep's and the fleet's workers are processes of their own),
    then compcache_ctl: prewarm --test (the trimmed and the full
    program), ls, stats, gc down to one entry, and prewarm --sweep on
    CC_SWEEP_SPEC cold and warm. Prints one {"tools_side"} line. Run as
    `python3 -c "import chip_smoke; chip_smoke.tools_side_main(tmp)"`."""
    import os

    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.tools import chaos_soak, compcache_ctl

    t0 = time.perf_counter()
    out = {"soak": {}, "cc": {}}
    mailbox_gather.launches = 0
    for mode, argv in SOAK_MODES.items():
        if mode == "jobs":
            argv = argv + ["--fleet-dir", os.path.join(tmp, "jobs")]
        rc, lines, secs = _tool_main(chaos_soak.main, argv)
        out["soak"][mode] = {"rc": rc, "s": secs, "reports": [
            json.loads(ln) for ln in lines if ln.startswith('{"seed"')]}
    out["launches_chaos"] = mailbox_gather.launches

    cc = out["cc"]
    root = os.path.join(tmp, "aot_test")
    for key, argv in (("test", ["prewarm", "--test"]),
                      ("test_full", ["prewarm", "--test", "--specialize",
                                     "off"])):
        rc, lines, secs = _tool_main(compcache_ctl.main,
                                     ["--root", root, *argv])
        cc[key] = {"rc": rc, "s": secs, "info": _summary_json(lines),
                   "lines": [ln for ln in lines if not ln.startswith(
                       (" ", "{", "}"))]}
    rc, lines, secs = _tool_main(compcache_ctl.main, ["--root", root, "ls"])
    cc["ls"] = {"rc": rc, "s": secs, "lines": lines}
    rc, lines, secs = _tool_main(compcache_ctl.main,
                                 ["--root", root, "stats"])
    cc["stats"] = {"rc": rc, "s": secs, "stats": json.loads("\n".join(lines))}
    rc, lines, secs = _tool_main(compcache_ctl.main, [
        "--root", root, "gc", "--max-bytes",
        str(cc["stats"]["stats"]["total_bytes"] - 1)])
    cc["gc"] = {"rc": rc, "s": secs, "out": json.loads("\n".join(lines))}
    rc, lines, _ = _tool_main(compcache_ctl.main, ["--root", root, "stats"])
    cc["after_gc"] = json.loads("\n".join(lines))
    spec = os.path.join(tmp, "cc_sweep.json")
    with open(spec, "w") as f:
        json.dump(CC_SWEEP_SPEC, f)
    for key in ("cold", "warm"):
        rc, lines, secs = _tool_main(compcache_ctl.main, [
            "--root", os.path.join(tmp, "aot_sweep"), "prewarm", "--sweep",
            spec])
        cc[key] = {"rc": rc, "s": secs, "out": _summary_json(lines)}
    out["s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"tools_side": out}), flush=True)
    return 0


def start_tools_side(tmp):
    """24b and 24c's process, started beside phases 14-23 at a lower CPU
    priority (TOOLS_NICE) than the phases' own work: the soak's ranks
    and fleet workers (and their children) take the host's idle cores,
    not the timed phases'."""
    import os

    os.makedirs(tmp, exist_ok=True)
    return start_proc("24 tools side", [
        sys.executable, "-c", "import sys, chip_smoke; "
        f"sys.exit(chip_smoke.tools_side_main({tmp!r}))"], nice=TOOLS_NICE)


def _soak_equal(label, got, want, keys=None):
    """A soak report equal to its CPU pin (on `keys` when given)."""
    if keys is not None:
        got = {k: got.get(k) for k in keys}
    if got != want:
        raise AssertionError(f"24b {label}: {json.dumps(got)} != the CPU's "
                             f"{json.dumps(want)}")


def tools_cell(side):
    """24b and 24c's checks on the tools side process's line: every soak
    mode exit 0 with every report ok and equal to its CPU pin, the
    side's launches counted; compcache_ctl's entries, gc and the sweep
    census's cold and warm counts. Returns the row fields."""
    code, stdout, stderr, wall = finish_proc(side)
    if code != 0:
        raise AssertionError(f"24 tools side: exit {code}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    f = _json_line(stdout, '{"tools_side"')["tools_side"]
    soak = f["soak"]
    for mode, r in soak.items():
        if r["rc"] != 0 or not r["reports"] \
                or not all(rep.get("ok") for rep in r["reports"]):
            raise AssertionError(f"24b {mode}: exit {r['rc']}, reports "
                                 f"{json.dumps(r['reports'])[:3000]}")
    _soak_equal("--verify", soak["trial"]["reports"][0], SOAK_TRIAL[2])
    _soak_equal("--replicas 4", soak["replicas"]["reports"][0], SOAK_REPLICA)
    _soak_equal("--device-loss --shards 4", soak["device_loss"]["reports"][0],
                SOAK_DEVICE_LOSS)
    _soak_equal("--churn", soak["churn"]["reports"][0], SOAK_CHURN,
                keys=SOAK_CHURN)
    _soak_equal("--sweep", soak["sweep"]["reports"][0], SOAK_SWEEP,
                keys=SOAK_SWEEP)
    if soak["sweep"]["reports"][0]["kills"] < 1:
        raise AssertionError("24b --sweep: no worker was killed")
    jobs = soak["jobs"]["reports"]
    if [r["seed"] for r in jobs] != [2, 3]:
        raise AssertionError(f"24b --jobs 2: seeds {[r['seed'] for r in jobs]}")
    for rep in jobs:
        _soak_equal(f"--jobs 2 seed {rep['seed']}", rep, SOAK_TRIAL[
            rep["seed"]])
    if f["launches_chaos"] <= 0:
        raise AssertionError("24b: mailbox_gather was never launched")
    log(f"  24b on the card, each mode's report equal to the CPU's: "
        + ", ".join(f"{m} {r['s']} s" for m, r in soak.items())
        + f"; {f['launches_chaos']} mailbox_gather launches in the side "
        f"process ({f['s']} s of work; the process ended {wall:.1f} s after "
        f"its start)")
    cc = f["cc"]
    for key in ("test", "test_full"):
        info = cc[key]["info"]
        if cc[key]["rc"] != 0 or not info.get("stored") or info.get("hit"):
            raise AssertionError(f"24c prewarm {key}: {cc[key]}")
    if "specializing: trimmed loss (key extra 'no_loss')" \
            not in cc["test"]["lines"]:
        raise AssertionError(f"24c prewarm --test: {cc['test']['lines']}")
    ls = cc["ls"]["lines"]
    keys = [cc[k]["info"]["key"] for k in ("test", "test_full")]
    if cc["ls"]["rc"] != 0 or not ls[0].endswith("— 2 entries") \
            or [ln.split()[0] for ln in ls[1:]] != keys \
            or not all(ln.endswith(" servable") for ln in ls[1:]):
        raise AssertionError(f"24c ls: {ls}")
    st = cc["stats"]["stats"]
    if st["entries"] != 2 or st["specialized"] != 1:
        raise AssertionError(f"24c stats: {st}")
    if cc["gc"]["out"]["dropped"] != keys[:1] \
            or cc["after_gc"]["entries"] != 1:
        raise AssertionError(f"24c gc: {cc['gc']} then {cc['after_gc']}")
    cold, warm = cc["cold"]["out"], cc["warm"]["out"]
    if (cc["cold"]["rc"], cc["warm"]["rc"]) != (0, 0) \
            or (cold["points"], cold["distinct"]) != (4, 2) \
            or (cold["compiled"], cold["hits"]) != (2, 0) \
            or (warm["compiled"], warm["hits"]) != (0, 2) \
            or [k["key"] for k in warm["keys"]] \
            != [k["key"] for k in cold["keys"]] \
            or [k["affinity_key"] for k in cold["keys"]] != CC_AFFINITY:
        raise AssertionError(f"24c prewarm --sweep: cold {cold}, warm {warm}")
    log(f"  24c: prewarm --test {cc['test']['s']} s (trimmed) and "
        f"{cc['test_full']['s']} s (full), 2 entries, gc to 1; prewarm "
        f"--sweep cold {cc['cold']['s']} s (2 built, 0 hits), warm "
        f"{cc['warm']['s']} s (0 built, 2 hits), the census's affinity keys "
        f"the reference's")
    return {"launches_chaos": f["launches_chaos"],
            "tools": {"soak_s": {m: r["s"] for m, r in soak.items()},
                      "compcache_s": {k: cc[k]["s"] for k in (
                          "test", "test_full", "cold", "warm")},
                      "side_s": f["s"]}}


def scale_cell(device):
    """24a: tools/scale_run.py's 100k tier through the twin, alone: its
    main path (parse_args and run: the escalating warm-up on seed 1, the
    timed run on seed 2) with the launch counter set to 0 just before
    and read just after, mailbox_gather's route inputs kept; the row's
    gates, PHOLD conservation on the timed run's state, and the kernel
    against its plain version on the route and timed there. Returns
    (row fields, max abs error)."""
    import torch

    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.tools import scale_run

    args = scale_run.parse_args(list(SCALE_ARGV))
    torch.cuda.synchronize()
    mailbox_gather.launches = 0
    with KeepGatherInputs() as kept:
        t0 = time.perf_counter()
        scale, sim, cap = scale_run.run(args, device, say=log)
        wall = time.perf_counter() - t0
    launches = mailbox_gather.launches
    log(f"  24a: {json.dumps(scale)}")
    log(f"  24a: the escalation's final capacity {cap}; warm-up and timed "
        f"run {wall:.1f} s together")
    if not scale["verified"] or scale["overflow"] != 0 \
            or scale["platform"] != "cuda":
        raise AssertionError(f"24a: {scale}")
    if SCALE_EVENTS is not None and scale["events"] != SCALE_EVENTS:
        raise AssertionError(f"24a: events {scale['events']} != the "
                             f"reference's {SCALE_EVENTS}")
    check_phold("24a scale_run 100k", sim, SCALE_HOSTS, SCALE_LOAD,
                {"mailbox_gather": launches})
    err = kept.check("24a")
    gather = time_gather("24a route", kept.kept)
    del sim, kept
    return {"launches_scale_100k": launches, "scale_100k": {
        "row": scale, "final_capacity": cap, "gather": {k: gather[k] for k in (
            "n", "H", "P", "ms", "plain_ms", "bound_ms", "library_ms")}}}, err


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
    """Phases 1-24 and the result lines (main starts and stops the CPU
    halves' worker around them)."""
    import os
    import tempfile

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
    phase4 = main4[2].as_dict()   # 22a's bench rows hold these counts

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
    # phase 20's and 21's untimed runs (20b, 20c, 21b-21e) start here,
    # beside 14-19
    shards_tmp = tempfile.TemporaryDirectory(prefix="shadow_shards_")
    shards_side = start_shards_side(shards_tmp.name)
    shards_side["21"] = start_elastic_side()
    # and phase 23's (its serial oracle and 23c; 23b and 23d)
    sweep_tmp = tempfile.TemporaryDirectory(prefix="shadow_sweep_")
    shards_side.update(start_sweep_sides(sweep_tmp.name))
    # and phase 24's (24b, 24c), 18a's CLI and 19c's two long CLIs
    shards_side["24s"] = start_tools_side(os.path.join(sweep_tmp.name, "24s"))
    shards_side["18a"] = start_obs_cli(os.path.join(sweep_tmp.name, "18a"))
    os.makedirs(os.path.join(sweep_tmp.name, "19c"))
    shards_side.update(start_reftests_clis(os.path.join(sweep_tmp.name, "19c"),
                                           VP_LONG, nice=VP_NICE))
    # phase 17 frees these: no reference stays here
    carried = [main4, relay6s, phase4]
    del main4, relay6s
    try:
        return _phases_14_on(args, row, device, smi, kind, phase, phase_s,
                             shards_side, carried)
    finally:
        for st in shards_side.values():
            stop_proc(st)
        shards_tmp.cleanup()
        sweep_tmp.cleanup()


def _phases_14_on(args, row, device, smi, kind, phase, phase_s,
                  shards_side, carried) -> int:
    """Phases 14-24 and the result lines (run_phases' tail; 20b, 20c,
    21b-21e, 23's and 24's side work already running; `carried` holds
    phases 4's and 6s's runs for 17)."""
    import tempfile

    main4, relay6s, phase4 = carried
    carried.clear()

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

    # phase 22's fleet and its oracles run beside phases 16-21
    fleet_tmp = tempfile.TemporaryDirectory(prefix="shadow_fleet_")
    fleet_side = start_fleet_side(fleet_tmp.name)
    keep = [main4, relay6s]
    del main4, relay6s
    try:
        return _phases_16_on(args, row, device, smi, kind, phase, phase_s,
                             shards_side, keep, phase4, fleet_side)
    finally:
        stop_proc(fleet_side)
        fleet_tmp.cleanup()


def _phases_16_on(args, row, device, smi, kind, phase, phase_s,
                  shards_side, keep, phase4, fleet_side) -> int:
    """Phases 16-24 and the result lines (22b and 22c's oracle already
    running in `fleet_side`; `keep` holds phases 4's and 6s's runs for
    17)."""
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
    return _phases_17_on(args, row, device, smi, kind, phase, phase_s,
                         shards_side, keep, phase4, fleet_side)


def _phases_17_on(args, row, device, smi, kind, phase, phase_s,
                  shards_side, keep, phase4, fleet_side) -> int:
    """Phases 17-24 and the result lines (22b and 22c's oracle already
    running in `fleet_side`, phase 23's untimed runs in
    `shards_side["23o"]` and `["23k"]`, 24b and 24c in
    `shards_side["24s"]`; `keep` holds phases 4's and 6s's runs for
    17)."""
    import tempfile

    import torch

    main4, relay6s = keep
    keep.clear()

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
    # phase 19's untimed work starts beside 18c
    vp_tmp = tempfile.TemporaryDirectory(prefix="shadow_vproc_")
    # 19c's long CLIs, started at 14, are checked with the others
    vp_clis = {k: st for k, st in shards_side.items()
               if k.startswith("reftests ")}
    tcp_cpu = []
    try:
        got, err = obs_cell(device, untimed=lambda: tcp_cpu.append(
            start_vproc_untimed(vp_tmp.name, vp_clis)))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(got)
        obs = got["obs"]
        log(f"  phase 18 profile on {smi}: {obs['ms_per_window']} ms a "
            f"window and a drain of {obs['drain_ms_per_window']} ms on top "
            f"({obs['ms_per_window_with_drain']} ms hook to hook), "
            f"{obs['micro_steps_per_window']} micro-steps a window; the "
            f"drains {obs['drain_share'] * 100:.1f}% of 18b's whole run")

        phase("19")
        log(f"[19] virtual processes: {VP_HOSTS} coroutines over UDP and "
            f"TCP through ProcessRuntime; the reftests configs, a .py "
            f"plugin and --host-kernel diff through the CLI")
        got, err = vproc_cell(device, vp_tmp.name, vp_clis, tcp_cpu[0],
                              obs_cli=shards_side["18a"])
        row["max_abs_err"] = max(row["max_abs_err"], err)
        udp_oracle = got.pop("udp_oracle")
        row.update(got)
    finally:
        for st in vp_clis.values():
            stop_proc(st)
        vp_tmp.cleanup()

    phase("20")
    log(f"[20] the sharded window loop on this card: `BENCH_SHARDS="
        f"{SHARDS} BENCH_SENTINEL=1 BENCH_SENTINEL_OVERHEAD=1 python -m "
        f"shadow_tpu_torch.bench` ({HOSTS} hosts as {SHARDS} ranks, "
        f"{SHARD_SIM_S} sim-s; 20a its twin without the sentinel, 21a the "
        f"run with it) against one shard; the CLI "
        f"with --workers 2; run_supervised on {SUP_MESH_RANKS} ranks with "
        f"the degraded plan to {SUP_MESH_SIM_S} sim-s")
    got, err = shards_cell(device, shards_side)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["shards"] = got.pop("shards")
    oracles = got.pop("oracles")
    row.update(got)

    phase("21")
    log(f"[21] elastic degraded-mesh recovery: the sentinel's cost in "
        f"20's row; run_supervised on {EL_RANKS} ranks with two poisoned "
        f"dispatches, on 2 with a diverging replica, on {EL_RANKS} with a "
        f"rank killed; ProcessRuntime on 2 ranks")
    got, err = elastic_cell(device, shards_side, oracles, udp_oracle)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(got)

    phase("22")
    log(f"[22] warm-start serving and the scenario fleet: BENCH_WARM=1 "
        f"bench processes (a miss on an empty build root and store; then "
        f"together a hit, the store off, a miss after a flipped byte); "
        f"`fleet run --workers "
        f"{FLEET_WORKERS}` on {len(FLEET_JOBS)} scenario jobs of {HOSTS} "
        f"hosts (a worker SIGKILLed) against the serial oracle; "
        f"BENCH_RESIDENT={RES_LANES} at {HOSTS} hosts a tenant, "
        f"{RES_SIM_S} sim-s")
    row.update(warm_cell(phase4))
    got, calm = fleet_cell(fleet_side)
    row.update(got)
    got, err = resident_cell(calm)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    gather = got.pop("resident_gather")
    row["resident_route"] = {k: gather[k] for k in (
        "n", "ms", "plain_ms", "bound_ms", "library_ms", "launches")}
    row.update(got)

    phase("23")
    log(f"[23] the counterfactual sweep, sharded fleet jobs and profiles: "
        f"BENCH_SWEEP=1 at {HOSTS} hosts (8 points, {SWEEP_SIM_S} sim-s, 2 "
        f"workers) against its serial oracle; a sweep SIGKILLed and "
        f"resumed; a shards = 2 fleet job; --profile-dir and "
        f"BENCH_PROFILE_DIR")
    got, err = sweep_cell({k: shards_side[k] for k in ("23o", "23k")},
                          smi)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(got)

    phase("24")
    log("[24] the tools twins: chaos_soak's modes and compcache_ctl (24b, "
        "24c, in the side process started at 14), then `python -m "
        "shadow_tpu_torch.tools.scale_run " + " ".join(SCALE_ARGV) + "` "
        "alone (24a)")
    row.update(tools_cell(shards_side["24s"]))
    got, err = scale_cell(device)
    row["max_abs_err"] = max(row["max_abs_err"], err)
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
