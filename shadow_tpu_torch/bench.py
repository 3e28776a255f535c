"""Benchmark of the port: events/s on bench.py's two workloads, printed
as bench.py's one JSON row. Run it as

    python -m shadow_tpu_torch.bench [--faults PLAN.json]

`--faults` (or BENCH_FAULTS) installs a JSON fault plan
(faults.records_from_json, e.g. examples/faultplan_degraded.json) on
every PHOLD or injection input: the degraded-network row, named with
`_faults`.

Env knobs (bench.py's, for what the port runs):

  BENCH_WORKLOAD=phold|pingpong  PHOLD (default) or the UDP ping/echo
                                 pairs (20 pings each, client i to
                                 server i; every client must reach 20)
  BENCH_TOPO=one|mix             'one' = the one-vertex 50 ms graph
                                 (pingpong: __graft_entry__'s, 10,240
                                 KiB/s); 'mix' = bench.py's three-vertex
                                 MIX_VERTICES (~1.1 ms windows) for
                                 either workload — bench.py keeps the
                                 one-vertex graph for pingpong under
                                 'mix', this module does not
  BENCH_HOSTS=N                  host count (default 10240)
  BENCH_SIM_SECONDS=N            simulated seconds (default 5)
  BENCH_LOAD=N                   PHOLD messages per host (default 8)
  BENCH_TELEMETRY=0              PHOLD without the window telemetry
                                 ring (default on)
  BENCH_CHUNK_WINDOWS=K          run through net.build.make_chunked_runner,
                                 K windows per chunk (metric name gains
                                 _chunk{K}; the port's own row, bench.py
                                 takes K only under BENCH_SUPERVISE=1);
                                 under BENCH_SUPERVISE=1 the supervised
                                 loop's windows_per_dispatch
  BENCH_SUPERVISE=1              PHOLD through faults.run_supervised (name
                                 gains _supervised_chunk{K or 1}, and
                                 _adaptive with BENCH_ADAPTIVE_JUMP=1)
  BENCH_CHECKPOINT_WINDOWS=N     supervised checkpoint cadence (default:
                                 never)
  BENCH_ADAPTIVE_JUMP=1          the supervised loop's adaptive window rule
  BENCH_MIN_JUMP_MS=M            PHOLD only: lowers (never raises) the
                                 window span to M ms (name gains _mj{M}ms)
  BENCH_INJECT_RATE=R            open-system injection: the tgen app
                                 (every host binds a UDP socket) fed a
                                 synthesized uniform trace of R events/s
                                 (round-robin sources, 64-byte datagrams
                                 to the next host) streamed through
                                 faults.run_supervised with a fresh
                                 inject.Feeder per run; the name is
                                 ..._inject_rate{R}_chunk{K or 1}
  BENCH_INJECT_TRACE=PATH        the same scenario replaying a trace file
                                 (name ..._inject_trace_chunk{K or 1});
                                 exclusive with BENCH_INJECT_RATE. The
                                 loop knobs (BENCH_CHUNK_WINDOWS,
                                 BENCH_ADAPTIVE_JUMP,
                                 BENCH_CHECKPOINT_WINDOWS,
                                 BENCH_MIN_JUMP_MS) apply; BENCH_WORKLOAD
                                 and BENCH_SUPERVISE do not
  BENCH_FAULTS=PLAN.json         as --faults
  BENCH_REPLICAS=R               PHOLD ensemble: R independent replicas
                                 of the H-host program packed into one
                                 program of R*H rows (aggregate
                                 events/s; name gains _x{R}replicas)
  BENCH_LANE_ISOLATION=1         with BENCH_REPLICAS > 1: lane-scoped
                                 health latches, one lane a replica
                                 (core/lanes.py; name gains _lanes)
  BENCH_FLOW_SAMPLE=N            the flow flight-recorder on the timed
                                 inputs, 1-in-N sampling (PHOLD and
                                 injection; name gains _flow{N}; the
                                 row gains a "flows" block)
  BENCH_FLOW_OVERHEAD=1          rebuild without the flow ring, time it
                                 and record flow_overhead_pct
  BENCH_CAUSALITY=N              the causality recorder on the timed
                                 inputs (name gains _caus{N}; the row
                                 gains a "causality" block)
  BENCH_CAUSALITY_OVERHEAD=1     the same A/B for the causality planes
  BENCH_ACTIVE=N                 sparse PHOLD shape: only the first N
                                 hosts inject load (phold.setup
                                 active_hosts); the bulk pass is off
                                 (it would consume whole windows before
                                 the sparse fast path ran); name gains
                                 _active{N}
  BENCH_SPARSE_LANES=S           the compact-lane budget
                                 (cfg.sparse_lanes; unset = the engine
                                 default 256, 0 = the fast path off)
  BENCH_SPECIALIZE=1             plain PHOLD runner only: the timed
                                 program is the capability-trimmed one
                                 (compile/specialize.py, applied after
                                 every attachment, the guard on every
                                 timed input; name gains _spec); the
                                 unspecialized twin of the same
                                 workload is warmed and timed too, and
                                 the row gains specialize_speedup
                                 (trimmed / full events/s),
                                 events_per_sec_full_program and
                                 "specialization" {dropped, key_extra}
  BENCH_BUCKETED=1/0             quantize the capacity knobs to their
                                 power-of-two buckets before the build
                                 (compile/buckets.py; the row gains
                                 "compile": {"buckets": ...}); unset
                                 follows warm serving, as bench.py's
                                 does (a store keyed on exact
                                 capacities would fragment)
  BENCH_WARM=1                   warm-rerun scoring: serve dispatch
                                 programs from the persistent program
                                 store (compile/store.py; the same as
                                 SHADOW_WARM_PROGRAMS=1). The warm-up
                                 call builds and stores on a miss; the
                                 timed call re-resolves the SAME
                                 program against the store, so the
                                 row's "compile" block records the
                                 stored cost (hit, load_s) beside the
                                 fresh one (compile.warmup: lower_s,
                                 compile_s, stored) and warm_speedup
  BENCH_RESIDENT=R               its own scenario (bench.py's
                                 _resident_row): R heterogeneous PHOLD
                                 tenants of BENCH_HOSTS hosts as lanes
                                 of one resident program
                                 (fleet/admission.py), admitted at 0,
                                 the last evicted and re-admitted half
                                 way, then drained; a warm-up trial,
                                 then the timed one. The row carries
                                 the lease table's "resident" block
                                 (program_key_stable, retraces, ...);
                                 R >= 2, alone
  BENCH_SHARDS=N                 plain PHOLD runner: the hosts sharded
                                 over N ranks (parallel/shard.py
                                 run_sharded), one process each — this
                                 command runs as rank 0 and starts the
                                 others; NCCL across cards, gloo on the
                                 CPU, and where the machine has fewer
                                 cards than N (bench.py falls back to a
                                 virtual-CPU mesh there) all N ranks on
                                 the one card over gloo, which the log
                                 says; name gains _{N}shards; the row
                                 gains a "shards" block (ranks, backend,
                                 the collectives' calls, ms and bytes a
                                 window, narrow counters, each rank's
                                 mailbox_gather launches, and a digest
                                 of the final state's shard-count-
                                 invariant leaves). Not with
                                 BENCH_SUPERVISE, injection, pingpong,
                                 BENCH_REPLICAS, BENCH_CHUNK_WINDOWS,
                                 BENCH_SPECIALIZE or the flow and
                                 causality A/Bs
  BENCH_SENTINEL=1               attach the integrity sentinel
                                 (parallel/elastic.py) to the timed
                                 inputs of the PHOLD, supervised PHOLD
                                 and injection runners (with
                                 BENCH_SHARDS, the digest and its one
                                 all_gather a window); name gains
                                 _sentinel, the row a "sentinel" block
                                 (the timed run's latch report)
  BENCH_SENTINEL_OVERHEAD=1      bench.py's A/B: the same workload
                                 without the sentinel (from the
                                 capacity the timed run settled on),
                                 timed the same way;
                                 sentinel_overhead_pct = (off-on)/off
                                 (needs BENCH_SENTINEL=1)
  BENCH_SWEEP=1                  its own scenario (bench.py's
                                 _sweep_row): the lattice seed {1, 2} x
                                 load {L, L+1} x event_capacity {3L,
                                 4L} at BENCH_HOSTS hosts through the
                                 sweep driver (sweep/driver.py) on a
                                 2-worker fleet on the run's device,
                                 twice: the warm-up sweep builds every
                                 distinct program into the store, the
                                 scored sweep re-runs the lattice in a
                                 fresh dir; the row banks its points/s
                                 and a "sweep" block (lattice_conserved,
                                 prewarm hits/compiled/hit rate, best:
                                 tools/bench_regress.py fails a row
                                 whose sweep exited non-zero, lattice
                                 is not conserved or hit rate is below
                                 1.0); alone
  BENCH_PROFILE_DIR=DIR          after the row's timed call and every
                                 A/B, ONE extra unscored call under a
                                 torch.profiler capture
                                 (telemetry/profile.py) exported into
                                 DIR; the row gains {"profile": {"dir",
                                 "tool": "torch.profiler"}}. A profiler
                                 that cannot start warns and the row
                                 goes out without the block (bench.py's
                                 rule)
  BENCH_PLATFORM=cpu             run on the CPU

Every other BENCH_* knob of bench.py is refused (SystemExit naming it),
and so are bench.py's own refusals: --faults, BENCH_SUPERVISE
and BENCH_MIN_JUMP_MS with pingpong (bench.py ignores the last there),
BENCH_REPLICAS, BENCH_FLOW_SAMPLE and BENCH_CAUSALITY with pingpong,
BENCH_REPLICAS with BENCH_SUPERVISE or an injection scenario,
BENCH_ACTIVE with BENCH_REPLICAS or BENCH_SUPERVISE, BENCH_ACTIVE and
BENCH_SPARSE_LANES with an injection scenario, BENCH_SPECIALIZE outside
the plain PHOLD runner, BENCH_SENTINEL outside the PHOLD and injection
runners, BENCH_FLOW_OVERHEAD / BENCH_CAUSALITY_OVERHEAD /
BENCH_SENTINEL_OVERHEAD without their knob, BENCH_ADAPTIVE_JUMP and
BENCH_CHECKPOINT_WINDOWS without BENCH_SUPERVISE=1 or an injection
scenario, and BENCH_INJECT_* with BENCH_WORKLOAD or BENCH_SUPERVISE.

PHOLD is bench.py's default program: capacities start at max(16,
3*load) and double on a counted overflow, then the run goes again; the
timed calls rotate over three inputs built from seeds 1-3; the bulk
window pass (phold.BULK), the default sparse budget and (unless
BENCH_TELEMETRY=0) the ring are on. One warm-up call, then one timed
call (again if it escalated).

There is no quiet fallback: without CUDA and without BENCH_PLATFORM=cpu
the module exits non-zero (bench.py instead falls back to the CPU and
records it in `backend`).

The row: metric (bench.py's names, with _mixtopo under BENCH_TOPO=mix),
value (events/s of the timed call), unit, vs_baseline (value over
BASELINE.json's published rate at the same scale, bench.py's rule),
backend ("cuda" or "cpu"), device (the nvidia-smi name and power-limit
line; null on the CPU), warmup_s, wall_s, windows, micro_steps, events;
with a recorder, bench.py's "flows" and "causality" blocks of the timed
run (and the A/B's overhead fields); with lane isolation, a "lanes"
block (replicas, quarantined lanes, per-lane events).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
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

# bench.py's heterogeneous small-latency fixture: three vertices with
# mutually incommensurate millisecond latencies, so PHOLD arrivals
# smear over sim-time; min pair latency 1.1 ms -> ~1.1 ms windows.
MIX_VERTICES = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <node id="v1"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <node id="v2"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">1.1</data></edge>
    <edge source="v1" target="v1"><data key="lat">1.7</data></edge>
    <edge source="v2" target="v2"><data key="lat">2.3</data></edge>
    <edge source="v0" target="v1"><data key="lat">1.3</data></edge>
    <edge source="v0" target="v2"><data key="lat">1.9</data></edge>
    <edge source="v1" target="v2"><data key="lat">2.9</data></edge>
  </graph>
</graphml>"""

KNOBS = frozenset({"BENCH_WORKLOAD", "BENCH_TOPO", "BENCH_HOSTS",
                   "BENCH_SIM_SECONDS", "BENCH_LOAD", "BENCH_TELEMETRY",
                   "BENCH_CHUNK_WINDOWS", "BENCH_PLATFORM", "BENCH_FAULTS",
                   "BENCH_SUPERVISE", "BENCH_CHECKPOINT_WINDOWS",
                   "BENCH_ADAPTIVE_JUMP", "BENCH_MIN_JUMP_MS",
                   "BENCH_INJECT_RATE", "BENCH_INJECT_TRACE",
                   "BENCH_REPLICAS", "BENCH_LANE_ISOLATION",
                   "BENCH_FLOW_SAMPLE", "BENCH_FLOW_OVERHEAD",
                   "BENCH_CAUSALITY", "BENCH_CAUSALITY_OVERHEAD",
                   "BENCH_SPECIALIZE", "BENCH_BUCKETED", "BENCH_ACTIVE",
                   "BENCH_SPARSE_LANES", "BENCH_SHARDS", "BENCH_SENTINEL",
                   "BENCH_SENTINEL_OVERHEAD", "BENCH_WARM",
                   "BENCH_RESIDENT", "BENCH_SWEEP", "BENCH_PROFILE_DIR"})
# the loop and workload knobs BENCH_SWEEP and BENCH_RESIDENT do not
# combine with (bench.py's exclusivity lists)
_SHAPE_KNOBS = ("BENCH_REPLICAS", "BENCH_SUPERVISE", "BENCH_ACTIVE",
                "BENCH_SPARSE_LANES", "BENCH_INJECT_TRACE",
                "BENCH_INJECT_RATE", "BENCH_CHUNK_WINDOWS",
                "BENCH_SHARDS", "BENCH_FLOW_OVERHEAD",
                "BENCH_FLOW_SAMPLE", "BENCH_CAUSALITY",
                "BENCH_CAUSALITY_OVERHEAD", "BENCH_SENTINEL",
                "BENCH_SENTINEL_OVERHEAD")
# the leaves the reference gives per shard count (parallel/shard.py),
# and the ring planes whose meaning is per shard (micro-steps are the
# slowest rank's, routed_local/cross split by rank): left out of the
# sharded row's state digest
PER_SHARD_LEAVES = (".outbox.narrow_hit", ".outbox.narrow_miss",
                    ".outbox.max_occupied", ".outbox.route_elided",
                    ".telem.micro_steps", ".telem.routed_local",
                    ".telem.routed_cross")

PINGPONG_COUNT = 20
ONE_MILLISECOND = 1_000_000   # core.simtime's, without importing torch


def build_phold(H, load, sim_s, seed, cap, graph, device, ring=True,
                fault_records=None, ring_capacity=None, replica_size=None,
                lanes=False, flow_sample=0, causality_sample=0,
                active_hosts=None, sparse_lanes=None, bucketed=False,
                sentinel=False):
    """bench.py's _build_phold: capacities `cap`, in_ring max(16,
    2*load), the sparse budget `sparse_lanes` (None = the default),
    only the first `active_hosts` hosts loaded when given; the capacity
    knobs quantized to their power-of-two buckets when `bucketed` (the
    plan on `b.bucket_plan`); `replica_size` packs H/replica_size
    independent replicas, each a lane-isolated lane when `lanes`
    (attached before the ring, which sizes its per-lane planes off it);
    the fault plan `fault_records` installed when given; the telemetry
    ring (of `ring_capacity` records, default the ring's) when `ring`;
    the flow and causality recorders at 1-in-N when `flow_sample` /
    `causality_sample` > 0; the integrity sentinel when `sentinel`."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(num_hosts=H, tcp=False,
                    end_time=int(sim_s * simtime.ONE_SECOND), seed=seed,
                    event_capacity=cap, outbox_capacity=cap,
                    router_ring=cap, in_ring=max(16, 2 * load),
                    sparse_lanes=sparse_lanes)
    cfg, plan = _bucket(cfg, bucketed)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, graph, hosts, device=device)
    b.bucket_plan = plan
    b.sim = phold.setup(b.sim, load=load, replica_size=replica_size,
                        active_hosts=active_hosts)
    if replica_size and H > replica_size and lanes:
        from shadow_tpu_torch.core import lanes as lanes_mod

        b.sim = lanes_mod.attach(b.sim, H // replica_size)
    if fault_records:
        from shadow_tpu_torch import faults

        faults.install(b, fault_records)
    if ring:
        b.sim = (telemetry.attach(b.sim) if ring_capacity is None
                 else telemetry.attach(b.sim, capacity=ring_capacity))
    b.sim = attach_recorders(b.sim, flow_sample, causality_sample)
    return attach_sentinel(b, sentinel)


def attach_sentinel(b, on):
    """bench.py's _attach_sentinel: the integrity sentinel on the timed
    inputs (after the recorders, before a specialization), so on-vs-off
    is the real cost of the screen."""
    if on:
        from shadow_tpu_torch.parallel import elastic

        b.sim = elastic.attach_sentinel(b.sim)
    return b


def _bucket(cfg, bucketed):
    """bench.py's BENCH_BUCKETED rule: (cfg with its capacity knobs
    quantized to their power-of-two buckets, the BucketPlan), or (cfg,
    None) when off."""
    if not bucketed:
        return cfg, None
    from shadow_tpu_torch.compile.buckets import bucket_config

    return bucket_config(cfg)


def specialize_inputs(b, sims, app_bulk):
    """bench.py's BENCH_SPECIALIZE step, after every attachment: the
    capability-trimmed bundle for PHOLD, and the timed inputs each
    carrying its guard (the trimmed program expects the guard leaves in
    every input)."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import specialize

    b.sim = sims[0]
    b = specialize.apply(b, (phold.handler,), app_bulk=app_bulk)
    guard = getattr(b.sim, "guard", None)
    if guard is not None:
        sims = [b.sim] + [s.replace(guard=guard) for s in sims[1:]]
    return b, sims


def attach_recorders(sim, flow_sample=0, causality_sample=0):
    """bench.py's _attach_flow_ring and _attach_causality_ring: the
    recorders ride the timed inputs."""
    from shadow_tpu_torch import telemetry

    if flow_sample > 0:
        sim = telemetry.attach_flows(sim, sample_period=flow_sample)
    if causality_sample > 0:
        sim = telemetry.attach_causality(sim, sample_period=causality_sample)
    return sim


def _runner(b, handler, device, chunk_windows, app_bulk=None, mesh=None,
            compile_info=None):
    from shadow_tpu_torch.net.build import make_chunked_runner, make_runner

    if mesh is not None:
        from shadow_tpu_torch.parallel import make_sharded_runner

        return make_sharded_runner(b, mesh, app_handlers=(handler,),
                                   app_bulk=app_bulk,
                                   compile_info=compile_info)
    if chunk_windows:
        return make_chunked_runner(b, app_handlers=(handler,),
                                   app_bulk=app_bulk,
                                   chunk_windows=chunk_windows, device=device,
                                   compile_info=compile_info)
    return make_runner(b, app_handlers=(handler,), app_bulk=app_bulk,
                       device=device, compile_info=compile_info)


def _lower_min_jump(b, min_jump_ns):
    """bench.py's BENCH_MIN_JUMP_MS rule: lower the window span, never
    raise it (a larger span would break the conservative window)."""
    if min_jump_ns is not None:
        b.min_jump = min(b.min_jump, int(min_jump_ns))
    return b


def phold_runner(H, load, sim_s, device, graph=ONE_VERTEX, ring=True,
                 chunk_windows=None, fault_records=None, min_jump_ns=None,
                 replica_size=None, lanes=False, flow_sample=0,
                 causality_sample=0, active_hosts=None, sparse_lanes=None,
                 bucketed=False, specialize=False, mesh=None,
                 sentinel=False, cap=None):
    """bench.py's _phold_runner: a zero-argument callable that runs the
    workload once and returns its events; each call takes the next of
    three inputs (seeds 1, 2, 3), each with its own seeded fault
    wakeups when `fault_records` is given. A counted queue or outbox
    overflow doubles the capacities, rebuilds and runs again
    (`go.escalated`). `go.last_sim` / `go.last_stats` hold the last
    clean run; `go.state` holds the bundle (its `caps`, the capability
    vector) and `plan`, the BucketPlan (None unbucketed). `replica_size`,
    `lanes`, the samples, `active_hosts` (which leaves the bulk pass
    off, as bench.py does: it would consume whole windows before the
    sparse fast path the shape exists to exercise), `sparse_lanes` and
    `bucketed` are build_phold's; `specialize` times the
    capability-trimmed program (specialize_inputs). `mesh` (this
    rank's parallel.shard.Mesh) runs it sharded on every rank, global
    state in and out (run_sharded). `cap` starts the capacities
    elsewhere than bench.py's max(16, 3*load) (an A/B twin starts at
    the capacity its timed run settled on)."""
    from shadow_tpu_torch.apps import phold

    state = {"n": 0}
    app_bulk = phold.BULK if active_hosts is None else None

    def build_at(cap):
        bundles = [_lower_min_jump(build_phold(
            H, load, sim_s, seed, cap, graph, device, ring=ring,
            fault_records=fault_records, replica_size=replica_size,
            lanes=lanes, flow_sample=flow_sample,
            causality_sample=causality_sample, active_hosts=active_hosts,
            sparse_lanes=sparse_lanes, bucketed=bucketed,
            sentinel=sentinel), min_jump_ns)
            for seed in (1, 2, 3)]
        b, sims = bundles[0], [x.sim for x in bundles]
        plan = b.bucket_plan
        if specialize:
            b, sims = specialize_inputs(b, sims, app_bulk)
        state.update(cap=cap, bundle=b, sims=sims, plan=plan)
        new_fn()

    def new_fn():
        """A fresh runner over the current bundle: with warm serving on,
        its first call resolves the program against the store again."""
        state["cinfo"] = {}
        state["fn"] = _runner(state["bundle"], phold.handler, device,
                              chunk_windows, app_bulk=app_bulk, mesh=mesh,
                              compile_info=state["cinfo"])

    build_at(cap or max(16, 3 * load))

    def go():
        go.escalated = False
        while True:
            sim0 = state["sims"][state["n"] % len(state["sims"])]
            state["n"] += 1
            if mesh is not None:
                # the shards block counts the last (clean) run alone
                from shadow_tpu_torch.core.insert_kernels import \
                    mailbox_gather

                mesh.reset_counters()
                mailbox_gather.launches = 0
            sim, stats = state["fn"](sim0)
            if int(sim.events.overflow) + int(sim.outbox.overflow):
                build_at(state["cap"] * 2)   # rebuild, run again clean
                go.escalated = True
                continue
            if int(sim.app.rcvd.sum()) <= 0:
                raise RuntimeError("PHOLD: no message was received")
            go.last_sim, go.last_stats = sim, stats
            go.last_compile = dict(state["cinfo"])
            return int(stats.events_processed)

    go.escalated = False
    go.state = state
    go.rewarm = new_fn
    return go


def _supervised_runner(what, make_bundles, cap, handler, device,
                       chunk_windows=None, adaptive_jump=False,
                       checkpoint_windows=None, feeder=None):
    """The supervised bench loop of bench.py's _phold_supervised_runner
    and _inject_runner: `handler`'s app through faults.run_supervised,
    health checks at every dispatch barrier, `chunk_windows` windows a
    dispatch and a checkpoint every `checkpoint_windows` windows
    (default never). make_bundles(cap, W) builds the three inputs
    (seeds 1..3) with a ring of W records: at least twice a chunk's
    windows, rounded up to a power of two. Each call runs the next
    input, with a fresh Feeder from `feeder()` when given. Capacities
    start at `cap` and double on a counted queue or outbox overflow or
    an injection drop (`go.escalated`). `go.last_sim`, `go.last_stats`,
    `go.last_result`, `go.last_feeder` and `go.harvester` hold the last
    clean run; `go.state["plan"]` the inputs' BucketPlan (None
    unbucketed)."""
    import atexit
    import shutil
    import tempfile

    from shadow_tpu_torch import faults, telemetry
    from shadow_tpu_torch.compile.buckets import quantize_pow2
    from shadow_tpu_torch.telemetry.ring import DEFAULT_CAPACITY

    state = {"n": 0}
    every = checkpoint_windows or (1 << 30)
    ckdir = tempfile.mkdtemp(prefix="bench_sup_")
    atexit.register(shutil.rmtree, ckdir, True)
    W = quantize_pow2(max(DEFAULT_CAPACITY, 2 * (chunk_windows or 1)))

    def build_at(cap):
        bundles = make_bundles(cap, W)
        state.update(cap=cap, bundle=bundles[0],
                     sims=[x.sim for x in bundles],
                     plan=getattr(bundles[0], "bucket_plan", None))

    build_at(cap)

    def go():
        go.escalated = False
        while True:
            b = state["bundle"]
            b.sim = state["sims"][state["n"] % len(state["sims"])]
            state["n"] += 1
            f = feeder() if feeder is not None else None
            h = telemetry.Harvester()
            result = faults.run_supervised(
                b, app_handlers=(handler,),
                checkpoint_path=os.path.join(ckdir, "ck"),
                checkpoint_every_windows=every, harvester=h,
                windows_per_dispatch=chunk_windows,
                adaptive_jump=adaptive_jump or None, feeder=f,
                device=device)
            sim = result.sim
            over = int(sim.events.overflow) + int(sim.outbox.overflow)
            if f is not None:
                over += int(sim.inject.dropped)
            if over:
                build_at(state["cap"] * 2)   # rebuild, run again clean
                go.escalated = True
                continue
            if not result.ok:
                raise RuntimeError(f"{what} supervised: "
                                   f"{result.failure_report()}")
            if int(sim.app.rcvd.sum()) <= 0:
                raise RuntimeError(f"{what}: nothing was received")
            go.last_sim, go.last_stats = sim, result.stats
            go.last_result, go.last_feeder, go.harvester = result, f, h
            go.last_compile = dict(result.compile_info or {})
            return int(result.stats.events_processed)

    go.escalated = False
    go.state = state
    return go


def phold_supervised_runner(H, load, sim_s, device, graph=ONE_VERTEX,
                            ring=True, fault_records=None,
                            chunk_windows=None, adaptive_jump=False,
                            min_jump_ns=None, checkpoint_windows=None,
                            flow_sample=0, causality_sample=0,
                            bucketed=False, sentinel=False, cap=None):
    """bench.py's _phold_supervised_runner: PHOLD through
    _supervised_runner with the bulk pass (bundle.app_bulk). Inputs,
    escalation and `cap` as phold_runner."""
    from shadow_tpu_torch.apps import phold

    def make_bundles(cap, W):
        bundles = [_lower_min_jump(build_phold(
            H, load, sim_s, seed, cap, graph, device, ring=ring,
            fault_records=fault_records, ring_capacity=W,
            flow_sample=flow_sample, causality_sample=causality_sample,
            bucketed=bucketed, sentinel=sentinel), min_jump_ns)
            for seed in (1, 2, 3)]
        bundles[0].app_bulk = phold.BULK
        return bundles

    return _supervised_runner("PHOLD", make_bundles,
                              cap or max(16, 3 * load),
                              phold.handler, device, chunk_windows,
                              adaptive_jump, checkpoint_windows)


def rate_trace(H: int, rate: float, sim_s: int) -> list:
    """bench.py's _rate_trace: a synthesized uniform injection trace of
    aggregate `rate` events/s, round-robin source host, each a
    KIND_TGEN datagram of 64 bytes to the next host. Pure arithmetic —
    a function of (H, rate, sim_s) alone."""
    from shadow_tpu_torch.apps.tgen import KIND_TGEN
    from shadow_tpu_torch.core import simtime

    period = max(1, int(simtime.ONE_SECOND / rate))
    end = sim_s * simtime.ONE_SECOND
    events = []
    t, i = period, 0
    while t < end:
        src = i % H
        events.append({"t_ns": t, "host": src, "kind": KIND_TGEN,
                       "payload": [(src + 1) % H, 9100, 64]})
        i += 1
        t += period
    return events


def build_inject(H, sim_s, seed, cap, lanes, graph, device,
                 fault_records=None, min_jump_ns=None, bucketed=False):
    """bench.py's injection bundle: the tgen app on every host (UDP,
    capacities `cap`, in_ring 16, `lanes` staging lanes; bucketed when
    `bucketed`, the plan on `b.bucket_plan`), the fault plan installed
    when given, the window span lowered to `min_jump_ns`."""
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(num_hosts=H, tcp=False,
                    end_time=sim_s * simtime.ONE_SECOND, seed=seed,
                    event_capacity=cap, outbox_capacity=cap,
                    router_ring=cap, in_ring=16, inject_lanes=lanes)
    cfg, plan = _bucket(cfg, bucketed)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, graph, hosts, device=device)
    b.bucket_plan = plan
    b.sim = tgen.setup(b.sim)
    if fault_records:
        from shadow_tpu_torch import faults

        faults.install(b, fault_records)
    return _lower_min_jump(b, min_jump_ns)


def inject_runner(H, sim_s, device, seed=1, graph=ONE_VERTEX,
                  trace_path=None, rate=None, ring=True,
                  fault_records=None, chunk_windows=None,
                  adaptive_jump=False, min_jump_ns=None,
                  checkpoint_windows=None, flow_sample=0,
                  causality_sample=0, bucketed=False, sentinel=False,
                  cap=None):
    """bench.py's _inject_runner: the tgen app driven by a streamed trace
    (`trace_path`, or rate_trace(H, `rate`, sim_s)) through
    _supervised_runner — the feeder refills the staging lanes at every
    dispatch barrier, so the rate covers the whole on-ramp. A fresh
    Feeder per call replays the trace from position 0 against the next
    of three inputs (seeds `seed`..`seed`+2). Staging lanes
    tgen.lanes_for(trace length); capacities start at 64 (or `cap`)."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import tgen
    from shadow_tpu_torch.inject import Feeder, read_trace

    if trace_path is not None:
        n_ev = sum(1 for _ in read_trace(trace_path))
        mem_events = None
    else:
        mem_events = rate_trace(H, rate, sim_s)
        n_ev = len(mem_events)
    lanes = tgen.lanes_for(n_ev)

    def make_bundles(cap, W):
        bundles = [build_inject(H, sim_s, seed + i, cap, lanes, graph,
                                device, fault_records, min_jump_ns,
                                bucketed=bucketed)
                   for i in (0, 1, 2)]
        for x in bundles:
            if ring:
                x.sim = telemetry.attach(x.sim, capacity=W)
            x.sim = attach_recorders(x.sim, flow_sample, causality_sample)
            attach_sentinel(x, sentinel)
        return bundles

    def feeder():
        return Feeder(trace_path if trace_path is not None
                      else list(mem_events))

    return _supervised_runner("injection", make_bundles, cap or 64,
                              tgen.handler,
                              device, chunk_windows, adaptive_jump,
                              checkpoint_windows, feeder=feeder)


def pingpong_runner(H, sim_s, device, graph=None, chunk_windows=None):
    """bench.py's _pingpong_runner: pingpong.build_bench with 20 UDP
    pings a pair; each call perturbs the host RNG counters (the
    traffic draws nothing, so the workload is unchanged) and checks
    that every client got its 20 replies."""
    from shadow_tpu_torch.apps import pingpong
    from shadow_tpu_torch.core import rng

    b = pingpong.build_bench(H, end_time_s=sim_s, count=PINGPONG_COUNT,
                             tcp=False, device=device,
                             graph=graph or pingpong.GRAPH)
    fn = _runner(b, pingpong.handler, device, chunk_windows)
    state = {"n": 0, "bundle": b}

    def go():
        state["n"] += 1
        net = b.sim.net
        sim0 = b.sim.replace(net=net.replace(
            rng_ctr=(net.rng_ctr + state["n"]) & rng.M32))
        sim, stats = fn(sim0)
        rcvd = sim.app.rcvd[: H // 2]
        if not bool((rcvd == PINGPONG_COUNT).all()):
            raise RuntimeError(f"pingpong incomplete: "
                               f"{rcvd[:8].tolist()}")
        go.last_sim, go.last_stats = sim, stats
        return int(stats.events_processed)

    go.escalated = False
    go.state = state
    return go


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(runner, device):
    """One timed call of `runner` (again while it escalated).
    Returns {"wall_s", "events"}."""
    while True:
        _sync(device)
        t0 = time.perf_counter()
        events = runner()
        _sync(device)
        wall = time.perf_counter() - t0
        if not runner.escalated:
            return {"wall_s": wall, "events": events}


def baseline_rate(H) -> float:
    """BASELINE.json's published events/s at H hosts' scale (bench.py's
    rule); 0.0 when the file is absent."""
    p = pathlib.Path(__file__).resolve().parent.parent / "BASELINE.json"
    try:
        pub = json.loads(p.read_text())["published"]
    except (OSError, KeyError, ValueError):
        return 0.0
    if H >= 100_000:
        return float(pub.get("events_per_sec_at_100k_hosts", 0.0))
    if H >= 10_000:
        return float(pub.get("events_per_sec_at_10k_hosts", 0.0))
    return float(pub.get("events_per_sec", 0.0))


def device_line(device):
    """nvidia-smi's name and power limit of the card (None on the
    CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()
    return out[0]


def make_row(metric, H, m, stats, device, warmup_s) -> dict:
    """bench.py's JSON row for one timed call `m` (timed())."""
    import torch

    value = m["events"] / m["wall_s"]
    base = baseline_rate(H)
    st = stats.as_dict()
    return {
        "metric": metric,
        "value": round(value, 1),
        "unit": "events/s",
        "vs_baseline": round(value / base, 3) if base else 0.0,
        "backend": torch.device(device).type,
        "device": device_line(device),
        "warmup_s": round(warmup_s, 3),
        "wall_s": round(m["wall_s"], 4),
        "windows": st["windows"],
        "micro_steps": st["micro_steps"],
        "events": m["events"],
    }


def _bench_bucketed() -> bool:
    """bench.py's rule: quantize capacities to power-of-two buckets?
    An explicit BENCH_BUCKETED wins; unset follows warm serving (a
    store keyed on exact capacities would fragment across nearby
    configs)."""
    v = os.environ.get("BENCH_BUCKETED")
    if v is None:
        from shadow_tpu_torch.compile import serve

        return serve.warm_enabled(False)
    return v != "0"


def compile_block(runner, warmup_cinfo) -> dict:
    """bench.py's row "compile" block: the TIMED call's program-store
    block, the warm-up call's nested under "warmup" when it differs,
    the bucket plan, and warm_speedup = the fresh build's wall over the
    stored load's."""
    cinfo = dict(getattr(runner, "last_compile", None) or {})
    if warmup_cinfo and warmup_cinfo != cinfo:
        cinfo["warmup"] = warmup_cinfo
    plan = runner.state.get("plan")
    if plan is not None:
        cinfo["buckets"] = plan.as_dict()
    if cinfo.get("hit") and cinfo.get("load_s"):
        w = cinfo.get("warmup") or {}
        fresh_s = w.get("compile_s", 0.0) + w.get("lower_s", 0.0)
        if fresh_s:
            cinfo["warm_speedup"] = round(
                fresh_s / max(cinfo["load_s"], 1e-9), 1)
    return cinfo


def resident_specs(H: int, load: int, sim_s: int, lanes: int) -> list:
    """bench.py's _resident_row tenants: `lanes` PHOLD scenarios of H
    hosts, seeds 1000 + k, load `load` less one on odd lanes."""
    from shadow_tpu_torch.fleet.spec import JobSpec

    return [JobSpec(id=f"tenant-{k}", kind="scenario", seed=1000 + k,
                    hosts=H, load=max(1, load - (k % 2)), sim_s=sim_s)
            for k in range(lanes)]


def resident_trial(specs, workdir, lanes, sim_s, device, churn=True):
    """One trial of bench.py's _resident_row: every tenant admitted at
    0; with `churn`, the last evicted half way and re-admitted; then
    the program drains. Returns the closed ResidentProgram."""
    from shadow_tpu_torch.fleet import admission as adm_mod

    rp = adm_mod.ResidentProgram(
        specs, workdir=workdir, lanes=lanes, horizon_s=2 * sim_s + 1,
        checkpoint_every_events=0, fsync=False, device=device)
    try:
        for s in specs:
            rp.admit(s.id)
        if churn:
            rp.advance(until_ns=(sim_s * 1_000_000_000) // 2)
            rp.evict(specs[-1].id, reason="bench churn")
            rp.admit(specs[-1].id)
        rp.drain()
    finally:
        rp.close()
    return rp


def resident_row(H: int, load: int, sim_s: int, lanes: int,
                 device) -> dict:
    """bench.py's _resident_row (BENCH_RESIDENT=R): throughput of one
    resident packed program whose lane population churns at window
    barriers (fleet/admission.py). R heterogeneous PHOLD tenants are
    admitted at t=0, the last is evicted and re-admitted half way — two
    extra admission barriers inside the timed wall — and the program
    drains. The warm-up trial pays the builds; the timed trial runs the
    same program again. The row carries the lease table's roll-up, so a
    broken zero-retrace contract (program_key_stable false or retraces
    > 0) shows on the row, not only a throughput drop; `digests` holds
    each tenant's final lane_digest of the timed trial."""
    import shutil
    import tempfile

    from shadow_tpu_torch.fleet import admission as adm_mod

    specs = resident_specs(H, load, sim_s, lanes)

    def trial(workdir):
        return resident_trial(specs, workdir, lanes, sim_s, device)

    root = tempfile.mkdtemp(prefix="bench_resident_")
    try:
        _sync(device)
        t0 = time.perf_counter()
        trial(os.path.join(root, "warm"))      # pays the builds
        _sync(device)
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rp = trial(os.path.join(root, "timed"))
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    value = rp.events / wall
    base = baseline_rate(H)
    blk = rp.manifest_block()
    import torch

    return {
        "metric": (f"events_per_sec_per_chip@{H}hosts_resident"
                   f"_x{lanes}lanes_churn"),
        "value": round(value, 1),
        "unit": "events/s",
        "vs_baseline": round(value / base, 3) if base else 0.0,
        "backend": torch.device(device).type,
        "device": device_line(device),
        "warmup_s": round(warmup_s, 3),
        "wall_s": round(wall, 4),
        "windows": rp.windows,
        "dispatches": rp.dispatches,
        "events": rp.events,
        "resident": {k: blk.get(k) for k in
                     ("lanes", "admitted", "completed", "evicted",
                      "quarantined", "resident", "deferred",
                      "program_key", "program_key_stable",
                      "admission_events", "retraces", "lane_width",
                      "degrade_level")},
        "digests": {h["job"]: h["digest"] for h in rp.table.history
                    if h.get("state") == adm_mod.COMPLETED},
    }


def sweep_spec_obj(H: int, load: int, sim_s: int) -> dict:
    """bench.py's _sweep_row lattice: seed {1, 2} x load {L, L+1} x
    event_capacity {3L, 4L} (the capacities share a pow2 bucket at the
    default load, so the census stays small), a grid ranked on events."""
    return {
        "sweep": {"id": "bench",
                  "objective": {"metric": "events", "goal": "max"},
                  "search": {"strategy": "grid"}},
        "fleet": {"max_attempts": 2},
        "template": {"kind": "scenario", "hosts": H, "sim_s": sim_s},
        "axes": [
            {"field": "seed", "values": [1, 2]},
            {"field": "load", "values": [load, load + 1]},
            {"field": "event_capacity",
             "values": [3 * load, 4 * load]},
        ],
    }


def sweep_row(H: int, load: int, sim_s: int, device) -> dict:
    """bench.py's _sweep_row (BENCH_SWEEP=1): the fleet as a query
    service. sweep_spec_obj's lattice through the sweep driver
    (sweep/driver.py) on 2 workers on `device`, twice: the warm-up
    sweep pays every distinct program's build into the program store,
    the scored sweep re-runs the identical lattice in a fresh dir and
    must find every program warm (prewarm_hit_rate 1.0). The banked
    value is completed points per second of the scored sweep."""
    import shutil
    import tempfile

    import torch

    from shadow_tpu_torch.sweep import driver as sweep_driver
    from shadow_tpu_torch.sweep import plan as plan_mod

    spec_obj = sweep_spec_obj(H, load, sim_s)
    dev = torch.device(device).type
    root = tempfile.mkdtemp(prefix="bench_sweep_")
    try:
        t0 = time.perf_counter()
        warm = sweep_driver.SweepDriver(
            os.path.join(root, "warm"),
            plan_mod.SweepSpec.from_obj(spec_obj), workers=2,
            fsync=False, device=dev)
        rc_warm = warm.run()
        warm_s = time.perf_counter() - t0
        warm_block = warm.report()
        t0 = time.perf_counter()
        timed = sweep_driver.SweepDriver(
            os.path.join(root, "timed"),
            plan_mod.SweepSpec.from_obj(spec_obj), workers=2,
            fsync=False, device=dev)
        rc_timed = timed.run()
        wall = time.perf_counter() - t0
        block = timed.report()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    pts = block["points"]
    conserved = (pts["expanded"] == pts["completed"] + pts["failed"]
                 + pts["quarantined"] + pts["pruned"]
                 + pts["pending"]) and pts["pending"] == 0
    pw = block.get("prewarm") or {"hits": 0, "compiled": 0}
    warmed = pw["hits"] + pw["compiled"]
    hit_rate = (pw["hits"] / warmed) if warmed else 0.0
    value = pts["completed"] / wall if wall > 0 else 0.0
    return {
        "metric": (f"sweep_points_per_sec@{pts['expanded']}points"
                   f"_{block['census']['distinct']}programs"
                   f"_x2workers"),
        "value": round(value, 3),
        "unit": "points/s",
        "vs_baseline": 0.0,
        "backend": dev,
        "device": device_line(device),
        "compile_s": round(warm_s, 3),
        "compile_cache": ("cached" if (warm_block.get("prewarm")
                                       or {}).get("compiled", 1) == 0
                          else "fresh"),
        "wall_seconds": round(wall, 3),
        "sweep": {
            "exit_warm": rc_warm,
            "exit_timed": rc_timed,
            "lattice": block["lattice"],
            "points": pts,
            "lattice_conserved": bool(conserved),
            "distinct_programs": block["census"]["distinct"],
            "prewarm_hits": pw["hits"],
            "prewarm_compiled": pw["compiled"],
            "prewarm_hit_rate": round(hit_rate, 3),
            "best": block["best"],
        },
    }


def _env_int(name, default):
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        raise SystemExit(f"{name}={v!r} is not an integer") from None


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="the port's benchmark (env knobs in the module "
                    "docstring)")
    ap.add_argument("--faults", default=os.environ.get("BENCH_FAULTS"),
                    help="JSON fault plan (faults.records_from_json): "
                    "measure PHOLD on a degraded network")
    args = ap.parse_args(argv)
    off = sorted(k for k, v in os.environ.items()
                 if k.startswith("BENCH_") and v and k not in KNOBS)
    if off:
        raise SystemExit(f"shadow_tpu_torch.bench does not implement "
                         f"{', '.join(off)} (see ROADMAP.md)")
    if os.environ.get("BENCH_WARM") == "1":
        # warm-rerun scoring: the runners resolve their dispatch
        # programs through the persistent program store
        os.environ.setdefault("SHADOW_WARM_PROGRAMS", "1")
    platform = os.environ.get("BENCH_PLATFORM") or None
    if platform not in (None, "cpu"):
        raise SystemExit(f"BENCH_PLATFORM={platform!r}: only 'cpu' "
                         f"(unset = the GPU)")

    workload = os.environ.get("BENCH_WORKLOAD") or "phold"
    topo = os.environ.get("BENCH_TOPO") or "one"
    if workload not in ("phold", "pingpong"):
        raise SystemExit(f"BENCH_WORKLOAD={workload!r}: phold or pingpong")
    if topo not in ("one", "mix"):
        raise SystemExit(f"BENCH_TOPO={topo!r}: one or mix (ref needs the "
                         f"reference's topology file, not in the repo)")
    H = _env_int("BENCH_HOSTS", 10_240)
    sim_s = _env_int("BENCH_SIM_SECONDS", 5)
    load = _env_int("BENCH_LOAD", 8)
    chunk = _env_int("BENCH_CHUNK_WINDOWS", None)
    if chunk is not None and chunk < 1:
        raise SystemExit(f"BENCH_CHUNK_WINDOWS={chunk}: must be >= 1")
    ring = os.environ.get("BENCH_TELEMETRY", "1") != "0"
    supervise = os.environ.get("BENCH_SUPERVISE") == "1"
    adaptive = os.environ.get("BENCH_ADAPTIVE_JUMP") == "1"
    ck_w = _env_int("BENCH_CHECKPOINT_WINDOWS", None)
    mjms = os.environ.get("BENCH_MIN_JUMP_MS")
    min_jump_ns = None
    if mjms:
        try:
            min_jump_ns = int(float(mjms) * ONE_MILLISECOND)
        except ValueError:
            raise SystemExit(f"BENCH_MIN_JUMP_MS={mjms!r} is not a "
                             f"number") from None
    inj_trace = os.environ.get("BENCH_INJECT_TRACE") or None
    inj_rate = os.environ.get("BENCH_INJECT_RATE") or None
    if inj_rate:
        try:
            inj_rate = float(inj_rate)
        except ValueError:
            raise SystemExit(f"BENCH_INJECT_RATE={inj_rate!r} is not a "
                             f"number") from None
    inject_on = bool(inj_trace or inj_rate)
    replicas = _env_int("BENCH_REPLICAS", 1)
    if replicas < 1:
        raise SystemExit(f"BENCH_REPLICAS={replicas}: must be >= 1")
    lanes = os.environ.get("BENCH_LANE_ISOLATION", "0") != "0"
    active = _env_int("BENCH_ACTIVE", None)
    sparse = _env_int("BENCH_SPARSE_LANES", None)
    spec_on = os.environ.get("BENCH_SPECIALIZE", "0") == "1"
    bucketed = _bench_bucketed()
    flow_n = _env_int("BENCH_FLOW_SAMPLE", 0)
    caus_n = _env_int("BENCH_CAUSALITY", 0)
    flow_ab = os.environ.get("BENCH_FLOW_OVERHEAD") == "1"
    caus_ab = os.environ.get("BENCH_CAUSALITY_OVERHEAD") == "1"
    if flow_ab and flow_n <= 0:
        raise SystemExit("BENCH_FLOW_OVERHEAD=1 needs BENCH_FLOW_SAMPLE=N "
                         "(what would it A/B?)")
    if caus_ab and caus_n <= 0:
        raise SystemExit("BENCH_CAUSALITY_OVERHEAD=1 needs "
                         "BENCH_CAUSALITY=N (what would it A/B?)")
    sent_on = os.environ.get("BENCH_SENTINEL", "0") == "1"
    sent_ab = os.environ.get("BENCH_SENTINEL_OVERHEAD") == "1"
    if sent_on and workload != "phold" and not inject_on:
        raise SystemExit("BENCH_SENTINEL=1 is only wired for the "
                         "phold/injection runners")
    if sent_ab and not sent_on:
        raise SystemExit("BENCH_SENTINEL_OVERHEAD=1 needs "
                         "BENCH_SENTINEL=1 (what would it A/B?)")
    if inj_trace and inj_rate:
        raise SystemExit("BENCH_INJECT_TRACE and BENCH_INJECT_RATE are "
                         "mutually exclusive (replay xor synthesize)")
    if (adaptive or ck_w) and not (supervise or inject_on):
        raise SystemExit(
            "BENCH_ADAPTIVE_JUMP / BENCH_CHECKPOINT_WINDOWS shape the "
            "supervised window loop; set BENCH_SUPERVISE=1")
    if inject_on:
        # the injection scenario is its own workload: the tgen app under
        # the supervised loop (streaming needs the host-driven barrier)
        if os.environ.get("BENCH_WORKLOAD"):
            raise SystemExit("BENCH_INJECT_* defines its own scenario; "
                             "leave BENCH_WORKLOAD unset")
        if supervise or replicas > 1 or active is not None \
                or sparse is not None:
            raise SystemExit(
                "BENCH_INJECT_* does not combine with BENCH_SUPERVISE / "
                "BENCH_REPLICAS / BENCH_ACTIVE / BENCH_SPARSE_LANES — it "
                "is already a supervised tgen scenario")
    if workload == "phold" and active is not None and replicas > 1:
        raise SystemExit("BENCH_ACTIVE and BENCH_REPLICAS are mutually "
                         "exclusive PHOLD shapes")
    if supervise and (replicas > 1 or active is not None):
        raise SystemExit("BENCH_SUPERVISE=1 does not combine with "
                         "BENCH_REPLICAS/BENCH_ACTIVE")
    if spec_on and (workload != "phold" or supervise or inject_on):
        raise SystemExit(
            "BENCH_SPECIALIZE=1 is only wired for the plain PHOLD "
            "runner (the supervised/injection loops build their own "
            "bundles)")
    shards = _env_int("BENCH_SHARDS", 0)
    if shards > 1:
        for flag, on in (("BENCH_SUPERVISE=1", supervise),
                         ("BENCH_INJECT_*", inject_on),
                         ("BENCH_WORKLOAD=pingpong", workload != "phold"),
                         ("BENCH_REPLICAS", replicas > 1),
                         ("BENCH_CHUNK_WINDOWS", chunk),
                         ("BENCH_SPECIALIZE=1", spec_on),
                         ("BENCH_FLOW_OVERHEAD=1", flow_ab),
                         ("BENCH_CAUSALITY_OVERHEAD=1", caus_ab)):
            if on:
                raise SystemExit(f"BENCH_SHARDS is wired for the plain "
                                 f"PHOLD runner; not with {flag}")
    if workload != "phold":
        for flag, on in (("--faults", args.faults),
                         ("BENCH_SUPERVISE=1", supervise),
                         ("BENCH_MIN_JUMP_MS", mjms),
                         ("BENCH_REPLICAS", replicas > 1),
                         ("BENCH_FLOW_SAMPLE", flow_n > 0),
                         ("BENCH_CAUSALITY", caus_n > 0)):
            if on:
                raise SystemExit(f"{flag} is only wired for "
                                 f"BENCH_WORKLOAD=phold")
    sweep = os.environ.get("BENCH_SWEEP") == "1"
    if sweep and (any(os.environ.get(k) for k in
                      _SHAPE_KNOBS + ("BENCH_RESIDENT",))
                  or workload != "phold" or topo != "one" or args.faults):
        raise SystemExit(
            "BENCH_SWEEP is its own scenario (a job lattice through the "
            "sweep driver on a warm worker pool); it does not combine "
            "with the other workload/loop shapes")
    resident = _env_int("BENCH_RESIDENT", 0)
    if resident:
        if (any(os.environ.get(k) for k in _SHAPE_KNOBS)
                or workload != "phold" or topo != "one"
                or args.faults):
            raise SystemExit(
                "BENCH_RESIDENT is its own scenario (one warm packed "
                "program, tenant leases, mid-run churn); it does not "
                "combine with the other workload/loop shapes")
        if resident < 2:
            raise SystemExit("BENCH_RESIDENT needs >= 2 lanes (churn on a "
                             "1-lane program has no undisturbed tenant to "
                             "protect)")
    # every knob is checked before torch loads and the device resolves
    from shadow_tpu_torch.device import rank_device, resolve_device
    from shadow_tpu_torch.parallel.shard import rank_env
    from shadow_tpu_torch.utils.compcache import enable_compile_cache

    enable_compile_cache()

    rank, world, init = rank_env()
    try:
        device = resolve_device(platform)
        if shards > 1:
            # a started rank runs on its own card where there is one
            device = rank_device(rank, device)
    except RuntimeError as e:
        raise SystemExit(f"shadow_tpu_torch.bench: {e}") from None
    if sweep:
        print(json.dumps(sweep_row(H, load, sim_s, device)))
        return 0
    if resident:
        print(json.dumps(resident_row(H, load, sim_s, resident, device)))
        return 0
    mesh = ranks = None
    if shards > 1:
        mesh, ranks = _shard_mesh(shards, rank, world, init, device, argv)
    fault_records = None
    if args.faults:
        from shadow_tpu_torch import faults

        with open(args.faults) as f:
            fault_records = faults.records_from_json(f.read())

    graph = MIX_VERTICES if topo == "mix" else ONE_VERTEX

    def make_runner(flow_sample, causality_sample, specialize=spec_on,
                    sentinel=sent_on, cap=None):
        rec = dict(flow_sample=flow_sample,
                   causality_sample=causality_sample, bucketed=bucketed,
                   sentinel=sentinel, cap=cap)
        if inject_on:
            return inject_runner(
                H, sim_s, device, graph=graph, trace_path=inj_trace,
                rate=inj_rate, ring=ring, fault_records=fault_records,
                chunk_windows=chunk, adaptive_jump=adaptive,
                min_jump_ns=min_jump_ns, checkpoint_windows=ck_w, **rec)
        if workload == "phold" and supervise:
            return phold_supervised_runner(
                H, load, sim_s, device, graph=graph, ring=ring,
                fault_records=fault_records, chunk_windows=chunk,
                adaptive_jump=adaptive, min_jump_ns=min_jump_ns,
                checkpoint_windows=ck_w, **rec)
        if workload == "phold":
            return phold_runner(
                H * replicas, load, sim_s, device, graph=graph, ring=ring,
                chunk_windows=chunk, fault_records=fault_records,
                min_jump_ns=min_jump_ns,
                replica_size=H if replicas > 1 else None, lanes=lanes,
                active_hosts=active, sparse_lanes=sparse,
                specialize=specialize, mesh=mesh, **rec)
        return pingpong_runner(
            H, sim_s, device, graph=MIX_VERTICES if topo == "mix" else None,
            chunk_windows=chunk)

    runner = make_runner(flow_n, caus_n)
    if inject_on:
        name = f"events_per_sec_per_chip@{H}hosts_inject"
        name += "_trace" if inj_trace else f"_rate{int(inj_rate)}"
        name += f"_chunk{chunk or 1}"
        if adaptive:
            name += "_adaptive"
    elif workload == "phold":
        name = f"events_per_sec_per_chip@{H}hosts_phold_load{load}"
        if replicas > 1:
            name += f"_x{replicas}replicas"
            if lanes:
                name += "_lanes"
        if active is not None:
            name += f"_active{active}"
    else:
        name = f"events_per_sec_per_chip@{H}hosts_udp_pingpong"
    if supervise:
        name += f"_supervised_chunk{chunk or 1}"
        if adaptive:
            name += "_adaptive"
    elif chunk and not inject_on:
        name += f"_chunk{chunk}"
    if mjms:
        name += f"_mj{mjms}ms"
    if topo == "mix":
        name += "_mixtopo"
    if fault_records:
        name += "_faults"
    if flow_n > 0:
        name += f"_flow{flow_n}"
    if spec_on:
        name += "_spec"
    if caus_n > 0:
        name += f"_caus{caus_n}"
    if sent_on:
        name += "_sentinel"
    if mesh is not None:
        name += f"_{mesh.size}shards"

    _sync(device)
    t0 = time.perf_counter()
    runner()                      # warm-up: builds kernels, may escalate
    _sync(device)
    warmup_s = time.perf_counter() - t0
    # the warm-up call's store block: on an empty store the miss that
    # paid lower_s + compile_s; the timed call re-resolves the same key
    warmup_cinfo = dict(getattr(runner, "last_compile", None) or {})
    if getattr(runner, "rewarm", None) is not None \
            and warmup_cinfo.get("warm"):
        runner.rewarm()
    m = timed(runner, device)
    row = make_row(name, H, m, runner.last_stats, device, warmup_s)
    if mesh is not None:
        row["shards"] = shards_block(mesh, runner, m)
    cinfo = compile_block(runner, warmup_cinfo)
    if cinfo:
        row["compile"] = cinfo
    row.update(recorder_blocks(runner, flow_n, caus_n))
    # bench.py's A/B: the same workload rebuilt without the recorder,
    # timed the same way; overhead = (off - on) / off
    for on, key, off_kw in (
            (flow_ab, "flow", dict(flow_sample=0, causality_sample=caus_n)),
            (caus_ab, "causality",
             dict(flow_sample=flow_n, causality_sample=0))):
        if on:
            base = make_runner(**off_kw)
            base()                # warm-up
            m_off = timed(base, device)
            off = m_off["events"] / m_off["wall_s"]
            row[f"{key}_overhead_pct"] = round(
                (off - row["value"]) / off * 100.0, 2)
            row[f"events_per_sec_{key}_off"] = round(off, 1)
    if sent_on:
        # the timed run's latch report (bench.py's "sentinel" block)
        from shadow_tpu_torch.parallel import elastic

        row["sentinel"] = elastic.sentinel_report(runner.last_sim)
    if sent_ab:
        # bench.py's A/B: the same workload without the sentinel,
        # started at the capacity the timed run settled on (its warm-up
        # then escalates no more); on a mesh the off run's collectives a
        # window ride the block too
        base = make_runner(flow_n, caus_n, sentinel=False,
                           cap=runner.state["cap"])
        base()                    # warm-up
        m_off = timed(base, device)
        off = m_off["events"] / m_off["wall_s"]
        on = m["events"] / m["wall_s"]
        row["sentinel_overhead_pct"] = round((off - on) / off * 100.0, 2)
        row["events_per_sec_sentinel_off"] = round(off, 1)
        if mesh is not None:
            row["sentinel"]["shards_off"] = shards_block(mesh, base, m_off)
    if spec_on:
        # bench.py's A/B: the unspecialized twin of the same workload,
        # timed the same way; specialize_speedup = trimmed / full
        base = make_runner(flow_n, caus_n, specialize=False)
        base()                    # warm-up
        m_full = timed(base, device)
        full = m_full["events"] / m_full["wall_s"]
        row["specialize_speedup"] = round(row["value"] / full, 4)
        row["events_per_sec_full_program"] = round(full, 1)
        caps = runner.state["bundle"].caps
        if caps is not None:
            row["specialization"] = {"dropped": list(caps.dropped()),
                                     "key_extra": caps.key_extra()}
    # BENCH_PROFILE_DIR: capture ONE extra, unscored run, after every
    # export has read the timed run's state (a capture costs wall time,
    # so it never brackets the run whose events/s banks); on a mesh
    # every rank runs it and writes its own trace
    prof_dir = os.environ.get("BENCH_PROFILE_DIR")
    if prof_dir:
        from shadow_tpu_torch.telemetry.profile import Capture

        cap = None
        try:
            cap = Capture(prof_dir, device)
            runner()
            _sync(device)
        except Exception as e:  # noqa: BLE001 — the profiler is optional
            print(f"WARNING: BENCH_PROFILE_DIR: profiler unavailable "
                  f"({e}); continuing without capture", file=sys.stderr)
        finally:
            if cap is not None:
                cap.stop()
                row["profile"] = cap.block
    if mesh is not None:
        mesh.close()
        if mesh.rank != 0:
            return 0
    code = 0 if ranks is None else ranks.join()
    print(json.dumps(row))
    return code


def _shard_mesh(shards, rank, world, init, device, argv):
    """BENCH_SHARDS: (this rank's Mesh, the RankProcesses this command
    started, or None in a started rank). Rank 0 starts ranks 1..N-1 as
    `python -m shadow_tpu_torch.bench` with the same arguments (killed
    at exit if still running) and logs where the ranks run when the
    machine has fewer cards than ranks."""
    import atexit

    import torch

    from shadow_tpu_torch.parallel import Mesh
    from shadow_tpu_torch.parallel.shard import RankProcesses

    ranks = None
    if world is None:
        ranks = RankProcesses("shadow_tpu_torch.bench",
                              list(sys.argv[1:] if argv is None else argv),
                              shards)
        atexit.register(ranks.kill)
        init = ranks.init
    if rank == 0 and device.type == "cuda" \
            and torch.cuda.device_count() < shards:
        print(f"shadow_tpu_torch.bench: BENCH_SHARDS={shards} on "
              f"{torch.cuda.device_count()} card(s): all {shards} ranks "
              f"run on {device} over gloo (bench.py falls back to a "
              f"virtual-CPU mesh here)", file=sys.stderr, flush=True)
    return Mesh(shards, rank, init_method=init, device=device), ranks


def state_digest(sim) -> str:
    """sha256 over the final state's leaves (flax field path order) but
    PER_SHARD_LEAVES and the integrity sentinel's (the row's "sentinel"
    block reports those): equal for any shard count, with the sentinel
    on or off."""
    import hashlib

    import numpy as np

    from shadow_tpu_torch import convert

    h = hashlib.sha256()
    for k, v in sorted(convert.sim_to_numpy(sim).items()):
        if k not in PER_SHARD_LEAVES and not k.startswith(".sentinel."):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def shards_block(mesh, runner, m) -> dict:
    """The sharded row's "shards" block, from the timed call's clean
    run: the mesh, the collectives' calls, host-clock ms and bytes a
    window on this rank (the exchange and every reduction; the final
    reassembly of the global state apart, as gather_*), the narrow
    counters, every rank's mailbox_gather launches and the state
    digest."""
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather

    st = runner.last_stats.as_dict()
    sim = runner.last_sim
    w = max(st["windows"], 1)
    calls, nbytes, secs = (mesh.calls, mesh.bytes, mesh.seconds)
    gather = (mesh.gather_calls, mesh.gather_bytes, mesh.gather_seconds)
    launches = [r[0] for r in
                mesh.all_gather_ints([mailbox_gather.launches])]
    return {
        "ranks": mesh.size, "backend": mesh.backend,
        "collective_calls_per_window": round((calls - gather[0]) / w, 2),
        "collective_ms_per_window": round((secs - gather[2]) * 1e3 / w,
                                          4),
        "collective_bytes_per_window": round((nbytes - gather[1]) / w, 1),
        "gather_calls": gather[0], "gather_bytes": gather[1],
        "gather_ms": round(gather[2] * 1e3, 3),
        "wall_ms_per_window": round(m["wall_s"] * 1e3 / w, 4),
        "narrow_hit": int(sim.outbox.narrow_hit),
        "narrow_miss": int(sim.outbox.narrow_miss),
        "route_elided": int(sim.outbox.route_elided),
        "mailbox_gather_launches": launches,
        # the timed call's input (seeds 1-3 in turn) and capacity
        "seed": (runner.state["n"] - 1) % len(runner.state["sims"]) + 1,
        "capacity": runner.state["cap"],
        "stats": st,
        "state_digest": state_digest(sim),
    }


def recorder_blocks(runner, flow_n, caus_n) -> dict:
    """bench.py's "flows" and "causality" row blocks of the timed run,
    and a "lanes" block for a lane-isolated one (replicas, quarantined
    lanes, the per-lane report)."""
    from shadow_tpu_torch import telemetry

    sim = runner.last_sim
    out = {}
    if getattr(sim, "lanes", None) is not None:
        from shadow_tpu_torch.core.lanes import lane_report

        rep = lane_report(sim)
        out["lanes"] = {"replicas": len(rep),
                        "quarantined": [d["lane"] for d in rep
                                        if d["quarantined"]],
                        "per_lane": rep}
    if not (flow_n > 0 or caus_n > 0):
        return out
    h = getattr(runner, "harvester", None) or telemetry.Harvester()
    h.drain(sim)
    H = int(sim.events.num_hosts)
    if flow_n > 0:
        fb = telemetry.flows_manifest_block(h, num_hosts=H,
                                            sample_period=flow_n)
        out["flows"] = {k: fb[k] for k in
                        ("sample_period", "sampled", "recorded",
                         "harvested", "lost_ring", "lost_window_clamp",
                         "per_lane")}
    if caus_n > 0:
        cb = telemetry.causality_manifest_block(h, num_hosts=H,
                                                sample_period=caus_n)
        out["causality"] = {k: cb[k] for k in
                            ("sample_period", "sampled", "harvested",
                             "lost_ring", "windows_attributed",
                             "windows_lost", "causes") if k in cb}
    return out


if __name__ == "__main__":
    sys.exit(main())
