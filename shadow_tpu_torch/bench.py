"""Benchmark of the port: events/s on bench.py's two workloads, printed
as bench.py's one JSON row. Run it as

    python -m shadow_tpu_torch.bench [--faults PLAN.json]

`--faults` (or BENCH_FAULTS) installs a JSON fault plan
(faults.records_from_json, e.g. examples/faultplan_degraded.json) on
every PHOLD input: the degraded-network row, named with `_faults`.

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
  BENCH_FAULTS=PLAN.json         as --faults
  BENCH_PLATFORM=cpu             run on the CPU

Every other BENCH_* knob of bench.py is refused (SystemExit naming it),
and so are bench.py's own refusals: --faults, BENCH_SUPERVISE and
BENCH_MIN_JUMP_MS with pingpong (bench.py ignores the last there),
BENCH_ADAPTIVE_JUMP and BENCH_CHECKPOINT_WINDOWS without
BENCH_SUPERVISE=1.

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
line; null on the CPU), warmup_s, wall_s, windows, micro_steps, events.
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
                   "BENCH_ADAPTIVE_JUMP", "BENCH_MIN_JUMP_MS"})

PINGPONG_COUNT = 20
ONE_MILLISECOND = 1_000_000   # core.simtime's, without importing torch


def build_phold(H, load, sim_s, seed, cap, graph, device, ring=True,
                fault_records=None, ring_capacity=None):
    """bench.py's _build_phold (no replicas or active subset):
    capacities `cap`, in_ring max(16, 2*load), the default sparse
    budget, the fault plan `fault_records` installed when given; plus
    the telemetry ring (of `ring_capacity` records, default the ring's)
    when `ring`."""
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(num_hosts=H, tcp=False,
                    end_time=int(sim_s * simtime.ONE_SECOND), seed=seed,
                    event_capacity=cap, outbox_capacity=cap,
                    router_ring=cap, in_ring=max(16, 2 * load))
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, graph, hosts, device=device)
    b.sim = phold.setup(b.sim, load=load)
    if fault_records:
        from shadow_tpu_torch import faults

        faults.install(b, fault_records)
    if ring:
        b.sim = (telemetry.attach(b.sim) if ring_capacity is None
                 else telemetry.attach(b.sim, capacity=ring_capacity))
    return b


def _runner(b, handler, device, chunk_windows, app_bulk=None):
    from shadow_tpu_torch.net.build import make_chunked_runner, make_runner

    if chunk_windows:
        return make_chunked_runner(b, app_handlers=(handler,),
                                   app_bulk=app_bulk,
                                   chunk_windows=chunk_windows, device=device)
    return make_runner(b, app_handlers=(handler,), app_bulk=app_bulk,
                       device=device)


def _lower_min_jump(b, min_jump_ns):
    """bench.py's BENCH_MIN_JUMP_MS rule: lower the window span, never
    raise it (a larger span would break the conservative window)."""
    if min_jump_ns is not None:
        b.min_jump = min(b.min_jump, int(min_jump_ns))
    return b


def phold_runner(H, load, sim_s, device, graph=ONE_VERTEX, ring=True,
                 chunk_windows=None, fault_records=None, min_jump_ns=None):
    """bench.py's _phold_runner: a zero-argument callable that runs the
    workload once and returns its events; each call takes the next of
    three inputs (seeds 1, 2, 3), each with its own seeded fault
    wakeups when `fault_records` is given. A counted queue or outbox
    overflow doubles the capacities, rebuilds and runs again
    (`go.escalated`). `go.last_sim` / `go.last_stats` hold the last
    clean run."""
    from shadow_tpu_torch.apps import phold

    state = {"n": 0}

    def build_at(cap):
        bundles = [_lower_min_jump(build_phold(
            H, load, sim_s, seed, cap, graph, device, ring=ring,
            fault_records=fault_records), min_jump_ns)
            for seed in (1, 2, 3)]
        state.update(cap=cap, bundle=bundles[0],
                     sims=[x.sim for x in bundles],
                     fn=_runner(bundles[0], phold.handler, device,
                                chunk_windows, app_bulk=phold.BULK))

    build_at(max(16, 3 * load))

    def go():
        go.escalated = False
        while True:
            sim0 = state["sims"][state["n"] % len(state["sims"])]
            state["n"] += 1
            sim, stats = state["fn"](sim0)
            if int(sim.events.overflow) + int(sim.outbox.overflow):
                build_at(state["cap"] * 2)   # rebuild, run again clean
                go.escalated = True
                continue
            if int(sim.app.rcvd.sum()) <= 0:
                raise RuntimeError("PHOLD: no message was received")
            go.last_sim, go.last_stats = sim, stats
            return int(stats.events_processed)

    go.escalated = False
    go.state = state
    return go


def phold_supervised_runner(H, load, sim_s, device, graph=ONE_VERTEX,
                            ring=True, fault_records=None,
                            chunk_windows=None, adaptive_jump=False,
                            min_jump_ns=None, checkpoint_windows=None):
    """bench.py's _phold_supervised_runner: PHOLD through
    faults.run_supervised with the bulk pass (bundle.app_bulk), health
    checks at every dispatch barrier, `chunk_windows` windows a dispatch
    and a checkpoint every `checkpoint_windows` windows (default never).
    The ring is sized for a chunk (at least twice its windows, rounded
    up to a power of two). Inputs, escalation and `go.last_*` as
    phold_runner; `go.last_result` is the SupervisorResult."""
    import atexit
    import shutil
    import tempfile

    from shadow_tpu_torch import faults, telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.faults.escalate import quantize_pow2
    from shadow_tpu_torch.telemetry.ring import DEFAULT_CAPACITY

    state = {"n": 0}
    every = checkpoint_windows or (1 << 30)
    ckdir = tempfile.mkdtemp(prefix="bench_sup_")
    atexit.register(shutil.rmtree, ckdir, True)
    W = quantize_pow2(max(DEFAULT_CAPACITY, 2 * (chunk_windows or 1)))

    def build_at(cap):
        bundles = [_lower_min_jump(build_phold(
            H, load, sim_s, seed, cap, graph, device, ring=ring,
            fault_records=fault_records, ring_capacity=W), min_jump_ns)
            for seed in (1, 2, 3)]
        b = bundles[0]
        b.app_bulk = phold.BULK
        state.update(cap=cap, bundle=b, sims=[x.sim for x in bundles])

    build_at(max(16, 3 * load))

    def go():
        go.escalated = False
        while True:
            b = state["bundle"]
            b.sim = state["sims"][state["n"] % len(state["sims"])]
            state["n"] += 1
            h = telemetry.Harvester()
            result = faults.run_supervised(
                b, app_handlers=(phold.handler,),
                checkpoint_path=os.path.join(ckdir, "ck"),
                checkpoint_every_windows=every, harvester=h,
                windows_per_dispatch=chunk_windows,
                adaptive_jump=adaptive_jump or None, device=device)
            sim = result.sim
            if int(sim.events.overflow) + int(sim.outbox.overflow):
                build_at(state["cap"] * 2)
                go.escalated = True
                continue
            if not result.ok:
                raise RuntimeError(f"PHOLD supervised: "
                                   f"{result.failure_report()}")
            if int(sim.app.rcvd.sum()) <= 0:
                raise RuntimeError("PHOLD: no message was received")
            go.last_sim, go.last_stats = sim, result.stats
            go.last_result, go.harvester = result, h
            return int(result.stats.events_processed)

    go.escalated = False
    go.state = state
    return go


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
    if (adaptive or ck_w) and not supervise:
        raise SystemExit(
            "BENCH_ADAPTIVE_JUMP / BENCH_CHECKPOINT_WINDOWS shape the "
            "supervised window loop; set BENCH_SUPERVISE=1")
    if workload != "phold":
        for flag, on in (("--faults", args.faults),
                         ("BENCH_SUPERVISE=1", supervise),
                         ("BENCH_MIN_JUMP_MS", mjms)):
            if on:
                raise SystemExit(f"{flag} is only wired for "
                                 f"BENCH_WORKLOAD=phold")
    # every knob is checked before torch loads and the device resolves
    from shadow_tpu_torch.device import resolve_device

    try:
        device = resolve_device(platform)
    except RuntimeError as e:
        raise SystemExit(f"shadow_tpu_torch.bench: {e}") from None
    fault_records = None
    if args.faults:
        from shadow_tpu_torch import faults

        with open(args.faults) as f:
            fault_records = faults.records_from_json(f.read())

    graph = MIX_VERTICES if topo == "mix" else ONE_VERTEX
    if workload == "phold" and supervise:
        runner = phold_supervised_runner(
            H, load, sim_s, device, graph=graph, ring=ring,
            fault_records=fault_records, chunk_windows=chunk,
            adaptive_jump=adaptive, min_jump_ns=min_jump_ns,
            checkpoint_windows=ck_w)
    elif workload == "phold":
        runner = phold_runner(
            H, load, sim_s, device, graph=graph, ring=ring,
            chunk_windows=chunk, fault_records=fault_records,
            min_jump_ns=min_jump_ns)
    else:
        runner = pingpong_runner(
            H, sim_s, device, graph=MIX_VERTICES if topo == "mix" else None,
            chunk_windows=chunk)
    if workload == "phold":
        name = f"events_per_sec_per_chip@{H}hosts_phold_load{load}"
    else:
        name = f"events_per_sec_per_chip@{H}hosts_udp_pingpong"
    if supervise:
        name += f"_supervised_chunk{chunk or 1}"
        if adaptive:
            name += "_adaptive"
    elif chunk:
        name += f"_chunk{chunk}"
    if mjms:
        name += f"_mj{mjms}ms"
    if topo == "mix":
        name += "_mixtopo"
    if fault_records:
        name += "_faults"

    _sync(device)
    t0 = time.perf_counter()
    runner()                      # warm-up: builds kernels, may escalate
    _sync(device)
    warmup_s = time.perf_counter() - t0
    m = timed(runner, device)
    print(json.dumps(make_row(name, H, m, runner.last_stats, device,
                              warmup_s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
