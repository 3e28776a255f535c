"""Benchmark of the port: events/s on bench.py's two workloads, printed
as bench.py's one JSON row. Run it as

    python -m shadow_tpu_torch.bench

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
                                 _chunk{K})
  BENCH_PLATFORM=cpu             run on the CPU

Every other BENCH_* knob of bench.py is refused (SystemExit naming it).

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
                   "BENCH_CHUNK_WINDOWS", "BENCH_PLATFORM"})

PINGPONG_COUNT = 20


def build_phold(H, load, sim_s, seed, cap, graph, device, ring=True):
    """bench.py's _build_phold (no replicas, faults or active subset):
    capacities `cap`, in_ring max(16, 2*load), the default sparse
    budget; plus the telemetry ring when `ring`."""
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
    if ring:
        b.sim = telemetry.attach(b.sim)
    return b


def _runner(b, handler, device, chunk_windows, app_bulk=None):
    from shadow_tpu_torch.net.build import make_chunked_runner, make_runner

    if chunk_windows:
        return make_chunked_runner(b, app_handlers=(handler,),
                                   app_bulk=app_bulk,
                                   chunk_windows=chunk_windows, device=device)
    return make_runner(b, app_handlers=(handler,), app_bulk=app_bulk,
                       device=device)


def phold_runner(H, load, sim_s, device, graph=ONE_VERTEX, ring=True,
                 chunk_windows=None):
    """bench.py's _phold_runner: a zero-argument callable that runs the
    workload once and returns its events; each call takes the next of
    three inputs (seeds 1, 2, 3). A counted queue or outbox
    overflow doubles the capacities, rebuilds and runs again
    (`go.escalated`). `go.last_sim` / `go.last_stats` hold the last
    clean run."""
    from shadow_tpu_torch.apps import phold

    state = {"n": 0}

    def build_at(cap):
        bundles = [build_phold(H, load, sim_s, seed, cap, graph, device,
                               ring=ring) for seed in (1, 2, 3)]
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


def main() -> int:
    off = sorted(k for k, v in os.environ.items()
                 if k.startswith("BENCH_") and v and k not in KNOBS)
    if off:
        raise SystemExit(f"shadow_tpu_torch.bench does not implement "
                         f"{', '.join(off)} (see ROADMAP.md)")
    platform = os.environ.get("BENCH_PLATFORM") or None
    if platform not in (None, "cpu"):
        raise SystemExit(f"BENCH_PLATFORM={platform!r}: only 'cpu' "
                         f"(unset = the GPU)")
    from shadow_tpu_torch.device import resolve_device

    try:
        device = resolve_device(platform)
    except RuntimeError as e:
        raise SystemExit(f"shadow_tpu_torch.bench: {e}") from None

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

    if workload == "phold":
        runner = phold_runner(
            H, load, sim_s, device,
            graph=MIX_VERTICES if topo == "mix" else ONE_VERTEX, ring=ring,
            chunk_windows=chunk)
        name = f"events_per_sec_per_chip@{H}hosts_phold_load{load}"
    else:
        runner = pingpong_runner(
            H, sim_s, device, graph=MIX_VERTICES if topo == "mix" else None,
            chunk_windows=chunk)
        name = f"events_per_sec_per_chip@{H}hosts_udp_pingpong"
    if chunk:
        name += f"_chunk{chunk}"
    if topo == "mix":
        name += "_mixtopo"

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
