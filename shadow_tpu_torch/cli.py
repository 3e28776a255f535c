"""Command-line entry point of the PyTorch/CUDA port (the counterpart of
shadow_tpu/cli.py; ref: main.c:734-802, options.c): parse flags, load
the XML config, build device state, run, report.

    python -m shadow_tpu_torch.cli --test            # 1,000-client example
    python -m shadow_tpu_torch.cli my.shadow.config.xml
    python -m shadow_tpu_torch.cli my.shadow.config.xml --platform cpu

The parser takes every flag of the reference's, with the same defaults,
and the run prints the reference's report (events, windows, app_rcvd,
overflow, ... as its last line), tracker heartbeat, object counts and
per-host executed-event lines. Runs go to the GPU unless `--platform
cpu` asks for the CPU: `auto` and `gpu` both mean the card, and raise
without CUDA.

Open-system injection streams a trace (`--inject-trace`) or the
config's <traffic> elements through inject.Feeder: the supervised loop
refills the staging lanes at every barrier, the whole-run path stages
the whole trace up front; the report gains the `injection` block.
`--trace-out`, `--metrics-out` and `--telemetry-capacity` attach the
window ring and write `run_manifest.json` into the data directory, the
Chrome trace and the Prometheus text. `--flow-sample N` and
`--causality-sample N` attach the flow and causality recorders (their
manifest blocks, and trace groups with `--trace-out`).
`--lane-isolation R` partitions the hosts into R lanes with lane-scoped
health latches (core/lanes.py; the manifest's `lanes` block), and
`--resident` adds the resident lease planes (its `admission` block).

The netstack's observability settings run as in the reference: a
config with <host logpcap="true"> drains the capture ring into one
libpcap file per host in the data directory after every window
(utils/pcap.py), `--track-paths` logs the per-path packet counts, and
`--cpu-threshold N` (with `--cpu-precision`) turns on the virtual CPU.
On the card the run requires the native library (native/, built with
g++ at first use): its log writer sorts large batches with it.

A config with `.py` plugins or the reftests syscall plugins runs its
virtual processes (process/vproc.py ProcessRuntime: coroutines over the
simulated syscalls, the device window between their rounds), on the
full program and without injection, lane isolation or window telemetry,
as in the reference. `--host-kernel run` executes the same processes on
the real OS (hostrun/); `--host-kernel diff` runs both and diffs their
normalized syscall traces (exit 4 on divergence, 2 when no localhost
port binds; the manifest's `conformance` block).

Flags whose mechanism the port does not have yet are refused by name
(exit 2) with the ROADMAP.md Queue 1 item they wait for: `--workers` >
1 (item 9); `--profile-dir`, which names jax.profiler. The `fleet` and
`sweep` sub-commands wait for item 12.

`--specialize auto` (the default) runs the capability-trimmed program,
as the reference does (compile/specialize.py: on a lossless topology
with no plan touching reliability the loss draws are left out, and the
timer handlers when every app declares it arms no timer), with a guard
latch that makes a violated assumption a fatal health fault; the
manifest gains its `specialization` block. `--specialize off` runs the
full program. The reference's compatibility flags (`--preload`,
`--data-template`, `--gdb`, `--valgrind`, `--interface-batch`,
`--interface-buffer`, `--scheduler-policy`) are accepted and have no
effect, as there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from shadow_tpu_torch import __version__
from shadow_tpu_torch.telemetry.export import config_hash


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="parallel discrete-event network simulator "
                    "(PyTorch/CUDA port of shadow-tpu)",
    )
    p.add_argument("config", nargs="?", help="shadow.config.xml path")
    p.add_argument("--test", action="store_true",
                   help="run the built-in example config (ref: --test)")
    p.add_argument("--test-clients", type=int, default=1000,
                   help="clients in the built-in --test config; the "
                        "reference bakes in 1000 (examples.c:10-12)")
    p.add_argument("-w", "--workers", type=int, default=1,
                   help="device shards (refused above 1: ROADMAP.md "
                        "Queue 1 item 9)")
    p.add_argument("-s", "--seed", type=int, default=1)
    p.add_argument("--scheduler-policy", default="device",
                   choices=["device", "host", "steal", "thread",
                            "threadXthread", "threadXhost"],
                   help="accepted for config compatibility; one device "
                        "scheduler implements the window semantics")
    p.add_argument("--runahead", type=int, default=0,
                   help="minimum window (ms), 0 = derive from topology "
                        "min latency (ref: master.c:133-159)")
    p.add_argument("--bootstrap-end", type=int, default=0,
                   help="unlimited-bandwidth bootstrap period (s)")
    p.add_argument("--interface-qdisc", default="fifo",
                   choices=["fifo", "rr"])
    p.add_argument("--router-qdisc", default="codel",
                   choices=["codel", "single", "static"],
                   help="upstream router queue manager (ref: router.c; "
                        "CoDel default per host.c:205)")
    p.add_argument("--socket-recv-buffer", type=int, default=174760)
    p.add_argument("--socket-send-buffer", type=int, default=131072)
    p.add_argument("--tcp-congestion-control", default="reno",
                   choices=["reno", "aimd", "cubic"])
    p.add_argument("--tcp-ssthresh", type=int, default=0,
                   help="initial slow-start threshold in packets, "
                        "0 = discover via loss (ref: options.c:137)")
    p.add_argument("--tcp-windows", type=int, default=0,
                   help="pin the initial congestion window in packets, "
                        "0 = protocol default (ref: options.c:138)")
    p.add_argument("--cpu-threshold", type=int, default=-1,
                   help="virtual-CPU blocking threshold in microseconds, "
                        "negative disables the CPU model (ref: "
                        "options.c:130)")
    p.add_argument("--cpu-precision", type=int, default=200,
                   help="round CPU delays to this many microseconds "
                        "(ref: options.c:129)")
    p.add_argument("-l", "--log-level", default="message",
                   choices=["error", "critical", "warning", "message",
                            "info", "debug"])
    p.add_argument("--heartbeat-frequency", type=int, default=60,
                   help="tracker heartbeat interval (s)")
    p.add_argument("--heartbeat-log-level", default="message")
    p.add_argument("-i", "--heartbeat-log-info",
                   default="node,socket,ram",
                   help="comma list of heartbeat sections "
                        "('node','socket','ram')")
    # accepted for reference-invocation compatibility; no effect
    for flag in ("--preload", "--data-template"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--gdb", "--valgrind"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag in ("--interface-batch", "--interface-buffer"):
        p.add_argument(flag, type=int, default=None,
                       help=argparse.SUPPRESS)
    p.add_argument("-d", "--data-directory", default="shadow.data")
    # default None = let the plugin capacity hints size these
    p.add_argument("--sockets-per-host", type=int, default=None)
    p.add_argument("--platform", default="auto",
                   choices=["auto", "gpu", "cpu"],
                   help="device to run on: 'auto' and 'gpu' are the "
                        "CUDA card (an error without one); 'cpu' asks "
                        "for the CPU explicitly")
    p.add_argument("--track-paths", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="per-path packet counters, logged at the end of "
                        "the run (ref: topology.c:2053-2063)")
    p.add_argument("--event-capacity", type=int, default=None)
    p.add_argument("--outbox-capacity", type=int, default=None)
    p.add_argument("--router-ring", type=int, default=None)
    p.add_argument("--inject-trace", default=None, metavar="PATH",
                   help="stream an injection trace (newline-JSON or "
                        "binary, see docs/9-injection.md) into the "
                        "simulated hosts; overrides a config's "
                        "<traffic> elements. The injected kinds must "
                        "have a device handler (the tgen plugin, or "
                        "tools/trace_gen.py targeting one)")
    p.add_argument("--inject-lanes", type=int, default=None,
                   help="device staging lanes for injection "
                        "(power of two; default sized from the trace "
                        "length, capped at 1024 — longer traces "
                        "stream through a host-driven loop)")
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome-trace/Perfetto JSON of "
                        "per-window telemetry records (sim-time track) "
                        "plus wall-clock phase spans; enables the "
                        "device-resident telemetry ring")
    p.add_argument("--metrics-out", default=None,
                   help="write final counters as Prometheus text "
                        "exposition; enables the telemetry ring")
    p.add_argument("--telemetry-capacity", type=int, default=None,
                   help="telemetry ring capacity in window records "
                        "(default 4096); overruns are latched as a "
                        "health warning, never silently")
    p.add_argument("--flow-sample", type=int, default=0, metavar="N",
                   help="sample 1-in-N cross-host packets into the "
                        "per-flow latency flight recorder "
                        "(telemetry/flows.py): deterministic "
                        "(time,dst,src,seq)-hash sampling, per-lane "
                        "latency histograms and a cross-shard traffic "
                        "matrix in the manifest. 0 (default) = off, "
                        "byte-identical to builds without the recorder")
    p.add_argument("--flow-capacity", type=int, default=None,
                   help="flow ring capacity in sampled records "
                        "(default 4096); window-clamp and overrun "
                        "losses are accounted, never silent")
    p.add_argument("--causality-sample", type=int, default=0, metavar="N",
                   help="sample 1-in-N emitted events into the causal "
                        "lineage recorder (telemetry/causality.py): "
                        "parent/child event keys, window-advance "
                        "attribution (which clamp decided every window "
                        "end), top-K critical chains and a binding-"
                        "cause histogram in the manifest, a critical-"
                        "path track in --trace-out, and the input "
                        "tools/critpath.py turns into a speed-of-light "
                        "report. 0 (default) = off, byte-identical to "
                        "builds without the recorder")
    p.add_argument("--causality-capacity", type=int, default=None,
                   help="per-host lineage sub-ring capacity in sampled "
                        "events (default 64); overruns are accounted "
                        "in the manifest, never silently")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="refused: names jax.profiler (chip_smoke.py "
                        "--profile profiles the port)")
    p.add_argument("--host-kernel", choices=("run", "diff"), default=None,
                   help="execute the config's .py-plugin processes on "
                        "the REAL host kernel (hostrun backend): 'run' "
                        "executes there only; 'diff' runs both backends "
                        "and diffs normalized syscall traces, writing a "
                        "conformance block into run_manifest.json "
                        "(exit 4 on divergence)")
    p.add_argument("--host-time-scale", type=float, default=0.05,
                   help="host-kernel backend: simulated seconds -> real "
                        "seconds for sleeps/timers (default 0.05)")
    p.add_argument("--supervise", action="store_true",
                   help="host-driven window loop with health latches, "
                        "periodic checkpoints, and checkpoint-backed "
                        "retry on a latch trip (exit 3 + structured "
                        "failure report when retries are exhausted)")
    p.add_argument("--chunk-windows", type=int, default=None,
                   metavar="K",
                   help="windows per dispatch: the chunked runner (and "
                        "the supervised loop's chunk size)")
    p.add_argument("--adaptive-jump", action="store_true", default=None,
                   help="derive each window's span from the live "
                        "latency tables (supervised loop only)")
    p.add_argument("--checkpoint-every-windows", type=int, default=64,
                   help="supervisor snapshot cadence in windows")
    p.add_argument("--checkpoint-path", default=None,
                   help="snapshot path prefix (default: "
                        "<data-directory>/checkpoint)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="resume attempts after a latch trip before "
                        "giving up")
    p.add_argument("--retry-backoff", type=float, default=0.25,
                   help="base seconds of exponential backoff between "
                        "retries")
    p.add_argument("--max-run-wallclock", type=float, default=None,
                   metavar="SECONDS",
                   help="supervised runs: wallclock deadline; when a "
                        "barrier finds it spent, take a final snapshot "
                        "and exit 3 (--resume continues)")
    p.add_argument("--stall-windows", type=int, default=512,
                   help="consecutive zero-event windows before the "
                        "stall latch trips")
    p.add_argument("--lane-isolation", type=int, default=None,
                   metavar="R",
                   help="partition the hosts into R contiguous lanes "
                        "with lane-scoped health latches "
                        "(core/lanes.py): a capacity trip quarantines "
                        "only the tripped lane — its hosts freeze at "
                        "the window barrier while healthy lanes run to "
                        "completion (blast-radius containment for "
                        "packed ensemble runs; supervised runs salvage "
                        "the sick lane's slice from the last clean "
                        "checkpoint). Lanes must not exchange traffic "
                        "for healthy-lane bit-exactness; single-shard "
                        "only (docs/6-robustness.md)")
    p.add_argument("--resident", action="store_true",
                   help="attach resident-admission lease planes to a "
                        "lane-isolated run (requires --lane-isolation; "
                        "core/lanes.py LaneAdmission): every lane "
                        "boots with an open lease, barriers enforce "
                        "free-lane flush + completion latching, and "
                        "the manifest gains an 'admission' block. "
                        "This is the static-population twin of the "
                        "fleet's resident programs, whose lease table "
                        "churns lanes at barriers (not ported: "
                        "ROADMAP.md Queue 1 item 12)")
    p.add_argument("--auto-grow", action="store_true",
                   help="supervisor escalation: a fatal capacity "
                        "overflow doubles the tripped knob, rebuilds "
                        "and transplants the last clean checkpoint")
    p.add_argument("--max-grow", type=int, default=8,
                   help="escalation budget: total capacity doublings")
    p.add_argument("--specialize", choices=("auto", "off"),
                   default="auto",
                   help="program specialization "
                        "(compile/specialize.py): auto (default) "
                        "leaves the loss draws and timer handlers the "
                        "build proves dead out of the program, with a "
                        "device guard latch that turns any violation "
                        "into a fatal health fault; off runs the full "
                        "program")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="continue a previous run from its checkpoint: "
                        "a snapshot file, a checkpoint path prefix, or "
                        "a data directory (newest snapshot wins). "
                        "Implies --supervise")
    p.add_argument("--version", action="version",
                   version=f"shadow-tpu-torch {__version__} "
                           f"(capability target: shadow 1.x)")
    return p


def overrides_from_args(args) -> dict:
    """Map parsed CLI flags onto config-loader overrides (None values
    mean "keep the config/default"). Reference units: the CPU knobs are
    microseconds (options.c:129-130), negative threshold = CPU model
    disabled."""
    overrides = {
        "tcp_ssthresh": args.tcp_ssthresh or None,
        "tcp_windows": args.tcp_windows or None,
        "cpu_threshold_ns": (args.cpu_threshold * 1000
                             if args.cpu_threshold >= 0 else None),
        "cpu_precision_ns": (args.cpu_precision * 1000
                             if args.cpu_precision >= 0 else None),
        "interface_qdisc": args.interface_qdisc,
        "router_qdisc": args.router_qdisc,
        "socket_recv_buffer": args.socket_recv_buffer,
        "socket_send_buffer": args.socket_send_buffer,
        "tcp_congestion_control": args.tcp_congestion_control,
        "runahead": args.runahead,
        "sockets_per_host": args.sockets_per_host,
        "event_capacity": args.event_capacity,
        "outbox_capacity": args.outbox_capacity,
        "router_ring": args.router_ring,
        "track_paths": args.track_paths,
        "windows_per_dispatch": args.chunk_windows,
        "adaptive_jump": args.adaptive_jump,
        "inject_lanes": args.inject_lanes,
    }
    return {k: v for k, v in overrides.items() if v is not None}


def refused_flags(args) -> list[str]:
    """The flags given whose mechanism is not ported, each with its
    ROADMAP.md Queue 1 item."""
    out = []
    if args.workers > 1:
        out.append("--workers > 1 (ROADMAP.md Queue 1 item 9)")
    if args.profile_dir is not None:
        out.append("--profile-dir (it names jax.profiler; "
                   "chip_smoke.py --profile profiles the port)")
    return out


def _host_kernel_mode(args, b, loaded, logger, device) -> int:
    """--host-kernel: execute the config's virtual processes on the
    real OS (hostrun backend). 'diff' additionally runs the simulation
    on `device` and compares normalized syscall traces — the dual-mode
    conformance check. Exit codes: 0 agree/ran, 2 no bindable localhost
    ports, 4 divergence."""
    from shadow_tpu_torch import hostrun
    from shadow_tpu_torch.hostrun.trace import TraceRecorder

    try:
        hostrun.PortAllocator.preflight()
    except hostrun.PortsUnavailable as e:
        print(f"error: host-kernel backend unavailable: {e}",
              file=sys.stderr)
        return 2

    ip_names = {int(b.ip_of(n)): n for n in b.host_names}
    host_rec = TraceRecorder(ip_names=ip_names)
    ex = hostrun.HostKernelExecutor(
        b, time_scale=args.host_time_scale, trace=host_rec)
    for hi, fn, st, sp in loaded.vprocs:
        ex.spawn(hi, fn, start_time=st, stop_time=sp)
    t0 = time.time()
    ex.run()
    wall = time.time() - t0
    logger.message(0, "shadow-tpu",
                   f"host-kernel run complete: {len(ex.procs)} "
                   f"process(es), {wall:.2f}s wall")
    if args.host_kernel == "run":
        print(json.dumps({"mode": "host-kernel-run",
                          "processes": len(ex.procs),
                          "wall_seconds": round(wall, 3)}))
        return 0

    # diff: the same generators through the simulation, then compare
    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    sim_rec = TraceRecorder(ip_names=ip_names)
    rt = ProcessRuntime(b, app_handlers=loaded.handlers, device=device)
    rt.trace = sim_rec
    for hi, fn, st, sp in loaded.vprocs:
        rt.spawn(hi, fn, start_time=st, stop_time=sp)
    sim, stats = rt.run()
    res = hostrun.diff_traces(sim_rec.normalized(), host_rec.normalized())
    print(hostrun.render(res))
    name = os.path.basename(args.config) if args.config else "config"
    conf = {"workloads": {name: "agree" if res.agree else "diverge"},
            "agree": int(res.agree), "diverge": int(not res.agree),
            "total": 1}
    man = telemetry.run_manifest(
        cfg=b.cfg, seed=args.seed, shards=1, sim=sim, stats=stats,
        fault_plan=b.fault_plan, conformance=conf)
    os.makedirs(args.data_directory, exist_ok=True)
    mpath = telemetry.write_manifest(
        os.path.join(args.data_directory, "run_manifest.json"), man)
    logger.message(0, "shadow-tpu", f"run manifest -> {mpath}")
    print(json.dumps({"mode": "host-kernel-diff", "agree": res.agree,
                      "manifest": mpath}))
    return 0 if res.agree else 4


def _resolve_resume(path: str) -> str | None:
    """--resume accepts a snapshot file, a checkpoint prefix, or a data
    directory; returns the newest matching snapshot path."""
    from shadow_tpu_torch.utils import checkpoint as ckpt

    if os.path.isdir(path):
        return ckpt.latest_checkpoint(os.path.join(path, "checkpoint"))
    if os.path.isfile(path):
        return path
    return ckpt.latest_checkpoint(path)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ("fleet", "sweep"):
        print(f"error: `{argv[0]}` is not ported yet (ROADMAP.md Queue 1 "
              f"item 12)", file=sys.stderr)
        return 2
    args = make_parser().parse_args(argv)
    refused = refused_flags(args)
    if refused:
        print("error: shadow_tpu_torch does not implement these flags "
              "yet: " + ", ".join(refused), file=sys.stderr)
        return 2

    from shadow_tpu_torch.device import resolve_device

    # no quiet move to the CPU: 'auto' and 'gpu' are the card
    try:
        device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        # no quiet move to list.sort on the card either
        from shadow_tpu_torch import native

        try:
            native.require()
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    from shadow_tpu_torch.config.examples import example_config
    from shadow_tpu_torch.utils.shadowlog import SimLogger, level_from_name

    if args.test:
        text = example_config(clients=args.test_clients)
    elif args.config:
        with open(args.config) as f:
            text = f.read()
    else:
        print("error: provide a config path or --test", file=sys.stderr)
        return 1

    logger = SimLogger(level=level_from_name(args.log_level),
                       require_native=device.type == "cuda")
    # flush on every exit path so a mid-run failure still surfaces the
    # buffered sim log (the reference flushes each round,
    # slave.c:446-450)
    try:
        return _run(args, text, device, logger)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        logger.flush()


class _Telemetry:
    """The run's optional observability: the injection feeder, and the
    window ring's harvester and phase timers (None when off)."""

    def __init__(self, feeder=None, harvester=None, timers=None):
        self.feeder = feeder
        self.harvester = harvester
        self.timers = timers

    def phase(self, name):
        return (self.timers.phase(name) if self.timers is not None
                else contextlib.nullcontext())

    def lost(self) -> int:
        """Window and flow records overwritten before a drain."""
        h = self.harvester
        return 0 if h is None else h.records_lost + h.flow_lost

    def injection(self, sim):
        if self.feeder is None:
            return None
        from shadow_tpu_torch import inject

        return inject.manifest_block(sim, self.feeder)


def _run(args, text, device, logger) -> int:
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config

    cfg = parse_config(text)
    # --resume: find the snapshot BEFORE building, because its recorded
    # capacities must size the build
    resume_ckpt = None
    resume_meta = None
    overrides = overrides_from_args(args)
    if args.resume:
        resume_ckpt = _resolve_resume(args.resume)
        if resume_ckpt is None:
            print(f"error: no checkpoint found at {args.resume}",
                  file=sys.stderr)
            return 1
        args.supervise = True
        from shadow_tpu_torch.utils import checkpoint as ckpt_mod

        resume_meta = ckpt_mod.peek_meta(resume_ckpt)
        for k, v in (resume_meta.get("capacities") or {}).items():
            if k in ("event_capacity", "outbox_capacity", "router_ring"):
                overrides[k] = max(int(overrides.get(k) or 0), int(v))
    if args.inject_trace and "inject_lanes" not in overrides:
        # size the staging buffer from the trace before the build (the
        # loader's default for <traffic> elements)
        from shadow_tpu_torch.apps.tgen import lanes_for
        from shadow_tpu_torch.inject import read_trace

        n_ev = sum(1 for _ in read_trace(args.inject_trace))
        overrides["inject_lanes"] = lanes_for(n_ev)
    loaded = load(cfg, seed=args.seed, overrides=overrides,
                  base_dir=os.path.dirname(os.path.abspath(args.config))
                  if args.config else None, device=device)
    b = loaded.bundle
    if resume_meta is not None and resume_meta.get("config_digest"):
        if resume_meta["config_digest"] != config_hash(b.cfg):
            logger.warning(
                0, "shadow-tpu",
                "resume snapshot was taken under a different config "
                "digest — continuing, but the runs are not the same "
                "simulation")
    logger.message(0, "shadow-tpu", f"built {b.cfg.num_hosts} hosts, "
                   f"min window {b.min_jump} ns, end {b.cfg.end_time} ns")

    # open-system injection: an explicit --inject-trace beats the
    # config's compiled <traffic> trace
    tel = _Telemetry()
    if args.inject_trace or loaded.inject_events:
        from shadow_tpu_torch.inject import Feeder

        if loaded.vprocs:
            print("error: event injection needs the on-device window "
                  "loop; .py-plugin virtual processes cannot consume "
                  "injected events", file=sys.stderr)
            return 1
        if args.inject_trace and loaded.inject_events:
            logger.warning(0, "shadow-tpu",
                           "--inject-trace overrides the config's "
                           "<traffic> elements")
        tel.feeder = Feeder(args.inject_trace or list(loaded.inject_events))
        logger.message(
            0, "shadow-tpu",
            f"injection staging: {b.sim.inject.lanes} lanes, source "
            f"{args.inject_trace or '<traffic> elements'}")
    t0 = time.time()
    # periodic run-time progress records (the reference's per-round
    # heartbeat, slave.c:390-411); the host-driven supervised loop calls
    # it per window
    prog_state = {"last": -1}

    def progress_hook(s, wend):
        sec = int(wend) // 10**9
        bucket = sec // max(args.heartbeat_frequency, 1)
        if bucket > prog_state["last"]:
            prog_state["last"] = bucket
            logger.message(
                int(wend), "shadow-tpu", "[shadow-progress] "
                + json.dumps({
                    "sim_seconds": round(int(wend) / 1e9, 3),
                    "wall_seconds": round(time.time() - t0, 3)}))

    # lane-isolated health: attach BEFORE the telemetry ring, which
    # sizes its per-lane fan-out planes off sim.lanes. Single-program
    # window loops only: the ProcessRuntime loop has no lane barrier
    if args.lane_isolation and loaded.vprocs:
        logger.warning(0, "shadow-tpu",
                       "--lane-isolation is unavailable with .py plugins "
                       "(ProcessRuntime window loop); ignored")
    elif args.lane_isolation:
        from shadow_tpu_torch.core import lanes as lanes_mod

        try:
            b.sim = lanes_mod.attach(b.sim, args.lane_isolation)
        except ValueError as e:
            print(f"error: --lane-isolation: {e}", file=sys.stderr)
            return 1
        logger.message(
            0, "shadow-tpu",
            f"lane isolation: {args.lane_isolation} lanes x "
            f"{b.cfg.num_hosts // args.lane_isolation} hosts")
        if args.resident:
            # static-population resident planes: every lane admitted at
            # t=0 with an open lease
            b.sim = lanes_mod.admit_all(lanes_mod.attach_admission(b.sim))
            logger.message(
                0, "shadow-tpu",
                f"resident admission: {args.lane_isolation} lanes "
                f"admitted with open leases")
    if args.resident and getattr(b.sim, "admission", None) is None:
        logger.warning(0, "shadow-tpu",
                       "--resident requires --lane-isolation (admission "
                       "is lease bookkeeping over lanes); ignored")

    # window telemetry and the recorders: attach BEFORE the run so the
    # supervisor's resume template and the runners see the same state
    from shadow_tpu_torch import telemetry

    telem_on = bool(args.trace_out or args.metrics_out
                    or args.telemetry_capacity)
    flows_on = bool(args.flow_sample and args.flow_sample > 0)
    caus_on = bool(args.causality_sample and args.causality_sample > 0)
    if (telem_on or flows_on or caus_on) and loaded.vprocs:
        logger.warning(0, "shadow-tpu",
                       "window telemetry is unavailable with .py plugins "
                       "(ProcessRuntime drives its own window loop); "
                       "--trace-out/--metrics-out/--flow-sample/"
                       "--causality-sample ignored")
        telem_on = flows_on = caus_on = False
    if telem_on:
        b.sim = telemetry.attach(
            b.sim, capacity=args.telemetry_capacity
            or telemetry.DEFAULT_CAPACITY)
    if flows_on:
        from shadow_tpu_torch.telemetry import flows as flows_mod

        cap = args.flow_capacity or flows_mod.DEFAULT_CAPACITY
        try:
            b.sim = telemetry.attach_flows(
                b.sim, sample_period=args.flow_sample, capacity=cap)
        except ValueError as e:
            print(f"error: --flow-sample: {e}", file=sys.stderr)
            return 1
        logger.message(0, "shadow-tpu",
                       f"flow tracing: 1-in-{args.flow_sample} packet "
                       f"sampling, ring capacity {cap}")
    if caus_on:
        from shadow_tpu_torch.telemetry import causality as caus_mod

        cap = args.causality_capacity or caus_mod.DEFAULT_CAPACITY
        try:
            b.sim = telemetry.attach_causality(
                b.sim, sample_period=args.causality_sample, capacity=cap)
        except ValueError as e:
            print(f"error: --causality-sample: {e}", file=sys.stderr)
            return 1
        logger.message(0, "shadow-tpu",
                       f"causality tracing: 1-in-{args.causality_sample} "
                       f"event sampling, per-host lineage capacity {cap}")
    if telem_on or flows_on or caus_on:
        tel.harvester = telemetry.Harvester()
        tel.timers = telemetry.PhaseTimers()

    # program specialization (compile/specialize.py): derive the
    # capability vector from the concrete build AFTER every attachment,
    # so the analysis sees the final Sim. Virtual processes arm host
    # timers outside the handlers' declarations, so .py-plugin runtimes
    # and --host-kernel run the full program
    from shadow_tpu_torch.compile import specialize

    if loaded.vprocs or args.host_kernel:
        b = specialize.apply(b, mode="off")
    else:
        b = specialize.apply(b, loaded.handlers, app_bulk=b.app_bulk,
                             mode=args.specialize)
    if b.caps is not None and b.caps.dropped():
        logger.message(
            0, "shadow-tpu",
            "specialization: trimmed " + ",".join(b.caps.dropped())
            + f" (program-key extra {b.caps.key_extra()!r}; guard latch "
              f"armed)")

    cap = None
    window_hook = progress_hook
    if b.cfg.pcap:
        # pcap capture needs a host-driven window loop to drain the
        # ring (ref: per-interface PCapWriter, pcap_writer.c)
        from shadow_tpu_torch.utils.pcap import CaptureSession

        cap = CaptureSession(b, args.data_directory)

        def window_hook(s, wend):
            cap.drain(s)
            progress_hook(s, wend)

    sup_result = None
    if args.host_kernel:
        if not loaded.vprocs:
            print("error: --host-kernel needs a config with .py plugins "
                  "(virtual processes)", file=sys.stderr)
            return 1
        return _host_kernel_mode(args, b, loaded, logger, device)
    if loaded.vprocs:
        # .py plugins: coroutine processes over the simulated syscall
        # surface; the runtime's window loop drains the capture ring
        from shadow_tpu_torch.process.vproc import ProcessRuntime

        if b.app_bulk is not None:
            # ProcessRuntime's window loop has no bulk-pass hook: a
            # mixed .py-plugin + bulk-capable-app config falls back to
            # per-event micro-steps
            logger.warning(0, "shadow-tpu",
                           "bulk window pass unavailable with .py "
                           "plugins; using per-event micro-steps")
        rt = ProcessRuntime(b, app_handlers=loaded.handlers, device=device)
        for hi, fn, st, sp in loaded.vprocs:
            rt.spawn(hi, fn, start_time=st, stop_time=sp)
        sim, stats = rt.run(on_window=window_hook)
        _sync(device)
    elif args.supervise:
        code, sup_result = _supervise(args, b, loaded, device, logger,
                                      window_hook, resume_ckpt, tel)
        if code is not None:
            return code
        sim, stats = sup_result.sim, sup_result.stats
    elif cap is not None:
        from shadow_tpu_torch.utils import checkpoint as ckpt

        def pcap_hook(s, wend):
            cap.drain(s)
            if tel.harvester is not None:
                # the host regains control every window here; draining
                # per window keeps ring loss at zero
                tel.harvester.drain(s)
            progress_hook(s, wend)

        with tel.phase("window-loop"):
            sim, stats, _ = ckpt.run_windows(
                b, app_handlers=loaded.handlers, on_window=pcap_hook,
                feeder=tel.feeder, device=device)
            _sync(device)
    else:
        from shadow_tpu_torch.net.build import make_chunked_runner, \
            make_runner

        if tel.feeder is not None:
            # whole-run path: the entire trace must fit the staging
            # lanes (fill_all names the streaming alternative)
            b.sim = tel.feeder.fill_all(b.sim)
        with tel.phase("trace-compile"):
            if args.chunk_windows:
                runner = make_chunked_runner(
                    b, app_handlers=loaded.handlers, app_bulk=b.app_bulk,
                    chunk_windows=args.chunk_windows, device=device)
            else:
                runner = make_runner(b, app_handlers=loaded.handlers,
                                     app_bulk=b.app_bulk, device=device)
        with tel.phase("device-execute"):
            sim, stats = runner(b.sim)
            _sync(device)
    _sync(device)
    if cap is not None:
        cap.drain(sim)
        cap.close()
        if cap.dropped:
            logger.warning(b.cfg.end_time, "shadow-tpu",
                           f"pcap ring overran: {cap.dropped} records "
                           f"lost (raise NetConfig.pcap_ring)")
    wall = time.time() - t0
    return _report(args, b, sim, stats, wall, logger, sup_result, tel)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _supervise(args, b, loaded, device, logger, progress_hook, resume_ckpt,
               tel):
    """The --supervise branch: (exit code or None, SupervisorResult)."""
    import signal

    from shadow_tpu_torch.faults.escalate import EscalationPolicy
    from shadow_tpu_torch.faults.supervisor import run_supervised

    ckpt_prefix = args.checkpoint_path or os.path.join(
        args.data_directory, "checkpoint")
    os.makedirs(os.path.dirname(os.path.abspath(ckpt_prefix)),
                exist_ok=True)

    # preemption safety: the first SIGTERM/SIGINT asks the supervisor
    # for a final atomic snapshot at the next window barrier (exit 5);
    # the handler restores the previous disposition immediately, so a
    # second signal kills a hung run the ordinary way
    stop_flag = {"v": False}
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop_flag["v"] = True
        signal.signal(signum, prev_handlers[signum])

    for sg in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sg] = signal.signal(sg, _on_signal)
        except ValueError:
            pass  # not the main thread (embedded use)
    try:
        with tel.phase("supervised-run"):
            result = run_supervised(
                b, app_handlers=loaded.handlers,
                checkpoint_path=ckpt_prefix,
                checkpoint_every_windows=args.checkpoint_every_windows,
                max_retries=args.max_retries,
                backoff_s=args.retry_backoff,
                stall_windows=args.stall_windows,
                escalation=(EscalationPolicy(max_grow=args.max_grow)
                            if args.auto_grow else None),
                stop=lambda: stop_flag["v"],
                resume_from=resume_ckpt,
                max_run_wallclock=args.max_run_wallclock,
                config_digest=config_hash(b.cfg),
                log=lambda m: logger.message(0, "shadow-tpu", m),
                on_window=progress_hook, harvester=tel.harvester,
                feeder=tel.feeder, device=device)
    finally:
        for sg, h in prev_handlers.items():
            with contextlib.suppress(ValueError, TypeError):
                signal.signal(sg, h)

    if result.preempted:
        # interrupted, not failed: the final snapshot is on disk and
        # `--resume <data-directory>` continues the run
        report = {
            "preempted": True,
            "checkpoint": result.final_checkpoint,
            "run_id": result.run_id,
            "escalations": len(result.escalations),
            "resume": f"--resume {args.data_directory}",
        }
        if tel.harvester is not None and result.sim is not None:
            tel.harvester.drain(result.sim)
            report["manifest"] = _export(
                args, b, result.sim, result.stats, None, tel, result,
                preempted=True)
        logger.message(0, "shadow-tpu", "run preempted "
                       + json.dumps(report))
        logger.flush()
        print(json.dumps(report))
        return 5, result
    if not result.ok:
        failure = result.failure_report()
        # critical, not error: SimLogger.error raises
        for _, msg in result.health.diagnostics():
            logger.critical(0, "shadow-tpu", msg)
        report = {"failure": failure, "attempts": result.attempts}
        if result.deadline_exceeded:
            report["checkpoint"] = result.final_checkpoint
            report["resume"] = f"--resume {args.data_directory}"
        if result.sim is not None:
            from shadow_tpu_torch.utils import objcount

            oc = objcount.gather(result.sim)
            logger.message(0, "shadow-tpu", oc.format())
            logger.message(0, "shadow-tpu", oc.format_diff())
            if tel.harvester is not None:
                tel.harvester.drain(result.sim)
                report["manifest"] = _export(
                    args, b, result.sim, None, result.health, tel, result)
        logger.flush()
        print(json.dumps(report))
        return 3, result
    return None, result


def _export(args, b, sim, stats, health, tel, sup_result=None, *,
            wall=None, preempted=None) -> dict:
    """Write run_manifest.json into the data directory (and the Chrome
    trace / Prometheus text when asked); returns the manifest."""
    from shadow_tpu_torch import telemetry

    extra = {}
    if sup_result is not None:
        wpd = max(1, int(getattr(b.cfg, "windows_per_dispatch", 1) or 1))
        disp = {"windows_per_dispatch": wpd,
                "dispatches": sup_result.dispatches}
        # the per-dispatch window list only sums to the chain's window
        # counter for a clean single-attempt run
        if (wpd > 1 and sup_result.dispatch_windows
                and sup_result.attempts == 1
                and sup_result.resume_of is None):
            disp["windows"] = list(sup_result.dispatch_windows)
        if getattr(b.cfg, "adaptive_jump", False):
            m = tel.harvester.mean_window_ns()
            if m is not None:
                disp["adaptive_jump_mean_ns"] = m
        extra = {"run_id": sup_result.run_id,
                 "resume_of": sup_result.resume_of,
                 "escalations": sup_result.escalations,
                 "dispatch": disp}
    from shadow_tpu_torch.compile import specialize
    from shadow_tpu_torch.telemetry.causality import (
        causality_manifest_block,
    )
    from shadow_tpu_torch.telemetry.export import (
        admission_manifest_block,
        lanes_manifest_block,
    )
    from shadow_tpu_torch.telemetry.flows import flows_manifest_block

    h = tel.harvester
    caus_blk = causality_manifest_block(
        h, num_hosts=b.cfg.num_hosts, shards=1,
        sample_period=args.causality_sample or None)
    man = telemetry.run_manifest(
        cfg=b.cfg, seed=args.seed, shards=1, sim=sim, stats=stats,
        health=health, fault_plan=b.fault_plan, harvester=h,
        timers=tel.timers, wall_seconds=wall, preempted=preempted,
        injection=tel.injection(sim),
        lanes=lanes_manifest_block(
            health, sup_result.lane_incidents
            if sup_result is not None else ()),
        flows=flows_manifest_block(
            h, num_hosts=b.cfg.num_hosts, shards=1,
            sample_period=args.flow_sample or None),
        admission=admission_manifest_block(health),
        causality=caus_blk,
        specialization=specialize.specialization_block(
            getattr(b, "caps", None), sim, mode=args.specialize),
        **extra)
    os.makedirs(args.data_directory, exist_ok=True)
    telemetry.write_manifest(
        os.path.join(args.data_directory, "run_manifest.json"), man)
    if args.trace_out:
        telemetry.write_trace(args.trace_out, h.records, tel.timers, 1,
                              flow_records=h.flow_records,
                              adv_records=h.adv_records or None,
                              chains=(caus_blk or {}).get("chains"))
    if args.metrics_out:
        telemetry.write_metrics(args.metrics_out, man)
    return man


def _report(args, b, sim, stats, wall, logger, sup_result, tel) -> int:
    """End-of-run heartbeat, object accounting, executed-event lines,
    the health verdict, the run manifest and the JSON report (the
    reference's keys)."""
    from shadow_tpu_torch.faults import health as health_mod
    from shadow_tpu_torch.utils import objcount
    from shadow_tpu_torch.utils.shadowlog import level_from_name
    from shadow_tpu_torch.utils.tracker import Tracker

    end = b.cfg.end_time
    # ref: the tracker heartbeat subsystem, tracker.c:419-607, and the
    # shutdown object counter dump, slave.c:237-241
    tracker = Tracker(
        logger, b.host_names, interval_s=args.heartbeat_frequency,
        level=level_from_name(args.heartbeat_log_level),
        sections=tuple(x.strip() for x in args.heartbeat_log_info.split(",")
                       if x.strip()))
    tracker.heartbeat(sim, end)
    oc = objcount.gather(sim, stats=stats)
    logger.message(end, "shadow-tpu", oc.format())
    logger.message(end, "shadow-tpu", oc.format_diff())

    # per-host executed-event lines (ref: host.c:314-317), info level
    exec_h = sim.net.ctr_events_exec.cpu().numpy()
    for hi in np.argsort(-exec_h)[: min(len(exec_h), 10)]:
        if exec_h[hi] > 0:
            logger.info(end, b.host_names[hi],
                        f"executed {int(exec_h[hi])} events")
    # per-path packet counts (ref: topology.c:2053-2063)
    if b.cfg.track_paths:
        mat = sim.net.ctr_path_packets.cpu().numpy()
        for a, c in zip(*np.nonzero(mat)):
            logger.message(end, "shadow-tpu",
                           f"path {a}->{c}: {int(mat[a, c])} packets")

    # health-latch enforcement: every run ends with an explicit verdict,
    # and a fatal latch means exit 3 with a structured failure report
    if tel.harvester is not None:
        with tel.phase("harvest"):
            tel.harvester.drain(sim)
    run_health = health_mod.gather(sim, telemetry_lost=tel.lost())
    for sev, msg in run_health.diagnostics():
        if sev == "fatal":
            logger.critical(end, "shadow-tpu", msg)
        else:
            logger.warning(end, "shadow-tpu", msg)

    ev = int(stats.events_processed)
    sim_s = end / 1e9
    app = getattr(sim, "app", None)
    report = {
        "events": ev,
        "windows": int(stats.windows),
        "sim_seconds": round(sim_s, 3),
        # the app's own rcvd units — bytes for bulk, replies for
        # pingpong (ref: the example's downloads verified by size)
        **({"app_rcvd": int(app.rcvd.sum())}
           if app is not None and hasattr(app, "rcvd") else {}),
        "wall_seconds": round(wall, 3),
        "events_per_second": round(ev / wall, 1) if wall > 0 else None,
        "simulated_seconds_per_wall_second":
            round(sim_s / wall, 3) if wall > 0 else None,
        "overflow": int(sim.events.overflow) + int(sim.outbox.overflow)
        + int(sim.net.rq_overflow),
    }
    inj_blk = tel.injection(sim)
    if inj_blk is not None:
        report["injection"] = inj_blk
    if sup_result is not None:
        if sup_result.escalations:
            report["escalations"] = [
                e.as_dict() for e in sup_result.escalations]
        if sup_result.resume_of:
            report["resume_of"] = sup_result.resume_of
    if tel.harvester is not None:
        with tel.phase("export"):
            man = _export(args, b, sim, stats, run_health, tel, sup_result,
                          wall=wall)
            logger.message(end, "shadow-tpu", "run manifest -> "
                           + os.path.join(args.data_directory,
                                          "run_manifest.json"))
            if args.trace_out:
                logger.message(end, "shadow-tpu",
                               f"trace -> {args.trace_out} (load in "
                               f"chrome://tracing or ui.perfetto.dev)")
        report["telemetry"] = man["telemetry"]
    if run_health.fatal:
        report["failure"] = run_health.failure_report()
        logger.critical(end, "shadow-tpu",
                        "simulation FAILED " + json.dumps(report))
        logger.flush()
        print(json.dumps(report))
        return 3
    logger.message(end, "shadow-tpu", "simulation complete "
                   + json.dumps(report))
    logger.flush()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
