#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (shadow_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py              # what the acceptance check runs
    python3 chip_smoke.py --profile    # also a torch.profiler window

Phases, in order; any failure exits non-zero and prints no result:

1. the device (nvidia-smi name and power limit, torch's device name);
2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the card, exact
   int32 equality, at the main path's shape and at a ragged shape, with
   CUDA-event timings of the kernel, the plain version and one PyTorch
   library call computing the same function (one event pair around
   many calls that cycle through input sets larger than the L2);
4. the main path at full width: UDP PHOLD, 10,240 hosts, load 8, the
   one-vertex 50 ms topology, capacities 48 and in_ring 16 as bench.py
   settles them, 5 simulated seconds, with the launch counters reset
   just before and read just after;
5. the same small PHOLD run on CUDA and on the CPU inside the port:
   equal EngineStats and every state leaf equal (tolerance zero — the
   state is integer apart from bit-exact f32 draws).

The last lines are the nvidia-smi line, one JSON object listing every
kernel, and {"ok": true, "device": {...}}. The script imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
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


T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *a, flush=True)


def build_phold(H, load, sim_s, seed, device, cap=None):
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    kw = {}
    if cap is not None:
        kw = dict(event_capacity=cap, outbox_capacity=cap, router_ring=cap)
    cfg = NetConfig(num_hosts=H, tcp=False, seed=seed, in_ring=IN_RING,
                    end_time=int(sim_s * simtime.ONE_SECOND),
                    sparse_lanes=0, **kw)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, ONE_VERTEX, hosts, device=device)
    b.sim = phold.setup(b.sim, load=load)
    return b


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


def check_mailbox_gather(device):
    """Phase 3: kernel == plain on the card, plus timings. `ms`,
    `plain_ms` and `library_ms` are cold: the calls cycle through input
    sets that together hold twice the L2, so every call reads its
    inputs from device memory, like the bound. The warm time (one input
    set, resident in L2) is printed beside them."""
    import torch

    from shadow_tpu_torch.core.events import INSERT_SWEEP
    from shadow_tpu_torch.core.insert_kernels import (
        mailbox_gather, mailbox_gather_ref)

    Wn, P = INSERT_SWEEP, 11
    shapes = {"main": (HOSTS, HOSTS * 24, 0), "ragged": (1_001, 5_000, 77)}
    err = 0
    for label, (H, n, tail) in shapes.items():
        stream, start = mailbox_inputs(H, n, Wn, P, seed=H, device=device,
                                       empty_tail=tail)
        got = mailbox_gather(stream, start, Wn)
        want = mailbox_gather_ref(stream, start, Wn)
        torch.cuda.synchronize()
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"mailbox_gather differs from its plain version at the "
                f"{label} shape (max abs err {err})")
        log(f"  mailbox_gather == plain at {label} shape H={H} n={n} "
            f"Wn={Wn} P={P}: exact")

    H, n = shapes["main"][:2]
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
    log(f"  mailbox_gather main shape, {n_sets} input sets cycled (cold): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, index_select "
        f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes:.0f} B); "
        f"kernel warm in L2 {warm_ms:.5f} ms")
    return {"name": "mailbox_gather", "route": "cuda",
            "source": "shadow_tpu_torch/csrc/mailbox_gather.cu",
            "replaces": "shadow_tpu/core/insert_pallas.py:98",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": lib_ms}, warm_ms


def run_main_path(device):
    """Phase 4: full-width PHOLD through the port's entry points."""
    import torch

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.net.build import make_runner

    t0 = time.perf_counter()
    b = build_phold(HOSTS, LOAD, SIM_S, seed=1, device=device, cap=CAPACITY)
    runner = make_runner(b, app_handlers=(phold.handler,), device=device)
    torch.cuda.synchronize()
    log(f"  built {HOSTS} hosts in {time.perf_counter() - t0:.2f} s")
    mailbox_gather.launches = 0
    t0 = time.perf_counter()
    sim, stats = runner(b.sim)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mailbox_gather": mailbox_gather.launches}
    st = stats.as_dict()
    app = sim.app
    sent, rcvd = int(app.sent.sum()), int(app.rcvd.sum())
    checks = {
        "events.overflow": int(sim.events.overflow),
        "outbox.overflow": int(sim.outbox.overflow),
        "rq_overflow": int(sim.net.rq_overflow),
        "remaining": int(app.remaining.sum()),
    }
    log(f"  EngineStats {st}")
    log(f"  wall {wall:.3f} s, {st['events_processed'] / wall:.1f} events/s, "
        f"{wall / max(st['windows'], 1) * 1e3:.2f} ms/window, "
        f"{wall / max(st['micro_steps'], 1) * 1e3:.3f} ms/micro-step")
    log(f"  sent {sent} rcvd {rcvd} checks {checks} launches {launches} "
        f"narrow_hit {int(sim.outbox.narrow_hit)} narrow_miss "
        f"{int(sim.outbox.narrow_miss)} max_occupied "
        f"{int(sim.outbox.max_occupied)}")
    for k, v in checks.items():
        if v != 0:
            raise AssertionError(f"main path: {k} = {v}, expected 0")
    if sent != HOSTS * LOAD + rcvd:
        raise AssertionError(f"main path: sent {sent} != H*load + rcvd "
                             f"{HOSTS * LOAD + rcvd}")
    if rcvd <= 0:
        raise AssertionError("main path: no message was received")
    if launches["mailbox_gather"] <= 0:
        raise AssertionError("main path never launched mailbox_gather")
    return launches


def profile_windows(device, gather_ms):
    """Optional: the main path's first 3 windows, once timed without the
    profiler and once under torch.profiler. Prints the device-busy share
    (union of the device intervals of the profiled run over the
    unprofiled run's wall time), the largest kernels by device time, the
    host's launch count, and mailbox_gather's time in the main path
    beside its standalone cold and warm times (`gather_ms`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    def fresh():
        b = build_phold(HOSTS, LOAD, 0.12, seed=2, device=device,
                        cap=CAPACITY)
        runner = make_runner(b, app_handlers=(phold.handler,), device=device)
        torch.cuda.synchronize()
        return runner, b.sim

    runner, sim = fresh()
    t0 = time.perf_counter()
    _, stats = runner(sim)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runner, sim = fresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pstats = runner(sim)
        torch.cuda.synchronize()
    if pstats.as_dict() != stats.as_dict():
        raise AssertionError("profiled run differs from the unprofiled one")
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in dev):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    log(f"  profile: {stats.as_dict()}; wall {wall:.3f} s without the "
        f"profiler; device busy {busy_us / 1e6:.4f} s = "
        f"{busy_us / 1e6 / wall * 100:.2f}% of it")
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"    {name[:60]:60s} calls {len(ts):7d} device "
            f"{sum(ts) / 1e3:9.2f} ms")
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("cuda") and "Launch" in e.name)
    log(f"  profile: {launches} kernel launches from the host, "
        f"{launches / max(stats.as_dict()['micro_steps'], 1):.0f} per "
        f"micro-step")
    g = [t for name, ts in by_name.items() if "mailbox_gather" in name
         for t in ts]
    if g:
        log(f"  profile: mailbox_gather in the main path {len(g)} launches, "
            f"mean {statistics.mean(g) / 1e3:.5f} ms (standalone cold "
            f"{gather_ms[0]:.5f} ms, warm {gather_ms[1]:.5f} ms)")


def compare_cuda_cpu(hosts, load, sim_s):
    """Phase 5: the port on CUDA equals the port on the CPU, leaf by
    leaf (tolerance zero)."""
    import numpy as np

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import make_runner

    out = {}
    for dev in ("cuda", "cpu"):
        b = build_phold(hosts, load, sim_s, seed=5, device=dev)
        t0 = time.perf_counter()
        sim, stats = make_runner(b, app_handlers=(phold.handler,),
                                 device=dev)(b.sim)
        out[dev] = (stats.as_dict(), convert.sim_to_numpy(sim))
        log(f"  {dev}: {out[dev][0]} in {time.perf_counter() - t0:.2f} s")
    (sa, la), (sb, lb) = out["cuda"], out["cpu"]
    if sa != sb:
        raise AssertionError(f"EngineStats differ: cuda {sa} cpu {sb}")
    if la.keys() != lb.keys():
        raise AssertionError("leaf sets differ")
    bad = [k for k in la if la[k].dtype != lb[k].dtype
           or not np.array_equal(la[k], lb[k])]
    if bad:
        raise AssertionError(f"{len(bad)} leaves differ, first {bad[:5]}")
    log(f"  cuda == cpu: EngineStats and all {len(la)} leaves equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the main path's first windows")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from shadow_tpu_torch.core import insert_kernels

    log("[1] device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()[0]
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
    device = torch.device("cuda", 0)
    row, warm_ms = check_mailbox_gather(device)

    log(f"[4] main path: PHOLD {HOSTS} hosts load {LOAD} {SIM_S} sim-s")
    launches = run_main_path(device)
    row["launches"] = launches["mailbox_gather"]

    if args.profile:
        log("[4b] profile")
        profile_windows(device, (row["ms"], warm_ms))

    log("[5] CUDA against CPU inside the port")
    compare_cuda_cpu(64, 4, 1.0)

    log("  done")
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
