"""The per-job engine: one scenario, run under the self-healing
supervisor, inside a worker process (PyTorch port of
shadow_tpu/fleet/scenario.py).

The fleet layer reuses the single-run machinery rather than
reimplementing any of it: `faults.run_supervised` is the engine
(health latches, escalation, preemption snapshots, the wallclock
deadline), `utils/checkpoint.py` is the resume mechanism (a job
requeued after a worker SIGKILL continues from its own supervisor
checkpoint, under a different worker process), and
`telemetry/export.py` writes the per-job `run_manifest.json` the fleet
manifest rolls up.

Every job runs on the device its worker was given (`device`: "cuda" on
the card, "cpu" when the fleet asks for it); a worker that cannot reach
CUDA fails its job, it never moves to the CPU.

A sharded spec (`shards` > 1) leases n = min(shards,
next_pow2_down(devices)) ranks, the devices counted as the CLI's
--workers counts them (the cards on CUDA, the request on the CPU); the
result's `device_lease` block says {requested, leased, devices,
final_shards}. With n > 1 the worker runs as rank 0 and starts ranks
1..n-1 as subprocesses (`python -m shadow_tpu_torch.fleet.scenario
RANKFILE`, parallel/shard.py RankProcesses: a fresh rendezvous each
attempt, each rank killed by the kernel when its worker dies:
die_with_parent), and
every rank runs the scenario under `run_supervised(mesh=...,
elastic=ElasticPolicy())`. The rank that reports (rank 0 unless the
ladder retired it) writes the result. A ladder exhausted on device
loss with more than one shard left returns the reference's
`device_lost` verdict {lost_shard, new_shards = final // 2, cause}: the
runner requeues the same attempt at that width (`shards_override`).
With n = 1 the job runs serially, as the reference's does on a one-chip
host.

Determinism: run_job(spec) is a pure function of the spec — the
checkpoint contract (run(0->T) == run(0->C) + resume(C->T)) makes the
result independent of how many times the job was killed and requeued —
and `sim_digest` equals the reference's for the same state, bit for
bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import sys
import time
from typing import Optional

from shadow_tpu_torch.fleet.spec import JobSpec


# the leaves whose values depend on the shard count (the outbox's route
# counters; parallel/shard.py), left out of `width_digest`
PER_SHARD_LEAVES = (".outbox.narrow_hit", ".outbox.narrow_miss",
                    ".outbox.max_occupied", ".outbox.route_elided")


def sim_digests(sim) -> tuple:
    """(sim_digest, width_digest) of one state, in one pass over its
    leaves: sha256 over every leaf's bytes keyed by leaf path — the
    bit-identity fingerprint the fleet compares against a clean serial
    run of the same spec — and the same over every leaf but
    PER_SHARD_LEAVES, which is equal for a job run at any width (a
    sharded job, a ladder's shrink, a requeue at a degraded width).
    Leaves are hashed under their flax path and as the reference's
    dtype (convert.sim_to_numpy), in the reference's flatten order, so
    sim_digest equals the reference's."""
    import numpy as np

    from shadow_tpu_torch.convert import sim_to_numpy

    full, width = hashlib.sha256(), hashlib.sha256()
    for path, arr in sim_to_numpy(sim).items():
        key = path.encode()
        data = np.ascontiguousarray(arr).tobytes()
        full.update(key)
        full.update(data)
        if path not in PER_SHARD_LEAVES:
            width.update(key)
            width.update(data)
    return full.hexdigest(), width.hexdigest()


def sim_digest(sim) -> str:
    """The first of sim_digests: equal to the reference's for the same
    state."""
    return sim_digests(sim)[0]


def _write_json(path: str, obj) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


# the PHOLD-on-one-vertex soak topology every scenario job runs on
# (shared with the resident-program builders below — one graph, so
# heterogeneous tenants differ only in their per-lane host count, load,
# seed and lease terms)
SOAK_GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""


def _build_scenario(spec: JobSpec, caps: dict, device=None):
    """The PHOLD-on-one-vertex scenario surface, sized by the spec
    (undersized caps + auto_grow exercises escalation; undersized caps
    without auto_grow is the deterministic-failure / quarantine
    vector), on `device`."""
    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile.buckets import bucket_config
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    lanes = 0
    if spec.inject_trace:
        # lane count must be stable across rebuilds/requeues — the
        # checkpoint's .inject leaves are [lanes]-shaped
        if spec.inject_lanes:
            lanes = int(spec.inject_lanes)
        else:
            from shadow_tpu_torch.apps.tgen import lanes_for
            from shadow_tpu_torch.inject import read_trace

            lanes = lanes_for(sum(1 for _ in
                                  read_trace(spec.inject_trace)))
    # packed job: R lane copies of the scenario in one program — `hosts`
    # is per-lane, the build carries hosts*replicas rows with contiguous
    # lane blocks and lane-isolated health attached below
    R = max(1, int(getattr(spec, "replicas", 1)))
    H = spec.hosts * R
    cfg = NetConfig(num_hosts=H, tcp=False,
                    end_time=spec.sim_s * simtime.ONE_SECOND,
                    seed=spec.seed,
                    event_capacity=caps["event_capacity"],
                    outbox_capacity=caps["outbox_capacity"],
                    router_ring=caps["router_ring"],
                    in_ring=max(8, 2 * spec.load),
                    inject_lanes=lanes)
    # every shape-bearing knob to its power-of-two bucket, so jobs of
    # nearby sizes share one program (and one store entry); padding is
    # behavior-neutral until the first overflow (compile/buckets.py)
    cfg, bucket_plan = bucket_config(cfg)
    hosts = [HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = build(cfg, SOAK_GRAPH, hosts, device=device)
    b.bucket_plan = bucket_plan
    b.sim = phold.setup(b.sim, load=spec.load,
                        replica_size=spec.hosts if R > 1 else None)
    if R > 1:
        from shadow_tpu_torch.core import lanes as lanes_mod

        b.sim = lanes_mod.attach(b.sim, R)
    if spec.faults:
        from shadow_tpu_torch.faults.plan import records_from_json

        faults.install(b, records_from_json({"faults":
                                             list(spec.faults)}))
    if int(getattr(spec, "flow_sample", 0) or 0) > 0:
        from shadow_tpu_torch import telemetry

        b.sim = telemetry.attach_flows(
            b.sim, sample_period=int(spec.flow_sample))
    if int(getattr(spec, "causality_sample", 0) or 0) > 0:
        from shadow_tpu_torch import telemetry

        b.sim = telemetry.attach_causality(
            b.sim, sample_period=int(spec.causality_sample))
    if getattr(spec, "sentinel", False):
        from shadow_tpu_torch.parallel import elastic as elastic_mod

        b.sim = elastic_mod.attach_sentinel(b.sim)
    # specialization LAST — the analysis reads the final sim
    # composition (attachments above) and the installed fault plan
    from shadow_tpu_torch.compile import specialize as specialize_mod

    b = specialize_mod.apply(b, (phold.handler,),
                             app_bulk=getattr(b, "app_bulk", None),
                             mode=getattr(spec, "specialize", "auto"))
    return b


def resident_caps(specs) -> dict:
    """Shared capacity envelope for a heterogeneous tenant set: every
    shape-bearing knob takes the max any tenant asked for (then the
    shell build quantizes to pow2 buckets). Padding is behavior-neutral
    until the first overflow, so the small tenant runs bit-identically
    at the big tenant's caps — the price of sharing one resident
    program."""
    specs = list(specs)
    if not specs:
        raise ValueError("resident_caps needs at least one tenant")
    return {
        "event_capacity": max(int(s.event_capacity) for s in specs),
        "outbox_capacity": max(int(s.outbox_capacity) for s in specs),
        "router_ring": max(int(s.router_ring) for s in specs),
        "in_ring": max(8, 2 * max(int(s.load) for s in specs)),
    }


def _resident_cfg(*, width: int, lanes: int, caps: dict,
                  horizon_ns: int, seed: int):
    """One NetConfig rule for the shell AND every tenant donor — the
    donor must build at identical shapes/dtypes or the implant
    (fleet/admission.py) would be transplanting across programs."""
    from shadow_tpu_torch.compile.buckets import bucket_config
    from shadow_tpu_torch.net.state import NetConfig

    cfg = NetConfig(num_hosts=int(width) * int(lanes), tcp=False,
                    end_time=int(horizon_ns), seed=int(seed),
                    event_capacity=caps["event_capacity"],
                    outbox_capacity=caps["outbox_capacity"],
                    router_ring=caps["router_ring"],
                    in_ring=caps["in_ring"])
    return bucket_config(cfg)


def build_resident_shell(*, width: int, lanes: int, caps: dict,
                         horizon_ns: int, seed: int = 0,
                         flow_sample: int = 1, device=None):
    """The resident program's bundle: R FREE lanes of `width` hosts,
    lane health + admission + (optionally) flow tracing attached, and
    NO pending events — build() seeds every host's PROC_START, but a
    FREE lane must be empty BEFORE the first window or the boot events
    would execute ahead of the device-side free-lane flush. Tenants
    enter by implant (fleet/admission.py), never by running the shell's
    own boot."""
    import torch

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import lanes as lanes_mod
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build

    cfg, bucket_plan = _resident_cfg(width=width, lanes=lanes, caps=caps,
                                     horizon_ns=horizon_ns, seed=seed)
    hosts = [HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(cfg.num_hosts)]
    b = build(cfg, SOAK_GRAPH, hosts, device=device)
    b.bucket_plan = bucket_plan
    # load=0: the injector arms nobody — the shell is an inert vessel
    # with the full PHOLD handler set, so any tenant's implanted chains
    # execute
    b.sim = phold.setup(b.sim, load=0, replica_size=int(width))
    b.sim = lanes_mod.attach(b.sim, int(lanes))
    b.sim = lanes_mod.attach_admission(b.sim)
    if int(flow_sample) > 0:
        from shadow_tpu_torch import telemetry

        b.sim = telemetry.attach_flows(
            b.sim, sample_period=int(flow_sample))
    # flush the boot PROC_STARTs explicitly (host-side, before any
    # dispatch): every lane starts FREE and empty
    b.sim = b.sim.replace(events=b.sim.events.replace(
        time=torch.full_like(b.sim.events.time, simtime.INVALID)))
    return b


def build_tenant_donor(spec: JobSpec, *, width: int, lanes: int,
                       caps: dict, horizon_ns: int, device=None):
    """A tenant's donor build: the SAME shapes as the resident shell
    (same cfg rule, same pow2 buckets) but seeded and loaded as the
    tenant's scenario — `spec.hosts` active hosts occupy each lane's
    prefix (apps/phold.py active_hosts), padding rows idle forever.

    The donor is never dispatched: fleet/admission.py slices ONE lane
    block out of its leaves and implants it into the warm program at
    the join barrier."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.net.build import HostSpec, build

    active = int(spec.hosts)
    if active > int(width):
        raise ValueError(
            f"tenant {spec.id}: hosts={active} exceeds the resident "
            f"lane width {width}")
    cfg, _ = _resident_cfg(width=width, lanes=lanes, caps=caps,
                           horizon_ns=horizon_ns, seed=spec.seed)
    hosts = [HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(cfg.num_hosts)]
    b = build(cfg, SOAK_GRAPH, hosts, device=device)
    b.sim = phold.setup(
        b.sim, load=int(spec.load), replica_size=int(width),
        active_hosts=active if active < int(width) else None)
    return b


def slo_verdict(spec: JobSpec, flows_blk) -> dict | None:
    """The per-job "slo" result block: compare the run's worst per-lane
    flow p99 against the spec's objective. None when the spec carries
    no SLO or no flow data exists."""
    if spec.slo_p99_ms is None or not flows_blk:
        return None
    per_lane = flows_blk.get("per_lane") or {}
    p99s = [int(v.get("p99_ns", 0)) for v in per_lane.values()
            if v.get("count")]
    if not p99s:
        return None
    worst = max(p99s)
    objective_ns = int(float(spec.slo_p99_ms) * 1e6)
    return {"objective_p99_ms": float(spec.slo_p99_ms),
            "p99_ns": worst,
            "met": worst <= objective_ns,
            "tenant_class": spec.tenant_class}


# the rank file a sharded job's started ranks read (one per attempt,
# written by rank 0 before it starts them)
RANK_FILE = "mesh_ranks.json"


def _lease_width(want: int, dev) -> tuple:
    """The reference's width rule for a sharded job: (n, devices) with
    n = min(want, next_pow2_down(device count)) and the devices of ranks
    0..n-1 — the device count as cli.mesh_width takes it: the cards on
    CUDA, the request on the CPU."""
    import torch

    from shadow_tpu_torch.device import rank_device
    from shadow_tpu_torch.parallel.elastic import next_pow2_down

    avail = torch.cuda.device_count() if dev.type == "cuda" else int(want)
    n = min(int(want), next_pow2_down(max(1, avail)))
    devices = []
    for r in range(n):
        d = rank_device(r, dev)
        devices.append(f"{d.type}:{r if d.index is None else d.index}")
    return n, devices


def _start_ranks(spec, job_dir, resume_from, dev, n, device_lease):
    """Ranks 1..n-1 of a sharded job's attempt, on a fresh rendezvous;
    they read RANK_FILE."""
    from shadow_tpu_torch.parallel.shard import RankProcesses

    _write_json(os.path.join(job_dir, RANK_FILE), {
        "spec": spec.as_dict(), "job_dir": job_dir,
        "resume_from": resume_from, "device": dev.type,
        "device_lease": device_lease})
    return RankProcesses("shadow_tpu_torch.fleet.scenario",
                         [os.path.join(job_dir, RANK_FILE)], n)


def _await_ranks(ranks, prefix, heartbeat, deadline_s=None) -> None:
    """Wait for the started ranks to exit, heartbeating meanwhile so the
    fleet's lease holds: without a deadline while a rank carries the
    run (the ladder retired this one; the job's wallclock watchdog
    bounds it), else within `deadline_s` once this rank is done."""
    from shadow_tpu_torch.utils import checkpoint as ckpt

    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    while ranks.alive() and (t_end is None or time.monotonic() < t_end):
        if heartbeat is not None:
            heartbeat({"wstart": -1,
                       "checkpoint": ckpt.latest_checkpoint(prefix)})
        time.sleep(0.2)


def _run_scenario(spec: JobSpec, job_dir: str, *, resume_from,
                  stop, heartbeat, log, device=None,
                  mesh_rank=None, device_lease=None) -> Optional[dict]:
    """One attempt of a scenario job on `device`. `mesh_rank` is
    (rank, world, rendezvous) in a started rank of a sharded job (None
    in the worker, which leases the width and starts the others);
    `device_lease` is the worker's lease, passed to a started rank
    so that whichever rank reports writes it. Returns the result, or
    None on a started rank that does not report."""
    from shadow_tpu_torch import faults, telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import specialize as specialize_mod
    from shadow_tpu_torch.core.insert_kernels import mailbox_gather
    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    caps = {"event_capacity": spec.event_capacity,
            "outbox_capacity": spec.outbox_capacity,
            "router_ring": spec.router_ring}
    if resume_from:
        # a post-escalation snapshot is larger than the spec says; its
        # recorded capacities size the rebuild (the CLI's --resume rule)
        meta = ckpt.peek_meta(resume_from)
        for k, v in (meta.get("capacities") or {}).items():
            if k in caps:
                caps[k] = max(caps[k], int(v))

    built = {"b": None}   # last-built bundle: cfg/plan for the manifest

    def make_bundle():
        built["b"] = _build_scenario(spec, caps, device=dev)
        return built["b"]

    def rebuild(overrides):
        caps.update(overrides)
        return make_bundle()

    prefix = os.path.join(job_dir, "ck")
    hb_state = {"last": 0.0}

    def on_round(sim, wstats, wstart, wend, next_min):
        if spec.round_sleep_s:
            time.sleep(spec.round_sleep_s)
        now = time.monotonic()
        if heartbeat is not None and now - hb_state["last"] >= 0.05:
            hb_state["last"] = now
            heartbeat({"wstart": int(wstart),
                       "checkpoint": ckpt.latest_checkpoint(prefix)})

    # a fresh Feeder per attempt is correct even on resume: the window
    # loop syncs it to the snapshot's trace cursor before the first
    # refill
    feeder = None
    if spec.inject_trace:
        from shadow_tpu_torch.inject import Feeder

        feeder = Feeder(spec.inject_trace)

    harvester = (telemetry.Harvester()
                 if int(getattr(spec, "flow_sample", 0) or 0) > 0
                 or int(getattr(spec, "causality_sample", 0) or 0) > 0
                 else None)

    # Elastic degraded-mesh execution (parallel/elastic.py): the worker
    # leases a width of the spec's shards (a degraded requeue arrives
    # with `shards` already shrunk by the fleet), starts the other
    # ranks, and every rank arms the in-run degradation ladder — device
    # loss retries, then shrinks to survivors, then falls serial,
    # resuming each rung from the last verified checkpoint.
    mesh = ranks = None
    elastic_policy = None
    want = max(1, int(getattr(spec, "shards", 1)))
    if want > 1 or getattr(spec, "sentinel", False):
        from shadow_tpu_torch.parallel import elastic as elastic_mod

        elastic_policy = elastic_mod.ElasticPolicy()
    if want > 1 and mesh_rank is None:
        n, devices = _lease_width(want, dev)
        device_lease = {"requested": want, "leased": n,
                        "devices": devices}
        if n > 1:
            # a result.json in the dir is a former attempt's: the rank
            # that reports this one writes it anew
            stale = os.path.join(job_dir, "result.json")
            if os.path.exists(stale):
                os.unlink(stale)
            ranks = _start_ranks(spec, job_dir, resume_from, dev, n,
                                 device_lease)
            mesh_rank = (0, n, ranks.init)
    launches0 = mailbox_gather.launches
    ran = False                  # the attempt returned on this rank
    try:
        if mesh_rank is not None:
            from shadow_tpu_torch.parallel import Mesh

            rank, world, init = mesh_rank
            mesh = Mesh(world, rank, init_method=init, device=dev)
            # every rank passes a stop: the supervisor reduces the
            # ranks' flags at each barrier
            stop = stop or (lambda: False)
        t0 = time.monotonic()
        res = faults.run_supervised(
            make_bundle(), app_handlers=(phold.handler,),
            checkpoint_path=prefix,
            checkpoint_every_windows=spec.checkpoint_every_windows,
            max_retries=spec.max_retries,
            escalation=(faults.EscalationPolicy(max_grow=spec.max_grow)
                        if spec.auto_grow else None),
            rebuild=rebuild, stop=stop, resume_from=resume_from,
            max_run_wallclock=spec.max_wallclock_s,
            on_round=on_round, log=log, sleep=lambda s: None,
            feeder=feeder, harvester=harvester, mesh=mesh,
            elastic=elastic_policy,
            # fleets live on repeated shapes: serve dispatch programs
            # from the persistent program store by default
            # (compile/serve.py; SHADOW_WARM_PROGRAMS=0 /
            # SHADOW_NO_COMPILE_CACHE opt out)
            warm_start=True, device=dev if mesh is None else None)
        wall_s = time.monotonic() - t0
        ran = True
        if mesh is not None:
            mesh.close()
        if not res.reports or res.retired:
            if ranks is None:
                return None          # a started rank that does not report
            # the ladder retired this rank: the rank carrying the run
            # writes the result
            _await_ranks(ranks, prefix, heartbeat)
            path = os.path.join(job_dir, "result.json")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"the ladder retired rank 0 and the rank carrying "
                    f"the run wrote no result: {ranks.errors()}")
            with open(path) as f:
                return json.load(f)
    finally:
        if mesh is not None:
            mesh.close()
        if ranks is not None:
            from shadow_tpu_torch.parallel.shard import RANK_JOIN_S

            # the others finish with this one; after a failure here
            # they are killed at once
            _await_ranks(ranks, prefix, heartbeat,
                         RANK_JOIN_S if ran else 0.0)
            for r, err in ranks.errors().items():
                if log is not None:
                    log(f"fleet: rank {r} exited non-zero:\n{err}")
            ranks.kill()

    result = {
        "ok": bool(res.ok),
        "preempted": bool(res.preempted),
        "deadline": bool(res.deadline_exceeded),
        # wallclock of this attempt only (a requeued continuation
        # reports its own)
        "wall_s": round(wall_s, 3),
        "run_id": res.run_id,
        "resume_of": res.resume_of,
        "supervisor_attempts": res.attempts,
        "escalation_restarts": res.escalation_restarts,
        "final_capacities": dict(caps),
        "checkpoint": res.final_checkpoint,
        # this process's launches of the hand-written kernel (a sharded
        # job's other ranks count their own)
        "kernel_launches": {
            "mailbox_gather": mailbox_gather.launches - launches0},
    }
    elastic_blk = getattr(res, "elastic", None)
    final_shards = (int(elastic_blk["final_shards"])
                    if elastic_blk else
                    (mesh.size if mesh is not None else 1))
    if device_lease is not None:
        device_lease = dict(device_lease, final_shards=final_shards)
        result["device_lease"] = device_lease
    if elastic_blk is not None:
        result["elastic"] = elastic_blk
    hl = getattr(res, "health", None)
    if (not res.ok and hl is not None
            and int(getattr(hl, "device_lost", 0) or 0) > 0
            and final_shards > 1):
        # the in-run ladder exhausted on device loss: hand the fleet a
        # degraded-requeue verdict — next-pow2-down width, same attempt
        # (runner._fold_result routes this through queue.device_lost)
        result["device_lost"] = {
            "lost_shard": int(getattr(hl, "lost_shard", -1) or -1),
            "new_shards": max(1, final_shards // 2),
            "cause": str(getattr(hl, "device_lost_cause", "")
                         or "device lost"),
        }
    incidents = tuple(getattr(res, "lane_incidents", ()) or ())
    if incidents:
        # packed job: each quarantined lane becomes a standalone
        # replicas=1 requeue spec at the regrown capacities its trip
        # bits name — the runner backfills these into the queue
        requeues = []
        for inc in incidents:
            child = spec.as_dict()
            child.update({"id": f"{spec.id}.lane{inc.lane}",
                          "replicas": 1, "lane_of": spec.id})
            for knob, val in (inc.regrow or {}).items():
                child[knob] = max(int(child.get(knob) or 0), int(val))
            requeues.append(child)
        result["lanes"] = {
            "replicas": int(getattr(spec, "replicas", 1)),
            "quarantined": [int(i.lane) for i in incidents],
            "incidents": [i.as_dict() for i in incidents],
            "requeues": requeues,
        }
    if res.sim is not None:
        bundle = built["b"]
        from shadow_tpu_torch import inject as inject_mod
        from shadow_tpu_torch.telemetry.export import lanes_manifest_block
        from shadow_tpu_torch.telemetry.flows import flows_manifest_block

        cinfo = dict(res.compile_info or {})
        plan = getattr(bundle, "bucket_plan", None)
        if plan is not None:
            cinfo["buckets"] = plan.as_dict()
        result["program_key"] = cinfo.get("key")
        flows_blk = None
        caus_blk = None
        if harvester is not None:
            harvester.drain(res.sim)
            flows_blk = flows_manifest_block(
                harvester, num_hosts=bundle.cfg.num_hosts, shards=1,
                sample_period=int(spec.flow_sample))
            from shadow_tpu_torch.telemetry.causality import \
                causality_manifest_block

            caus_blk = causality_manifest_block(
                harvester, num_hosts=bundle.cfg.num_hosts, shards=1,
                sample_period=int(getattr(spec, "causality_sample", 0)
                                  or 0) or None)
        man = telemetry.run_manifest(
            cfg=bundle.cfg, seed=spec.seed, shards=final_shards,
            sim=res.sim,
            stats=res.stats, health=res.health,
            fault_plan=bundle.fault_plan,
            elastic=elastic_blk,
            run_id=res.run_id, resume_of=res.resume_of,
            escalations=res.escalations,
            preempted=res.preempted or None,
            injection=inject_mod.manifest_block(res.sim, feeder),
            lanes=lanes_manifest_block(res.health, incidents),
            flows=flows_blk,
            causality=caus_blk,
            compile_info=cinfo or None,
            specialization=specialize_mod.specialization_block(
                getattr(bundle, "caps", None), res.sim,
                mode=getattr(spec, "specialize", "auto")))
        result["manifest"] = telemetry.write_manifest(
            os.path.join(job_dir, "run_manifest.json"), man)
        result["counters"] = man["counters"]
        result["health_verdict"] = (man.get("health") or {}).get(
            "verdict")
        ev = (man["counters"] or {}).get("events_processed")
        if ev is not None and wall_s > 0:
            result["events_per_sec"] = round(int(ev) / wall_s, 3)
        if flows_blk is not None:
            result["flows"] = {
                k: flows_blk[k] for k in
                ("sample_period", "sampled", "recorded", "harvested",
                 "lost_ring", "lost_window_clamp", "per_lane")
                if k in flows_blk}
        if caus_blk is not None:
            result["causality"] = {
                k: caus_blk[k] for k in
                ("sample_period", "sampled", "harvested", "lost_ring",
                 "windows_attributed", "windows_lost", "causes")
                if k in caus_blk}
        verdict = slo_verdict(spec, flows_blk)
        if verdict is not None:
            result["slo"] = verdict
        if res.ok:
            result["digest"], result["width_digest"] = sim_digests(
                res.sim)
    if not res.ok and not res.preempted:
        result["failure"] = res.failure_report()
    return result


def run_job(spec: JobSpec, job_dir: str, *,
            resume_from: Optional[str] = None, stop=None,
            heartbeat=None, log=None, device=None) -> dict:
    """Execute one job attempt (or continuation) on `device` (None ->
    "cuda"; raises inside, and so fails the job, without CUDA). Always
    leaves `result.json` in the job dir — the crash-safe copy the
    supervisor salvages if the worker's pipe dies with the worker.

    The "chaos_trial" kind runs tools/chaos_soak.py in the reference,
    which has no port yet (ROADMAP.md Queue 1 item 14): such a job
    fails with a ValueError naming its item."""
    os.makedirs(job_dir, exist_ok=True)
    try:
        if spec.kind == "chaos_trial":
            raise ValueError(
                "kind 'chaos_trial' runs tools/chaos_soak.py, which the "
                "port does not have yet (ROADMAP.md Queue 1 item 14)")
        result = _run_scenario(spec, job_dir,
                               resume_from=resume_from, stop=stop,
                               heartbeat=heartbeat, log=log, device=device)
    except Exception as e:  # noqa: BLE001 — worker must not die on a job
        result = {"ok": False, "preempted": False, "deadline": False,
                  "error": f"{type(e).__name__}: {e}"}
    _write_json(os.path.join(job_dir, "result.json"), result)
    return result


def rank_main(argv=None) -> int:
    """A started rank of a sharded job: `python -m
    shadow_tpu_torch.fleet.scenario RANKFILE` with its rank, the width
    and the rendezvous in the environment (parallel/shard.py rank_env).
    It runs the attempt of RANKFILE on its mesh and, when the ladder
    makes it the reporting rank, writes the job's result.json. SIGTERM
    sets its stop flag (the ranks' flags are reduced at each
    barrier)."""
    from shadow_tpu_torch.parallel.shard import die_with_parent, rank_env

    die_with_parent()
    argv = sys.argv[1:] if argv is None else argv
    rank, world, init = rank_env()
    with open(argv[0]) as f:
        d = json.load(f)
    spec = JobSpec.from_dict(d["spec"])
    stop = {"v": False}
    signal.signal(signal.SIGTERM, lambda s, f: stop.update(v=True))
    with open(os.path.join(d["job_dir"], f"rank{rank}.log"), "a",
              buffering=1) as logf:
        logf.write(f"fleet: job {spec.id} rank {rank} of {world}, pid "
                   f"{os.getpid()}\n")
        result = _run_scenario(
            spec, d["job_dir"], resume_from=d["resume_from"],
            stop=lambda: stop["v"], heartbeat=None,
            log=lambda m: logf.write(f"{m}\n"), device=d["device"],
            mesh_rank=(rank, world, init),
            device_lease=d.get("device_lease"))
    if result is not None:
        _write_json(os.path.join(d["job_dir"], "result.json"), result)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
