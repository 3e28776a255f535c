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
CUDA fails its job, it never moves to the CPU. A sharded spec
(`shards` > 1) fails by name: the port runs a mesh as one process a
rank (parallel/shard.py), which a fleet worker does not start yet
(ROADMAP.md Queue 1 item 12c), so the reference's DEVICE_LOST requeue
at the degraded width has no job to come from.

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
import time
from typing import Optional

from shadow_tpu_torch.fleet.spec import JobSpec


def sim_digest(sim) -> str:
    """sha256 over every leaf's bytes (keyed by leaf path) — the
    bit-identity fingerprint the fleet compares against a clean serial
    run of the same spec. Leaves are hashed under their flax path and
    as the reference's dtype (convert.sim_to_numpy), in the reference's
    flatten order, so the digest equals the reference's."""
    import numpy as np

    from shadow_tpu_torch.convert import sim_to_numpy

    h = hashlib.sha256()
    for path, arr in sim_to_numpy(sim).items():
        h.update(path.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


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


def _run_scenario(spec: JobSpec, job_dir: str, *, resume_from,
                  stop, heartbeat, log, device=None) -> dict:
    from shadow_tpu_torch import faults, telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import specialize as specialize_mod
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

    # Elastic degraded execution: the in-run ladder is armed for a
    # sentinel-carrying spec (a sharded one is refused, run_job)
    elastic_policy = None
    if getattr(spec, "sentinel", False):
        from shadow_tpu_torch.parallel import elastic as elastic_mod

        elastic_policy = elastic_mod.ElasticPolicy()

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
        feeder=feeder, harvester=harvester, elastic=elastic_policy,
        # fleets live on repeated shapes: serve dispatch programs from
        # the persistent program store by default (compile/serve.py;
        # SHADOW_WARM_PROGRAMS=0 / SHADOW_NO_COMPILE_CACHE opt out)
        warm_start=True, device=dev)
    wall_s = time.monotonic() - t0

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
    }
    elastic_blk = getattr(res, "elastic", None)
    if elastic_blk is not None:
        result["elastic"] = elastic_blk
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
            cfg=bundle.cfg, seed=spec.seed, shards=1,
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
            result["digest"] = sim_digest(res.sim)
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
    which has no port yet (ROADMAP.md Queue 1 item 14), and a sharded
    spec needs a mesh of ranks the worker does not start yet (item
    12c): such a job fails with a ValueError naming its item."""
    os.makedirs(job_dir, exist_ok=True)
    try:
        if spec.kind == "chaos_trial":
            raise ValueError(
                "kind 'chaos_trial' runs tools/chaos_soak.py, which the "
                "port does not have yet (ROADMAP.md Queue 1 item 14)")
        if int(spec.shards) > 1:
            raise ValueError(
                f"shards={spec.shards}: a sharded job runs on a mesh of "
                "ranks, which the port's fleet worker does not start yet "
                "(ROADMAP.md Queue 1 item 12c)")
        result = _run_scenario(spec, job_dir,
                               resume_from=resume_from, stop=stop,
                               heartbeat=heartbeat, log=log, device=device)
    except Exception as e:  # noqa: BLE001 — worker must not die on a job
        result = {"ok": False, "preempted": False, "deadline": False,
                  "error": f"{type(e).__name__}: {e}"}
    _write_json(os.path.join(job_dir, "result.json"), result)
    return result
