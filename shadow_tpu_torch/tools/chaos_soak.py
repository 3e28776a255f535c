"""Randomized chaos soak for the self-healing supervisor (the port's
tools/chaos_soak.py).

Each trial assembles a hostile-but-lawful run from a seeded RNG:

- a random fault plan over loss / latency / linkdown / linkup (crash
  and restart are excluded on purpose — a crash flushes a host's event
  row non-conservatively, which would void the exact ledger the soak
  asserts; see faults/conserve.py),
- a deliberately undersized event queue, so the overflow latch trips
  and the supervisor must escalate (grow + rebuild + transplant)
  rather than retry,
- a random number of simulated preemption kills: the stop flag fires
  at a random round barrier, the supervisor takes its final snapshot
  and raises Preempted, and the trial resumes the chain from that
  snapshot — exactly the SIGTERM/--resume path minus the signal.

The oracle is the per-window conservation ledger (faults/conserve.py):
at every round barrier of every attempt of every segment,
pushed == processed + queued + outboxed (exact, since healed runs
carry zero overflow), and window starts / counters stay monotone.
Samples from windows that a resume replays are superseded by the
replay (the checkpoint contract makes them bit-identical), mirroring
conserve.stitch.

With --verify each trial also re-runs the whole simulation
uninterrupted at the final (post-escalation) capacities and demands
the final state be bit-identical to the healed chain's.

Usage:
  python -m shadow_tpu_torch.tools.chaos_soak --trials 20 --seed 1 \\
      [--kills 2] [--verify] [--platform cpu]
  python -m shadow_tpu_torch.tools.chaos_soak --trials 5 --replicas 4
One JSON line per trial on stdout; exit 1 if any trial fails.
--replicas R packs R PHOLD lanes into one program (core/lanes.py),
floods one seeded victim lane's event rows mid-run, and asserts the
victim quarantines while every neighbor lane's final per-host state
stays byte-identical to a clean packed run.
--sweep runs one small halving sweep (sweep/driver.py) clean and
again under one SIGKILL per fleet round, asserting lattice
conservation, quarantine accounting, and byte-identical rankings.
--device-loss runs sharded trials killing one victim shard on two
consecutive dispatches (poisoned dispatch_wrap), asserting the
supervisor walks retry -> shrink-to-survivors, the healed run is
byte-identical to an uninterrupted full-width control, and the
elastic block + checkpoint ledger stamps are lint-clean
(parallel/elastic.py). Its mesh is one process per rank
(parallel.spawn): gloo on the CPU and for ranks that share a card,
NCCL across cards.

Every trial runs on the card unless --platform cpu (device="cpu" in
code) asks for the CPU; without CUDA it fails and names the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

# how long the device-loss trial's ranks may take
RANK_DEADLINE_S = 600.0


def random_records(rng: np.random.Generator, *, sim_s: int):
    """A lawful random plan over the conservation-safe kinds. Link
    flaps are generated as down/up pairs so the topology never stays
    dark to the end (an all-dark run finishes early and legally, but
    soaks nothing)."""
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.faults.plan import (FaultKind, FaultRecord,
                                              validate_records)

    SEC = simtime.ONE_SECOND
    end = sim_s * SEC
    recs = []
    for _ in range(int(rng.integers(2, 6))):
        t = int(rng.integers(SEC // 10, end - SEC // 10))
        roll = rng.random()
        if roll < 0.45:
            recs.append(FaultRecord(
                t_ns=t, kind=FaultKind.LOSS, a=0, b=0,
                value=int(rng.integers(50_000, 300_000))))
        elif roll < 0.8:
            recs.append(FaultRecord(
                t_ns=t, kind=FaultKind.LATENCY, a=0, b=0,
                value=int(rng.integers(100_000, 5_000_000))))
        else:
            up = min(t + int(rng.integers(50, 200)) * 1_000_000, end - 1)
            recs.append(FaultRecord(t_ns=t, kind=FaultKind.LINK_DOWN,
                                    a=0, b=0))
            recs.append(FaultRecord(t_ns=up, kind=FaultKind.LINK_UP,
                                    a=0, b=0))
    recs.sort(key=lambda r: r.t_ns)
    errors, _ = validate_records(recs, num_vertices=1)
    assert not errors, errors  # generator bug, not a sim bug
    return recs


def _build(hosts, load, sim_s, seed, caps, device, replicas=1):
    """The PHOLD scenario on one 50 ms vertex; with `replicas` > 1, R
    lane copies of it in one program (contiguous lane blocks with
    lane-isolated health latches)."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    H = hosts * replicas
    cfg = NetConfig(num_hosts=H, tcp=False,
                    end_time=sim_s * simtime.ONE_SECOND, seed=seed,
                    event_capacity=caps["event_capacity"],
                    outbox_capacity=caps["outbox_capacity"],
                    router_ring=caps["router_ring"],
                    in_ring=max(8, 2 * load))
    specs = [HostSpec(name=f"p{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, GRAPH, specs, device=device)
    if replicas == 1:
        b.sim = phold.setup(b.sim, load=load)
        return b
    from shadow_tpu_torch.core import lanes as lanes_mod

    b.sim = phold.setup(b.sim, load=load, replica_size=hosts)
    b.sim = lanes_mod.attach(b.sim, replicas)
    return b


def _roomy(load) -> dict:
    roomy = max(32, 4 * load)
    return {"event_capacity": roomy, "outbox_capacity": roomy,
            "router_ring": roomy}


def run_trial(seed: int, *, hosts: int = 8, load: int = 2,
              sim_s: int = 1, kills: int = 2,
              undersize: bool = True, max_grow: int = 8,
              checkpoint_every: int = 4, workdir: str | None = None,
              verify: bool = False, log=None, device=None) -> dict:
    """One healed run on `device` (None -> "cuda"): random plan +
    undersized capacity + `kills` random preemption kills,
    conservation-checked at every barrier. Returns a JSON-able report;
    report["ok"] is the verdict."""
    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.faults import conserve

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    records = random_records(rng, sim_s=sim_s)
    caps = _roomy(load)
    if undersize:
        caps["event_capacity"] = int(rng.integers(1, load + 1))
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="chaos_soak.")

    def make_bundle():
        b = _build(hosts, load, sim_s, seed, caps, device)
        faults.install(b, records)
        return b

    def rebuild(overrides):
        caps.update(overrides)  # next segment boots at grown shapes too
        return make_bundle()

    # The conservation ledger, sampled at every round barrier. A
    # resume replays from its snapshot, so a non-advancing wstart
    # supersedes the stale tail (conserve.stitch semantics, applied
    # online); cumulative processed restarts from the last kept
    # barrier — the snapshot the replay resumed from.
    samples: list = []
    ctl = {"rounds": 0, "kill_at": None}

    def on_round(sim, wstats, wstart, wend, next_min):
        while samples and samples[-1].wstart >= wstart:
            samples.pop()
        base = samples[-1].processed if samples else 0
        delta = int(wstats.events_processed)
        samples.append(conserve.sample(
            sim, wstart=wstart, wend=wend, next_min=next_min,
            processed_total=base + delta))
        ctl["rounds"] += 1

    def stop():
        return (ctl["kill_at"] is not None
                and ctl["rounds"] >= ctl["kill_at"])

    kills_left = kills
    segments = 0
    escalation_restarts = 0
    retries_used = 0
    resume_from = None
    while True:
        segments += 1
        ctl["rounds"] = 0
        ctl["kill_at"] = (int(rng.integers(2, 12))
                          if kills_left > 0 else None)
        res = faults.run_supervised(
            make_bundle(), app_handlers=(phold.handler,),
            checkpoint_path=os.path.join(workdir, "ck"),
            checkpoint_every_windows=checkpoint_every,
            max_retries=2, sleep=lambda s: None,
            escalation=faults.EscalationPolicy(max_grow=max_grow),
            rebuild=rebuild, stop=stop, resume_from=resume_from,
            on_round=on_round, log=log,
            # deterministic run ids make the whole report reproducible
            # byte for byte (the fleet-vs-serial identity check)
            run_id=f"s{seed}.g{segments}", device=device)
        escalation_restarts += res.escalation_restarts
        retries_used += res.retries_used
        if res.preempted:
            kills_left -= 1
            resume_from = res.final_checkpoint
            continue
        result = res
        break

    errors = conserve.check(samples)
    if result.ok:
        final = conserve.sample(
            result.sim, wstart=0, wend=1, next_min=1,
            processed_total=0)
        if final.drops:
            errors.append(f"healed run ended with drops={final.drops} "
                          f"— overflow latch survived escalation")
    else:
        errors.append("chain did not finish ok: "
                      + json.dumps(result.failure_report()))

    verified = None
    if verify and result.ok:
        verified = _verify_final(result.sim, make_bundle, errors, device)

    report = {
        "seed": int(seed),
        "ok": bool(result.ok and not errors),
        "segments": segments,
        "kills": kills - kills_left,
        "escalations": [e.as_dict() for e in result.escalations],
        "escalation_restarts": escalation_restarts,
        "retries_used": retries_used,
        "final_capacities": dict(caps),
        "windows_sampled": len(samples),
        "events": (int(result.stats.events_processed)
                   if result.stats is not None else None),
        "conservation_errors": errors,
        "run_id": result.run_id,
        "resume_of": result.resume_of,
    }
    if verified is not None:
        report["verified_bit_identical"] = verified
    return report


def _diverged(a, b, skip=lambda key: False) -> list:
    """The leaf paths at which two states differ (flax field path
    order), the `skip` ones aside."""
    from shadow_tpu_torch import convert

    la, lb = convert.sim_to_numpy(a), convert.sim_to_numpy(b)
    return [k for k in la if not skip(k)
            and not np.array_equal(la[k], lb[k])]


def _verify_final(sim_healed, make_bundle, errors, device) -> bool:
    """Re-run uninterrupted at the final capacities; the healed
    chain's final state must match bit for bit (the escalation
    acceptance criterion). make_bundle() already builds at the grown
    caps — escalation mutated the shared dict."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.utils import checkpoint

    sim_ref, _, _ = checkpoint.run_windows(
        make_bundle(), app_handlers=(phold.handler,), device=device)
    bad = _diverged(sim_healed, sim_ref)
    for key in bad:
        errors.append("healed final state diverges from the "
                      "from-scratch run at grown capacity: leaf " + key)
    return not bad


def _device_loss_rank(rank, size, init, seed, hosts, load, sim_s,
                      checkpoint_every, workdir, device):
    """One rank of run_device_loss_trial: the control and the poisoned
    run on this rank's mesh. The rank that reports the healed run (rank
    0 of the shrunk mesh) returns the trial's report; the others
    return None."""
    from shadow_tpu_torch import faults
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.parallel import Mesh
    from shadow_tpu_torch.parallel import elastic as elastic_mod

    mesh = Mesh(size, rank, init_method=init, device=device)
    rng = np.random.default_rng(seed)
    caps = _roomy(load)

    def make_bundle():
        b = _build(hosts, load, sim_s, seed, caps, mesh.device)
        b.sim = elastic_mod.attach_sentinel(b.sim)
        return b

    common = dict(app_handlers=(phold.handler,), mesh=mesh,
                  max_retries=2, sleep=lambda s: None)
    errors: list = []
    ctrl = faults.run_supervised(
        make_bundle(), checkpoint_path=os.path.join(workdir, "ctrl.ck"),
        checkpoint_every_windows=checkpoint_every,
        run_id=f"dl{seed}.ctrl", **common)
    if not ctrl.ok:
        errors.append("control run failed: "
                      + json.dumps(ctrl.failure_report()))

    # two consecutive poisoned dispatches, mid-run by construction
    # (the counter is global across attempts: the retry's first
    # dispatch is the next index, so the pair walks retry -> shrink)
    victim = int(rng.integers(0, size))
    kill_at = int(rng.integers(1, max(2, ctrl.dispatches - 1)))
    poison = elastic_mod.make_poisoned_dispatch(
        {kill_at, kill_at + 1}, shard=victim)
    res = faults.run_supervised(
        make_bundle(), checkpoint_path=os.path.join(workdir, "ck"),
        checkpoint_every_windows=checkpoint_every,
        elastic=elastic_mod.ElasticPolicy(), dispatch_wrap=poison,
        run_id=f"dl{seed}.chaos", **common)
    if res.retired or not res.reports:
        return None
    el = res.elastic
    if not res.ok:
        errors.append("healed run failed: "
                      + json.dumps(res.failure_report()))
    if el is None:
        errors.append("healed run carries no elastic block")
    else:
        if len(el["losses"]) != 2:
            errors.append(f"expected 2 recorded device losses, got "
                          f"{len(el['losses'])}")
        acts = [s["action"] for s in el["ladder_steps"]]
        if acts != ["retry", "shrink"]:
            errors.append(f"ladder walked {acts}, expected "
                          f"['retry', 'shrink']")
        if el["final_shards"] != size // 2:
            errors.append(f"final mesh is {el['final_shards']} "
                          f"shard(s), expected {size // 2} "
                          f"(pow2-down survivors of {size})")
        lint = _load_lint()
        sent = elastic_mod.sentinel_report(res.sim)
        lerr, _ = lint._lint_elastic(el, {"sentinel": sent})
        if lerr:
            errors.append(f"elastic block not lint-clean: {lerr[:3]}")
        if sent and sent["trips"]:
            errors.append(f"sentinel tripped during a pure device-"
                          f"loss trial: {sent}")
        if res.checkpoints:
            cerr, _ = lint.lint_checkpoint_elastic(res.checkpoints[-1][0])
            if cerr:
                errors.append(f"final checkpoint stamp not "
                              f"lint-clean: {cerr[:3]}")
        else:
            errors.append("healed run saved no checkpoints — the "
                          "shrink resumed from nothing")

    # the digest oracle: healed final state == uninterrupted control
    # (the exchange-tier occupancy telemetry tracks the mesh width, the
    # sentinel's barrier counter counts the resume replay)
    if ctrl.ok and res.ok:
        skip = {".outbox.max_occupied", ".outbox.narrow_hit",
                ".outbox.narrow_miss"}
        diverged = _diverged(res.sim, ctrl.sim, lambda key: (
            key in skip or key.startswith(".sentinel")))
        if diverged:
            errors.append(f"healed state diverges from the "
                          f"uninterrupted control at {diverged[:5]} — "
                          f"shrink-resume is not bit-exact")
        sa = elastic_mod.sentinel_report(res.sim)
        sb = elastic_mod.sentinel_report(ctrl.sim)
        if sa and sb and sa["verified_through_ns"] \
                != sb["verified_through_ns"]:
            errors.append(
                f"verified frontier diverged: healed "
                f"{sa['verified_through_ns']} vs control "
                f"{sb['verified_through_ns']}")
    return {
        "seed": int(seed),
        "ok": not errors,
        "shards": int(size),
        "victim": victim,
        "kill_at_dispatch": kill_at,
        "control_dispatches": ctrl.dispatches,
        "final_shards": (el or {}).get("final_shards"),
        "ladder": [s["action"] for s in (el or {}).get(
            "ladder_steps", [])],
        "losses": len((el or {}).get("losses", [])),
        "verified_through_ns": (elastic_mod.sentinel_report(res.sim)
                                or {}).get("verified_through_ns")
        if res.sim is not None else None,
        "device_loss_errors": errors,
    }


def run_device_loss_trial(seed: int, *, shards: int = 8,
                          hosts: int = 8, load: int = 2,
                          sim_s: int = 1, checkpoint_every: int = 2,
                          workdir: str | None = None,
                          log=None, device=None) -> dict:
    """Shrink-to-survivors oracle (parallel/elastic.py), on `shards`
    rank processes (parallel.spawn) of `device` (None -> "cuda"). One
    trial:

    1. run the sharded scenario uninterrupted at the full mesh width
       (the control), sentinel attached so every checkpoint carries
       the verified-state ledger stamp;
    2. run it again with a poisoned dispatch killing a seeded victim
       shard on two consecutive dispatches — the first DEVICE_LOST
       steps the ladder's same-mesh retry, the second forces the
       shrink to the pow2-down survivor mesh, resuming from the last
       verified checkpoint via a digest-checked replan;
    3. assert the healed run finishes ok at the shrunk width, its
       elastic block and final checkpoint stamp are lint-clean
       (tools/telemetry_lint.py), the sentinel stayed untripped, and
       the final state is byte-identical to the control's (modulo the
       exchange-tier occupancy telemetry, which legitimately tracks
       mesh width, and the sentinel's barrier counter, which counts
       the resume replay)."""
    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.parallel import spawn

    dev = resolve_device(device)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="chaos_devloss.")
    got = spawn(_device_loss_rank, int(shards), int(seed), hosts, load,
                sim_s, checkpoint_every, workdir, dev.type,
                deadline_s=RANK_DEADLINE_S)
    reports = [r for r in got if r is not None]
    if len(reports) != 1:
        return {"seed": int(seed), "ok": False, "device_loss_errors": [
            f"{len(reports)} rank(s) reported the healed run, not one"]}
    if log:
        log(f"device-loss trial seed={seed}: ladder="
            f"{reports[0]['ladder']} errors="
            f"{len(reports[0]['device_loss_errors'])}")
    return reports[0]


def _lane_digests(sim, replicas: int) -> list:
    """sha256 per lane over every [H]-leading leaf's lane slice. The
    lane-latch planes, the lease planes, and the telemetry/flow rings
    are excluded (they are the containment mechanism under test, not
    lane state), as are global scalars (the run-total overflow latch
    legitimately differs once the victim lane trips)."""
    import hashlib

    from shadow_tpu_torch import convert

    H = sim.events.num_hosts
    rs = H // replicas
    hs = [hashlib.sha256() for _ in range(replicas)]
    for key, a in convert.sim_to_numpy(sim).items():
        if (".lanes" in key or ".telem" in key or ".admission" in key
                or ".flows" in key or ".inject" in key):
            continue
        if a.ndim == 0 or a.shape[0] != H:
            continue
        for r in range(replicas):
            hs[r].update(key.encode())
            hs[r].update(np.ascontiguousarray(
                a[r * rs:(r + 1) * rs]).tobytes())
    return [h.hexdigest() for h in hs]


def run_replica_trial(seed: int, *, replicas: int = 4, hosts: int = 4,
                      load: int = 2, sim_s: int = 1,
                      log=None, device=None) -> dict:
    """Blast-radius containment oracle for packed ensemble runs on
    `device` (None -> "cuda"): run the R-lane scenario clean, then
    again with a seeded flood fault overflowing exactly one victim
    lane's event rows mid-run. The victim must quarantine
    (events_overflow trip, flushed rows), and every OTHER lane's final
    per-host state must be byte-identical to the clean run's — a
    one-lane fault must never perturb a neighbor lane."""
    import torch

    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.core import lanes as lanes_mod
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.core.events import push_rows
    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.net.build import make_runner

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    victim = int(rng.integers(0, replicas))
    caps = _roomy(load)
    trig = sim_s * simtime.ONE_SECOND // 2

    b = _build(hosts, load, sim_s, seed, caps, device, replicas)
    fn = make_runner(b, app_handlers=(phold.handler,),
                     app_bulk=phold.BULK, device=device)
    sim_clean, _ = fn(b.sim)

    cap = int(b.sim.events.capacity)

    def flood_fn(sim, wend):
        q = sim.events
        Hn = q.num_hosts
        dev = q.time.device
        rows = torch.arange(Hn, device=dev)
        mask = ((rows >= victim * hosts) & (rows < (victim + 1) * hosts)
                & (torch.as_tensor(wend, dtype=simtime.DTYPE, device=dev)
                   > trig))
        t = torch.full((Hn,), simtime.INVALID - 1, dtype=simtime.DTYPE,
                       device=dev)
        z = torch.zeros((Hn,), dtype=torch.int32, device=dev)
        w = torch.zeros((Hn, q.words.shape[-1]), dtype=torch.int32,
                        device=dev)
        for _ in range(cap + 1):
            q = push_rows(q, mask, t, z, z, z, w)
        return sim.replace(events=q)

    b2 = _build(hosts, load, sim_s, seed, caps, device, replicas)
    fn2 = make_runner(b2, app_handlers=(phold.handler,),
                      app_bulk=phold.BULK, fault_fn=flood_fn, device=device)
    sim_fault, _ = fn2(b2.sim)

    errors = []
    rep = lanes_mod.lane_report(sim_fault)
    if not rep[victim]["quarantined"]:
        errors.append(f"victim lane {victim} did not quarantine: "
                      f"{rep[victim]}")
    elif "events_overflow" not in rep[victim].get("trip", []):
        errors.append(f"victim lane {victim} tripped on "
                      f"{rep[victim].get('trip')} instead of the "
                      f"flooded events_overflow latch")
    for r in range(replicas):
        if r != victim and rep[r]["quarantined"]:
            errors.append(f"healthy lane {r} quarantined — the "
                          f"victim's fault leaked: {rep[r]}")
    dig_clean = _lane_digests(sim_clean, replicas)
    dig_fault = _lane_digests(sim_fault, replicas)
    perturbed = [r for r in range(replicas)
                 if r != victim and dig_clean[r] != dig_fault[r]]
    if perturbed:
        errors.append(f"lane(s) {perturbed} diverged from the clean "
                      f"run — one-lane fault perturbed neighbor-lane "
                      f"state (blast radius NOT contained)")
    if log:
        log(f"replica trial seed={seed}: victim={victim} "
            f"trip={rep[victim].get('trip')} errors={len(errors)}")
    return {
        "seed": int(seed),
        "ok": not errors,
        "replicas": int(replicas),
        "victim": victim,
        "victim_trip": rep[victim].get("trip"),
        "victim_flushed": rep[victim].get("flushed"),
        "lane_events_exec": [d["events_exec"] for d in rep],
        "containment_errors": errors,
    }


def _load_lint():
    """Import tools/telemetry_lint.py by path (it imports neither
    package; the lint ships beside the reference's soak)."""
    import importlib.util
    import pathlib

    p = (pathlib.Path(__file__).resolve().parents[2] / "tools"
         / "telemetry_lint.py")
    spec = importlib.util.spec_from_file_location("telemetry_lint", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _churn_specs(seed: int):
    """>=4 heterogeneous tenants for one resident program: different
    host counts and loads (all pad to the shared pow2 lane bucket),
    mixed tenant classes. `t-slo` carries an impossible p99 objective
    so the admission gate MUST shed it; the two `t-und*` tenants are
    the undisturbed control group (admitted identically in the
    baseline and churn runs, byte-identity asserted on their terminal
    digests)."""
    from shadow_tpu_torch.fleet.spec import JobSpec

    return [
        JobSpec(id="t-und-prot", kind="scenario", seed=seed + 1,
                hosts=4, load=2, sim_s=1, tenant_class="protected",
                slo_p99_ms=1e9),
        JobSpec(id="t-und-be", kind="scenario", seed=seed + 2,
                hosts=3, load=2, sim_s=1),
        JobSpec(id="t-churn-a", kind="scenario", seed=seed + 3,
                hosts=2, load=1, sim_s=1),
        JobSpec(id="t-slo", kind="scenario", seed=seed + 4,
                hosts=4, load=3, sim_s=1,
                tenant_class="best_effort", slo_p99_ms=1e-6),
        JobSpec(id="t-churn-b", kind="scenario", seed=seed + 5,
                hosts=2, load=2, sim_s=1),
    ]


def run_churn_trial(seed: int, *, lanes: int = 6, horizon_s: int = 4,
                    workdir: str | None = None, log=None,
                    device=None) -> dict:
    """Continuous-admission churn oracle (fleet/admission.py) on
    `device` (None -> "cuda").

    One resident program, >=4 heterogeneous tenants, >=8 join/leave/
    evict events, one simulated SIGKILL. Asserts, in order:

    1. zero retraces: the program key is identical before and after
       every admission event and the live trace cache never grows;
    2. SLO shedding: the best-effort tenant breaching its own p99
       objective is evicted within one window barrier of the
       sustained breach, with a lint-clean salvage artifact;
    3. kill/resume: after a SIGKILL (journal abandoned mid-stream
       with a torn tail frame), ResidentProgram.resume reconstructs
       the EXACT resident lease population from replay;
    4. byte-identity: the undisturbed tenants' terminal lane digests
       are identical to a no-churn baseline run's, despite joins,
       leaves, evictions, and the kill in other lanes."""
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.fleet import admission as adm_mod
    from shadow_tpu_torch.fleet import journal as journal_mod

    device = resolve_device(device)
    SEC = simtime.ONE_SECOND
    say = log or (lambda m: None)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="chaos_churn.")
    specs = _churn_specs(seed)
    errors: list = []

    def resident(path, resume=False):
        make = (adm_mod.ResidentProgram.resume if resume
                else adm_mod.ResidentProgram)
        return make(specs, workdir=path, lanes=lanes, horizon_s=horizon_s,
                    gate=adm_mod.AdmissionGate(sustained=1), flow_sample=1,
                    seed=seed, fsync=False, log=say, device=device)

    # --- baseline: the two undisturbed tenants alone, no churn ------
    base = resident(os.path.join(workdir, "base"))
    for jid in ("t-und-prot", "t-und-be"):
        if base.admit(jid) is None:
            errors.append(f"baseline: {jid} was not admitted")
    base.drain()
    base_digest = {h["job"]: h["digest"] for h in base.table.history
                   if h["state"] == adm_mod.COMPLETED}
    base_key = base.program_key
    base.close()
    for jid in ("t-und-prot", "t-und-be"):
        if jid not in base_digest:
            errors.append(f"baseline: {jid} did not complete: "
                          f"{[h['state'] for h in base.table.history]}")
    if base_key is None:
        errors.append("baseline: program key unavailable (opaque "
                      "loop?) — zero-retrace proof impossible")
    if not base.program_key_stable:
        errors.append("baseline: program key moved without churn")

    # --- churn run: same undisturbed admissions + lane churn --------
    churn_dir = os.path.join(workdir, "churn")
    rp = resident(churn_dir)
    for jid in ("t-und-prot", "t-und-be", "t-churn-a", "t-slo"):
        if rp.admit(jid) is None:
            errors.append(f"churn: {jid} was not admitted at t=0")
    rp.advance(until_ns=SEC // 4)
    # the gate must have shed t-slo by now (sustained=1, folds every
    # barrier — "within one window barrier" by construction)
    slo_lease = next((h for h in rp.table.history
                      if h["job"] == "t-slo"), None)
    if slo_lease is None:
        errors.append("churn: t-slo still resident after "
                      f"{rp.dispatches} barriers — the gate never "
                      "shed the SLO-breaching best-effort lane")
    elif slo_lease["state"] != adm_mod.EVICTED:
        errors.append(f"churn: t-slo ended {slo_lease['state']}, "
                      f"expected evicted (reason: "
                      f"{slo_lease.get('reason')})")
    elif "slo breach" not in (slo_lease.get("reason") or ""):
        errors.append(f"churn: t-slo evicted for "
                      f"{slo_lease.get('reason')!r}, not an SLO "
                      f"breach")
    salvage_path = (slo_lease or {}).get("salvage")
    if not salvage_path or not os.path.isfile(salvage_path):
        errors.append(f"churn: t-slo eviction left no salvage "
                      f"artifact ({salvage_path})")
    else:
        lint = _load_lint().lint_salvage(salvage_path)
        if lint:
            errors.append(f"churn: t-slo salvage artifact is not "
                          f"lint-clean: {lint}")
    # operator churn: evict one tenant, admit the other mid-run, then
    # re-admit the evicted one into the shed lane
    if not rp.evict("t-churn-a", reason="operator churn"):
        errors.append("churn: operator evict of t-churn-a failed")
    rp.advance(until_ns=SEC // 2)
    for jid in ("t-churn-b", "t-churn-a"):
        if rp.admit(jid) is None:
            errors.append(f"churn: mid-run admission of {jid} failed")
    if not rp.program_key_stable:
        errors.append(
            f"churn: program retraced before the kill — keys "
            f"{sorted(map(str, rp.program_keys))}, retraces "
            f"{rp.retraces_seen}")

    # --- SIGKILL: abandon the journal mid-stream, torn tail and all -
    expected_pop = {int(k): tuple(v)
                    for k, v in rp.table.population().items()}
    rp.table.journal.close()       # fd gone, no terminal frames: the
    # on-disk journal is exactly what a SIGKILL leaves behind
    lease_log = os.path.join(churn_dir, "leases.log")
    with open(lease_log, "ab") as f:
        # half a frame header: the torn tail a dying writer leaves
        f.write(journal_mod.encode_frame(
            {"ev": "lease", "lane": 0, "state": "free"})[:7])
    del rp

    rp2 = resident(churn_dir, resume=True)
    got_pop = {int(k): tuple(v)
               for k, v in rp2.table.population().items()}
    if got_pop != expected_pop:
        errors.append(f"resume: lease population diverged — expected "
                      f"{expected_pop}, replay gave {got_pop}")
    rp2.drain()
    rp2.close()
    if not rp2.program_key_stable:
        errors.append(
            f"resume: program retraced after the kill — keys "
            f"{sorted(map(str, rp2.program_keys))}, retraces "
            f"{rp2.retraces_seen}")
    keys = {base_key, rp2.program_key}
    if len(keys) != 1:
        errors.append(f"program key differs across runs: {keys}")

    # --- byte-identity of the undisturbed lanes ---------------------
    churn_digest = {h["job"]: h["digest"] for h in rp2.table.history
                    if h["state"] == adm_mod.COMPLETED}
    for jid in ("t-und-prot", "t-und-be"):
        if jid not in churn_digest:
            errors.append(f"churn: undisturbed tenant {jid} did not "
                          f"complete")
        elif churn_digest[jid] != base_digest.get(jid):
            errors.append(
                f"undisturbed tenant {jid} diverged from the "
                f"no-churn baseline ({churn_digest[jid][:12]} != "
                f"{(base_digest.get(jid) or '?')[:12]}) — churn in "
                f"other lanes perturbed a healthy lane")

    # --- event census over the journal ------------------------------
    frames = [r for r in journal_mod.replay(lease_log)[0]
              if r.get("ev") == "lease"]
    joins = sum(1 for r in frames if r["state"] == adm_mod.ADMITTED)
    leaves = sum(1 for r in frames
                 if r["state"] in (adm_mod.COMPLETED,
                                   adm_mod.QUARANTINED))
    evictions = sum(1 for r in frames
                    if r["state"] == adm_mod.EVICTED)
    tenants = {r.get("job") for r in frames if r.get("job")}
    if joins + leaves + evictions < 8:
        errors.append(f"churn schedule too thin: {joins} joins + "
                      f"{leaves} leaves + {evictions} evictions < 8")
    if len(tenants) < 4:
        errors.append(f"churn covered only {len(tenants)} tenants "
                      f"(need >= 4): {sorted(tenants)}")
    return {
        "seed": int(seed),
        "ok": not errors,
        "tenants": len(tenants),
        "joins": joins,
        "leaves": leaves,
        "evictions": evictions,
        "program_key": base_key,
        "program_key_stable": bool(rp2.program_key_stable),
        "population_resumed": {str(k): list(v)
                               for k, v in sorted(got_pop.items())},
        "slo_evicted": (slo_lease or {}).get("job"),
        "salvage": salvage_path,
        "lease_warnings": list(rp2.table.fold_warnings),
        "churn_errors": errors,
    }


def _sweep_spec(seed: int):
    """A small deterministic halving sweep (2x2 lattice, >= 2 rounds)
    over a simulation-deterministic objective — kills must not be able
    to move the ranking, so the metric must carry no wallclock."""
    from shadow_tpu_torch.sweep import plan as plan_mod

    return plan_mod.SweepSpec.from_obj({
        "sweep": {"id": f"chaos-{seed}",
                  "objective": {"metric": "events", "goal": "max"},
                  "search": {"strategy": "halving", "eta": 2,
                             "budget_field": "sim_s",
                             "budget_scale": 2},
                  "prewarm": False},
        "fleet": {"max_attempts": 3},
        "template": {"kind": "scenario", "hosts": 4, "sim_s": 1,
                     "event_capacity": 24},
        "axes": [{"field": "seed", "values": [seed, seed + 1]},
                 {"field": "load", "values": [1, 2]}],
    })


def run_sweep_trial(seed: int, *, workers: int = 2,
                    workdir: str | None = None, log=None,
                    device=None) -> dict:
    """Sweep-under-fire oracle (sweep/driver.py), the fleet's workers
    on `device` (None -> "cuda"): run one small halving sweep clean,
    then again while SIGKILLing one worker per fleet round, and assert

    1. lattice conservation — every expanded point still ends in
       exactly one category, none pending, and the chaos manifest
       (sweep block included) is lint-clean;
    2. quarantine accounting — the sweep block's quarantined count
       equals the manifest's quarantined jobs (divergent points park,
       they never sink the sweep);
    3. ranking identity — every round's ranking, the final table, and
       "best" are byte-identical to the clean run's (deterministic
       objective + the fleet's kill/resume bit-identity contract)."""
    import signal as signal_mod

    from shadow_tpu_torch.device import resolve_device
    from shadow_tpu_torch.fleet import journal as journal_mod
    from shadow_tpu_torch.sweep import driver as sweep_driver

    device = resolve_device(device).type
    say = log or (lambda m: None)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="chaos_sweep.")
    errors: list = []
    spec = _sweep_spec(seed)

    clean = sweep_driver.SweepDriver(
        os.path.join(workdir, "clean"), spec, workers=workers,
        fsync=False, log=say, device=device)
    rc_clean = clean.run()
    clean_block = clean.report()

    killed: list = []

    def on_ev(runner, ev):
        # one SIGKILL per fleet round: the driver builds a fresh
        # runner per round, so a once-per-runner latch is exactly
        # once-per-round; the first job to reach "running" loses its
        # worker mid-execution
        if ev.get("ev") != "running" \
                or getattr(runner, "_chaos_killed", False):
            return
        runner._chaos_killed = True
        pid = runner.worker_pid(ev.get("worker"))
        if pid:
            os.kill(pid, signal_mod.SIGKILL)
            killed.append({"worker": ev.get("worker"),
                           "job": ev.get("job")})
            say(f"sweep chaos: killed {ev.get('worker')} running "
                f"{ev.get('job')}")

    chaos = sweep_driver.SweepDriver(
        os.path.join(workdir, "chaos"), spec, workers=workers,
        fsync=False, on_fleet_event=on_ev, log=say, device=device)
    rc_chaos = chaos.run()
    chaos_block = chaos.report()

    if rc_clean != 0:
        errors.append(f"clean sweep exited {rc_clean}")
    if rc_chaos != 0:
        errors.append(f"chaos sweep exited {rc_chaos}")
    if not killed:
        errors.append("no worker was ever killed — the soak soaked "
                      "nothing")
    losses = sum(1 for r in journal_mod.replay(
        os.path.join(workdir, "chaos", "journal.log"))[0]
        if r.get("ev") == "worker_lost")
    if losses < len(killed):
        errors.append(f"{len(killed)} kill(s) but only {losses} "
                      f"worker_lost frame(s) in the fleet journal")

    lint = _load_lint()
    with open(os.path.join(workdir, "chaos",
                           "fleet_manifest.json")) as f:
        man = json.load(f)
    lerr, _ = lint.lint_fleet_manifest_obj(man)
    if lerr:
        errors.append(f"chaos manifest not lint-clean: {lerr[:3]}")
    pts = chaos_block["points"]
    if pts["expanded"] != sum(pts[c] for c in
                              ("completed", "failed", "quarantined",
                               "pruned", "pending")):
        errors.append(f"lattice not conserved under kills: {pts}")
    if pts["pending"]:
        errors.append(f"{pts['pending']} point(s) pending after a "
                      f"complete chaos sweep")
    man_q = sum(1 for j in man["jobs"].values()
                if j.get("status") == "quarantined")
    if pts["quarantined"] > man_q:
        errors.append(f"sweep block claims {pts['quarantined']} "
                      f"quarantined point(s) but the manifest holds "
                      f"{man_q} quarantined job(s)")

    if len(clean_block["rounds"]) != len(chaos_block["rounds"]):
        errors.append(f"round count diverged under kills: "
                      f"{len(clean_block['rounds'])} clean vs "
                      f"{len(chaos_block['rounds'])} chaos")
    for k, (rdc, rdk) in enumerate(zip(clean_block["rounds"],
                                       chaos_block["rounds"])):
        if rdc["ranking"] != rdk["ranking"]:
            errors.append(f"round {k} ranking diverged under kills: "
                          f"{rdc['ranking']} vs {rdk['ranking']}")
    if clean_block["best"] != chaos_block["best"]:
        errors.append(f"best point diverged under kills: "
                      f"{clean_block['best']!r} vs "
                      f"{chaos_block['best']!r}")

    if len(clean_block["rounds"]) < 2:
        errors.append(f"halving produced only "
                      f"{len(clean_block['rounds'])} round(s) — the "
                      f"soak must cross at least one prune")
    return {
        "seed": int(seed),
        "ok": not errors,
        "rounds": len(chaos_block["rounds"]),
        "kills": len(killed),
        "worker_losses": losses,
        "points": pts,
        "best": chaos_block["best"],
        "ranking_identical": (clean_block["ranking"]
                              == chaos_block["ranking"]),
        "sweep_errors": errors,
    }


def _main_fleet(args, device) -> int:
    """--jobs K: dogfood the fleet runner. Each trial becomes a
    `chaos_trial` job; K worker processes execute them on `device` with
    the full durable-queue / lease / requeue machinery, and the reports
    come back through the journal. Output order is seed order (not
    completion order), so the stdout stream is byte-identical to the
    serial path's for the same flags."""
    from shadow_tpu_torch.fleet import FleetPolicy, FleetRunner, JobSpec

    fleet_dir = args.fleet_dir or tempfile.mkdtemp(prefix="chaos_fleet.")
    specs = [JobSpec(id=f"trial-{k:03d}", kind="chaos_trial",
                     seed=args.seed + k, hosts=args.hosts,
                     load=args.load, sim_s=args.sim_s,
                     kills=args.kills, max_grow=args.max_grow,
                     verify=args.verify)
             for k in range(args.trials)]
    runner = FleetRunner(fleet_dir, FleetPolicy(), specs,
                         workers=args.jobs,
                         log=lambda m: print(m, file=sys.stderr),
                         device=device)
    rc = runner.run(install_signals=True)
    failed = 0
    for k in range(args.trials):
        j = runner.queue.jobs[f"trial-{k:03d}"]
        rep = (j.result or {}).get("report")
        if rep is None:
            print(json.dumps({"seed": args.seed + k, "ok": False,
                              "fleet_status": j.status,
                              "failure": j.failure}), flush=True)
            failed += 1
        else:
            print(json.dumps(rep), flush=True)
            failed += 0 if rep["ok"] else 1
    print(f"chaos soak: {args.trials - failed}/{args.trials} trials ok "
          f"(fleet: {len(specs)} jobs, exit {rc})", file=sys.stderr)
    return 1 if failed or rc != 0 else 0


def _serial(label, trials, seed, run) -> int:
    """Run `trials` trials at seeds seed, seed+1, ... through `run`,
    one JSON line each; 1 when any failed."""
    failed = 0
    for k in range(trials):
        rep = run(seed + k)
        print(json.dumps(rep), flush=True)
        if not rep["ok"]:
            failed += 1
    print(f"{label}: {trials - failed}/{trials} trials ok",
          file=sys.stderr)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="randomized kill/heal soak over the supervised "
                    "runner (seeded, reproducible)")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1,
                    help="base seed; trial k runs at seed+k")
    ap.add_argument("--kills", type=int, default=2,
                    help="preemption kills per trial")
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--load", type=int, default=2)
    ap.add_argument("--sim-s", type=int, default=1)
    ap.add_argument("--max-grow", type=int, default=8)
    ap.add_argument("--verify", action="store_true",
                    help="also diff each healed run against an "
                         "uninterrupted run at the final capacities")
    ap.add_argument("--jobs", type=int, default=0,
                    help="run the trials through the fleet runner "
                         "(shadow_tpu_torch.fleet) with this many worker "
                         "processes; 0 = serial in-process. Reports "
                         "are byte-identical either way (seeded "
                         "trials, deterministic run ids)")
    ap.add_argument("--fleet-dir", default=None,
                    help="fleet state dir for --jobs (default: a "
                         "fresh temp dir)")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="'cpu' runs on the CPU; unset or 'gpu' is the "
                         "card")
    ap.add_argument("--replicas", type=int, default=0,
                    help="blast-radius mode: pack this many PHOLD "
                         "lanes per trial, flood one victim lane's "
                         "event rows mid-run, and assert neighbor "
                         "lanes' final state is byte-identical to a "
                         "clean packed run (core/lanes.py "
                         "containment)")
    ap.add_argument("--churn", action="store_true",
                    help="continuous-admission mode: random-free "
                         "join/leave/evict schedule over one resident "
                         "program (fleet/admission.py) with a "
                         "simulated SIGKILL")
    ap.add_argument("--lanes", type=int, default=6,
                    help="resident lane count for --churn")
    ap.add_argument("--device-loss", action="store_true",
                    help="elastic-recovery mode: sharded trials with "
                         "a poisoned dispatch killing one shard twice "
                         "(retry, then shrink to survivors)")
    ap.add_argument("--shards", type=int, default=8,
                    help="mesh width for --device-loss (that many rank "
                         "processes)")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep-under-fire mode: run one small "
                         "halving sweep (sweep/driver.py) clean, then "
                         "again killing one worker per round")
    ap.add_argument("--workers", type=int, default=2,
                    help="fleet workers per sweep for --sweep")
    args = ap.parse_args(argv)

    from shadow_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.platform == "cpu" else None).type
    if args.device_loss:
        if args.jobs > 0 or args.replicas > 1 or args.churn \
                or args.sweep:
            ap.error("--device-loss is a standalone elastic soak; it "
                     "does not combine with --jobs/--replicas/--churn/"
                     "--sweep")
        return _serial("device-loss soak", args.trials, args.seed,
                       lambda s: run_device_loss_trial(
                           s, shards=args.shards, hosts=args.hosts,
                           load=args.load, sim_s=args.sim_s,
                           device=device))
    if args.sweep:
        if args.jobs > 0 or args.replicas > 1 or args.churn:
            ap.error("--sweep is a standalone sweep-driver soak; it "
                     "does not combine with --jobs/--replicas/--churn")
        return _serial("sweep soak", args.trials, args.seed,
                       lambda s: run_sweep_trial(
                           s, workers=args.workers, device=device))
    if args.churn:
        if args.jobs > 0 or args.replicas > 1:
            ap.error("--churn is a standalone resident-program soak; "
                     "it does not combine with --jobs or --replicas")
        return _serial("churn soak", args.trials, args.seed,
                       lambda s: run_churn_trial(
                           s, lanes=args.lanes, device=device))
    if args.replicas > 1:
        if args.jobs > 0:
            ap.error("--replicas is a standalone containment soak; "
                     "it does not combine with --jobs")
        return _serial("containment soak", args.trials, args.seed,
                       lambda s: run_replica_trial(
                           s, replicas=args.replicas, hosts=args.hosts,
                           load=args.load, sim_s=args.sim_s,
                           device=device))
    if args.jobs > 0:
        return _main_fleet(args, device)
    return _serial("chaos soak", args.trials, args.seed,
                   lambda s: run_trial(
                       s, hosts=args.hosts, load=args.load,
                       sim_s=args.sim_s, kills=args.kills,
                       max_grow=args.max_grow, verify=args.verify,
                       device=device))


if __name__ == "__main__":
    sys.exit(main())
