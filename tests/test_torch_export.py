"""The run manifest and the telemetry exports of the port
(shadow_tpu_torch.telemetry.export) against the reference's
(shadow_tpu.telemetry.export), on the CPU.

One run in each package: the tgen app at 8 hosts streaming a 40-event
trace through 16 lanes, with the window ring and a latency fault plan
installed (one reference program). From each run's harvested ring,
health and injection block: run_manifest, metrics_from_manifest,
prometheus_text and chrome_trace are equal, except the wall-clock
fields, which are named here (WALL_*): the phase timers' durations and
start offsets. config_hash and fault_plan_digest are equal. The lanes,
admission, flows and causality blocks, their trace groups and the lane
metric families are equal on hand-made inputs (a real run's in
tests/test_torch_lanes_cli.py), and so are the elastic mesh-transition
markers, the manifest's elastic block and its counters, on a
supervisor's block (tools/telemetry_lint.py accepts both). Tolerance
zero.
"""

import json

import pytest
import torch

from shadow_tpu import faults as jfaults
from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import tgen as jtgen
from shadow_tpu.inject import Feeder as JFeeder
from shadow_tpu.inject import manifest_block as jmanifest_block
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import tgen
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.inject import Feeder, manifest_block
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.telemetry import export
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SEC = 1_000_000_000
# the wall-clock fields: phase-timer totals in the manifest and the
# metrics, their gauge lines in the Prometheus text, and the wall-time
# spans (pid 1) of the Chrome trace
WALL_MANIFEST = ("wall_phases_s",)
WALL_METRICS = ("wall_phase_seconds",)
WALL_PROM = "shadow_tpu_wall_phase_seconds"
WALL_TRACE = ("ts", "dur")

PLAN = json.dumps({"faults": [
    {"time_s": 0.3, "kind": "latency", "a": 0, "b": 0, "value": 0.01},
    {"time_s": 0.5, "kind": "latency", "a": 0, "b": 0, "value": 0.0}]})


def _trace():
    return [{"t_ns": SEC // 10 + i * (SEC // 50), "host": i % 8,
             "kind": tgen.KIND_TGEN, "payload": [(i + 3) % 8, 9100, 64]}
            for i in range(40)]


def _cfg():
    return dict(num_hosts=8, tcp=False, end_time=SEC, seed=7,
                event_capacity=64, outbox_capacity=64, router_ring=64,
                in_ring=16, inject_lanes=16)


def _run(pkg):
    """(bundle, sim, stats, harvester, timers, health, injection block)."""
    if pkg == "jax":
        build, cfgc, app, faults, tel, ckpt, feeder, block = (
            jbuild, JConfig, jtgen, jfaults, jtel, jckpt, JFeeder,
            jmanifest_block)
        kw = {}
    else:
        build, cfgc, app, faults, tel, ckpt, feeder, block = (
            tbuild, TConfig, tgen, tfaults, ttel, tckpt, Feeder,
            manifest_block)
        kw = {"device": "cpu"}
    hosts = [build.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(8)]
    b = build.build(cfgc(**_cfg()), ONE_VERTEX, hosts, **kw)
    b.sim = tel.attach(app.setup(b.sim), capacity=64)
    faults.install(b, faults.records_from_json(PLAN))
    f = feeder(_trace())
    h, timers = tel.Harvester(), tel.PhaseTimers()
    with timers.phase("device-execute"):
        sim, stats, _ = ckpt.run_windows(b, (app.handler,), feeder=f,
                                         **kw)
    with timers.phase("harvest"):
        h.drain(sim)
    health = faults.gather(sim, telemetry_lost=h.records_lost)
    return b, sim, stats, h, timers, health, block(sim, f)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for pkg, tmod in (("jax", jtel), ("port", ttel)):
        b, sim, stats, h, timers, health, inj = _run(pkg)
        man = tmod.run_manifest(
            cfg=b.cfg, seed=7, shards=1, sim=sim, stats=stats,
            health=health, fault_plan=b.fault_plan, harvester=h,
            timers=timers, wall_seconds=1.25, run_id="r1", resume_of="r0",
            escalations=[{"knob": "event_capacity", "from": 32, "to": 64}],
            preempted=False,
            dispatch={"windows_per_dispatch": 1, "dispatches": 3},
            injection=inj)
        out[pkg] = {"bundle": b, "harvester": h, "timers": timers,
                    "man": json.loads(json.dumps(man)), "mod": tmod}
    return out


def _drop(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


def test_run_manifest_matches_reference(runs):
    want, got = runs["jax"]["man"], runs["port"]["man"]
    assert _drop(got, WALL_MANIFEST) == _drop(want, WALL_MANIFEST)
    assert sorted(got["wall_phases_s"]) == sorted(want["wall_phases_s"])
    assert got["injection"]["injected"] == 40
    assert got["counters"]["events_processed"] > 0
    assert got["telemetry"]["injected_sum"] == 40
    assert got["fault_plan_digest"] is not None


def test_metrics_and_prometheus_text_match_reference(runs):
    want = jtel.metrics_from_manifest(runs["jax"]["man"])
    got = ttel.metrics_from_manifest(runs["port"]["man"])
    assert _drop(got, WALL_METRICS) == _drop(want, WALL_METRICS)
    assert got["inject_injected"] == 40

    def lines(text):
        return [ln for ln in text.splitlines() if WALL_PROM not in ln]
    want_t = jtel.prometheus_text(want)
    got_t = ttel.prometheus_text(got)
    assert lines(got_t) == lines(want_t)
    # every line parses: a TYPE comment or "name[{labels}] number"
    for ln in got_t.splitlines():
        if ln.startswith("# TYPE "):
            continue
        name, val = ln.rsplit(" ", 1)
        float(val)
        assert name.startswith("shadow_tpu_")


def test_chrome_trace_matches_reference(runs):
    def trace(pkg):
        r = runs[pkg]
        t = json.loads(json.dumps(r["mod"].chrome_trace(
            r["harvester"].records, r["timers"], 1)))
        for ev in t["traceEvents"]:
            if ev["pid"] == 1 and ev["ph"] == "X":
                for k in WALL_TRACE:
                    ev.pop(k)
        return t
    want, got = trace("jax"), trace("port")
    assert got == want
    windows = [e for e in got["traceEvents"]
               if e["pid"] == 0 and e["ph"] == "X"]
    assert len(windows) == runs["port"]["man"]["counters"]["windows"]
    assert sum(e["args"]["injected"] for e in windows) == 40


def test_write_files_load(runs, tmp_path):
    r = runs["port"]
    p = export.write_trace(str(tmp_path / "t.json"), r["harvester"].records,
                           r["timers"], 1)
    assert json.load(open(p))["traceEvents"]
    p = export.write_metrics(str(tmp_path / "m.prom"), r["man"])
    assert "shadow_tpu_inject_injected 40" in open(p).read()
    p = export.write_manifest(str(tmp_path / "run_manifest.json"), r["man"])
    assert json.load(open(p)) == r["man"]


def test_config_hash_and_plan_digest_match_reference(runs):
    from shadow_tpu.telemetry import export as jexport

    jb, tb = runs["jax"]["bundle"], runs["port"]["bundle"]
    assert export.config_hash(tb.cfg) == jexport.config_hash(jb.cfg)
    assert export.fault_plan_digest(tb.fault_plan) \
        == jexport.fault_plan_digest(jb.fault_plan)
    assert export.fault_plan_digest(None) is None


def _elastic_block():
    """A retry then a shrink 4 -> 2 of a lost shard 2 (the shape of
    faults/supervisor.py's block)."""
    shrink = {"action": "shrink", "cause": "device_lost", "shard": 2,
              "from": 4, "to": 2, "resume_time_ns": 400_000_000,
              "attempt": 2}
    loss = {"fault": "DEVICE_LOST", "shard": 2, "device": None,
            "cause": "xla_error", "message": "injected", "mesh": 4}
    return {"policy": {"same_mesh_retries": 1, "allow_shrink": True,
                       "allow_serial": True, "min_shards": 1,
                       "max_losses": 8, "dispatch_deadline_s": None},
            "initial_shards": 4, "final_shards": 2,
            "losses": [dict(loss, attempt=1), dict(loss, attempt=2)],
            "divergences": [],
            "ladder_steps": [
                {"action": "retry", "cause": "device_lost", "shard": 2,
                 "from": 4, "to": 4, "resume_time_ns": 200_000_000,
                 "attempt": 1}, shrink],
            "mesh_transitions": [dict(shrink)]}


@pytest.mark.parametrize("arg", ["elastic"])
def test_unported_trace_groups_are_refused(arg, runs):
    """The elastic group, once refused: the mesh-transition markers of
    the trace, and the manifest's block with its counters, equal the
    reference's export of the same block; both lint clean."""
    from conftest import load_tool

    tl = load_tool("telemetry_lint")
    block = _elastic_block()
    want = jtel.chrome_trace([], **{arg: block})
    got = export.chrome_trace([], **{arg: block})
    assert got == want
    assert [e["name"] for e in got["traceEvents"] if e["ph"] == "i"] \
        == ["mesh 4->2 (device_lost)"]
    assert tl.lint_trace_obj(got)[0] == []
    man = dict(runs["port"]["man"], **{arg: block})
    jman = dict(runs["jax"]["man"], **{arg: block})
    counters = export.metrics_from_manifest(man)
    assert _drop(counters, WALL_METRICS) \
        == _drop(jtel.metrics_from_manifest(jman), WALL_METRICS)
    assert (counters["device_lost_total"], counters["mesh_shrink_total"],
            counters["elastic_final_shards"]) == (2, 1, 2)
    # the fixture's hand-made escalation record is not a real one; the
    # elastic block is linted as the manifest lint lints it
    assert tl._lint_elastic(json.loads(json.dumps(block)),
                            man.get("health")) == ([], [])


# ------------------------------------- the lane and recorder blocks
#
# Hand-made inputs, the same in both packages (each built from its own
# record classes): two lanes, lane 1 quarantined with its incident, the
# admission planes, flow records, lineage records joined into a chain
# and advance records of every cause. The blocks of real runs are held
# to the reference in tests/test_torch_lanes_cli.py.


def _recorder_inputs(tel, incident_cls):
    import types

    flows = [tel.FlowRecord(i, i % 4, (i + 1) % 4, i // 2, 24, 0,
                            100 * i, 100 * i + 50, 100 * i + 70 + 13 * i)
             for i in range(4)]
    lineage = [tel.CausalityRecord(h, 0, 10 + h, 9 + h, (h + 1) % 4, 24, h,
                                   1000 * h, 1000 * (h + 1))
               for h in range(4)]
    adv = [tel.AdvanceRecord(i, 50 * i, 50 * i + jump, raw, cause, a, b,
                             act)
           for i, (jump, raw, cause, a, b, act) in enumerate([
               (50, 50, 0, -1, -1, 4), (30, 60, 1, 0, 1, 2),
               (20, 50, 2, -1, -1, 3), (10, 50, 3, -1, -1, -1),
               (1, 50, 4, -1, -1, 1)])]
    harvester = types.SimpleNamespace(
        flow_enabled=True, flow_records=flows, flow_sampled=6, flow_seen=5,
        flow_lost=1, flow_lost_clamp=1, caus_enabled=True,
        caus_records=lineage, adv_records=adv, caus_sampled=4,
        caus_emitted=9, caus_lost=0, adv_lost=0)
    per_lane = [{"lane": r, "events_overflow": r, "outbox_overflow": 0,
                 "rq_overflow": 0, "inj_dropped": 0, "stall_streak": 0,
                 "time_regression": 0, "events_exec": 40 + r,
                 "quarantined": bool(r), "flushed": 7 * r}
                for r in range(2)]
    health = types.SimpleNamespace(
        lanes_total=2, lanes=per_lane, lanes_quarantined=[1],
        lane_contained=True, resident=True,
        admission=[{"lane": r, "admitted": True, "completed": not r}
                   for r in range(2)])
    incident = incident_cls(lane=1, time_ns=300, detected_ns=350,
                            trip_bits=1, trip=("events_overflow",),
                            flushed=7, salvage="s.npz",
                            salvaged_from="c.npz",
                            regrow={"event_capacity": 128})
    return harvester, health, incident


@pytest.fixture(scope="module")
def recorder_blocks(runs):
    from shadow_tpu.faults.supervisor import LaneIncident as JIncident
    from shadow_tpu_torch.faults.supervisor import LaneIncident

    out = {}
    for pkg, tel, inc_cls in (("jax", jtel, JIncident),
                              ("port", ttel, LaneIncident)):
        h, health, inc = _recorder_inputs(tel, inc_cls)
        mod = runs[pkg]["mod"]
        exp = mod.export if pkg == "jax" else export
        blocks = {
            "lanes": exp.lanes_manifest_block(health, [inc]),
            "admission": exp.admission_manifest_block(health),
            "flows": tel.flows_manifest_block(h, num_hosts=4, shards=2,
                                              sample_period=8),
            "causality": tel.causality_manifest_block(
                h, num_hosts=4, sample_period=8, path_shards=2)}
        b = runs[pkg]["bundle"]
        man = mod.run_manifest(cfg=b.cfg, seed=7, shards=1, sim=b.sim,
                               wall_seconds=1.0, **blocks)
        out[pkg] = {"h": h, "blocks": blocks,
                    "man": json.loads(json.dumps(man))}
    return out


@pytest.mark.parametrize("block", ["lanes", "admission", "flows",
                                   "causality"])
def test_recorder_manifest_blocks_match_reference(recorder_blocks, block):
    want, got = recorder_blocks["jax"], recorder_blocks["port"]
    assert got["blocks"][block] is not None
    assert got["blocks"][block] == want["blocks"][block]
    assert got["man"][block] == want["man"][block]
    assert _drop(got["man"], WALL_MANIFEST) \
        == _drop(want["man"], WALL_MANIFEST)


@pytest.mark.parametrize("arg", ["flow_records", "adv_records", "chains"])
def test_recorder_trace_groups_match_reference(recorder_blocks, arg):
    from shadow_tpu.telemetry import export as jexport

    def group(exp, pkg):
        h = recorder_blocks[pkg]["h"]
        src = {"flow_records": h.flow_records, "adv_records": h.adv_records,
               "chains": recorder_blocks[pkg]["blocks"]["causality"][
                   "chains"]}[arg]
        return exp.chrome_trace([], **{arg: src})

    got, want = group(export, "port"), group(jexport, "jax")
    assert got == want
    assert any(e["pid"] in (2, 3) for e in got["traceEvents"])


def test_lane_metric_families_match_reference(recorder_blocks):
    from shadow_tpu.telemetry import export as jexport

    want = jexport.metrics_from_manifest(recorder_blocks["jax"]["man"])
    got = export.metrics_from_manifest(recorder_blocks["port"]["man"])
    assert got == want
    assert any(k.startswith("lane_") for k in got)
    assert export.prometheus_text(got) == jexport.prometheus_text(want)
