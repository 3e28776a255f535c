"""The run manifest and the telemetry exports of the port
(shadow_tpu_torch.telemetry.export) against the reference's
(shadow_tpu.telemetry.export), on the CPU.

One run in each package: the tgen app at 8 hosts streaming a 40-event
trace through 16 lanes, with the window ring and a latency fault plan
installed (one reference program). From each run's harvested ring,
health and injection block: run_manifest, metrics_from_manifest,
prometheus_text and chrome_trace are equal, except the wall-clock
fields, which are named here (WALL_*): the phase timers' durations and
start offsets. config_hash and fault_plan_digest are equal, and the
planes the port does not have (flows, causality, lanes, admission) are
refused by name. Tolerance zero.
"""

import copy
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


@pytest.mark.parametrize("block", ["lanes", "admission", "flows",
                                   "causality"])
def test_unported_manifest_blocks_are_refused(runs, block):
    r = runs["port"]
    b = r["bundle"]
    with pytest.raises(NotImplementedError, match="item"):
        export.run_manifest(cfg=b.cfg, seed=7, shards=1, sim=b.sim,
                            **{block: {"x": 1}})


@pytest.mark.parametrize("arg", ["flow_records", "adv_records", "chains",
                                 "elastic"])
def test_unported_trace_groups_are_refused(arg):
    with pytest.raises(NotImplementedError, match=arg):
        export.chrome_trace([], **{arg: [{"x": 1}]})


def test_lane_metric_families_are_refused(runs):
    man = copy.deepcopy(runs["port"]["man"])
    man["lanes"] = {"replicas": 2, "per_lane": []}
    with pytest.raises(NotImplementedError, match="lanes"):
        export.metrics_from_manifest(man)
