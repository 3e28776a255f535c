"""Continuous lane admission in the port (shadow_tpu_torch/fleet/
admission.py) against the reference's (shadow_tpu/fleet/admission.py):

- the lease table and the SLO gate are copies: the same frames fold to
  the same population, warnings and counts; the same p99 records walk
  the same ladder;
- a ResidentProgram of 4 lanes, 3 heterogeneous tenants (4 and 3 hosts
  padded to the 4-host lane bucket), the last evicted half way and
  re-admitted: the lease history, every tenant's lane_digest and the
  manifest block (but the program key, which hashes each package's own
  code) equal the reference's; live_cache_size stays 1 (no input shape
  ever changed) and the program key never moved;
- the churn containment oracle: an undisturbed run's tenants end with
  the churned run's digests wherever they were not evicted;
- a killed resident program resumes from its lease journal with the
  exact population; `fleet run --resident` (and BENCH_RESIDENT) run.

Tolerance zero. One reference program (the churn trial).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from shadow_tpu.fleet import admission as jadm
from shadow_tpu.fleet.spec import JobSpec as JSpec
from shadow_tpu_torch.compile import serve
from shadow_tpu_torch.fleet import admission as tadm
from shadow_tpu_torch.fleet import journal as tjournal
from shadow_tpu_torch.fleet.spec import JobSpec as TSpec
from torch_parity import side_by_side

torch.set_num_threads(1)

SEC = 1_000_000_000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(Spec):
    return [Spec(id="t-a", kind="scenario", seed=7, hosts=4, load=2,
                 sim_s=1, tenant_class="protected", slo_p99_ms=1e9),
            Spec(id="t-b", kind="scenario", seed=9, hosts=3, load=1,
                 sim_s=1),
            Spec(id="t-c", kind="scenario", seed=11, hosts=4, load=2,
                 sim_s=1)]


def _trial(adm, Spec, wd, churn=True, **kw):
    specs = _specs(Spec)
    rp = adm.ResidentProgram(specs, workdir=wd, lanes=4, horizon_s=3,
                             checkpoint_every_events=0, fsync=False, **kw)
    for s in specs:
        rp.admit(s.id)
    if churn:
        rp.advance(until_ns=SEC // 2)
        rp.evict("t-c", reason="churn")
        rp.admit("t-c")
    rp.drain()
    rp.close()
    return rp


def _summary(rp):
    blk = rp.manifest_block()
    return {"history": [(h["job"], h["state"], h["lane"], h["epoch"],
                         h["digest"]) for h in rp.table.history],
            "block": blk, "events": rp.events, "windows": rp.windows,
            "dispatches": rp.dispatches,
            "live": serve.live_cache_size(rp._one_window
                                          or rp._chunk_fn)
            if hasattr(rp, "_one_window") else None}


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident")
    ref, churned, calm = side_by_side([
        lambda: _summary(_trial(jadm, JSpec, str(tmp / "ref"))),
        lambda: _summary(_trial(tadm, TSpec, str(tmp / "port"),
                                device="cpu")),
        lambda: _summary(_trial(tadm, TSpec, str(tmp / "calm"),
                                churn=False, device="cpu"))])
    return {"ref": ref, "port": churned, "calm": calm}


def test_resident_churn_equals_reference(trials):
    ref, port = trials["ref"], trials["port"]
    assert port["history"] == ref["history"]
    assert (port["events"], port["windows"], port["dispatches"]) == \
        (ref["events"], ref["windows"], ref["dispatches"])
    want = dict(ref["block"], program_key=None)
    got = dict(port["block"], program_key=None)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    blk = port["block"]
    assert blk["program_key_stable"] is True and blk["retraces"] == 0
    # 3 joins, the eviction, the re-join and 3 completion folds
    assert blk["admission_events"] == 8 and blk["evicted"] == 1
    assert port["live"] == 1


def test_churn_containment_oracle(trials):
    """Healthy lanes are byte-identical to an undisturbed run: every
    tenant the churn did not touch ends with the calm run's digest."""
    def done(s):
        return {h[0]: h[4] for h in s["history"] if h[1] == "completed"}
    churned, calm = done(trials["port"]), done(trials["calm"])
    assert set(calm) == {"t-a", "t-b", "t-c"}
    for job in ("t-a", "t-b"):
        assert churned[job] == calm[job], job
    assert trials["calm"]["block"]["program_key"] == \
        trials["port"]["block"]["program_key"]


def test_lane_digest_equals_reference_on_a_donor():
    """lane_digest over the same state in both packages: a tenant donor
    build (4 lanes of 4 hosts), every lane."""
    from shadow_tpu.fleet import scenario as jscen
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.fleet import scenario as tscen

    caps = {"event_capacity": 32, "outbox_capacity": 32,
            "router_ring": 32, "in_ring": 8}
    kw = dict(width=4, lanes=4, caps=caps, horizon_ns=3 * SEC)
    jb = jscen.build_tenant_donor(_specs(JSpec)[1], **kw)
    tb = tscen.build_tenant_donor(_specs(TSpec)[1], device="cpu", **kw)
    for lane in range(4):
        assert tadm.lane_digest(tb.sim, lane, 4) == \
            jadm.lane_digest(jb.sim, lane, 4)
    assert tscen.sim_digest(tb.sim) == jscen.sim_digest(jb.sim)
    # and the shell starts with every lane free and empty
    sh = tscen.build_resident_shell(device="cpu", **kw)
    leaves = convert.sim_to_numpy(sh.sim)
    assert (leaves[".events.time"] == 2**63 - 1).all()
    assert not leaves[".admission.active"].any()


# ---- the lease table and the gate (copies) --------------------------

def _frames(adm):
    return [
        {"ev": "lease", "lane": 0, "state": adm.ADMITTED, "job": "a",
         "epoch": 1, "t_join": 0, "lease_end": SEC},
        {"ev": "lease", "lane": 0, "state": adm.RUNNING, "job": "a",
         "epoch": 1},
        {"ev": "lease", "lane": 1, "state": adm.ADMITTED, "job": "b",
         "epoch": 1, "t_join": 0, "lease_end": SEC,
         "tenant_class": "protected", "slo_p99_ms": 5.0},
        {"ev": "lease", "lane": 1, "state": adm.RUNNING, "job": "b",
         "epoch": 1},
        {"ev": "lease", "lane": 0, "state": adm.COMPLETED, "job": "a",
         "epoch": 1, "t_end": 5, "digest": "d"},
        {"ev": "lease", "lane": 0, "state": adm.EVICTED, "job": "a",
         "epoch": 1, "t_end": 6},                   # duplicate terminal
        {"ev": "lease", "lane": 0, "state": adm.FREE, "job": "a",
         "epoch": 1},
        {"ev": "lease", "lane": 2, "state": adm.RUNNING, "job": "c"},
        {"ev": "lease", "lane": 9, "state": adm.FREE},
        {"ev": "defer", "job": "c", "why": "no free lane"},
        {"ev": "degrade", "level": 1, "step": "stride", "why": "x"}]


def _table_run(adm, path):
    t = adm.LeaseTable(path, 3, fsync=False)
    for f in _frames(adm):
        t.record(f)
    t.close()
    with open(path, "ab") as f:
        f.write(tjournal.encode_frame({"ev": "lease", "lane": 1,
                                       "state": "free"})[:6])
    r = adm.LeaseTable(path, 3, fsync=False, resume=True)
    out = (t.counts(), t.population(), t.fold_warnings, t.free_lanes(),
           r.counts(), r.population(), r.seq, r.degrade_level,
           [h for h in r.history])
    r.close()
    return out


def test_lease_table_fold_equals_reference(tmp_path):
    want = _table_run(jadm, str(tmp_path / "ref.log"))
    got = _table_run(tadm, str(tmp_path / "port.log"))
    assert got == want
    assert len(got[2]) == 3   # duplicate, illegal, out of range


class _Rec:
    def __init__(self, lane, lat):
        self.lane, self.latency_ns = lane, lat


def _gate_run(adm, path, recs_of):
    t = adm.LeaseTable(path, 3, fsync=False)
    for lane, job, cls, slo in ((0, "p", "protected", 1.0),
                                (1, "e1", "best_effort", 1.0),
                                (2, "e2", "best_effort", None)):
        t.record({"ev": "lease", "lane": lane, "state": adm.ADMITTED,
                  "job": job, "epoch": 1, "t_join": 0, "lease_end": SEC,
                  "tenant_class": cls, "slo_p99_ms": slo})
        t.record({"ev": "lease", "lane": lane, "state": adm.RUNNING,
                  "job": job, "epoch": 1})
    g = adm.AdmissionGate(sustained=2)
    out = []
    for step in range(10):
        acts = g.evaluate(recs_of(step), t)
        out.append((acts, g.level, g.stride, g.defer_admissions))
    t.close()
    return out, g.breached_jobs, g.last_p99


def test_gate_ladder_equals_reference(tmp_path):
    """A protected lane breaching for 6 evaluations then clear: the
    ladder climbs and walks back identically; the best-effort lane's
    own breach evicts it."""
    def recs_of(step):
        bad = 3_000_000 if step < 6 else 10
        return ([_Rec(0, bad)] * 5 + [_Rec(1, 5_000_000)] * 3
                + [_Rec(2, 100)] * 2)
    want = _gate_run(jadm, str(tmp_path / "r.log"), recs_of)
    got = _gate_run(tadm, str(tmp_path / "p.log"), recs_of)
    assert got == want
    assert any(a for a, *_ in got[0])


# ---- resume, the fleet path and the bench row -----------------------

def test_resident_resume_reconstructs_population(tmp_path):
    """Kill/resume: close the journal mid-flight, tear its tail, and
    resume — the lease population and the program key must match, and
    every tenant then completes."""
    specs = [TSpec(id="r-a", kind="scenario", seed=3, hosts=4, load=1,
                   sim_s=1),
             TSpec(id="r-b", kind="scenario", seed=4, hosts=4, load=1,
                   sim_s=1)]
    wd = str(tmp_path)
    rp = tadm.ResidentProgram(specs, workdir=wd, lanes=2, horizon_s=3,
                              checkpoint_every_events=1, fsync=False,
                              device="cpu")
    rp.admit("r-a")
    rp.advance(until_ns=SEC // 4)
    rp.admit("r-b")
    pop = {int(k): tuple(v) for k, v in rp.table.population().items()}
    key = rp.program_key
    rp.table.journal.close()
    with open(rp.table.path, "ab") as f:
        f.write(tjournal.encode_frame({"ev": "lease", "lane": 0,
                                       "state": "free"})[:6])
    del rp
    rp2 = tadm.ResidentProgram.resume(
        specs, workdir=wd, lanes=2, horizon_s=3,
        checkpoint_every_events=1, fsync=False, device="cpu")
    assert {int(k): tuple(v)
            for k, v in rp2.table.population().items()} == pop
    rp2.drain()
    assert rp2.table.counts()["completed"] == 2
    assert rp2.program_key_stable
    assert rp2.program_key == key
    rp2.close()


def test_fleet_run_resident_and_bench_row(tmp_path, trials):
    """`fleet run --resident` on the churn trial's tenants: every job
    done, the admission block's conservation and zero retraces, and
    tools/telemetry_lint.py clean on its manifest; BENCH_RESIDENT=2
    prints bench.py's row with the "resident" block."""
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps({"jobs": [s.as_dict()
                                         for s in _specs(TSpec)]}))
    fleet = tmp_path / "fleet"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "run",
         "--jobs-file", str(jobs), "--fleet-dir", str(fleet),
         "--resident", "--resident-lanes", "4", "--platform", "cpu",
         "--no-fsync"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.bench"], cwd=ROOT,
        env=dict(env, BENCH_RESIDENT="2", BENCH_PLATFORM="cpu",
                 BENCH_HOSTS="4", BENCH_SIM_SECONDS="1", BENCH_LOAD="2"),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    outs = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    (fo, fe, fc), (bo, be, bc) = outs
    assert fc == 0, fe[-3000:]
    out = json.loads(fo.strip().splitlines()[-1])
    assert out["counts"] == {"done": 3}
    adm = out["admission"]
    assert adm["admitted"] == adm["completed"] == 3
    assert adm["program_key_stable"] is True
    man = json.loads((fleet / "fleet_manifest.json").read_text())
    assert man["admission"]["retraces"] == 0
    # the tenants ran from t=0 on a 4-lane program: the calm trial's
    # digests
    calm = {h[0]: h[4] for h in trials["calm"]["history"]}
    for job, j in man["jobs"].items():
        assert j["result"]["digest"] == calm[job], job
    lint = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "telemetry_lint.py"),
         "--fleet-manifest", str(fleet / "fleet_manifest.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    assert bc == 0, be[-3000:]
    row = json.loads(bo.strip().splitlines()[-1])
    assert row["metric"] == \
        "events_per_sec_per_chip@4hosts_resident_x2lanes_churn"
    r = row["resident"]
    assert (r["program_key_stable"], r["retraces"], r["lanes"]) == \
        (True, 0, 2)
    assert r["admitted"] == 3 and r["evicted"] == 1
    assert row["events"] > 0 and set(row["digests"]) == {"tenant-0",
                                                         "tenant-1"}
