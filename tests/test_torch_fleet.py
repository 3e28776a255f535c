"""The port's scenario fleet (shadow_tpu_torch/fleet/) against the
reference's (shadow_tpu/fleet/):

- the host-only copies (journal, spec, state, backoff, manifest) give
  the reference's journal bytes, folded states, delays, validation
  errors and manifest roll-ups on the same inputs, the device-loss
  requeue (tests/test_elastic.py's fleet cases) included;
- `python -m shadow_tpu_torch.cli fleet run --workers 2 --platform
  cpu` on three 16-host scenario jobs: every job's sim_digest equals
  the reference's scenario.run_job digest of the same spec, `fleet
  status` folds to all done, tools/telemetry_lint.py --fleet-manifest
  is clean, and a job of a key another job stored reports hit: true;
- a worker SIGKILLed after its first checkpoint heartbeat: the job is
  requeued at the same attempt, resumes from its checkpoint, and ends
  with the digest of the uninterrupted run;
- a zero wallclock budget latches the deadline, as the reference's;
- a `chaos_trial` job runs the port's chaos soak trial
  (shadow_tpu_torch/tools/chaos_soak.py) and returns the reference's
  run_job result: ok, trial_ok and the trial's report;
- a `shards = 2` job through a real worker runs on 2 gloo ranks: its
  digest and counters equal the reference's sharded run_job's, its
  state the serial oracle's (`width_digest`, every leaf but the
  outbox's per-shard-count counters), and its `device_lease` and
  `elastic` blocks have the reference's keys
  (tests/test_torch_fleet_mesh.py kills its ranks and workers).

Tolerance zero. The reference's three run_job calls (one program) run
in a thread beside the port's fleet processes.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from shadow_tpu.fleet import journal as jjournal
from shadow_tpu.fleet import manifest as jmanifest
from shadow_tpu.fleet import spec as jspec
from shadow_tpu.fleet import state as jstate
from shadow_tpu.fleet.scenario import run_job as jrun_job
from shadow_tpu_torch.fleet import FleetPolicy, FleetRunner
from shadow_tpu_torch.fleet import journal as tjournal
from shadow_tpu_torch.fleet import manifest as tmanifest
from shadow_tpu_torch.fleet import spec as tspec
from shadow_tpu_torch.fleet import state as tstate
from shadow_tpu_torch.fleet.scenario import run_job as trun_job
from tests.conftest import load_tool
from torch_parity import side_by_side

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the three fleet jobs: seeds 1-3 of one 16-host PHOLD shape (one
# program key, so a worker's second job of it is a store hit)
JOBS = [{"id": f"s{i}", "kind": "scenario", "seed": i, "hosts": 16,
         "load": 2, "sim_s": 1} for i in (1, 2, 3)]
# the SIGKILL case: checkpoints every 2 windows, a sleep a round so the
# kill lands mid-run
KILL = {"id": "kill-0", "kind": "scenario", "seed": 7, "hosts": 16,
        "load": 2, "sim_s": 1, "checkpoint_every_windows": 2,
        "round_sleep_s": 0.05}


def _ref_digests(tmp):
    out = {}
    for d in JOBS + [dict(KILL, round_sleep_s=0.0)]:
        res = jrun_job(jspec.JobSpec.from_dict(d), os.path.join(tmp, d["id"]))
        assert res["ok"], res
        out[d["id"]] = (res["digest"], res["counters"])
    return out


def _port_fleet(tmp):
    jobs = os.path.join(tmp, "jobs.json")
    with open(jobs, "w") as f:
        json.dump({"fleet": {"backoff_base_s": 0.0, "backoff_cap_s": 0.0},
                   "jobs": JOBS}, f)
    fleet = os.path.join(tmp, "fleet")
    env = dict(os.environ, SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    env.pop("SHADOW_NO_COMPILE_CACHE", None)
    env.pop("SHADOW_WARM_PROGRAMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "run",
         "--jobs-file", jobs, "--fleet-dir", fleet, "--workers", "2",
         "--platform", "cpu", "--no-fsync"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    st = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.cli", "fleet", "status",
         "--fleet-dir", fleet], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    lint = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "telemetry_lint.py"),
         "--fleet-manifest", os.path.join(fleet, "fleet_manifest.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    return r, st, lint, fleet


# the sharded case: 16 hosts on 2 ranks
MESH = {"id": "mesh-0", "kind": "scenario", "seed": 4, "hosts": 16,
        "load": 2, "sim_s": 1, "shards": 2}


def _ref_mesh(tmp):
    """The reference's run_job of MESH (2 of the conftest's 8 CPU
    devices)."""
    res = jrun_job(jspec.JobSpec.from_dict(MESH), os.path.join(tmp, "mesh"))
    assert res["ok"], res
    return res


def _port_mesh(tmp):
    """MESH through one real worker on the CPU, and the serial run of the
    same spec in process."""
    fleet = os.path.join(tmp, "mfleet")
    runner = FleetRunner(fleet, FleetPolicy(backoff_base_s=0.0,
                                            backoff_cap_s=0.0),
                         [tspec.JobSpec.from_dict(MESH)], workers=1,
                         fsync=False, device="cpu")
    rc = runner.run()
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    serial = trun_job(tspec.JobSpec.from_dict(dict(MESH, shards=1)),
                      os.path.join(tmp, "mserial"), device="cpu")
    return rc, man, serial


def _port_kill(tmp, monkeypatch_env):
    killed = {"done": False}

    def on_event(runner, ev):
        if (not killed["done"] and ev["ev"] == "heartbeat"
                and ev["job"] == "kill-0" and ev.get("checkpoint")):
            os.kill(runner.workers[ev["worker"]]["proc"].pid,
                    signal.SIGKILL)
            killed["done"] = True

    runner = FleetRunner(
        os.path.join(tmp, "kfleet"),
        FleetPolicy(backoff_base_s=0.0, backoff_cap_s=0.0),
        [tspec.JobSpec.from_dict(KILL)], workers=1, fsync=False,
        on_event=on_event, device="cpu")
    rc = runner.run()
    return rc, killed["done"]


# the chaos_trial job: tools/chaos_soak.py run_trial(2, kills=1) at the
# scenario surface's default shape (three escalations and a kill;
# tests/test_torch_chaos_soak.py holds the 2-kill, verified trial)
CHAOS = {"id": "c", "kind": "chaos_trial", "seed": 2, "kills": 1}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fleets"))
    ref, port, kill, ref_mesh, mesh, ref_chaos = side_by_side([
        lambda: _ref_digests(os.path.join(tmp, "ref")),
        lambda: _port_fleet(tmp), lambda: _port_kill(tmp, None),
        lambda: _ref_mesh(os.path.join(tmp, "ref")),
        lambda: _port_mesh(tmp),
        lambda: jrun_job(jspec.JobSpec.from_dict(CHAOS),
                         os.path.join(tmp, "ref", "chaos"))])
    return {"ref": ref, "port": port, "kill": kill, "tmp": tmp,
            "ref_mesh": ref_mesh, "mesh": mesh, "ref_chaos": ref_chaos}


# ---- the host-only copies -------------------------------------------

RECORDS = [{"ev": "job_added", "job": "a", "spec": {"id": "a"}},
           {"ev": "leased", "job": "a", "worker": "w0", "attempt": 1},
           {"ev": "heartbeat", "job": "a", "checkpoint": "/ck/1.npz",
            "u": "é"},
           {"ev": "done", "job": "a", "result": {"ok": True, "x": 1.5}}]


def test_journal_bytes_equal_reference(tmp_path):
    paths = []
    for mod, name in ((jjournal, "ref"), (tjournal, "port")):
        p = str(tmp_path / f"{name}.log")
        j = mod.Journal(p, fsync=False)
        for r in RECORDS:
            j.append(r)
        j.close()
        with open(p, "ab") as f:                 # a torn tail
            f.write(mod.encode_frame({"ev": "torn"})[:7])
        paths.append(p)
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]
    assert jjournal.encode_frame(RECORDS[2]) == \
        tjournal.encode_frame(RECORDS[2])
    assert jjournal.replay(paths[0]) == tjournal.replay(paths[1])
    assert tjournal.replay(paths[1])[0] == RECORDS


GOOD = {"fleet": {"max_attempts": 4, "backoff_seed": 9},
        "jobs": [dict(JOBS[0], faults=[{"time_s": 0.3, "kind": "loss",
                                        "a": 0, "b": 0, "value": 0.02}],
                      auto_grow=True, max_grow=8),
                 {"id": "c", "kind": "chaos_trial", "seed": 2}]}
BAD = [{"jobs": [{"id": "x y"}]},
       {"jobs": [{"id": "a"}, {"id": "a"}]},
       {"jobs": [{"id": "a", "kind": "nope"}]},
       {"jobs": [{"id": "a", "hosts": 1}]},
       {"jobs": [{"id": "a", "seed": "x"}]},
       {"jobs": [{"id": "a", "unknown_knob": 1}]},
       {"fleet": {"max_attempts": 0}, "jobs": [{"id": "a"}]},
       {"jobs": []}, []]


def _parse(mod, obj):
    try:
        pol, specs = mod.parse_jobs_obj(obj)
        return ("ok", pol.as_dict(), [s.as_dict() for s in specs])
    except Exception as e:  # noqa: BLE001 — the error is the result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", range(len(BAD) + 1))
def test_spec_parse_and_validation_equal_reference(case):
    obj = GOOD if case == len(BAD) else BAD[case]
    want, got = _parse(jspec, obj), _parse(tspec, obj)
    assert got == want
    if case == len(BAD):
        assert got[0] == "ok"


def test_backoff_delays_equal_reference():
    pol = [m.FleetPolicy(backoff_base_s=0.25, backoff_cap_s=5.0,
                         backoff_seed=s) for m, s in ((jspec, 3),
                                                      (tspec, 3))]
    for job in ("a", "job-17", "x.lane3"):
        for attempt in range(1, 9):
            assert tstate.backoff_delay(pol[1], job, attempt) == \
                jstate.backoff_delay(pol[0], job, attempt)


def _script(mod_spec, mod_state, mod_manifest, path):
    t = {"v": 100.0}
    pol = mod_spec.FleetPolicy(max_attempts=2, backoff_base_s=0.0,
                               backoff_cap_s=0.0, requeue_budget=2)
    specs = [mod_spec.JobSpec(id="a", seed=1, shards=8),
             mod_spec.JobSpec(id="b", seed=2),
             mod_spec.JobSpec(id="c", seed=3)]
    q = mod_state.FleetQueue(path, pol, specs, fsync=False,
                             now=lambda: t["v"])
    sts = []
    q.lease("a", "w0")
    q.mark_running("a", "w0")
    q.heartbeat("a", checkpoint="/ck/400.npz")
    sts.append(q.device_lost("a", lost_shard=6, new_shards=4,
                             cause="injected"))
    rec = q.lease("a", "w1")
    sts.append((rec["attempt"], rec["resume_from"]))
    q.complete("a", {"ok": True, "digest": "d"})
    q.lease("b", "w0")
    t["v"] += 5
    sts.append(q.fail("b", {"error": "RuntimeError: x"}))
    q.lease("b", "w0")
    sts.append(q.fail("b", {"error": "RuntimeError: x"}))
    q.lease("c", "w1")
    sts.append(q.worker_lost("w1", "c", "killed"))
    q.lease("c", "w0")
    q.complete("c", {"ok": True})
    jobs = {k: (j.status, j.attempts, j.shards_override,
                j.device_losses, j.continuation)
            for k, j in q.jobs.items()}
    man = mod_manifest.fleet_manifest(q, complete=True)
    q.close()
    q2 = mod_state.FleetQueue(path, pol, resume=True, fsync=False,
                              now=lambda: t["v"])
    refold = {k: (j.status, j.attempts, j.shards_override)
              for k, j in q2.jobs.items()}
    q2.close()
    return sts, jobs, man, refold, open(os.path.join(path, "journal.log"),
                                        "rb").read()


def test_queue_fold_and_manifest_equal_reference(tmp_path):
    """Leases, a device loss (requeued at the degraded width on the
    same attempt: tests/test_elastic.py:345), a failure into
    quarantine, a worker loss, the journal's replay and the fleet
    manifest (its elastic roll-up included) — equal to the
    reference's."""
    want = _script(jspec, jstate, jmanifest, str(tmp_path / "ref"))
    got = _script(tspec, tstate, tmanifest, str(tmp_path / "port"))
    assert got[0] == want[0]
    assert got[0][1] == (1, "/ck/400.npz")   # no failure attempt burned
    assert got[1] == want[1] and got[3] == want[3]
    for key in ("counts", "complete", "jobs"):
        assert json.dumps(got[2].get(key), sort_keys=True) == \
            json.dumps(want[2].get(key), sort_keys=True), key
    assert got[4].count(b"SJ") == want[4].count(b"SJ")


# ---- fleet run on worker processes ----------------------------------

def test_fleet_run_two_workers_equals_reference(fleets):
    r, st, lint, fleet = fleets["port"]
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["counts"] == {"done": 3} and out["exit"] == 0
    status = json.loads(st.stdout)
    assert st.returncode == 0 and status["counts"] == {"done": 3}
    assert lint.returncode == 0, lint.stdout + lint.stderr
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    hits = []
    for d in JOBS:
        res = man["jobs"][d["id"]]["result"]
        assert (res["digest"], res["counters"]) == \
            tuple(fleets["ref"][d["id"]]), d["id"]
        jm = json.load(open(res["manifest"]))
        assert jm["compile"]["warm"] is True
        hits.append(jm["compile"]["hit"])
    assert any(hits) and not all(hits)
    assert len({man["jobs"][d["id"]]["result"]["program_key"]
                for d in JOBS}) == 1


def test_fleet_sigkill_requeues_same_attempt(fleets):
    rc, killed = fleets["kill"]
    assert rc == 0 and killed, "kill never landed"
    fleet = os.path.join(fleets["tmp"], "kfleet")
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    j = man["jobs"]["kill-0"]
    assert j["verdict"] == "ok" and j["worker_losses"] == 1
    assert j["attempt_history"] == [1, 1]   # continuation, not retry
    assert j["executions"] == 2
    assert (j["result"]["digest"], j["result"]["counters"]) == \
        tuple(fleets["ref"]["kill-0"])
    recs, _ = tjournal.replay(os.path.join(fleet, "journal.log"))
    req = [x for x in recs if x["ev"] == "requeued"]
    assert len(req) == 1 and req[0]["resume_from"]


def test_run_wallclock_deadline_latches_and_checkpoints(tmp_path):
    spec = tspec.JobSpec(id="dl-0", seed=7, hosts=8, load=2, sim_s=1,
                         max_wallclock_s=0.0, checkpoint_every_windows=4)
    res = trun_job(spec, str(tmp_path / "job"), device="cpu")
    assert not res["ok"] and res["deadline"] and not res["preempted"]
    assert res["checkpoint"] and os.path.exists(res["checkpoint"])
    assert res["failure"]["verdict"] == "deadline"
    assert res["failure"]["deadline_exceeded"] is True
    on_disk = json.load(open(tmp_path / "job" / "result.json"))
    assert on_disk["deadline"] is True


def test_chaos_trial_is_refused_by_name(fleets, tmp_path):
    """Once refused, now run: a chaos_trial job runs the port's soak
    trial and returns the reference's run_job result, report and all."""
    res = trun_job(tspec.JobSpec.from_dict(CHAOS), str(tmp_path / "c"),
                   device="cpu")
    assert res == fleets["ref_chaos"]
    assert res["ok"] and res["trial_ok"] and res["report"]["ok"]
    assert res["report"]["kills"] == 1
    assert res["report"]["escalation_restarts"] >= 1
    assert json.load(open(tmp_path / "c" / "result.json")) == res


def test_sharded_job_is_refused_by_name(fleets):
    """Once refused, now run: a `shards = 2` job through a real worker
    runs on 2 gloo ranks (the worker and one started rank) and ends done
    with the reference's sharded run_job's digest and counters, and the
    serial run's state and events; its device_lease and elastic blocks
    carry the reference's keys, and its manifest lints clean."""
    rc, man, serial = fleets["mesh"]
    want = fleets["ref_mesh"]
    assert rc == 0 and serial["ok"]
    j = man["jobs"]["mesh-0"]
    res = j["result"]
    assert j["verdict"] == "ok" and j["attempt_history"] == [1]
    # the reference's sharded run bit for bit (the outbox's per-shard
    # counters and the ranks' summed micro-steps included) ...
    assert (res["digest"], res["counters"]) == (want["digest"],
                                                want["counters"])
    # ... and the serial run's state but for those counters
    assert res["width_digest"] == serial["width_digest"]
    assert res["counters"]["events_processed"] == \
        serial["counters"]["events_processed"]
    assert sorted(res["device_lease"]) == sorted(want["device_lease"])
    assert res["device_lease"] == {"requested": 2, "leased": 2,
                                   "devices": ["cpu:0", "cpu:1"],
                                   "final_shards": 2}
    assert want["device_lease"]["leased"] == 2
    assert sorted(res["elastic"]) == sorted(want["elastic"])
    assert res["elastic"]["ladder_steps"] == [] == \
        want["elastic"]["ladder_steps"]
    assert res["elastic"]["policy"] == want["elastic"]["policy"]
    errors, _ = load_tool("telemetry_lint").lint_fleet_manifest_obj(man)
    assert errors == [], errors
