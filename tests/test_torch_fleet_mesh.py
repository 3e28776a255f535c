"""Sharded fleet jobs in the port (shadow_tpu_torch/fleet/scenario.py):
a `shards = 2` job on the CPU is a worker (rank 0) and one started rank
over gloo, under run_supervised(mesh=..., elastic=ElasticPolicy()).

- A rank SIGKILLed after the first snapshot: the ladder goes serial on
  rank 0 and the job ends done with the serial oracle's state (its
  `width_digest`: every leaf but the outbox's per-shard-count counters)
  and events; the elastic and device_lease blocks pass
  tools/telemetry_lint.py --fleet-manifest.
- A ladder that can neither shrink nor go serial, exhausted by a killed
  rank: the job's `device_lost` verdict {lost_shard, new_shards 1,
  cause}, driven into the runner's requeue (the same attempt, shards
  override 1), then finished at that width by a worker, from the
  job's 2-shard snapshot, with the serial oracle's state.
- A worker SIGKILLed mid-run: its started rank dies with it (the kernel's
  parent-death signal), and the requeued continuation ends with the
  serial oracle's state.

The runs happen side by side; each is a few seconds of 16-host PHOLD.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import torch_shard_ranks as R
from shadow_tpu_torch.fleet import FleetPolicy, FleetRunner
from shadow_tpu_torch.fleet import spec as tspec
from shadow_tpu_torch.fleet.scenario import run_job
from tests.conftest import load_tool
from torch_parity import side_by_side

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
# a 16-host PHOLD job on 2 ranks: snapshots every 2 windows, a sleep a
# round so a kill lands mid-run (it shapes no state)
MESH = {"kind": "scenario", "seed": 5, "hosts": 16, "load": 2, "sim_s": 1,
        "shards": 2, "checkpoint_every_windows": 2, "round_sleep_s": 0.05}
POLICY = dict(backoff_base_s=0.0, backoff_cap_s=0.0)


def _spec(jid, **kw):
    return tspec.JobSpec.from_dict(dict(MESH, id=jid, **kw))


def _oracle(tmp):
    """The serial run of the same spec: (width_digest, events)."""
    res = run_job(_spec("oracle", shards=1, round_sleep_s=0.0),
                  os.path.join(tmp, "oracle"), device="cpu")
    assert res["ok"], res
    return res["width_digest"], res["counters"]["events_processed"]


def _killed_rank(tmp):
    """The job through a real worker, its started rank SIGKILLed after
    the first snapshot."""
    fleet = os.path.join(tmp, "rank")
    runner = FleetRunner(fleet, FleetPolicy(**POLICY), [_spec("mesh-0")],
                         workers=1, fsync=False, device="cpu")
    killer = threading.Thread(target=lambda: out.append(
        R.kill_rank_after_checkpoint(runner.queue.job_dir("mesh-0"))),
        daemon=True)
    out = []
    killer.start()
    rc = runner.run()
    killer.join(timeout=30)
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    return rc, out[0] if out else None, man


def _exhausted(tmp):
    """A leased job whose rank 0 (a subprocess: R.fleet_exhaust_main)
    exhausts its ladder; the verdict folded by the runner; then the
    runner finishes the requeued job."""
    fleet = os.path.join(tmp, "exhaust")
    spec = _spec("mesh-x")
    runner = FleetRunner(fleet, FleetPolicy(**POLICY), [spec], workers=1,
                         fsync=False, device="cpu")
    rec = runner.queue.lease(spec.id, "w0")
    runner.queue.mark_running(spec.id, "w0")
    job_dir = runner.queue.job_dir(spec.id)
    r = subprocess.run(
        [sys.executable, "-c", "import sys, torch_shard_ranks as R; "
         f"sys.exit(R.fleet_exhaust_main({job_dir!r}, "
         f"{json.dumps(spec.as_dict())!r}))"],
        cwd=TESTS, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(TESTS), TESTS])))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    runner._fold_result(spec.id, got["result"])
    j = runner.queue.jobs[spec.id]
    folded = (j.status, j.shards_override, j.device_losses, j.attempts,
              rec["attempt"])
    rc = runner.run()
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    return got, folded, rc, man


def _killed_worker(tmp):
    """The job through a real worker, the worker SIGKILLed once its rank
    logged its pid and the first snapshot is on disk; whether that rank
    was gone within 10 s."""
    fleet = os.path.join(tmp, "worker")
    seen = {}

    def on_event(runner, ev):
        if seen or ev["ev"] != "heartbeat" or not ev.get("checkpoint"):
            return
        pid = R.rank_pid(runner.queue.job_dir("mesh-w"))
        if pid is None:
            return
        seen["rank"] = pid
        os.kill(runner.workers[ev["worker"]]["proc"].pid, signal.SIGKILL)
        t_end = time.monotonic() + 10
        while time.monotonic() < t_end and _alive(pid):
            time.sleep(0.05)
        seen["gone"] = not _alive(pid)

    runner = FleetRunner(fleet, FleetPolicy(**POLICY), [_spec("mesh-w")],
                         workers=1, fsync=False, on_event=on_event,
                         device="cpu")
    rc = runner.run()
    man = json.load(open(os.path.join(fleet, "fleet_manifest.json")))
    return rc, seen, man


def _alive(pid) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    oracle, rank, exhaust, worker = side_by_side([
        lambda: _oracle(tmp), lambda: _killed_rank(tmp),
        lambda: _exhausted(tmp), lambda: _killed_worker(tmp)])
    return {"oracle": oracle, "rank": rank, "exhaust": exhaust,
            "worker": worker}


def _lint(man):
    return load_tool("telemetry_lint").lint_fleet_manifest_obj(man)


def test_killed_rank_ends_as_the_serial_oracle(runs):
    rc, killed, man = runs["rank"]
    assert rc == 0 and killed, "the kill never landed"
    j = man["jobs"]["mesh-0"]
    res = j["result"]
    assert j["verdict"] == "ok" and j["attempt_history"] == [1]
    assert (res["width_digest"], res["counters"]["events_processed"]) \
        == runs["oracle"]
    el = res["elastic"]
    assert el["initial_shards"] == 2 and el["final_shards"] == 1
    assert len(el["losses"]) >= 1
    assert [s["action"] for s in el["mesh_transitions"]] == ["serial"]
    assert res["device_lease"] == {"requested": 2, "leased": 2,
                                   "devices": ["cpu:0", "cpu:1"],
                                   "final_shards": 1}
    assert _lint(man)[0] == []


def test_exhausted_ladder_requeues_at_the_degraded_width(runs):
    got, folded, rc, man = runs["exhaust"]
    assert got["killed"], "the kill never landed"
    res = got["result"]
    assert not res["ok"] and res["device_lost"]["new_shards"] == 1
    assert res["device_lost"]["lost_shard"] >= -1
    assert res["device_lease"]["final_shards"] == 2
    assert res["elastic"]["final_shards"] == 2
    # the runner's fold: a continuation of the SAME attempt at 1 shard
    status, override, losses, attempts, attempt = folded
    assert (status, override, losses) == ("queued", 1, 1)
    assert attempts == attempt == 1
    assert rc == 0
    j = man["jobs"]["mesh-x"]
    assert j["verdict"] == "ok" and j["shards_override"] == 1
    assert j["attempt_history"] == [1, 1] and j["device_losses"] == 1
    done = j["result"]
    assert done["resume_of"] is not None
    assert (done["width_digest"], done["counters"]["events_processed"]) \
        == runs["oracle"]
    assert _lint(man)[0] == []


def test_no_rank_outlives_a_killed_worker(runs):
    rc, seen, man = runs["worker"]
    assert seen.get("rank"), "the kill never landed"
    assert seen["gone"], f"rank pid {seen['rank']} outlived its worker"
    assert rc == 0
    j = man["jobs"]["mesh-w"]
    assert j["verdict"] == "ok" and j["worker_losses"] == 1
    assert j["attempt_history"] == [1, 1]
    res = j["result"]
    assert (res["width_digest"], res["counters"]["events_processed"]) \
        == runs["oracle"]
    assert res["device_lease"]["final_shards"] == 2
    assert _lint(man)[0] == []
