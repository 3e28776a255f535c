"""The port's chaos soak (shadow_tpu_torch/tools/chaos_soak.py) against
the reference's tools/chaos_soak.py, on the CPU:

- run_trial(2, kills=2, verify=True) (the reference's
  tests/test_escalate.py fixed-seed smoke) and run_replica_trial at
  tests/test_lanes.py's sizes give the reference's reports, every
  field; the CLI's default and --replicas modes print them;
- run_device_loss_trial(3, shards=4) on 4 gloo rank processes walks
  retry -> shrink to 2 shards with the healed state equal to its own
  uninterrupted 4-rank control, and at 8 ranks (the reference's slow
  8 -> 4 oracle, tests/test_elastic.py; a few seconds here) to 4. Its report is held to the reference's
  report of the same call (victim, dispatch counts, frontier), pinned
  from one in-process run of the reference tool on 4 of the harness's
  virtual CPU devices: that run costs ~47 s of compiles, past this
  file's share of the tier-1 budget, so the slow-marked
  test_trial_equals_reference_in_process runs it beside the twin;
- run_churn_trial passes the reference's slow test's oracle
  (tests/test_admission.py) in a few seconds; run_sweep_trial (~55 s
  of fleet workers) is slow-marked, as the reference's is;
- the slow-marked test_trial_equals_reference_in_process runs the
  reference's device-loss, churn and sweep trials in this process
  beside the twin's and compares every report field but those that
  name a path, a program key or how many kills a worker's timing let
  land.

Tolerance zero: the soak's reports carry no wall-clock field.
"""

import json

import pytest
import torch

from shadow_tpu_torch.tools import chaos_soak as tcs
from tests.conftest import load_tool
from torch_parity import side_by_side

torch.set_num_threads(1)

# tests/test_lanes.py's containment shape
R, RS, LOAD = 4, 4, 2

# the reference's run_device_loss_trial(3, shards=4) report (the
# reference tool in-process on 4 of the test harness's virtual CPU
# devices)
REF_DEVICE_LOSS = {
    "seed": 3, "ok": True, "shards": 4, "victim": 3,
    "kill_at_dispatch": 2, "control_dispatches": 21, "final_shards": 2,
    "ladder": ["retry", "shrink"], "losses": 2,
    "verified_through_ns": 1000000001, "device_loss_errors": []}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The reference's trial and replica reports and the port's (the
    device-loss trial's ranks included), side by side."""
    cs = load_tool("chaos_soak")
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    dl_dir = tmp_path_factory.mktemp("devloss")
    dl8_dir = tmp_path_factory.mktemp("devloss8")

    def port():
        return {"trial": tcs.run_trial(2, kills=2, verify=True,
                                       workdir=str(port_dir), device="cpu"),
                "replica": tcs.run_replica_trial(3, replicas=R, hosts=RS,
                                                 load=LOAD, device="cpu")}

    ref_trial, ref_replica, ports, devloss, devloss8 = side_by_side([
        lambda: cs.run_trial(2, kills=2, verify=True, workdir=str(ref_dir)),
        lambda: cs.run_replica_trial(3, replicas=R, hosts=RS, load=LOAD),
        port,
        lambda: tcs.run_device_loss_trial(3, shards=4, workdir=str(dl_dir),
                                          device="cpu"),
        lambda: tcs.run_device_loss_trial(3, shards=8, workdir=str(dl8_dir),
                                          device="cpu")])
    return {"ref": {"trial": ref_trial, "replica": ref_replica},
            "port": ports, "devloss": devloss, "devloss8": devloss8}


def test_run_trial_equals_reference(reports):
    rep = reports["port"]["trial"]
    assert rep == reports["ref"]["trial"]
    # the reference's own assertions (tests/test_escalate.py)
    assert rep["ok"] and rep["conservation_errors"] == []
    assert rep["kills"] == 2 and rep["segments"] == 3
    assert rep["escalation_restarts"] >= 1 and rep["retries_used"] == 0
    assert rep["verified_bit_identical"] is True and rep["resume_of"]


def test_replica_trial_equals_reference(reports):
    rep = reports["port"]["replica"]
    assert rep == reports["ref"]["replica"]
    assert rep["ok"] and rep["victim_trip"] == ["events_overflow"]
    assert rep["containment_errors"] == []


@pytest.mark.parametrize("mode", ["trial", "replica"])
def test_cli_prints_the_reference_reports(reports, mode, capsys):
    """The CLI's default mode and --replicas print one JSON line per
    trial, the reference's report, and exit 0."""
    argv = (["--trials", "1", "--seed", "2", "--kills", "2", "--verify"]
            if mode == "trial" else
            ["--trials", "1", "--seed", "3", "--replicas", str(R),
             "--hosts", str(RS), "--load", str(LOAD)])
    assert tcs.main(argv + ["--platform", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [json.dumps(reports["ref"][mode])]


def test_device_loss_trial_shrinks_to_survivors(reports):
    rep = reports["devloss"]
    assert rep["device_loss_errors"] == [] and rep["ok"], rep
    assert rep["ladder"] == ["retry", "shrink"]
    assert rep["final_shards"] == 2 and rep["losses"] == 2
    assert rep == REF_DEVICE_LOSS


def test_device_loss_trial_eight_shards_shrinks_to_four(reports):
    """tests/test_elastic.py's 8-shard oracle: retry, then shrink to the
    4 pow2-down survivors, byte-identical to the uninterrupted 8-rank
    control, the elastic block and the final stamp lint-clean."""
    rep = reports["devloss8"]
    assert rep["device_loss_errors"] == [] and rep["ok"], rep
    assert rep["ladder"] == ["retry", "shrink"]
    assert rep["final_shards"] == 4 and rep["losses"] == 2


def test_churn_trial_passes_the_oracle(tmp_path):
    """tests/test_admission.py's slow churn oracle: undisturbed tenants
    byte-identical to a no-churn run, the SLO tenant shed with a
    lint-clean salvage, the population rebuilt after the kill, no
    retrace."""
    rep = tcs.run_churn_trial(11, lanes=6, workdir=str(tmp_path),
                              device="cpu")
    assert rep["ok"], rep
    assert rep["churn_errors"] == [] and rep["program_key_stable"]
    assert rep["slo_evicted"] == "t-slo" and rep["tenants"] >= 4
    assert rep["joins"] + rep["leaves"] + rep["evictions"] >= 8


@pytest.mark.slow
def test_sweep_trial_ranking_survives_kills(tmp_path):
    """tests/test_sweep_recovery.py's slow sweep-under-fire oracle."""
    rep = tcs.run_sweep_trial(7, workers=2, workdir=str(tmp_path),
                              device="cpu")
    assert rep["ok"], rep
    assert rep["rounds"] >= 3 and rep["kills"] >= 1
    assert rep["worker_losses"] >= rep["kills"] - 1
    assert rep["ranking_identical"] and rep["sweep_errors"] == []


# Report fields that differ by construction: the port's program keys
# hash torch, each run writes under its own directory, and the sweep's
# kill count and worker losses follow when a worker reaches "running".
NOT_COMPARED = {"program_key", "salvage", "kills", "worker_losses"}


@pytest.mark.slow
@pytest.mark.parametrize("trial", ["device_loss", "churn", "sweep"])
def test_trial_equals_reference_in_process(trial, tmp_path):
    """The reference's run_device_loss_trial(3, shards=4) (on 4 of the
    harness's virtual CPU devices), run_churn_trial(11) and
    run_sweep_trial(7), run in this process, and the twin's on the CPU
    give the same report but the fields in NOT_COMPARED."""
    cs = load_tool("chaos_soak")
    call = {
        "device_loss": lambda mod, d, **kw: mod.run_device_loss_trial(
            3, shards=4, workdir=d, **kw),
        "churn": lambda mod, d, **kw: mod.run_churn_trial(
            11, lanes=6, workdir=d, **kw),
        "sweep": lambda mod, d, **kw: mod.run_sweep_trial(
            7, workers=2, workdir=d, **kw),
    }[trial]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = call(cs, str(tmp_path / "ref"))
    port = call(tcs, str(tmp_path / "port"), device="cpu")
    assert ref["ok"] and port["ok"], (ref, port)
    assert set(port) == set(ref)

    def strip(rep):
        return {k: v for k, v in rep.items() if k not in NOT_COMPARED}

    assert strip(port) == strip(ref)
    if trial == "device_loss":
        assert port == REF_DEVICE_LOSS == ref
