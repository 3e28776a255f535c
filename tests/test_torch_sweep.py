"""The port's counterfactual sweep (shadow_tpu_torch/sweep/) against the
reference's (shadow_tpu/sweep/):

- the host-level cases of tests/test_sweep.py run over both packages'
  modules on the same spec objects and give equal results: spec round
  trips and digests, the validation rejections, the lattice cap,
  row-major point ids and their width, the census and predict_caps, the
  reducer (metric_value, rank, survivors, halving_keep), seeded random
  search and the halving round re-derivation;
- the driver over a FleetRunner-shaped double (a real FleetQueue and
  manifest, synthetic results) on each package: a grid, divergent
  points, a preempt and a resume that re-runs nothing, a used or
  changed dir refused, a tampered journal refused, halving rounds; the
  journals' frames are equal apart from `t`, the sweep blocks and
  rankings byte for byte; tools/telemetry_lint.py accepts the port's
  sweep manifests and rejects the same negative cases; `fleet status`
  folds the sweep and `sweep status` / `sweep report` print it;
- one real-engine case: a 4-point grid of 8-host PHOLD points (2
  distinct programs) through the port's FleetRunner with 2 CPU workers,
  `sweep run` SIGKILLed after its first completed point and resumed:
  no completed point runs again, and the ranking and best point are
  byte for byte an uninterrupted port sweep's; every point's
  events_processed and digest equal the reference's run_job on the same
  spec in process (one JAX program per distinct key).

Tolerance zero. The reference's runs happen in a thread beside the
port's sweeps.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

from shadow_tpu.fleet import cli as jfleet_cli
from shadow_tpu.fleet import journal as jjournal
from shadow_tpu.fleet import manifest as jmanifest
from shadow_tpu.fleet import spec as jspec
from shadow_tpu.fleet import state as jstate
from shadow_tpu.fleet.affinity import affinity_key as jaffinity_key
from shadow_tpu.fleet.scenario import run_job as jrun_job
from shadow_tpu.sweep import cli as jsweep_cli
from shadow_tpu.sweep import driver as jdriver
from shadow_tpu.sweep import plan as jplan
from shadow_tpu.sweep import reduce as jreduce
from shadow_tpu.sweep import search as jsearch
from shadow_tpu_torch.fleet import cli as tfleet_cli
from shadow_tpu_torch.fleet import journal as tjournal
from shadow_tpu_torch.fleet import manifest as tmanifest
from shadow_tpu_torch.fleet import spec as tspec
from shadow_tpu_torch.fleet import state as tstate
from shadow_tpu_torch.fleet.affinity import affinity_key as taffinity_key
from shadow_tpu_torch.sweep import cli as tsweep_cli
from shadow_tpu_torch.sweep import driver as tdriver
from shadow_tpu_torch.sweep import plan as tplan
from shadow_tpu_torch.sweep import reduce as treduce
from shadow_tpu_torch.sweep import search as tsearch
from tests.conftest import load_tool
from torch_parity import side_by_side

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": types.SimpleNamespace(
        journal=jjournal, manifest=jmanifest, spec=jspec, state=jstate,
        affinity_key=jaffinity_key, plan=jplan, reduce=jreduce,
        search=jsearch, driver=jdriver, fleet_cli=jfleet_cli,
        sweep_cli=jsweep_cli),
    "port": types.SimpleNamespace(
        journal=tjournal, manifest=tmanifest, spec=tspec, state=tstate,
        affinity_key=taffinity_key, plan=tplan, reduce=treduce,
        search=tsearch, driver=tdriver, fleet_cli=tfleet_cli,
        sweep_cli=tsweep_cli),
}


def _spec_obj(**over):
    """tests/test_sweep.py's spec: a 2 x 2 grid of 4-host points."""
    obj = {
        "sweep": {"id": "t",
                  "objective": {"metric": "events", "goal": "max"},
                  "search": {"strategy": "grid"}},
        "fleet": {"max_attempts": 2, "backoff_base_s": 0.0,
                  "backoff_cap_s": 0.0},
        "template": {"kind": "scenario", "hosts": 4, "sim_s": 1,
                     "load": 2},
        "axes": [{"field": "seed", "values": [1, 2]},
                 {"field": "event_capacity", "values": [24, 48]}],
    }
    for k, v in over.items():
        obj[k] = v
    return obj


def _halving_obj(**search):
    obj = _spec_obj()
    obj["sweep"]["search"] = {"strategy": "halving", "eta": 2, **search}
    return obj


def _both(fn):
    """{"ref": fn(reference modules), "port": fn(port modules)}."""
    return {name: fn(m) for name, m in PKGS.items()}


def _same(fn):
    out = _both(fn)
    assert out["port"] == out["ref"]
    return out["port"]


# ------------------------------------------------------------- grammar

def test_spec_roundtrip_and_digest_equal_reference():
    obj = _spec_obj()

    def go(m):
        s1 = m.plan.SweepSpec.from_obj(copy.deepcopy(obj))
        s2 = m.plan.SweepSpec.from_obj(s1.as_dict())
        return (s1.digest(), s2.digest(), s1.lattice_size(),
                json.dumps(s1.as_dict(), sort_keys=True))

    d1, d2, n, _ = _same(go)
    assert d1 == d2 and n == 4


REJECTS = [
    lambda o: o["sweep"].__setitem__("id", "bad id!"),
    lambda o: o["sweep"].__setitem__("objective", {"metric": "nope"}),
    lambda o: o["sweep"].__setitem__("search", {"strategy": "annealing"}),
    lambda o: o.__setitem__("axes", []),
    lambda o: o.__setitem__("axes", [{"field": "seed", "values": [1]},
                                     {"field": "seed", "values": [2]}]),
    lambda o: o.__setitem__("axes", [{"field": "id", "values": ["a"]}]),
    lambda o: o.__setitem__("axes", [{"field": "load", "values": [1]}]),
    lambda o: o.__setitem__("axes", [{"field": "seed", "values": []}]),
    lambda o: o["template"].__setitem__("id", "x"),
    lambda o: o["template"].__setitem__("kind", "chaos_trial"),
    lambda o: o["sweep"].__setitem__("search", {"strategy": "random"}),
    lambda o: o["sweep"].__setitem__(
        "search", {"strategy": "halving", "budget_field": "seed"}),
    lambda o: o["sweep"].__setitem__("search",
                                     {"strategy": "grid", "eta": 2}),
    # the lattice cap
    lambda o: (o.__setitem__("axes", [
        {"field": "seed", "values": list(range(300))},
        {"field": "load", "values": list(range(300))}]),
        o["template"].pop("load")),
]


@pytest.mark.parametrize("case", range(len(REJECTS)))
def test_spec_validation_rejects_as_the_reference(case):
    def go(m):
        obj = _spec_obj()
        REJECTS[case](obj)
        with pytest.raises((ValueError, KeyError)) as ei:
            m.plan.SweepSpec.from_obj(obj)
        return type(ei.value).__name__, str(ei.value)

    kind, msg = _same(go)
    if case == len(REJECTS) - 1:
        assert "65536" in msg


# ----------------------------------------------------------- expansion

def test_expand_row_major_and_point_specs_equal_reference():
    def go(m):
        s = m.plan.SweepSpec.from_obj(_spec_obj())
        pts = m.plan.expand(s)
        return ([(p.pid, p.index, p.coords) for p in pts],
                s.point_spec(pts[2], 1).as_dict(),
                s.point_spec(pts[2], 2, {"sim_s": 4}).as_dict())

    pts, job, over = _same(go)
    assert [p[0] for p in pts] == ["p0000", "p0001", "p0002", "p0003"]
    assert job["id"] == "r1-p0002" and over["sim_s"] == 4


def test_expand_pid_width_grows_as_the_reference():
    def go(m):
        s = m.plan.SweepSpec.from_obj(_spec_obj(axes=[
            {"field": "seed", "values": list(range(10001))}]))
        pts = m.plan.expand(s)
        return pts[0].pid, pts[-1].pid, len(pts)

    assert _same(go) == ("p00000", "p10000", 10001)


# -------------------------------------------------------------- census

def test_census_and_predict_caps_equal_reference():
    def go(m):
        s = m.plan.SweepSpec.from_obj(_spec_obj())
        specs = [s.point_spec(p, 0) for p in m.plan.expand(s)]
        base = m.spec.JobSpec(id="x", kind="scenario", seed=1, hosts=4,
                              load=2, sim_s=1)
        lossy = m.spec.JobSpec(
            id="x", kind="scenario", seed=1, hosts=4, load=2, sim_s=1,
            faults=({"time_s": 0.1, "kind": "loss", "a": 0, "b": 0,
                     "value": 0.1},))
        off = m.spec.JobSpec(id="x", kind="scenario", seed=1, hosts=4,
                             load=2, sim_s=1, specialize="off")
        return (m.plan.plan_census(specs),
                [m.plan.predict_caps(x) for x in (base, lossy, off)])

    census, caps = _same(go)
    assert census["distinct"] == 2
    assert caps[0]["key_extra"] == "no_loss-no_timers"


# ------------------------------------------------------------- reducer

def _entry(status="done", events=100, hv="clean", **res):
    result = {"counters": {"events_processed": events,
                           "drops_total": res.pop("drops", 0)},
              "health_verdict": hv}
    result.update(res)
    return {"status": status, "result": result}


ENTRIES = {
    "p0": _entry(events=10),
    "p1": _entry(events=30),
    "p2": _entry(events=30),
    "p3": {"status": "failed", "failure": {"kind": "x"}},
    "p4": {"status": "quarantined"},
    "p5": _entry(events=20, hv="warnings"),
    "p6": {"status": "done", "result": {}},
    "p7": {},
}


def test_reducer_equals_reference():
    flows = _entry(events=42, drops=3, events_per_sec=9.5,
                   flows={"per_lane": {"0": {"p99_ns": 100, "count": 5},
                                       "1": {"p99_ns": 900, "count": 2},
                                       "2": {"p99_ns": 9999,
                                             "count": 0}}})
    table = [{"point": p, "value": v, "verdict": "ok"}
             for p, v in (("a", 5), ("b", 4), ("c", 3))]
    table.append({"point": "d", "value": None, "verdict": "failed"})

    def go(m):
        vals = [m.reduce.metric_value(flows, k) for k in m.plan.METRICS]
        vals += [m.reduce.metric_value({}, "events"),
                 m.reduce.metric_value(_entry(), "flow_p50_ns")]
        with pytest.raises(ValueError):
            m.reduce.metric_value(flows, "wallclock")
        ranks = [m.reduce.rank(ENTRIES, m.plan.Objective(**o)) for o in (
            {"metric": "events", "goal": "max"},
            {"metric": "events", "goal": "min"},
            {"metric": "events", "goal": "max",
             "require_clean_health": True},
            {"metric": "drops", "goal": "min"})]
        return (vals, ranks, m.reduce.survivors(table, 2),
                m.reduce.survivors(table, 99),
                [m.reduce.halving_keep(n, e)
                 for n, e in ((8, 2), (5, 2), (1, 3), (7, 3))])

    vals, ranks, keep2, keep99, halves = _same(go)
    assert vals[:6] == [0, 0, 900, 3, 42, 9.5]   # METRICS order
    assert [r["point"] for r in ranks[0]] == [
        "p1", "p2", "p5", "p0", "p3", "p4", "p6", "p7"]
    assert keep2 == ["a", "b"] and halves == [4, 3, 1, 3]


# ------------------------------------------------------------ strategies

def test_random_search_equals_reference():
    def go(m):
        out = []
        for seed in (7, 8):
            obj = _spec_obj()
            obj["sweep"]["search"] = {"strategy": "random", "samples": 2,
                                      "seed": seed}
            s = m.plan.SweepSpec.from_obj(obj)
            out.append(m.search.make_strategy(s).initial(
                m.plan.expand(s)))
        return out

    picks = _same(go)
    assert all(len(p) == 2 and p == sorted(p) for p in picks)


def test_halving_rounds_re_derive_as_the_reference():
    t0 = [{"point": f"p{i}", "value": 100 - i, "verdict": "ok"}
          for i in range(4)]
    t0.append({"point": "p9", "value": None, "verdict": "failed"})
    t1 = [{"point": "p1", "value": 200, "verdict": "ok"},
          {"point": "p0", "value": 150, "verdict": "ok"}]
    t2 = [{"point": "p1", "value": 400, "verdict": "ok"}]

    def go(m):
        strat = m.search.make_strategy(m.plan.SweepSpec.from_obj(
            _halving_obj(budget_scale=2)))
        capped = m.search.make_strategy(m.plan.SweepSpec.from_obj(
            _halving_obj(rounds=1)))
        return ([strat.next_round(t) for t in ([t0], [t0, t1],
                                               [t0, t1, t2])],
                capped.next_round([t0]),
                [strat.overrides(k) for k in range(4)])

    rounds, capped, overrides = _same(go)
    assert rounds[0] == {"points": ["p0", "p1"], "pruned": ["p2", "p3"]}
    assert rounds[2] is None and capped is None
    assert overrides == [{}, {"sim_s": 2}, {"sim_s": 4}, {"sim_s": 8}]


# ------------------------------------------- driver over a real queue

def _synthetic_result(m, spec):
    """tests/test_sweep.py's engine stand-in: events a pure function of
    the coordinates, the program key from the affinity key."""
    ak = m.affinity_key(spec)
    return {"ok": True,
            "counters": {"events_processed":
                         1000 * spec.seed + spec.event_capacity,
                         "drops_total": 0},
            "health_verdict": "clean", "events_per_sec": 100.0,
            "program_key": "pk" + ak[2:]}


class FakeRunner:
    """tests/test_sweep.py's FleetRunner-shaped double over package
    `m`: a real FleetQueue and manifest write path, synthetic results;
    `outcome(spec)` -> ("done", result) / ("fail", failure) /
    ("quarantine", reason); `max_jobs` preempts after N executions."""

    def __init__(self, m, fleet_dir, policy, specs, *, resume=False,
                 fsync=False, outcome=None, max_jobs=None, executed=None):
        self.m = m
        self.queue = m.state.FleetQueue(fleet_dir, policy, specs,
                                        resume=resume, fsync=fsync,
                                        now=lambda: 0.0)
        self.outcome = outcome or (lambda s: ("done",
                                              _synthetic_result(m, s)))
        self.max_jobs = max_jobs
        self.executed = executed if executed is not None else []
        self.sweep_block_fn = None

    def _write_manifest(self, complete, preempted=False):
        man = self.m.manifest.fleet_manifest(
            self.queue, workers_alive=0, preempted=preempted,
            complete=complete,
            sweep=(self.sweep_block_fn(self.queue)
                   if self.sweep_block_fn else None))
        self.m.manifest.write_fleet_manifest(
            os.path.join(self.queue.fleet_dir, "fleet_manifest.json"), man)

    def run(self, install_signals=False):
        n, now = 0, 0.0
        while True:
            if self.max_jobs is not None and n >= self.max_jobs:
                self._write_manifest(False, preempted=True)
                self.queue.close()
                return 5
            ready = self.queue.ready(now)
            if not ready:
                break
            jid = ready[0].spec.id
            self.queue.lease(jid, "w0")
            self.queue.mark_running(jid, "w0")
            self.executed.append(jid)
            kind, payload = self.outcome(ready[0].spec)
            if kind == "done":
                self.queue.complete(jid, payload)
            elif kind == "fail":
                self.queue.fail(jid, payload, fatal=True)
            else:
                self.queue.quarantine(jid, payload)
            n += 1
            now += 1.0
        complete = not self.queue.pending()
        self._write_manifest(complete)
        self.queue.close()
        return 0 if complete else 1


def _fake_prewarm(m):
    def prewarm(specs):
        reps = {}
        for s in specs:
            reps.setdefault(m.affinity_key(s), s)
        return [{"affinity_key": ak, "key": "pk" + ak[2:], "hit": True}
                for ak in sorted(reps)]
    return prewarm


def _driver(m, d, spec, **kw):
    runner_kw = kw.pop("runner_kw", {})
    kw.setdefault("prewarm", _fake_prewarm(m))
    kw.setdefault("make_runner", lambda fd, p, specs, **rkw: FakeRunner(
        m, fd, p, specs, **rkw, **runner_kw))
    return m.driver.SweepDriver(str(d), spec, fsync=False,
                                now=lambda: 0.0, **kw)


def _frames(path, m):
    """A journal's frames without their wall-clock `t`."""
    frames, _ = m.journal.replay(path)
    return [{k: v for k, v in f.items() if k != "t"} for f in frames]


def _artifacts(d, m):
    """What a sweep dir holds, wall-clock fields aside: both journals'
    frames, the sweep report and the manifest's sweep block and job
    results, as JSON text."""
    rep = json.load(open(os.path.join(d, "sweep_report.json")))
    man = json.load(open(os.path.join(d, "fleet_manifest.json")))
    return {"sweep_log": _frames(os.path.join(d, "sweep.log"), m),
            "journal": _frames(os.path.join(d, "journal.log"), m),
            "report": json.dumps(rep, sort_keys=True),
            "sweep": json.dumps(man["sweep"], sort_keys=True),
            "jobs": json.dumps({j: (e["status"], e["result"])
                                for j, e in man["jobs"].items()},
                               sort_keys=True)}


def test_driver_grid_and_divergent_points_equal_reference(tmp_path):
    """A grid, and a grid whose points fail or are quarantined: equal
    exits, journals, reports and blocks; the lint accepts both."""
    lint = load_tool("telemetry_lint")

    def outcome(m):
        def go(s):
            if s.seed == 1 and s.event_capacity == 24:
                return ("fail", {"kind": "boom", "message": "died"})
            if s.seed == 2 and s.event_capacity == 24:
                return ("quarantine", "poison pill")
            return ("done", _synthetic_result(m, s))
        return go

    def go(m, name):
        out = {}
        for case in ("grid", "divergent"):
            d = tmp_path / name / case
            kw = ({} if case == "grid" else
                  {"runner_kw": {"outcome": outcome(m)}})
            drv = _driver(m, d, m.plan.SweepSpec.from_obj(_spec_obj()), **kw)
            out[case] = (drv.run(), _artifacts(str(d), m))
            man = json.load(open(d / "fleet_manifest.json"))
            errors, _ = lint.lint_fleet_manifest_obj(man)
            assert errors == [], errors
        return out

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    rc, art = got["port"]["grid"]
    rep = json.loads(art["report"])
    assert rc == 0 and rep["best"] == "p0003"
    assert rep["points"]["completed"] == 4
    rc, art = got["port"]["divergent"]
    rep = json.loads(art["report"])
    assert rc == 0 and rep["best"] == "p0003"
    assert (rep["points"]["failed"], rep["points"]["quarantined"]) == (1, 1)


def test_driver_preempt_resume_zero_rerun_equal_reference(tmp_path):
    """Preempted after 2 of 4 points and resumed: the completed points
    are not run again, the ranking is the uninterrupted sweep's, and a
    resume of a complete sweep runs nothing — in both packages, with
    equal journals and reports."""
    def go(m, name):
        spec = m.plan.SweepSpec.from_obj(_spec_obj())
        control = _driver(m, tmp_path / name / "control", spec)
        assert control.run() == 0
        want = control.report()["ranking"]
        d = tmp_path / name / "s"
        first, second, third = [], [], []
        rc1 = _driver(m, d, spec, runner_kw={"max_jobs": 2,
                                             "executed": first}).run()
        rc2 = _driver(m, d, spec, resume=True,
                      runner_kw={"executed": second}).run()
        ranking = _driver(m, d, spec, resume=True).report()["ranking"]
        rc3 = _driver(m, d, spec, resume=True,
                      runner_kw={"executed": third}).run()
        return ((rc1, rc2, rc3), first, second, third,
                json.dumps(ranking) == json.dumps(want),
                _artifacts(str(d), m))

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    rcs, first, second, third, same, _ = got["port"]
    assert rcs == (tdriver.EXIT_PREEMPTED, 0, 0) and same
    assert len(first) == 2 and not set(first) & set(second)
    assert sorted(first + second) == [f"r0-p000{i}" for i in range(4)]
    assert third == []


def test_driver_refuses_used_dir_changed_spec_and_tampered_journal(
        tmp_path):
    def go(m, name):
        out = []
        spec = m.plan.SweepSpec.from_obj(_spec_obj())
        d = tmp_path / name / "s"
        assert _driver(m, d, spec).run() == 0
        with pytest.raises(FileExistsError):
            _driver(m, d, spec)
        obj = _spec_obj()
        obj["template"]["hosts"] = 8
        with pytest.raises(m.driver.SweepError, match="spec changed") as e:
            _driver(m, d, m.plan.SweepSpec.from_obj(obj), resume=True)
        out.append(str(e.value))
        # a doctored round-0 table fails the re-derivation
        hspec = m.plan.SweepSpec.from_obj(_halving_obj())
        h = tmp_path / name / "h"
        assert _driver(m, h, hspec).run() == 0
        jpath = str(h / "sweep.log")
        frames, _ = m.journal.replay(jpath)
        for fr in frames:
            if fr.get("ev") == "round_reduced" and fr["round"] == 0:
                fr["table"] = list(reversed(fr["table"]))
        os.unlink(jpath)
        with m.journal.Journal(jpath, fsync=False) as J:
            for fr in frames:
                J.append(fr)
        with pytest.raises(m.driver.SweepError,
                           match="does not re-derive") as e:
            _driver(m, h, hspec, resume=True).run()
        out.append(str(e.value))
        return out

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]


def test_driver_halving_rounds_equal_reference(tmp_path):
    """Halving over the double: 4 -> 2 -> 1 with the budget doubling,
    the same rounds, prunes and lineage as the reference's, and a
    resume that replays every round and runs nothing."""
    lint = load_tool("telemetry_lint")

    def go(m, name):
        spec = m.plan.SweepSpec.from_obj(_halving_obj(budget_scale=2))
        d = tmp_path / name
        assert _driver(m, d, spec).run() == 0
        again = []
        assert _driver(m, d, spec, resume=True,
                       runner_kw={"executed": again}).run() == 0
        man = json.load(open(d / "fleet_manifest.json"))
        errors, _ = lint.lint_fleet_manifest_obj(man)
        assert errors == [], errors
        return again, _artifacts(str(d), m)

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    again, art = got["port"]
    rep = json.loads(art["report"])
    assert again == [] and len(rep["rounds"]) == 3
    assert [r["overrides"] for r in rep["rounds"]] == [
        {}, {"sim_s": 2}, {"sim_s": 4}]
    assert rep["best"] == "p0003" and rep["jobs_expanded"] == 7


# ------------------------------------------------------- status folds

def test_fleet_status_and_sweep_cli_equal_reference(tmp_path, capsys):
    def go(m, name):
        d = tmp_path / name
        assert _driver(m, d, m.plan.SweepSpec.from_obj(_spec_obj())).run() \
            == 0
        capsys.readouterr()
        out = []
        for mod, argv in (
                (m.fleet_cli, ["status", "--fleet-dir", str(d)]),
                (m.sweep_cli, ["status", "--sweep-dir", str(d)]),
                (m.sweep_cli, ["report", "--sweep-dir", str(d), "--top",
                               "2"]),
                (m.sweep_cli, ["status", "--sweep-dir",
                               str(tmp_path / "empty")]),
                (m.sweep_cli, ["report", "--sweep-dir",
                               str(tmp_path / "empty")])):
            rc = mod.main(argv)
            text = capsys.readouterr().out
            body = json.loads(text) if text.strip() else None
            for k in ("journal_bytes", "manifest", "report",
                      "checkpoints"):
                if isinstance(body, dict):
                    body.pop(k, None)
            out.append((rc, body))
        return out

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    (rc, fleet), (_, status), (_, rep), (e1, _), (e2, _) = got["port"]
    assert rc == 0 and fleet["sweep"]["rounds"] == [
        {"planned": 4, "done": 4, "failed": 0, "quarantined": 0,
         "pending": 0, "pruned": 0, "reduced": True}]
    assert status["complete"] and len(rep["ranking"]) == 2
    assert (e1, e2) == (2, 2)


# ------------------------------------------------------------ the lint

def _negative_cases():
    def pend(m):
        m["sweep"]["points"]["pruned"] = 2
        m["sweep"]["points"]["pending"] = 1

    def flip(m):
        m["sweep"]["rounds"][0]["ranking"] = list(
            reversed(m["sweep"]["rounds"][0]["ranking"]))

    def wrong_survivor(m):
        m["sweep"]["rounds"][1]["points"] = ["p0000", "p0002"]

    def drop_census(m):
        progs = m["sweep"]["census"]["programs"]
        del progs[sorted(progs)[0]]
        m["sweep"]["census"]["distinct"] = len(progs)

    def cold(m):
        m["sweep"]["prewarm"]["keys"] = m["sweep"]["prewarm"]["keys"][:1]

    return [None,
            lambda m: m["sweep"]["points"].__setitem__("completed", 0),
            pend, flip, wrong_survivor, drop_census,
            lambda m: m["sweep"].__setitem__("best", "p0000"), cold]


def test_lint_sweep_negative_cases_on_port_manifests(tmp_path):
    """tools/telemetry_lint.py on the port's halving sweep manifest: clean,
    and each of test_lint_sweep_negative_cases' doctorings gives the same
    errors and warnings as on the reference's."""
    lint = load_tool("telemetry_lint")

    def go(m, name):
        d = tmp_path / name
        spec = m.plan.SweepSpec.from_obj(_halving_obj())
        assert _driver(m, d, spec).run() == 0
        man = json.load(open(d / "fleet_manifest.json"))
        out = []
        for mutate in _negative_cases():
            doc = copy.deepcopy(man)
            if mutate is not None:
                mutate(doc)
            out.append(lint.lint_fleet_manifest_obj(doc))
        return out

    got = {name: go(m, name) for name, m in PKGS.items()}
    assert got["port"] == got["ref"]
    res = got["port"]
    assert res[0] == ([], [])
    assert any("not conserved" in e for e in res[1][0])
    assert any("pending" in e for e in res[2][0])
    assert any("does not re-derive" in e for e in res[3][0])
    assert any("census" in e for e in res[5][0])
    assert any("top eligible" in e for e in res[6][0])
    assert any("never warmed" in w for w in res[7][1])


# ----------------------------------------------------- the real engine

# an 8-host PHOLD 2 x 2 grid: 2 distinct programs (event_capacity 24 and
# 48 are buckets 32 and 64); a sleep a round so a kill lands mid-sweep
REAL = {
    "sweep": {"id": "real",
              "objective": {"metric": "events", "goal": "max"},
              "search": {"strategy": "grid"}},
    "fleet": {"max_attempts": 3, "backoff_base_s": 0.0,
              "backoff_cap_s": 0.0},
    "template": {"kind": "scenario", "hosts": 8, "sim_s": 1, "load": 2,
                 "round_sleep_s": 0.05},
    "axes": [{"field": "seed", "values": [1, 2]},
             {"field": "event_capacity", "values": [24, 48]}],
}


def _ref_points(tmp):
    """{pid: (events_processed, digest)} of the reference's run_job on
    each point's spec, in process (no sleep: it shapes no state)."""
    spec = jplan.SweepSpec.from_obj(copy.deepcopy(REAL))
    out = {}
    for p in jplan.expand(spec):
        js = spec.point_spec(p, 0, {"round_sleep_s": 0.0})
        res = jrun_job(js, os.path.join(tmp, p.pid))
        assert res["ok"], res
        out[p.pid] = (res["counters"]["events_processed"], res["digest"])
    return out


def _journal_status(d):
    recs, _ = tjournal.replay(os.path.join(d, "journal.log"))
    st = {}
    for r in recs:
        if r.get("job"):
            st.setdefault(r["job"], []).append(r["ev"])
    return st


def _sweep_cmd(d, *extra):
    return [sys.executable, "-m", "shadow_tpu_torch.cli", "sweep", "run",
            "--sweep-dir", d, "--workers", "2", "--platform", "cpu",
            "--no-fsync", *extra]


def _port_control(tmp, env):
    """The uninterrupted port sweep, through the CLI."""
    spec_path = os.path.join(tmp, "real.json")
    r = subprocess.run(_sweep_cmd(os.path.join(tmp, "control"), "--spec",
                                  spec_path),
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.load(open(os.path.join(tmp, "control",
                                       "sweep_report.json")))


def _port_killed(tmp, env):
    """`sweep run` SIGKILLed (its whole process group: the driver and
    its workers) after the first completed point, then `--resume`."""
    spec_path = os.path.join(tmp, "real.json")
    d = os.path.join(tmp, "killed")
    proc = subprocess.Popen(_sweep_cmd(d, "--spec", spec_path), cwd=ROOT,
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True)
    try:
        t_end = time.time() + 300
        done = []
        while time.time() < t_end and not done:
            assert proc.poll() is None, "the sweep ended before the kill"
            done = [j for j, evs in _journal_status(d).items()
                    if "done" in evs]
            time.sleep(0.05)
        assert done, "no point completed within 300 s"
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
    before = set(j for j, evs in _journal_status(d).items()
                 if "done" in evs)
    r = subprocess.run(_sweep_cmd(d, "--resume"), cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return (proc.returncode, before, _journal_status(d),
            json.load(open(os.path.join(d, "sweep_report.json"))),
            json.load(open(os.path.join(d, "fleet_manifest.json"))))


def test_real_sweep_killed_and_resumed_equals_control_and_reference(
        tmp_path):
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "real.json"), "w") as f:
        json.dump(REAL, f)
    env = dict(os.environ, SHADOW_AOT_DIR=os.path.join(tmp, "aot"))
    env.pop("SHADOW_NO_COMPILE_CACHE", None)
    env.pop("SHADOW_WARM_PROGRAMS", None)
    ref, control, killed = side_by_side([
        lambda: _ref_points(os.path.join(tmp, "ref")),
        lambda: _port_control(tmp, env), lambda: _port_killed(tmp, env)])
    rc, before, status, rep, man = killed
    assert rc == -signal.SIGKILL
    assert 0 < len(before) < 4
    # zero re-execution: a point done before the kill was leased once
    for jid in before:
        assert status[jid].count("leased") == 1, (jid, status[jid])
    assert all(evs.count("done") == 1 for evs in status.values())
    assert len(status) == 4
    assert json.dumps(rep["ranking"], sort_keys=True) == \
        json.dumps(control["ranking"], sort_keys=True)
    assert rep["best"] == control["best"]
    assert rep["census"]["distinct"] == 2
    errors, _ = load_tool("telemetry_lint").lint_fleet_manifest_obj(man)
    assert errors == [], errors
    # every point as the reference's run_job of its spec
    for pid, want in ref.items():
        res = man["jobs"][f"r0-{pid}"]["result"]
        assert (res["counters"]["events_processed"], res["digest"]) \
            == want, pid
    rows = {r["point"]: r["value"] for r in rep["ranking"]}
    assert rows == {pid: ev for pid, (ev, _) in ref.items()}
