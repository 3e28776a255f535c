"""The port's supervised window loop (shadow_tpu_torch.faults.supervisor,
escalate) against the reference's, on the CPU, with the fault plan of
tests/test_torch_faults.py (PHOLD at 8 hosts, load 2, 1 sim-s):

- a supervised run at K = 1 (checkpoint every 4 windows, a
  conserve.sample at every barrier) equal to the reference's: final
  state, stats, snapshot times and the sample sequence; at K = 4 and
  with the adaptive rule too;
- preemption and resume: a snapshot of each package, taken at the 7th
  barrier, resumed in the other, ends leaf-equal to the straight run,
  with the chain's totals and run id carried;
- retries with exponential backoff on a poisoned latch (the reference's
  report), the stall and time-regression latches, the wallclock
  deadline, refusals of the unported arguments;
- escalation: an undersized event queue healed without a retry into the
  from-scratch run at the grown capacity; the grow budget; plan_growth
  and the transplant of a reference snapshot into a grown template,
  equal to the reference's transplant;
- `python -m shadow_tpu_torch.bench` with --faults, BENCH_SUPERVISE=1
  and the loop-shaping knobs, and bench.py's refusals.

One reference program (the per-window step) is compiled for the file.
Tolerance zero.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.faults import conserve as jconserve
from shadow_tpu.faults import escalate as jescalate
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.faults import conserve as tconserve
from shadow_tpu_torch.faults import escalate as tescalate
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt
from torch_parity import bench_in_process

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEC = simtime.ONE_SECOND
K = jfaults.FaultKind
PLAN = [
    (int(0.3 * SEC), K.LOSS, 0, 0, 200_000),
    (int(0.4 * SEC), K.CRASH, 3, -1, 0),
    (int(0.5 * SEC), K.LINK_UP, 0, 0, 0),
    (int(0.6 * SEC), K.RESTART, 3, -1, 0),
    (int(0.7 * SEC), K.LATENCY, 0, 0, 5_000_000),
]
EVERY = 4       # checkpoint cadence, windows
STOP_AT = 7     # the preempted runs stop at this barrier


def _caps(**kw):
    return dict({"event_capacity": 32, "outbox_capacity": 32,
                 "router_ring": 32}, **kw)


def _bundle(pkg, caps=None, plan=True):
    caps = caps or _caps()
    if pkg == "jax":
        mod, phold, faults, cfg, dev = (jbuild, jphold, jfaults, JConfig,
                                        {})
    else:
        mod, phold, faults, cfg, dev = (tbuild, tphold, tfaults, TConfig,
                                        {"device": "cpu"})
    hosts = [mod.HostSpec(name=f"p{i}", proc_start_time=0) for i in range(8)]
    b = mod.build(cfg(num_hosts=8, tcp=False, end_time=SEC, seed=7,
                      in_ring=8, **caps), ONE_VERTEX, hosts, **dev)
    b.sim = phold.setup(b.sim, load=2)
    if plan:
        faults.install(b, [faults.FaultRecord(t_ns=t, kind=k, a=a, b=bb,
                                              value=v)
                           for t, k, a, bb, v in PLAN])
    return b


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _stats(stats):
    return {k: int(getattr(stats, k)) for k in (
        "events_processed", "micro_steps", "windows", "fastpath_hit",
        "fastpath_miss")}


def _supervise(pkg, path, stop_at=None, resume_from=None, **kw):
    """A supervised run with a conserve sample at every barrier; the run
    stops (preempts) at barrier `stop_at`."""
    faults, conserve = ((jfaults, jconserve) if pkg == "jax"
                        else (tfaults, tconserve))
    if pkg == "port":
        kw["device"] = "cpu"
    samples, total = [], [0]

    def on_round(sim, wstats, wstart, wend, next_min):
        total[0] += int(wstats.events_processed)
        samples.append(conserve.sample(sim, wstart=wstart, wend=wend,
                                       next_min=next_min,
                                       processed_total=total[0]))

    res = faults.run_supervised(
        _bundle(pkg), (jphold.handler if pkg == "jax" else tphold.handler,),
        checkpoint_path=str(path), checkpoint_every_windows=EVERY,
        sleep=lambda s: None, on_round=on_round, resume_from=resume_from,
        stop=(None if stop_at is None else lambda: len(samples) >= stop_at),
        **kw)
    return res, samples


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's straight supervised run and its preempted run."""
    d = tmp_path_factory.mktemp("ref")
    straight, samples = _supervise("jax", d / "straight")
    stopped, _ = _supervise("jax", d / "stopped", stop_at=STOP_AT)
    assert straight.ok and stopped.preempted
    return {"leaves": _jax_leaves(straight.sim),
            "stats": _stats(straight.stats), "res": straight,
            "samples": [s.as_dict() for s in samples], "stopped": stopped,
            "dir": d}


# ------------------------------------------------------- supervised runs


def test_supervised_run_matches_reference(ref, tmp_path):
    res, samples = _supervise("port", tmp_path / "ck")
    assert res.ok and res.attempts == 1 and not res.health.fatal
    _assert_leaves_equal(ref["leaves"], convert.sim_to_numpy(res.sim))
    assert _stats(res.stats) == ref["stats"]
    assert [t for _, t in res.checkpoints] == \
        [t for _, t in ref["res"].checkpoints]
    assert res.dispatch_windows == ref["res"].dispatch_windows
    assert sum(res.dispatch_windows) == ref["stats"]["windows"]
    assert [s.as_dict() for s in samples] == ref["samples"]
    # the crash flushes host 3's row non-conservatively, by design: the
    # checker flags the same windows in both packages
    assert tconserve.check(samples) == jconserve.check(
        [jconserve.WindowSample(**s) for s in ref["samples"]])
    assert res.health.failure_report() == ref["res"].health.failure_report()


@pytest.mark.parametrize("kw", [dict(windows_per_dispatch=4),
                                dict(windows_per_dispatch=3,
                                     adaptive_jump=True)],
                         ids=["k4", "k3_adaptive"])
def test_supervised_chunks_end_in_the_same_state(ref, tmp_path, kw):
    res, _ = _supervise("port", tmp_path / "ck", **kw)
    assert res.ok
    leaves = convert.sim_to_numpy(res.sim)
    if not kw.get("adaptive_jump"):
        _assert_leaves_equal(ref["leaves"], leaves)
        assert _stats(res.stats) == ref["stats"]
    assert sum(res.dispatch_windows) == _stats(res.stats)["windows"]
    assert max(res.dispatch_windows) <= kw["windows_per_dispatch"]
    assert res.checkpoints


def test_conserve_holds_exactly_without_crash_records(tmp_path):
    """The degraded example plan (loss and latency only): the ledger is
    exact at every barrier."""
    b = _bundle("port", plan=False)
    text = (ROOT / "examples" / "faultplan_degraded.json").read_text()
    tfaults.install(b, [r for r in tfaults.records_from_json(text)
                        if r.t_ns < SEC] + [tfaults.FaultRecord(
                            t_ns=SEC // 2, kind=K.LOSS, a=0, b=0,
                            value=300_000)])
    samples, total = [], [0]

    def on_round(sim, wstats, wstart, wend, next_min):
        total[0] += int(wstats.events_processed)
        samples.append(tconserve.sample(sim, wstart=wstart, wend=wend,
                                        next_min=next_min,
                                        processed_total=total[0]))

    res = tfaults.run_supervised(b, (tphold.handler,),
                                 checkpoint_path=str(tmp_path / "ck"),
                                 on_round=on_round, device="cpu")
    assert res.ok and samples
    assert tconserve.check(samples) == []
    assert int(res.sim.net.ctr_drop_reliability.sum()) > 0


# ------------------------------------------------- preemption and resume


def test_preempted_snapshot_resumes_in_the_other_package(ref, tmp_path):
    port_stop, _ = _supervise("port", tmp_path / "stop", stop_at=STOP_AT)
    jstop = ref["stopped"]
    assert port_stop.preempted and not port_stop.ok
    assert port_stop.final_checkpoint.endswith(".npz")
    rep = port_stop.failure_report()
    assert rep["verdict"] == "preempted"
    assert rep["final_checkpoint"] == port_stop.final_checkpoint
    t = int(port_stop.final_checkpoint.rsplit(".", 2)[1])
    assert t == int(jstop.final_checkpoint.rsplit(".", 2)[1])
    assert _stats(port_stop.stats) == _stats(jstop.stats)

    # the reference's snapshot resumed in the port, and the port's in
    # the reference
    res_p, _ = _supervise("port", tmp_path / "p2",
                          resume_from=jstop.final_checkpoint)
    res_j, _ = _supervise("jax", tmp_path / "j2",
                          resume_from=port_stop.final_checkpoint)
    for res in (res_p, res_j):
        assert res.ok
        assert _stats(res.stats) == ref["stats"]
    _assert_leaves_equal(ref["leaves"], convert.sim_to_numpy(res_p.sim))
    _assert_leaves_equal(ref["leaves"], _jax_leaves(res_j.sim))
    assert res_p.resume_of == jstop.run_id
    assert res_j.resume_of == port_stop.run_id


def test_deadline_takes_a_final_snapshot(tmp_path):
    res = tfaults.run_supervised(
        _bundle("port"), (tphold.handler,),
        checkpoint_path=str(tmp_path / "ck"), max_run_wallclock=0.0,
        device="cpu")
    assert not res.ok and res.deadline_exceeded
    assert res.health.deadline_exceeded and res.health.fatal
    rep = res.failure_report()
    assert rep["verdict"] == "deadline"
    loaded, t, extra = tckpt.load(res.final_checkpoint, _bundle("port").sim)
    assert extra["stats"]["windows"] == 1 and t > 0


# ------------------------------------------------------- retry and latches


def _poisoned(pkg):
    b = _bundle(pkg)
    q = b.sim.events
    b.sim = b.sim.replace(events=q.replace(overflow=q.overflow + 1))
    return b


def test_poisoned_latch_retries_with_backoff_like_the_reference():
    reports = []
    for pkg, faults, handler, kw in (
            ("jax", jfaults, jphold.handler, {}),
            ("port", tfaults, tphold.handler, {"device": "cpu"})):
        slept = []
        res = faults.run_supervised(
            _poisoned(pkg), (handler,), checkpoint_path="/nonexistent/ck",
            max_retries=2, backoff_s=0.5, sleep=slept.append, **kw)
        assert not res.ok and res.attempts == 3
        assert slept == [0.5, 1.0]
        reports.append(res.failure_report())
    assert reports[1] == reports[0]
    assert any("event queue overflow" in d
               for d in reports[1]["diagnostics"])


@pytest.mark.parametrize("case", ["stall", "regression"])
def test_stall_and_regression_latches_trip(case, monkeypatch):
    """A run whose windows process nothing (stall) or whose next start
    precedes the window's (regression) trips its latch and retries."""
    def fake_run_windows(bundle, handlers, *, on_chunk, **kw):
        from shadow_tpu_torch.core.engine import EngineStats

        zero = EngineStats.create()
        one = zero.replace(windows=zero.windows + 1)
        for w in range(4):
            nm = (w + 1) * 10 if case == "stall" else -1
            on_chunk(bundle.sim, one, w * 10, w * 10 + 10, nm)
        raise AssertionError("the latch did not trip")

    monkeypatch.setattr(tckpt, "run_windows", fake_run_windows)
    slept = []
    res = tfaults.run_supervised(
        _bundle("port", plan=False), (tphold.handler,),
        checkpoint_path="/nonexistent/ck", stall_windows=3,
        max_retries=1, sleep=slept.append, device="cpu")
    assert not res.ok and res.attempts == 2 and len(slept) == 1
    h = res.health
    if case == "stall":
        assert h.stalled_windows == 3 and h.stall_limit == 3
        assert "stalled" in " ".join(h.failure_report()["diagnostics"])
    else:
        assert h.time_regression and h.window_start == 0


@pytest.mark.parametrize("arg,item", [
    ("mesh", 9), ("exchange_capacity", 9), ("elastic", 9),
    ("dispatch_wrap", 9), ("on_mesh_change", 9), ("warm_start", 11)])
def test_unported_arguments_are_refused(arg, item, tmp_path, ref,
                                        monkeypatch):
    """What is not ported raises naming its ROADMAP.md item. `mesh` and
    `exchange_capacity`, once refused, run: on a one-rank mesh (the
    sharded route at one shard, an exchange buffer past the outbox) the
    supervised run equals the serial one but for the outbox's narrow
    counters, which count per shard count (the reference's rule;
    tests/test_torch_parallel_dispatch.py holds two ranks to the
    reference's sharded run). `elastic`, `dispatch_wrap` and
    `on_mesh_change`, once refused, run against the reference: a
    dispatch poisoned at the 5th call steps one same-mesh retry (the
    elastic block, the final state and the stats the reference's); a
    counting wrap sees the reference's dispatches; a serial run never
    changes its mesh (tests/test_torch_elastic.py shrinks 4 ranks).
    `warm_start`, once refused, runs: on one program store a miss, then
    a hit, each equal to the reference's run, SupervisorResult.
    compile_info the final attempt's block (the reference's supervised
    run holds such a block too)."""
    if arg == "warm_start":
        monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "aot"))
        monkeypatch.delenv("SHADOW_WARM_PROGRAMS", raising=False)
        monkeypatch.delenv("SHADOW_NO_COMPILE_CACHE", raising=False)
        infos = []
        for i in range(2):
            res, _ = _supervise("port", tmp_path / f"ck{i}",
                                warm_start=True)
            assert res.ok
            _assert_leaves_equal(ref["leaves"],
                                 convert.sim_to_numpy(res.sim))
            assert _stats(res.stats) == ref["stats"]
            infos.append(res.compile_info)
        assert [i["hit"] for i in infos] == [False, True]
        assert infos[0]["key"] == infos[1]["key"] and infos[0]["stored"]
        assert sorted(ref["res"].compile_info) == ["key", "warm"]
        cold, _ = _supervise("port", tmp_path / "cold")
        assert sorted(cold.compile_info) == ["key", "warm"]
        assert cold.compile_info["warm"] is False
        return
    if arg in ("elastic", "dispatch_wrap", "on_mesh_change"):
        from shadow_tpu.parallel import elastic as jel
        from shadow_tpu_torch.parallel import elastic as tel

        out = {}
        for pkg, el in (("jax", jel), ("port", tel)):
            calls, changes = [], []

            def counting(fn, calls=calls):
                def dispatch(*a, **k):
                    calls.append(1)
                    return fn(*a, **k)
                return dispatch

            kw = {"elastic": {"elastic": el.ElasticPolicy(),
                              "dispatch_wrap": el.make_poisoned_dispatch(5)},
                  "dispatch_wrap": {"dispatch_wrap": counting},
                  "on_mesh_change": {
                      "elastic": el.ElasticPolicy(),
                      "on_mesh_change": lambda *a: changes.append(a)},
                  }[arg]
            res, _ = _supervise(pkg, tmp_path / pkg, **kw)
            assert res.ok and res.retries_used == 0 and changes == []
            out[pkg] = (res, len(calls))
        (jres, jcalls), (tres, tcalls) = out["jax"], out["port"]
        _assert_leaves_equal(ref["leaves"], convert.sim_to_numpy(tres.sim))
        assert _stats(tres.stats) == _stats(jres.stats) == ref["stats"]
        assert tres.elastic == jres.elastic
        assert tcalls == jcalls
        if arg == "elastic":
            assert [s["action"] for s in tres.elastic["ladder_steps"]] \
                == ["retry"]
        elif arg == "dispatch_wrap":
            assert tres.elastic is None and tcalls == ref["stats"]["windows"]
        return
    if arg in ("mesh", "exchange_capacity"):
        from shadow_tpu_torch.parallel import Mesh

        runs = []
        for i, kw in enumerate(({}, {"mesh": Mesh(1, device="cpu")})):
            if kw and arg == "exchange_capacity":
                kw["exchange_capacity"] = 1 << 20
            res = tfaults.run_supervised(
                _bundle("port", plan=False), (tphold.handler,),
                checkpoint_path=str(tmp_path / f"ck{i}"),
                checkpoint_every_windows=8, device="cpu", **kw)
            assert res.ok
            runs.append((convert.sim_to_numpy(res.sim),
                         res.stats.as_dict(), len(res.checkpoints)))
        (want, wst, wn), (got, gst, gn) = runs
        narrow = {".outbox.narrow_hit", ".outbox.narrow_miss",
                  ".outbox.max_occupied", ".outbox.route_elided"}
        assert sorted(want) == sorted(got)
        for k in sorted(set(want) - narrow):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert gst == wst and gn == wn > 0
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tfaults.run_supervised(_bundle("port", plan=False),
                               checkpoint_path="/nonexistent/ck",
                               device="cpu", **{arg: object()})


@pytest.mark.parametrize("arg", ["feeder", "on_lane_quarantine"])
def test_once_refused_arguments_run(arg, tmp_path):
    """A feeder (tests/test_torch_inject.py holds the tgen runs against
    the reference): tgen-kind events streamed into the PHOLD program
    under supervision land on run_windows' state, every one merged. A
    lane callback on a clean 2-lane program (tests/test_torch_lanes.py
    holds the lane surgery of a tripped lane): never called, no
    incident, the run equal to run_windows'."""
    from shadow_tpu_torch.core import lanes
    from shadow_tpu_torch.inject import Feeder, attach, manifest_block

    events = [{"t_ns": (1 + i) * 40_000_000, "host": i % 8, "kind": 24,
               "payload": [i]} for i in range(24)]
    seen = []
    out = []
    for sup in (True, False):
        b = _bundle("port", plan=False)
        if arg == "feeder":
            b.sim = attach(b.sim, 16)
            kw = {"feeder": Feeder(list(events))}
        else:
            b.sim = lanes.attach(b.sim, 2)
            kw = {}
        if sup:
            given = dict(kw)
            if arg == "on_lane_quarantine":
                given[arg] = seen.append
            res = tfaults.run_supervised(
                b, (tphold.handler,), checkpoint_path=str(tmp_path / "ck"),
                checkpoint_every_windows=4, device="cpu", **given)
            assert res.ok
            sim, stats = res.sim, res.stats
        else:
            sim, stats, _ = tckpt.run_windows(b, (tphold.handler,),
                                              device="cpu", **kw)
        out.append((convert.sim_to_numpy(sim), stats.as_dict(),
                    manifest_block(sim, kw["feeder"]) if kw else
                    lanes.lane_report(sim)))
        if sup and arg == "on_lane_quarantine":
            assert not res.lane_incidents and seen == []
            assert res.health.lanes_total == 2 and not res.health.fatal
    (a, sa, ba), (b_, sb, bb) = out
    assert sa == sb and ba == bb
    if arg == "feeder":
        assert ba["injected"] == 24
    else:
        assert [d["quarantined"] for d in ba] == [False, False]
        assert sum(d["events_exec"] for d in ba) == sa["events_processed"]
    _assert_leaves_equal(a, b_)


# -------------------------------------------------------------- escalation


def test_escalation_heals_without_consuming_retries(tmp_path):
    caps = _caps(event_capacity=1)   # trips at the first barrier

    def rebuild(overrides):
        caps.update(overrides)
        b = _bundle("port", dict(caps))
        b.sim = ttelemetry.attach(b.sim, capacity=64)
        return b

    start = _bundle("port", dict(caps))
    start.sim = ttelemetry.attach(start.sim, capacity=64)
    h = ttelemetry.Harvester()
    res = tfaults.run_supervised(
        start, (tphold.handler,), checkpoint_path=str(tmp_path / "ck"),
        checkpoint_every_windows=EVERY, max_retries=0, harvester=h,
        escalation=tfaults.EscalationPolicy(max_grow=8), rebuild=rebuild,
        device="cpu")
    assert res.ok and res.retries_used == 0
    assert res.escalation_restarts >= 1 and res.escalations
    assert all(e.knob == "event_capacity" and e.new == 2 * e.old
               for e in res.escalations)
    assert caps["event_capacity"] == res.escalations[-1].new > 1
    assert int(res.sim.events.overflow) == 0
    assert h.escalation_marks == [e.as_dict() for e in res.escalations]
    assert h.summary()["escalations"] == len(res.escalations)
    rep = res.failure_report()
    assert rep["retries_used"] == 0 and rep["escalations"]
    # bit-identical to never having been undersized
    ref = rebuild({})
    sim, _, _ = tckpt.run_windows(ref, (tphold.handler,), device="cpu")
    _assert_leaves_equal(convert.sim_to_numpy(sim),
                         convert.sim_to_numpy(res.sim))


def test_escalation_transplants_a_mid_run_snapshot(tmp_path):
    """A trip after the first snapshot heals from that snapshot: its
    leaves are padded into the grown shapes."""
    caps = _caps(event_capacity=8)
    seen = []

    def rebuild(overrides):
        caps.update(overrides)
        return _bundle("port", dict(caps))

    res = tfaults.run_supervised(
        _bundle("port", dict(caps)), (tphold.handler,),
        checkpoint_path=str(tmp_path / "ck"), checkpoint_every_windows=1,
        max_retries=0, escalation=tfaults.EscalationPolicy(),
        rebuild=rebuild, device="cpu", log=seen.append)
    assert res.ok and res.retries_used == 0 and res.escalations
    assert res.resumed_from and any("transplanting" in m for m in seen)
    sim, _, _ = tckpt.run_windows(rebuild({}), (tphold.handler,),
                                  device="cpu")
    _assert_leaves_equal(convert.sim_to_numpy(sim),
                         convert.sim_to_numpy(res.sim))


def test_grow_budget_exhaustion_falls_back_to_the_retry_path(tmp_path):
    caps = _caps(event_capacity=1)
    res = tfaults.run_supervised(
        _bundle("port", caps, plan=False), (tphold.handler,),
        checkpoint_path=str(tmp_path / "ck"), max_retries=0,
        escalation=tfaults.EscalationPolicy(max_grow=0),
        rebuild=lambda o: _bundle("port", caps, plan=False), device="cpu")
    assert not res.ok
    assert res.escalation_restarts == 0 and res.retries_used == 0
    rep = res.failure_report()
    assert rep["fatal"] is True and rep["events_overflow"] > 0


@pytest.mark.parametrize("latches,used,max_grow", [
    (dict(events_overflow=5), 0, 8),
    (dict(events_overflow=1, rq_overflow=2), 0, 3),
    (dict(outbox_overflow=1, rq_overflow=1), 2, 3),
    ({}, 0, 8),
])
def test_plan_growth_matches_reference(latches, used, max_grow):
    h = types.SimpleNamespace(**dict(
        {"events_overflow": 0, "outbox_overflow": 0, "rq_overflow": 0},
        **latches))
    caps = {"event_capacity": 24, "outbox_capacity": 8, "router_ring": 16}
    out = []
    for esc in (jescalate, tescalate):
        try:
            grow, events = esc.plan_growth(
                h, caps, esc.EscalationPolicy(max_grow=max_grow), used,
                time_ns=123)
            out.append((grow, [e.as_dict() for e in events]))
        except (ValueError, esc.GrowBudgetExceeded) as e:
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
    assert tescalate.plan_lane_regrow(7, caps) == \
        jescalate.plan_lane_regrow(7, caps)
    ev = tescalate.Escalation(1, "events_overflow", "event_capacity", 2, 4)
    assert tescalate.Escalation.from_dict(ev.as_dict()) == ev


def test_transplant_of_a_reference_snapshot_matches_reference(ref):
    path, _ = ref["res"].checkpoints[0]
    leaves, meta = jckpt.load_leaves(path)
    grown = _caps(event_capacity=64, router_ring=64)
    jsim, jt, jextra = jescalate.transplant(leaves, meta,
                                            _bundle("jax", grown).sim)
    tsim, tt, textra = tescalate.transplant(leaves, meta,
                                            _bundle("port", grown).sim)
    assert (tt, textra) == (jt, jextra)
    _assert_leaves_equal(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    with pytest.raises(ValueError, match="capacities only grow"):
        tescalate.transplant(leaves, meta, _bundle(
            "port", _caps(event_capacity=16)).sim)
    meta2 = dict(meta, capacities=dict(meta["capacities"], num_hosts=4))
    with pytest.raises(ValueError, match="host axis"):
        tescalate.transplant(leaves, meta2, _bundle("port", grown).sim)


def test_router_ring_rotation_and_lane_surgery_match_reference():
    R = 4
    src = np.array([[10, 11, 12, 13], [20, 21, 22, 23]])
    leaves = {".net.rq_src": src, ".net.rq_enq_ts": src * 100,
              ".net.rq_words": np.stack([src, src + 1], axis=-1),
              ".net.rq_head": np.array([1, 3]),
              ".net.rq_count": np.array([2, 2])}
    want = jescalate._rotate_router_ring(leaves)
    got = tescalate._rotate_router_ring(leaves)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got[".net.rq_head"] == 0).all() and R == src.shape[1]
    packed = {".events.time": np.arange(8 * 3).reshape(8, 3),
              ".net.rq_head": np.zeros(8, np.int32),
              ".net.latency_ns": np.zeros((1, 1)),
              ".lanes.flushed": np.arange(2)}
    meta = {"time_ns": 5, "capacities": {"num_hosts": 8}, "extra": {}}
    for lane in (0, 1):
        (wl, wm), (gl, gm) = (esc.extract_lane(packed, meta, lane, 2)
                              for esc in (jescalate, tescalate))
        assert gm == wm
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)


# ----------------------------------------------------------- bench rows


def _bench_start(*argv, **env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update({"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16",
                 "OMP_NUM_THREADS": "1"}, **env)
    return subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.bench", *argv], cwd=ROOT,
        env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _bench_finish(p):
    out, err = p.communicate(timeout=300)
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


PLAN_JSON = "examples/faultplan_degraded.json"

SUPERVISED = [
    (dict(BENCH_SUPERVISE="1"), "_supervised_chunk1_faults"),
    (dict(BENCH_SUPERVISE="1", BENCH_CHUNK_WINDOWS="8",
          BENCH_CHECKPOINT_WINDOWS="16", BENCH_FAULTS=PLAN_JSON),
     "_supervised_chunk8_faults"),
    (dict(BENCH_SUPERVISE="1", BENCH_CHUNK_WINDOWS="4",
          BENCH_ADAPTIVE_JUMP="1", BENCH_MIN_JUMP_MS="20"),
     "_supervised_chunk4_adaptive_mj20ms_faults"),
]


@pytest.fixture(scope="module")
def bench_rows():
    """The faulted, the plain and the supervised rows' processes, run
    side by side: {"faulted", "plain", suffix: CompletedProcess}."""
    procs = {"faulted": _bench_start("--faults", PLAN_JSON,
                                     BENCH_SIM_SECONDS="3"),
             "plain": _bench_start(BENCH_SIM_SECONDS="3")}
    for env, suffix in SUPERVISED:
        argv = () if "BENCH_FAULTS" in env else ("--faults", PLAN_JSON)
        procs[suffix] = _bench_start(*argv, BENCH_SIM_SECONDS="3", **env)
    return {k: _bench_finish(p) for k, p in procs.items()}


@pytest.fixture(scope="module")
def faulted_row(bench_rows):
    r = bench_rows["faulted"]
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_faults_row_is_named_and_degraded(faulted_row, bench_rows):
    assert faulted_row["metric"] == \
        "events_per_sec_per_chip@16hosts_phold_load8_faults"
    plain = bench_rows["plain"]
    assert plain.returncode == 0, plain.stderr
    # the plan's loss flaps drain PHOLD's circulating messages
    assert json.loads(plain.stdout)["events"] > faulted_row["events"] > 0


@pytest.mark.parametrize("env,suffix", SUPERVISED,
                         ids=["chunk1", "chunk8_checkpoints",
                              "chunk4_adaptive_mj"])
def test_supervised_rows_are_named_as_bench_py_names_them(
        faulted_row, bench_rows, env, suffix):
    r = bench_rows[suffix]
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == \
        "events_per_sec_per_chip@16hosts_phold_load8" + suffix
    # the same timed input (seed 2) and the same plan: the same events
    assert row["events"] == faulted_row["events"]
    if "BENCH_ADAPTIVE_JUMP" not in env:
        assert row["windows"] == faulted_row["windows"]


@pytest.mark.parametrize("argv,env,word", [
    (("--faults", PLAN_JSON), dict(BENCH_WORKLOAD="pingpong"), "--faults"),
    ((), dict(BENCH_WORKLOAD="pingpong", BENCH_MIN_JUMP_MS="5"),
     "BENCH_MIN_JUMP_MS"),
    ((), dict(BENCH_ADAPTIVE_JUMP="1"), "BENCH_ADAPTIVE_JUMP"),
    ((), dict(BENCH_CHECKPOINT_WINDOWS="8"), "BENCH_CHECKPOINT_WINDOWS"),
    ((), dict(BENCH_MIN_JUMP_MS="fast"), "BENCH_MIN_JUMP_MS"),
], ids=["faults_pingpong", "min_jump_pingpong", "adaptive_unsupervised",
        "checkpoints_unsupervised", "min_jump_nan"])
def test_bench_refusals(argv, env, word):
    r = bench_in_process(*argv, BENCH_PLATFORM="cpu", BENCH_HOSTS="16", **env)
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""
