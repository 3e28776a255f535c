"""Parity of the port's fault plans (shadow_tpu_torch.faults: plan,
apply, health, conserve) with the reference's (shadow_tpu.faults), on
the CPU:

- compile_plan arrays, validate_records errors and warnings and the
  JSON/config parsers on the repo's example plans and on PLAN (the
  shapes of tests/test_faults.py: PHOLD at 8 hosts, load 2, 1 sim-s;
  loss, crash, link up, restart, latency);
- make_table_fn at every record time t - 1, t and t + 1, including
  partitions, heals and seeded random loss values (float32 exact);
- the faulted run through make_runner, run_windows at K = 1 and K = 4,
  make_chunked_runner and run_supervised, each leaf-equal to the
  reference's make_runner, and run_windows with the adaptive rule
  leaf-equal to the reference's adaptive run_windows;
- the crash reset of TCP rows: a 3-host relay whose middle host
  crashes mid-transfer and restarts;
- health.gather and RunHealth reports, conserve.check and stitch.

Reference programs compiled for the file: PHOLD whole-run, PHOLD
adaptive chunk, and one TCP whole-run. Tolerance zero.
"""

import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.apps import relay as jrelay
from shadow_tpu.core import simtime
from shadow_tpu.faults import apply as japply
from shadow_tpu.faults import conserve as jconserve
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.apps import relay as trelay
from shadow_tpu_torch.bench import MIX_VERTICES, ONE_VERTEX
from shadow_tpu_torch.faults import apply as tapply
from shadow_tpu_torch.faults import conserve as tconserve
from shadow_tpu_torch.faults import health as thealth
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEC = simtime.ONE_SECOND
K = jfaults.FaultKind

# tests/test_faults.py's PLAN: (time, kind, a, b, value)
PLAN = [
    (int(0.3 * SEC), K.LOSS, 0, 0, 200_000),
    (int(0.4 * SEC), K.CRASH, 3, -1, 0),
    (int(0.5 * SEC), K.LINK_UP, 0, 0, 0),
    (int(0.6 * SEC), K.RESTART, 3, -1, 0),
    (int(0.7 * SEC), K.LATENCY, 0, 0, 5_000_000),
]


def _recs(mod, rows):
    return [mod.FaultRecord(t_ns=t, kind=k, a=a, b=b, value=v)
            for t, k, a, b, v in rows]


def _json_rows(name):
    obj = json.loads((ROOT / "examples" / name).read_text())
    return [(r.t_ns, r.kind, r.a, r.b, r.value)
            for r in jfaults.records_from_json(obj)]


def _mix_rows():
    """Every kind on MIX_VERTICES's 3 vertices, with seeded random loss
    values (the float32 arithmetic of 1 - v/PPM)."""
    rng = np.random.default_rng(11)
    rows = [(1_000_000, K.PARTITION, 1, -1, 0),
            (2_000_000, K.LOSS, 0, 2, 123_457),
            (2_000_000, K.LATENCY, 0, 1, 700_001),
            (3_000_000, K.HEAL, 1, -1, 0),
            (4_000_000, K.LINK_DOWN, 2, 2, 0),
            (5_000_000, K.LINK_UP, 2, 2, 0)]
    t = 6_000_000
    for v in rng.integers(0, 1_000_001, 12):
        a, b = (int(x) for x in rng.integers(0, 3, 2))
        rows.append((t, K.LOSS, a, b, int(v)))
        t += int(rng.integers(1, 3)) * 1_000_000
    return rows


PLANS = {"PLAN": (PLAN, ONE_VERTEX),
         "degraded": (_json_rows("faultplan_degraded.json"), ONE_VERTEX),
         "latency_spike": (_json_rows("faultplan_latency_spike.json"),
                           MIX_VERTICES),
         "mix": (_mix_rows(), MIX_VERTICES)}


def _cfg(cls, H=8, load=2, end=SEC, event_capacity=None):
    cap = max(32, 4 * load)
    return cls(num_hosts=H, tcp=False, end_time=end, seed=7,
               event_capacity=event_capacity or cap, outbox_capacity=cap,
               router_ring=cap, in_ring=max(8, 2 * load))


def _bundle(pkg, graph=ONE_VERTEX, rows=None, **kw):
    if pkg == "jax":
        mod, phold, faults, cfg, dev = (jbuild, jphold, jfaults, JConfig,
                                        {})
    else:
        mod, phold, faults, cfg, dev = (tbuild, tphold, tfaults, TConfig,
                                        {"device": "cpu"})
    H = kw.get("H", 8)
    hosts = [mod.HostSpec(name=f"p{i}", proc_start_time=0) for i in range(H)]
    b = mod.build(_cfg(cfg, **kw), graph, hosts, **dev)
    b.sim = phold.setup(b.sim, load=kw.get("load", 2))
    if rows is not None:
        faults.install(b, _recs(faults, rows))
    return b


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("name", list(PLANS))
def test_compile_plan_matches_reference(name):
    rows, graph = PLANS[name]
    V = 3 if graph is MIX_VERTICES else 1
    want = jfaults.compile_plan(_recs(jfaults, rows), num_hosts=8,
                                num_vertices=V)
    got = tfaults.compile_plan(_recs(tfaults, rows), num_hosts=8,
                               num_vertices=V)
    for col in ("t_ns", "kind", "a", "b", "value"):
        w, g = getattr(want, col), getattr(got, col)
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w, err_msg=col)
    assert (got.n, got.num_hosts, got.num_vertices) == (
        want.n, want.num_hosts, want.num_vertices)


BAD = [(2 * SEC, K.RESTART, 3, -1, 0), (1 * SEC, K.LOSS, 0, 1, 1_500_000),
       (3 * SEC, K.LINK_DOWN, 0, -1, 0), (4 * SEC, K.LATENCY, 0, 0, -5),
       (5 * SEC, K.CRASH, 99, -1, 0), (6 * SEC, K.CRASH, 2, -1, 0),
       (7 * SEC, K.CRASH, 2, -1, 0), (8 * SEC, 42, 0, 0, 0),
       (-1, K.PARTITION, 7, -1, 0)]


@pytest.mark.parametrize("rows,kw", [
    (BAD, dict(num_hosts=8, num_vertices=2)),
    (PLAN, dict(num_hosts=8, num_vertices=1, min_jump_ns=50_000_001)),
    (PLAN, {}),
], ids=["bad", "quantized", "unbounded"])
def test_validate_records_matches_reference(rows, kw):
    want = jfaults.validate_records(_recs(jfaults, rows), **kw)
    got = tfaults.validate_records(_recs(tfaults, rows), **kw)
    assert got == want
    if rows is BAD:
        assert len(got[0]) >= 8
        with pytest.raises(ValueError, match="invalid fault plan"):
            tfaults.compile_plan(_recs(tfaults, rows), num_hosts=8,
                                 num_vertices=2)


def test_records_from_json_and_config_match_reference():
    for name in ("faultplan_degraded.json", "faultplan_latency_spike.json"):
        text = (ROOT / "examples" / name).read_text()
        assert tfaults.records_from_json(text) == \
            [tfaults.FaultRecord(**vars(r))
             for r in jfaults.records_from_json(text)]
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.records_from_json({"faults": [{"kind": "melt", "a": 0}]})
    spec = types.SimpleNamespace
    config = spec(faults=[
        spec(time_ns=100, kind="crash", a="p3", b=None, value=None),
        spec(time_ns=200, kind="loss", a="p1", b="p2", value=0.25),
        spec(time_ns=300, kind="Latency", a="p0", b="0", value=0.002),
        spec(time_ns=400, kind="partition", a="p5", b=None, value=None),
        spec(time_ns=500, kind="restart", a="3", b=None, value=None)])
    want = jfaults.records_from_config(config, _bundle("jax", MIX_VERTICES))
    got = tfaults.records_from_config(config, _bundle("port", MIX_VERTICES))
    assert got == [tfaults.FaultRecord(**vars(r)) for r in want]
    bad = spec(faults=[spec(time_ns=1, kind="crash", a="nope", b=None,
                            value=None)])
    with pytest.raises(ValueError, match="not a known host"):
        tfaults.records_from_config(bad, _bundle("port"))


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("name", list(PLANS))
def test_table_fn_matches_reference_at_every_record(name):
    rows, graph = PLANS[name]
    jb, tb = _bundle("jax", graph, rows), _bundle("port", graph, rows)
    jfn = jax.jit(japply.make_table_fn(jb.fault_plan, jb.sim))
    tfn = tapply.make_table_fn(tb.fault_plan, tb.sim)
    times = sorted({0, simtime.INVALID} | {
        r[0] + d for r in rows for d in (-1, 0, 1)})
    for t in times:
        (jl, jr), (tl, tr) = jfn(t), tfn(t)
        jl, jr = np.asarray(jl), np.asarray(jr)
        assert (tl.dtype, tr.dtype) == (jl.dtype, jr.dtype)
        np.testing.assert_array_equal(tl, jl, err_msg=f"latency at {t}")
        np.testing.assert_array_equal(tr, jr, err_msg=f"reliability at {t}")
    assert tapply.make_table_fn(None, tb.sim) is None


def test_fault_fn_uploads_once_per_record_count():
    """Windows between two records reuse the uploaded tables (no launch
    per window), and the down vector changes only at crash records."""
    tb = _bundle("port", rows=PLAN)
    fn = tfaults.fault_fn_for(tb)
    a = fn(tb.sim, int(0.31 * SEC))
    b = fn(a, int(0.39 * SEC))
    assert b.net.reliability is a.net.reliability
    assert b.net.latency_ns is a.net.latency_ns
    assert float(a.net.reliability[0, 0]) == pytest.approx(0.8)
    c = fn(b, int(0.5 * SEC) + 1)
    assert c.net.reliability is not a.net.reliability
    assert float(c.net.reliability[0, 0]) == 1.0
    assert fn.replay.down(2).tolist() == [False] * 3 + [True] + [False] * 4
    assert not fn.replay.down(4).any()
    assert tfaults.make_fault_fn(None, tb.sim) is None
    assert tfaults.fault_fn_for(_bundle("port")) is None


def test_install_seeds_a_wakeup_per_record():
    jb, tb = _bundle("jax", rows=PLAN), _bundle("port", rows=PLAN)
    _assert_leaves_equal(_jax_leaves(jb.sim), convert.sim_to_numpy(tb.sim))
    q = tb.sim.events
    kinds = q.kind[q.time < simtime.INVALID].tolist()
    assert kinds.count(13) == 4     # FAULT_WAKEUP: loss, crash, up, latency
    assert tb.fault_plan.n == len(PLAN)


# ------------------------------------------------------- faulted PHOLD runs


@pytest.fixture(scope="module")
def ref():
    """The reference's faulted run through make_runner."""
    jb = _bundle("jax", rows=PLAN)
    sim, stats = jbuild.make_runner(jb, app_handlers=(jphold.handler,))(
        jb.sim)
    return _jax_leaves(sim), {k: int(getattr(stats, k))
                              for k in ("events_processed", "micro_steps",
                                        "windows")}


def _port_faulted(kind, tmp_path):
    tb = _bundle("port", rows=PLAN)
    h = (tphold.handler,)
    if kind == "make_runner":
        return tbuild.make_runner(tb, app_handlers=h, device="cpu")(tb.sim)
    if kind == "chunked_k3":
        return tbuild.make_chunked_runner(tb, app_handlers=h, chunk_windows=3,
                                          device="cpu")(tb.sim)
    if kind == "supervised":
        res = tfaults.run_supervised(
            tb, h, checkpoint_path=str(tmp_path / "ck"),
            checkpoint_every_windows=4, device="cpu")
        assert res.ok and res.checkpoints
        return res.sim, res.stats
    k = {"run_windows_k1": 1, "run_windows_k4": 4}[kind]
    sim, stats, _ = tckpt.run_windows(tb, h, windows_per_dispatch=k,
                                      device="cpu")
    return sim, stats


@pytest.mark.parametrize("kind", ["make_runner", "run_windows_k1",
                                  "run_windows_k4", "chunked_k3",
                                  "supervised"])
def test_faulted_run_matches_reference(ref, kind, tmp_path):
    want, want_stats = ref
    sim, stats = _port_faulted(kind, tmp_path)
    _assert_leaves_equal(want, convert.sim_to_numpy(sim))
    got = stats.as_dict()
    assert {k: got[k] for k in want_stats} == want_stats


def test_faulted_run_crash_semantics(ref):
    """The plan did something: host 3 re-ran its start handler after the
    restart and kept receiving; the loss flap dropped messages; the
    crash cut host 3's share against the fault-free run."""
    leaves, _ = ref
    assert int(leaves[".app.remaining"][3]) == 0
    assert int(leaves[".app.rcvd"][3]) > 0
    assert int(leaves[".net.ctr_drop_reliability"].sum()) > 0
    assert int(leaves[".events.overflow"]) == 0
    plain, _ = tbuild.make_runner(_bundle("port"),
                                  app_handlers=(tphold.handler,),
                                  device="cpu")(_bundle("port").sim)
    assert int(plain.app.rcvd.sum()) != int(leaves[".app.rcvd"].sum())


def test_adaptive_run_windows_with_plan_matches_reference():
    jb = _bundle("jax", rows=PLAN)
    jsim, jstats, _ = jckpt.run_windows(jb, (jphold.handler,),
                                        windows_per_dispatch=4,
                                        adaptive_jump=True)
    tb = _bundle("port", rows=PLAN)
    spans = []
    tsim, tstats, _ = tckpt.run_windows(
        tb, (tphold.handler,), windows_per_dispatch=4, adaptive_jump=True,
        device="cpu", on_chunk=lambda s, st, ws, we, nm: spans.append(we))
    _assert_leaves_equal(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    assert tstats.as_dict()["windows"] == int(jstats.windows)
    assert spans


def test_explicit_fault_fn_wins_and_adaptive_refuses_an_opaque_one():
    tb = _bundle("port", rows=PLAN)
    seen = []

    def fault_fn(sim, wend):
        seen.append(wend)
        return sim

    sim, _ = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                device="cpu", fault_fn=fault_fn)(tb.sim)
    assert seen and int(sim.net.ctr_drop_reliability.sum()) == 0
    plain = _bundle("port")
    with pytest.raises(ValueError, match="adaptive_jump requires"):
        tbuild.make_chunked_runner(plain, device="cpu", fault_fn=fault_fn,
                                   adaptive_jump=True)
    with pytest.raises(ValueError, match="adaptive_jump requires"):
        tckpt.run_windows(plain, device="cpu", fault_fn=fault_fn,
                          adaptive_jump=True)


# ------------------------------------------------------ TCP crash reset

RELAY_GRAPH = ONE_VERTEX.replace("<data key=\"lat\">50.0</data>",
                                 "<data key=\"lat\">25.0</data>").replace(
    "102400", "10240")
# a 3-host circuit (client, relay, server), 20,000 bytes; the relay
# crashes mid-transfer at 1.2 s and restarts at 2.0 s
RELAY_FAULTS = [(int(1.2 * SEC), K.CRASH, 1, -1, 0),
                (int(2.0 * SEC), K.RESTART, 1, -1, 0)]


def _relay(pkg):
    mod, relay, faults, cfg, dev = (
        (jbuild, jrelay, jfaults, JConfig, {}) if pkg == "jax" else
        (tbuild, trelay, tfaults, TConfig, {"device": "cpu"}))
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=SEC)
             for i in range(3)]
    b = mod.build(cfg(num_hosts=3, end_time=6 * SEC, sockets_per_host=4),
                  RELAY_GRAPH, hosts, **dev)
    b.sim = relay.setup(b.sim, circuits=[[0, 1, 2]], total_bytes=20_000)
    faults.install(b, _recs(faults, RELAY_FAULTS))
    return b


def test_relay_crash_restart_matches_reference():
    jb, tb = _relay("jax"), _relay("port")
    jsim, jstats = jbuild.make_runner(jb, app_handlers=(jrelay.handler,))(
        jb.sim)
    tsim, tstats = tbuild.make_runner(tb, app_handlers=(trelay.handler,),
                                      device="cpu")(tb.sim)
    _assert_leaves_equal(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    assert tstats.as_dict()["events_processed"] == \
        int(jstats.events_processed)
    # the crash cut the transfer short and the client retransmitted
    assert 0 < int(tsim.app.rcvd[2]) < 20_000
    assert int(tsim.tcp.retx_segs.sum()) > 0


# ------------------------------------------------------------ health


@pytest.mark.parametrize("fields", [
    dict(events_overflow=2, narrow_miss=3, window_start=123,
         suspect_hosts=(1, 4), stall_limit=512),
    dict(outbox_overflow=1, rq_overflow=2, time_regression=True),
    dict(stalled_windows=5, stall_limit=5, telemetry_lost=7),
    dict(deadline_exceeded=True, inject_dropped=2, inject_late=1,
         trace_warnings=("torn tail",)),
    dict(stall_limit=512),
], ids=["overflow", "outbox_rq_regress", "stall", "deadline", "clean"])
def test_run_health_reports_match_reference(fields):
    want = jfaults.RunHealth(**fields)
    got = tfaults.RunHealth(**fields)
    assert got.fatal == want.fatal
    assert got.diagnostics() == want.diagnostics()
    assert got.failure_report() == want.failure_report()


def _poisoned(pkg):
    """The boot state at event capacity 1 (every row full with its
    PROC_START) with the queue and outbox latches bumped."""
    sim = _bundle(pkg, event_capacity=1).sim
    q, out = sim.events, sim.outbox
    return sim.replace(events=q.replace(overflow=q.overflow + 1),
                       outbox=out.replace(overflow=out.overflow + 3))


def test_gather_on_a_poisoned_overflow_matches_reference():
    kw = dict(window_start=77, stalled_windows=2, stall_limit=9,
              telemetry_lost=1)
    want = jfaults.gather(_poisoned("jax"), **kw)
    got = tfaults.gather(_poisoned("port"), **kw)
    assert got.events_overflow > 0 and got.suspect_hosts
    assert got.failure_report() == want.failure_report()
    assert got == tfaults.RunHealth(**{
        f: getattr(want, f) for f in vars(want)})


@pytest.mark.parametrize("layer,item", [("lanes", 8), ("admission", 8),
                                        ("inject", 8), ("guard", 11),
                                        ("sentinel", 9)])
def test_gather_refuses_unported_layers(layer, item):
    sim = _bundle("port").sim
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        thealth.gather(sim.replace(**{layer: object()}))


# ----------------------------------------------------------- conserve


def _samples(mod):
    """A lawful 3-window ledger."""
    S = mod.WindowSample
    return [S(wstart=0, wend=10, next_min=10, pushed=10, processed=4,
              queued=6, outboxed=0, drops=0),
            S(wstart=10, wend=20, next_min=20, pushed=14, processed=9,
              queued=3, outboxed=2, drops=0),
            S(wstart=20, wend=30, next_min=25, pushed=15, processed=15,
              queued=0, outboxed=0, drops=0)]


@pytest.mark.parametrize("mutate", [
    None,
    lambda s: s[1].__dict__.update(pushed=13),
    lambda s: s[2].__dict__.update(processed=8),
    lambda s: s[2].__dict__.update(next_min=19),
    lambda s: s[1].__dict__.update(wstart=0),
    lambda s: s[0].__dict__.update(wend=0),
    lambda s: s[1].__dict__.update(drops=2, pushed=17),
    lambda s: s[1].__dict__.update(drops=2, pushed=15),
], ids=["lawful", "leak", "processed_back", "clock", "starts",
        "empty_window", "drops_out_of_bounds", "drops_in_bounds"])
def test_conserve_check_matches_reference(mutate):
    want, got = _samples(jconserve), _samples(tconserve)
    if mutate is not None:
        mutate(want)
        mutate(got)
    assert tconserve.check(got) == jconserve.check(want)
    if mutate is None:
        assert tconserve.check(got) == []


def test_conserve_stitch_and_lane_check_match_reference():
    before, after = _samples(tconserve), _samples(tconserve)[1:]
    got = tconserve.stitch(before, after, resume_time=10)
    assert [s.wstart for s in got] == [0, 10, 20]
    assert got[0].as_dict() == _samples(jconserve)[0].as_dict()
    L = [tconserve.LaneWindowSample(
        wstart=0, wend=10, pushed=(5, 6), processed=(2, 3), queued=(3, 2),
        outboxed=(0, 0), drops=(0, 0), flushed=(0, 1))]
    JL = [jconserve.LaneWindowSample(**L[0].as_dict())]
    assert tconserve.lane_check(L) == jconserve.lane_check(JL) == []
    L2 = [tconserve.LaneWindowSample(**dict(L[0].as_dict(), pushed=(5, 9)))]
    JL2 = [jconserve.LaneWindowSample(**L2[0].as_dict())]
    assert tconserve.lane_check(L2) == jconserve.lane_check(JL2) != []


def test_conserve_sample_reads_the_ledger():
    tb = _bundle("port", rows=PLAN)
    s = tconserve.sample(tb.sim, wstart=0, wend=1, next_min=0,
                         processed_total=0)
    q = tb.sim.events
    assert s.pushed == int(q.next_seq.sum()) == s.queued
    assert s.outboxed == 0 and s.drops == 0
    assert tconserve.check([s]) == []
