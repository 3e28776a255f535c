"""Open-system injection in the port (shadow_tpu_torch.inject) against the
reference's (shadow_tpu.inject), on the CPU:

- the trace formats: both packages write the same bytes and read the
  same records; a torn tail truncates with the reference's warning, a
  mid-file CRC error raises;
- merge_staged on the same staged planes gives the reference's queue,
  counters and window deltas (plain, late and row-full cases);
- a streamed run at 8 hosts (40 events through 16 lanes, one window a
  dispatch) is leaf-equal to shadow_tpu's, staging planes included;
- within the port: fill_all equals streaming, K = 1 equals K = 64,
  row-full drops land on inject.dropped (a health warning), not the
  engine latch, and events past end-of-run stay deferred;
- a mid-trace snapshot resumes in the other package with nothing
  replayed or dropped, both ways;
- a burst wider than the lanes stalls with the reference's error;
- the manifest block passes the reference's tools/telemetry_lint.py.

One reference program (the per-window step of the tgen app at 8 hosts,
16 lanes) is compiled for the file. Tolerance zero.
"""

import json

import jax
import numpy as np
import pytest
import torch
from conftest import load_tool

from shadow_tpu.apps import tgen as jtgen
from shadow_tpu.inject import Feeder as JFeeder
from shadow_tpu.inject import manifest_block as jmanifest_block
from shadow_tpu.inject import read_trace as jread_trace
from shadow_tpu.inject import staging as jstaging
from shadow_tpu.inject import write_trace as jwrite_trace
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import tgen
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.faults import health
from shadow_tpu_torch.inject import (
    Feeder,
    manifest_block,
    read_trace,
    staging,
    write_trace,
)
from shadow_tpu_torch.inject.trace import TraceFormatError
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND

# the staging planes are feeder-written scratch (consumed lanes keep
# their residue; the horizon tracks host refill pacing), excluded where
# the refill pacing differs; the device counters stay compared
INJECT = {".inject.time", ".inject.host", ".inject.kind",
          ".inject.seq", ".inject.words", ".inject.horizon"}
# event-heap slot planes: a different refill pacing feeds the heap in
# different batches, which permutes slot assignment; the live event
# multiset is compared instead (tests/test_inject.py's carve-out)
EVENT_SLOTS = {f".events.{n}" for n in ("time", "kind", "src", "seq",
                                        "words")}
# route watermarks count per window: the chunked loop's horizon clamp
# splits one window more than the per-window loop (19 against 18 here,
# as in the reference; tests/test_inject.py's TELEMETRY carve-out)
ROUTE_MARKS = {".outbox.max_occupied", ".outbox.narrow_hit",
               ".outbox.narrow_miss"}
DEV_KEYS = ("lanes", "injected", "dropped", "late", "deferred",
            "trace_events")


def _trace(n=40, H=8, start=SEC // 10, step=SEC // 50, dst_of=None):
    """n KIND_TGEN datagram events, round-robin source, `step` apart."""
    return [{"t_ns": start + i * step, "host": i % H,
             "kind": tgen.KIND_TGEN,
             "payload": [dst_of(i % H) if dst_of else (i % H + 1) % H,
                         9100, 64]} for i in range(n)]


def _cfg(lanes=16, cap=64, sim_s=1):
    return dict(num_hosts=8, tcp=False, end_time=sim_s * SEC, seed=7,
                event_capacity=cap, outbox_capacity=cap, router_ring=cap,
                in_ring=16, inject_lanes=lanes)


def _jax_bundle(**kw):
    hosts = [jbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(8)]
    b = jbuild.build(JConfig(**_cfg(**kw)), ONE_VERTEX, hosts)
    b.sim = jtgen.setup(b.sim)
    return b


def _port_bundle(**kw):
    hosts = [tbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(8)]
    b = tbuild.build(TConfig(**_cfg(**kw)), ONE_VERTEX, hosts, device="cpu")
    b.sim = tgen.setup(b.sim)
    return b


def _port_run(events, K=None, **kw):
    b = _port_bundle(**kw)
    f = Feeder(list(events))
    sim, stats, _ = tckpt.run_windows(
        b, (tgen.handler,), feeder=f, windows_per_dispatch=K, device="cpu")
    return sim, stats.as_dict(), f


def _jax_run(events, **kw):
    b = _jax_bundle(**kw)
    f = JFeeder(list(events))
    sim, stats, _ = jckpt.run_windows(b, (jtgen.handler,), feeder=f)
    return sim, _jax_stats(stats), f


def _jax_stats(stats):
    return {k: int(getattr(stats, k)) for k in (
        "events_processed", "micro_steps", "windows", "fastpath_hit",
        "fastpath_miss")}


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves(want, got, exclude=()):
    assert sorted(want) == sorted(got)
    for k in want:
        if k in exclude:
            continue
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype,
                                               got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _live_events(leaves):
    """Per-host sorted multiset of live (time < INVALID) event slots."""
    t = leaves[".events.time"]
    out = []
    for h in range(t.shape[0]):
        m = t[h] < simtime.INVALID
        cols = [leaves[f".events.{n}"][h][m].tolist()
                for n in ("time", "kind", "src", "seq")]
        cols.append(leaves[".events.words"][h][m].sum(axis=1).tolist())
        out.append(sorted(zip(*cols)))
    return out


def _dev(blk):
    return {k: blk[k] for k in DEV_KEYS}


# ------------------------------------------------------------ trace I/O


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_trace_round_trip_matches_reference(tmp_path, binary):
    evs = _trace(n=17)
    p, q = str(tmp_path / "port.trace"), str(tmp_path / "ref.trace")
    assert write_trace(p, evs, binary=binary) == 17
    assert jwrite_trace(q, evs, binary=binary) == 17
    assert open(p, "rb").read() == open(q, "rb").read()
    back = list(read_trace(p))
    assert back == list(jread_trace(p))
    assert back == [dict(e, payload=list(e["payload"])) for e in evs]


def _binary(tmp_path, n=5):
    p = str(tmp_path / "torn.trace")
    evs = [{"t_ns": 10 * i, "host": 0, "kind": 7, "payload": [i]}
           for i in range(n)]
    assert write_trace(p, evs, binary=True) == n
    return p, open(p, "rb").read()


def _torn(raw, how):
    if how == "short_header":
        return raw + raw[:5]
    if how == "short_payload":
        return raw[:-3]
    b = bytearray(raw)
    b[-4] ^= 0xFF                     # a payload byte of the last frame
    return bytes(b)


@pytest.mark.parametrize("how", ["short_header", "short_payload",
                                 "crc_tail"])
def test_torn_tail_truncates_with_the_reference_warning(tmp_path, how):
    p, raw = _binary(tmp_path)
    open(p, "wb").write(_torn(raw, how))
    got_w, want_w = [], []
    got = list(read_trace(p, on_warning=got_w.append))
    want = list(jread_trace(p, on_warning=want_w.append))
    assert got == want and got_w == want_w and len(got_w) == 1
    assert "truncated" in got_w[0]
    assert len(got) == (5 if how == "short_header" else 4)
    # the feeder keeps the warning for the manifest and health report
    f = Feeder(p)
    list(iter(lambda: f._read_next(), None))
    assert f.stats()["trace_warnings"] == got_w


def test_mid_file_crc_error_raises(tmp_path):
    p, raw = _binary(tmp_path)
    b = bytearray(raw)
    b[len(raw) // 5 * 2 - 4] ^= 0xFF  # inside the second frame
    open(p, "wb").write(bytes(b))
    with pytest.raises(TraceFormatError, match="CRC mismatch"):
        list(read_trace(p, on_warning=lambda m: None))


# ---------------------------------------------------------------- merge


MERGES = {
    # (trace, wstart, wend, event capacity)
    "plain": (_trace(n=12, step=SEC // 100), 0, SEC // 5, 64),
    # staged after their window ran: clamped up to wstart, counted late
    "late": (_trace(n=12, step=SEC // 100), SEC // 7, SEC // 5, 64),
    # ten events into host 0's row of 4 slots, one of them holding its
    # PROC_START: 7 row-full drops
    "row_full": ([dict(e, host=0) for e in _trace(n=10, step=1000)],
                 0, SEC, 4),
    # the same on a Sim packed as 2 lanes (core/lanes.py): the drops go
    # to lane 0's inj_dropped too (the merge's per-lane diversion)
    "row_full_lanes": ([dict(e, host=0) for e in _trace(n=10, step=1000)],
                       0, SEC, 4),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_staged_matches_reference(case):
    events, wstart, wend, cap = MERGES[case]
    jb, tb = _jax_bundle(cap=cap), _port_bundle(cap=cap)
    if case.endswith("_lanes"):
        from shadow_tpu.core import lanes as jlanes
        from shadow_tpu_torch.core import lanes as tlanes

        jb.sim, tb.sim = jlanes.attach(jb.sim, 2), tlanes.attach(tb.sim, 2)
    jsim = JFeeder(list(events)).refill(jb.sim)
    tsim = Feeder(list(events)).refill(tb.sim)
    _assert_leaves(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    jsim, *jd = jstaging.merge_staged(jsim, wstart, wend,
                                      jsim.net.lane_id)
    tsim, *td = staging.merge_staged(tsim, wstart, wend, tsim.net.lane_id)
    _assert_leaves(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    assert [int(x) for x in td] == [int(x) for x in jd]
    inj, drop, deferred = (int(x) for x in td)
    assert inj + drop + deferred == len(events)
    assert int(tsim.events.overflow) == 0   # drops moved off the latch
    if case == "late":
        assert int(tsim.inject.late) > 0
    if case.startswith("row_full"):
        assert drop == 7
    if case == "row_full_lanes":
        assert tsim.lanes.inj_dropped.tolist() == [7, 0]
    assert int(staging.staged_pending_min(tsim.inject)) == int(
        jstaging.staged_pending_min(jsim.inject))


# ------------------------------------------------------- streamed runs


@pytest.fixture(scope="module")
def streamed():
    """The 40-event trace streamed through 16 lanes, one window a
    dispatch, in both packages."""
    evs = _trace()
    jsim, jstats, jf = _jax_run(evs)
    tsim, tstats, tf = _port_run(evs)
    return {"jax": (_jax_leaves(jsim), jstats, jmanifest_block(jsim, jf)),
            "port": (convert.sim_to_numpy(tsim), tstats,
                     manifest_block(tsim, tf), tsim, tf)}


def test_streamed_run_is_leaf_equal_to_reference(streamed):
    want, jstats, jblk = streamed["jax"]
    got, tstats, tblk = streamed["port"][:3]
    assert tstats == jstats
    assert tblk == jblk
    _assert_leaves(want, got)
    assert tblk["injected"] == 40 and tblk["deferred"] == 0
    assert tblk["backpressure"] > 0        # 16 lanes << 40 events
    assert got[".app.sent"].sum() == got[".app.rcvd"].sum() == 40


def test_fill_all_equals_streaming(streamed):
    """Staging the whole trace up front (the whole-run path) lands on
    the streamed run's state."""
    b = _port_bundle(lanes=64)
    b.sim = Feeder(_trace()).fill_all(b.sim)
    sim, stats = tbuild.run(b, (tgen.handler,), device="cpu")
    want, wstats = streamed["port"][0], streamed["port"][1]
    assert stats.as_dict()["events_processed"] == wstats["events_processed"]
    got = convert.sim_to_numpy(sim)
    for k in want:
        if k not in INJECT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fill_all_refuses_a_trace_wider_than_the_lanes():
    with pytest.raises(ValueError, match="cannot be fully staged"):
        Feeder(_trace()).fill_all(_port_bundle(lanes=16).sim)


def test_k1_equals_k64(streamed):
    """64-window chunks run the same merge at every window boundary:
    the live event set, the device accounting and the rest of the state
    equal one window a dispatch."""
    want, wstats, wblk = streamed["port"][:3]
    sim, stats, f = _port_run(_trace(), K=64)
    got = convert.sim_to_numpy(sim)
    assert stats["events_processed"] == wstats["events_processed"]
    assert _dev(manifest_block(sim, f)) == _dev(wblk)
    for k in want:
        if k not in INJECT | EVENT_SLOTS | ROUTE_MARKS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _live_events(got) == _live_events(want)


def test_row_full_drops_count_on_the_injection_latch():
    """A flood onto host 0's row of 8 slots within one window: drops are
    counted on inject.dropped (a health warning), the engine latch stays
    clean, and the reconciliation closes."""
    evs = [dict(e, host=0, payload=[1, 9100, 64])
           for e in _trace(n=64, step=1000)]
    sim, _, f = _port_run(evs, lanes=64, cap=8)
    blk = manifest_block(sim, f)
    assert blk["dropped"] > 0
    assert blk["injected"] + blk["dropped"] + blk["deferred"] == 64
    assert int(sim.events.overflow) == 0
    h = health.gather(sim)
    assert not h.fatal and h.inject_dropped == blk["dropped"]
    assert any("injection drops" in m for _, m in h.diagnostics())


def test_deferred_past_end_of_run_is_accounted():
    evs = _trace(n=10, step=SEC // 5)      # the last at 1.9 s
    sim, _, f = _port_run(evs)
    blk = manifest_block(sim, f)
    assert blk["deferred"] > 0
    assert blk["injected"] + blk["dropped"] + blk["deferred"] == 10


# ---------------------------------------------------- snapshot crossing


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mid_trace_snapshot_resumes_in_the_other_package(
        streamed, tmp_path, direction):
    """A snapshot taken mid-trace by one package, resumed by the other
    with a fresh feeder: the straight run's state (staging scratch
    aside), every event injected once."""
    evs = _trace()
    prefix = str(tmp_path / "ck")
    if direction == "jax_to_port":
        b = _jax_bundle()
        _, _, saved = jckpt.run_windows(
            b, (jtgen.handler,), feeder=JFeeder(list(evs)),
            end_time=SEC // 2, checkpoint_every_ns=SEC // 4,
            checkpoint_path=prefix)
        path, t0 = saved[-1]
        tb = _port_bundle()
        sim, t, _ = tckpt.load(path, tb.sim)
        f = Feeder(list(evs))
        sim, _, _ = tckpt.run_windows(tb, (tgen.handler,), sim=sim,
                                      start_time=t, feeder=f,
                                      device="cpu")
        got, blk = convert.sim_to_numpy(sim), manifest_block(sim, f)
    else:
        tb = _port_bundle()
        _, _, saved = tckpt.run_windows(
            tb, (tgen.handler,), feeder=Feeder(list(evs)),
            end_time=SEC // 2, checkpoint_every_ns=SEC // 4,
            checkpoint_path=prefix, device="cpu")
        path, t0 = saved[-1]
        jb = _jax_bundle()
        sim, t, _ = jckpt.load(path, jb.sim)
        f = JFeeder(list(evs))
        sim, _, _ = jckpt.run_windows(jb, (jtgen.handler,), sim=sim,
                                      start_time=t, feeder=f)
        got, blk = _jax_leaves(sim), jmanifest_block(sim, f)
    assert t == t0 and 0 < t0 < SEC // 2 + 1
    assert 0 < int(np.load(path)[".inject.injected"]) < 40
    want = streamed["port"][0]
    _assert_leaves(want, got, exclude=INJECT)
    assert blk["injected"] == 40 and blk["dropped"] == 0
    assert got[".app.sent"].sum() == 40     # nothing replayed


def test_feeder_sync_after_restore_rebuilds_the_mirror(streamed, tmp_path):
    """sync() on a restored sim positions a fresh feeder just past the
    staged events: the same cursor and mirror the running feeder had."""
    tb = _port_bundle()
    f1 = Feeder(_trace())
    _, _, saved = tckpt.run_windows(
        tb, (tgen.handler,), feeder=f1, end_time=SEC // 2,
        checkpoint_every_ns=SEC // 4, checkpoint_path=str(tmp_path / "ck"),
        device="cpu")
    sim, _, _ = tckpt.load(saved[-1][0], tb.sim)
    f2, j2 = Feeder(_trace()), JFeeder(_trace())
    f2.sync(sim)
    jsim, _, _ = jckpt.load(saved[-1][0], _jax_bundle().sim)
    j2.sync(jsim)
    assert f2.cursor == j2.cursor and f2._staged == j2._staged


# ---------------------------------------------------------------- stall


def test_burst_wider_than_the_lanes_stalls_like_the_reference():
    """20 events at one timestamp cannot pass through 16 lanes: both
    packages stop with the same error instead of merging late."""
    evs = [dict(e, t_ns=SEC // 10) for e in _trace(n=20)]
    with pytest.raises(RuntimeError) as want:
        _jax_run(evs)
    with pytest.raises(RuntimeError) as got:
        _port_run(evs)
    assert str(got.value) == str(want.value)
    assert "stalled" in str(got.value)
    with pytest.raises(RuntimeError, match="stalled"):
        _port_run(evs, K=4)


# ------------------------------------------------------------- manifest


def test_manifest_block_passes_the_reference_lint(streamed):
    from shadow_tpu_torch import telemetry

    tl = load_tool("telemetry_lint")
    tsim, f = streamed["port"][3], streamed["port"][4]
    b = _port_bundle()
    man = telemetry.run_manifest(
        cfg=b.cfg, seed=b.cfg.seed, shards=1, sim=tsim,
        health=health.gather(tsim), injection=manifest_block(tsim, f))
    man = json.loads(json.dumps(man))       # the on-disk form
    errors, _ = tl.lint_manifest_obj(man)
    assert errors == []
    bad = json.loads(json.dumps(man))
    bad["injection"]["injected"] -= 1
    errors, _ = tl.lint_manifest_obj(bad)
    assert any("reconcile" in e for e in errors)


# ----------------------------------------------------------- supervised


def test_supervised_loop_is_leaf_equal_to_reference(streamed, tmp_path):
    """run_supervised(feeder=...) in both packages (snapshots every 8
    windows): the reference's state leaf for leaf, and the plain
    streamed run's."""
    from shadow_tpu import faults as jfaults
    from shadow_tpu_torch import faults as tfaults

    jr = jfaults.run_supervised(
        _jax_bundle(), (jtgen.handler,),
        checkpoint_path=str(tmp_path / "j"), checkpoint_every_windows=8,
        feeder=JFeeder(_trace()))
    f = Feeder(_trace())
    tr = tfaults.run_supervised(
        _port_bundle(), (tgen.handler,),
        checkpoint_path=str(tmp_path / "t"), checkpoint_every_windows=8,
        feeder=f, device="cpu")
    assert jr.ok and tr.ok and len(tr.checkpoints) == len(jr.checkpoints)
    assert tr.stats.as_dict() == _jax_stats(jr.stats)
    got = convert.sim_to_numpy(tr.sim)
    _assert_leaves(_jax_leaves(jr.sim), got)
    _assert_leaves(streamed["port"][0], got)
    assert tr.health.failure_report() == jr.health.failure_report()
    assert manifest_block(tr.sim, f)["injected"] == 40


def test_supervised_stop_and_resume_with_a_fresh_feeder(streamed,
                                                        tmp_path):
    """A supervised stop mid-trace, then a resume from its snapshot with
    a fresh feeder: the straight run's state, and the injection block
    reconciles (injected + dropped + deferred == trace events, late 0)."""
    from shadow_tpu_torch import faults as tfaults

    prefix = str(tmp_path / "ck")
    stop = {"v": False}

    def on_round(sim, ws, wstart, wend, nm):
        stop["v"] = nm >= SEC * 45 // 100
    first = tfaults.run_supervised(
        _port_bundle(), (tgen.handler,), checkpoint_path=prefix,
        checkpoint_every_windows=1 << 30, feeder=Feeder(_trace()),
        on_round=on_round, stop=lambda: stop["v"], device="cpu")
    assert first.preempted and first.final_checkpoint
    f = Feeder(_trace())
    rest = tfaults.run_supervised(
        _port_bundle(), (tgen.handler,), checkpoint_path=prefix,
        resume_from=first.final_checkpoint, feeder=f, device="cpu")
    assert rest.ok
    _assert_leaves(streamed["port"][0], convert.sim_to_numpy(rest.sim),
                   exclude=INJECT)
    assert rest.stats.as_dict() == streamed["port"][1]
    blk = manifest_block(rest.sim, f)
    assert blk["injected"] + blk["dropped"] + blk["deferred"] \
        == blk["trace_events"] == 40
    assert blk["late"] == 0


def test_horizon_clamp_and_its_attribution():
    """The staging horizon (the first unstaged event) clamps a window
    end as the reference's wend_clamp does, and make_wend_fn's explain
    attributes the clamp to CAUSE_INJECT_HORIZON; the plain rule does
    not read it."""
    from shadow_tpu_torch.core.engine import make_wend_fn
    from shadow_tpu_torch.telemetry.causality import CAUSE_INJECT_HORIZON

    evs = _trace(n=40, step=SEC // 100)
    tsim = Feeder(list(evs)).refill(_port_bundle().sim)
    jsim = JFeeder(list(evs)).refill(_jax_bundle().sim)
    hz = evs[16]["t_ns"]               # 16 lanes: event 16 is unstaged
    assert int(tsim.inject.horizon) == int(jsim.inject.horizon) == hz
    for wend in (hz - 1, hz, hz + 1, simtime.INVALID):
        assert staging.wend_clamp(tsim, wend) == int(
            jstaging.wend_clamp(jsim, wend))
    w = make_wend_fn(min_jump=SEC // 20, end_time=SEC)
    assert w(tsim, SEC // 4) == SEC // 4 + SEC // 20 > hz
    assert w.explain(tsim, SEC // 4)[:2] == (hz, CAUSE_INJECT_HORIZON)
    assert w.explain(tsim, 0)[0] == SEC // 20 < hz
