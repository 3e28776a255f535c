"""Parity of the port's lane isolation (core/lanes.py) with the
reference's, on the CPU, tolerance zero — tests/test_lanes.py's oracles
held against the reference:

- the helpers, attach's divisibility rule, and R = 1 bit-identical to
  the unattached program (the lanes only add leaves);
- bench's packed PHOLD (4 lanes x 4 hosts, bulk pass) with one lane
  flooded past its queue capacity (tests/test_lanes.py _flood_fn):
  every leaf equal to the reference's run, the lane report equal, the
  victim quarantined on events_overflow alone, the healthy lanes'
  state byte-identical to the clean run's, the per-lane ledger
  (faults/conserve.py lane_sample) equal to the reference's and clean;
- run_supervised's lane surgery: a contained trip, one LaneIncident
  through on_lane_quarantine, a salvage artifact equal to the
  reference's extract_lane of the same snapshot, a manifest lanes
  block tools/telemetry_lint.py accepts;
- window_update with the resident admission planes (a free lane, a
  lease horizon, a quarantine, the stall latch), the crash reset on an
  admission Sim, and the injection merge's per-lane drop diversion,
  each against the reference's function on the same state.

One reference program is compiled for the file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_tool
from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import lanes as jlanes
from shadow_tpu.core.events import push_rows as jpush_rows
from shadow_tpu.faults import conserve as jconserve
from shadow_tpu.faults import escalate as jescalate
from shadow_tpu.inject import staging as jstaging
from shadow_tpu.net import build as jbuild
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.apps.tgen import KIND_TGEN
from shadow_tpu_torch.core import lanes as tlanes
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import push_rows as tpush_rows
from shadow_tpu_torch.faults import conserve as tconserve
from shadow_tpu_torch.inject import Feeder
from shadow_tpu_torch.inject import staging as tstaging
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.telemetry.export import lanes_manifest_block
from shadow_tpu_torch.utils import checkpoint as tckpt
from torch_parity import assert_leaves_equal, jax_leaves, packed, to_jax

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
RS, R = 4, 4
H = RS * R
VICTIM = 1
TRIG = SEC // 2


def _victim_mask(A, n, wend):
    ar = A.arange(n)
    return (ar >= VICTIM * RS) & (ar < (VICTIM + 1) * RS) & (wend > TRIG)


def _flood_fn(pkg, cap):
    """Seq-conserving flood (tests/test_lanes.py): cap+1 far-future
    events into the victim lane's rows each window past TRIG, next_seq
    bumped per attempt."""

    def jax_flood(sim, wend):
        q = sim.events
        Hn = q.num_hosts
        mask = _victim_mask(jnp, Hn, jnp.asarray(wend, jnp.int64))
        t = jnp.full((Hn,), simtime.INVALID - 1, jnp.int64)
        z = jnp.zeros((Hn,), jnp.int32)
        w = jnp.zeros((Hn, q.words.shape[-1]), jnp.int32)
        for _ in range(cap + 1):
            q = jpush_rows(q, mask, t, z, z, q.next_seq, w)
            q = q.replace(next_seq=q.next_seq + mask.astype(jnp.int32))
        return sim.replace(events=q)

    def port_flood(sim, wend):
        q = sim.events
        Hn = q.num_hosts
        mask = _victim_mask(torch, Hn, int(wend))
        t = torch.full((Hn,), simtime.INVALID - 1, dtype=torch.int64)
        z = torch.zeros((Hn,), dtype=torch.int32)
        w = torch.zeros((Hn, q.words.shape[-1]), dtype=torch.int32)
        for _ in range(cap + 1):
            q = tpush_rows(q, mask, t, z, z, q.next_seq, w)
            q = q.replace(next_seq=q.next_seq + mask.to(torch.int32))
        return sim.replace(events=q)

    return jax_flood if pkg == "jax" else port_flood


def _port_run(flood, end=SEC):
    b = packed("port", end=end)
    fn = tbuild.make_runner(
        b, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        device="cpu",
        fault_fn=_flood_fn("port", b.cfg.event_capacity) if flood else None)
    return fn(b.sim)


@pytest.fixture(scope="module")
def runs():
    jb = packed("jax")
    jsim, jst = jbuild.make_runner(
        jb, app_handlers=(jphold.handler,), app_bulk=jphold.BULK,
        fault_fn=_flood_fn("jax", jb.cfg.event_capacity))(jb.sim)
    return {"jax": (jsim, jst), "flooded": _port_run(True),
            "clean": _port_run(False)}


def test_lane_helpers_match_reference():
    for x in (np.arange(8, dtype=np.int32),
              np.array([1, 0, 1, 1, 0, 0, 1, 0], bool),
              np.arange(16, dtype=np.int64).reshape(8, 2)):
        np.testing.assert_array_equal(
            tlanes.lane_sum(torch.as_tensor(x), 4).numpy(),
            np.asarray(jlanes.lane_sum(jnp.asarray(x), 4)))
    t = np.array([5, 3, 9, 9, 2, 7, 1, 8], np.int64)
    np.testing.assert_array_equal(
        tlanes.lane_min(torch.as_tensor(t), 2).numpy(),
        np.asarray(jlanes.lane_min(jnp.asarray(t), 2)))
    m = np.array([True, False, True, False])
    np.testing.assert_array_equal(
        tlanes.host_mask(torch.as_tensor(m), 8).numpy(),
        np.asarray(jlanes.host_mask(jnp.asarray(m), 8)))
    np.testing.assert_array_equal(
        tlanes.lane_of_host(torch.arange(8), 8, 4).numpy(),
        np.asarray(jlanes.lane_of_host(jnp.arange(8), 8, 4)))
    for bits in range(64):
        assert tlanes.trip_names(bits) == jlanes.trip_names(bits)


def test_attach_validates_divisibility():
    b = packed("port", H=6, R=2, lanes=False, replicas=False)
    with pytest.raises(ValueError, match="num_hosts % replicas"):
        tlanes.attach(b.sim, 4)
    with pytest.raises(ValueError, match="requires lane isolation"):
        tlanes.attach_admission(b.sim)


def test_r1_lane_isolation_bit_identical():
    """R = 1 reproduces the global-latch program: equal counters and
    every shared leaf equal; the lanes only add leaves."""
    out = []
    for lanes in (False, True):
        b = packed("port", H=8, R=1, lanes=lanes, replicas=False)
        sim, st = tbuild.make_runner(b, app_handlers=(tphold.handler,),
                                     app_bulk=tphold.BULK,
                                     device="cpu")(b.sim)
        out.append((sim, st.as_dict()))
    (sim0, st0), (sim1, st1) = out
    assert st0 == st1
    d0, d1 = convert.sim_to_numpy(sim0), convert.sim_to_numpy(sim1)
    extra = set(d1) - set(d0)
    allowed = {".events.overflow_h", ".outbox.overflow_h",
               ".net.rq_overflow_h", ".telem.lane_events",
               ".telem.prev_lane_exec"}
    assert extra and all(k.startswith(".lanes") or k in allowed
                         for k in extra), extra
    assert_leaves_equal(d0, d1, keys=sorted(d0))
    rep = tlanes.lane_report(sim1)
    assert len(rep) == 1 and not rep[0]["quarantined"]
    assert rep[0]["events_exec"] == int(sim0.net.ctr_events_exec.sum())


def test_clean_packed_run_no_trips(runs):
    sim, _ = runs["clean"]
    rep = tlanes.lane_report(sim)
    assert all(not d["quarantined"] for d in rep), rep
    assert int(sim.events.overflow) == 0
    assert int(sim.events.overflow_h.sum()) == int(sim.events.overflow)
    assert len({d["events_exec"] for d in rep}) == 1    # symmetric
    # the ring's per-lane fan-out sums to the events plane, per window
    ring = sim.telem
    n = int(ring.count)
    np.testing.assert_array_equal(ring.lane_events[:n].sum(1).numpy(),
                                  ring.events[:n].numpy())


def test_flooded_lane_matches_reference(runs):
    jsim, jst = runs["jax"]
    sim, st = runs["flooded"]
    assert st.as_dict() == {k: int(getattr(jst, k)) for k in st.as_dict()}
    assert_leaves_equal(jax_leaves(jsim), convert.sim_to_numpy(sim))
    rep = tlanes.lane_report(sim)
    assert rep == jlanes.lane_report(jsim)
    assert rep[VICTIM]["quarantined"]
    assert rep[VICTIM]["trip"] == ["events_overflow"]
    assert rep[VICTIM]["flushed"] > 0
    assert rep[VICTIM]["quarantined_at_ns"] > 0
    assert [d["lane"] for d in rep if d["quarantined"]] == [VICTIM]
    for plane in ("events", "outbox"):
        q = getattr(sim, plane)
        assert int(q.overflow) == int(q.overflow_h.sum())
    assert int(sim.net.rq_overflow) == int(sim.net.rq_overflow_h.sum())
    # blast radius: the healthy lanes equal the clean run, row for row
    clean, _ = runs["clean"]
    for a, c in ((clean.app.rcvd, sim.app.rcvd),
                 (clean.net.ctr_events_exec, sim.net.ctr_events_exec),
                 (clean.events.time, sim.events.time)):
        for r in range(R):
            if r != VICTIM:
                np.testing.assert_array_equal(
                    a[r * RS:(r + 1) * RS].numpy(),
                    c[r * RS:(r + 1) * RS].numpy())


def test_per_lane_conservation_ledger(runs):
    sim, _ = runs["flooded"]
    s = tconserve.lane_sample(sim, wstart=0, wend=SEC)
    want = jconserve.lane_sample(runs["jax"][0], wstart=0, wend=SEC)
    assert s.as_dict() == want.as_dict()
    assert tconserve.lane_check([s]) == []
    assert s.drops[VICTIM] > 0 and s.flushed[VICTIM] > 0
    for r in range(R):
        if r != VICTIM:
            assert s.drops[r] == 0 and s.flushed[r] == 0
            assert s.pushed[r] == s.processed[r] + s.queued[r] \
                + s.outboxed[r]


def test_supervisor_lane_surgery(tmp_path):
    from shadow_tpu_torch import telemetry

    b = packed("port")
    cap = b.cfg.event_capacity
    seen = []
    harvester = telemetry.Harvester()
    res = tfaults.run_supervised(
        b, app_handlers=(tphold.handler,),
        fault_fn=_flood_fn("port", cap),
        checkpoint_path=str(tmp_path / "ck"), checkpoint_every_windows=4,
        max_retries=0, sleep=lambda s: None, on_lane_quarantine=seen.append,
        harvester=harvester, device="cpu")
    assert res.ok, res.failure_report()
    h = res.health
    assert h.lanes_total == R and h.lane_contained and not h.fatal
    assert tuple(h.lanes_quarantined) == (VICTIM,)
    assert any("contained" in m for _, m in h.diagnostics())
    (inc,) = res.lane_incidents
    assert [i.lane for i in seen] == [VICTIM] == [inc.lane]
    assert "events_overflow" in inc.trip
    assert inc.regrow.get("event_capacity", 0) > cap
    leaves, meta = tckpt.load_leaves(inc.salvage)
    assert meta["kind"] == "lane_salvage" and meta["lane"] == VICTIM
    assert meta["capacities"]["num_hosts"] == RS
    src, src_meta = tckpt.load_leaves(inc.salvaged_from)
    want, want_meta = jescalate.extract_lane(src, src_meta, VICTIM, R)
    assert_leaves_equal(want, leaves)
    blk = lanes_manifest_block(h, res.lane_incidents)
    assert blk["quarantined"] == [VICTIM]
    assert blk["per_lane"][VICTIM]["salvage"] == inc.salvage
    assert "lane_incidents" in res.failure_report()
    man = telemetry.run_manifest(cfg=b.cfg, seed=1, shards=1, sim=res.sim,
                                 stats=res.stats, health=h, lanes=blk,
                                 harvester=harvester)
    errors, _ = load_tool("telemetry_lint").lint_manifest_obj(man)
    assert errors == []


def _resident(pkg, sim):
    ln = jlanes if pkg == "jax" else tlanes
    return ln.admit_all(ln.attach_admission(sim))


@pytest.mark.parametrize("case", ["admission", "trips"])
def test_window_update_matches_reference(case):
    """One barrier's rules on a mid-run state: a free lane, a lease
    horizon inside the queue, and a quarantined lane (admission); or
    overflow in one lane, the stall latch and a regression (trips)."""
    tb = packed("port", end=SEC // 3)
    if case == "admission":
        tb.sim = _resident("port", tb.sim)
    sim, _ = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                device="cpu")(tb.sim)
    if case == "admission":
        adm = sim.admission
        sim = sim.replace(
            admission=adm.replace(
                active=torch.tensor([True, False, True, True]),
                lease_end=torch.tensor([simtime.INVALID] * 2
                                       + [SEC // 3 + 60_000_000,
                                          simtime.INVALID])),
            lanes=sim.lanes.replace(
                quarantined=torch.tensor([False, False, False, True])))
        wend = SEC // 3 + 1
    else:
        h = torch.zeros(H, dtype=torch.int32)
        h[2] = 3
        sim = sim.replace(
            events=sim.events.replace(overflow_h=h, overflow=h.sum()),
            lanes=sim.lanes.replace(
                stall_limit=1,
                prev_min=tlanes.lane_min(sim.events.min_time(), R)))
        wend = int(sim.events.min_time().amin()) + 1
    jb = packed("jax", end=SEC // 3)
    if case == "admission":
        jb.sim = _resident("jax", jb.sim)
    jtmpl = jb.sim
    if case == "trips":
        jtmpl = jtmpl.replace(lanes=jtmpl.lanes.replace(stall_limit=1))
    want = jlanes.window_update(to_jax(sim, jtmpl), wend)
    got = tlanes.window_update(sim, wend)
    assert_leaves_equal(jax_leaves(want), convert.sim_to_numpy(got))
    if case == "admission":
        assert tlanes.admission_report(got) == jlanes.admission_report(want)
        assert int(got.admission.flushed.sum()) > 0
    else:
        assert tlanes.lane_report(got) == jlanes.lane_report(want)
        assert bool(got.lanes.quarantined.all())


def test_crash_reset_on_an_admission_sim_matches_reference():
    """A crash in a FREE lane is a no-op; one in a leased lane resets
    the host, as the reference's fault_fn does."""
    recs = [(SEC // 10, tfaults.FaultKind.CRASH, 5, -1, 0),
            (SEC // 10, tfaults.FaultKind.CRASH, 9, -1, 0)]
    out = {}
    for pkg, fmod in (("jax", jfaults), ("port", tfaults)):
        b = packed(pkg, end=SEC // 2)
        b.sim = _resident(pkg, b.sim)
        fmod.install(b, [fmod.FaultRecord(t_ns=t, kind=k, a=a, b=bb,
                                          value=v)
                         for t, k, a, bb, v in recs])
        out[pkg] = b
    tb, jb = out["port"], out["jax"]
    sim, _ = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                device="cpu", end_time=SEC // 20)(tb.sim)
    sim = sim.replace(admission=sim.admission.replace(
        active=torch.tensor([True, False, True, True])))
    wend = SEC // 5
    want = jfaults.apply.fault_fn_for(jb)(to_jax(sim, jb.sim), wend)
    got = tfaults.apply.fault_fn_for(tb)(sim, wend)
    assert_leaves_equal(jax_leaves(want), convert.sim_to_numpy(got))
    # host 5 (free lane 1) untouched, host 9 (lane 2) flushed
    assert bool((got.events.time[5] == sim.events.time[5]).all())
    assert not bool((got.events.time[9] == sim.events.time[9]).all())


def test_injection_merge_diverts_lane_drops_like_the_reference():
    """Injected events past a row's free slots: the drops land on the
    lanes' inj_dropped, the attribution plane keeps matching the
    scalar latch."""
    tb = packed("port", cap=4, inject_lanes=16, end=SEC // 2)
    events = [{"t_ns": SEC // 10, "host": 9, "kind": KIND_TGEN,
               "payload": [10, 9100, 64]}]
    events += [{"t_ns": SEC // 10 + i, "host": 5, "kind": KIND_TGEN,
                "payload": [6, 9100, 64]} for i in range(5)]
    sim = Feeder(events).refill(tb.sim)
    jtmpl = packed("jax", cap=4, inject_lanes=16, end=SEC // 2).sim
    want = jstaging.merge_staged(to_jax(sim, jtmpl), 0, SEC // 5)
    got = tstaging.merge_staged(sim, 0, SEC // 5)
    assert_leaves_equal(jax_leaves(want[0]), convert.sim_to_numpy(got[0]))
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    drops = int(got[2])
    assert drops > 0
    assert got[0].lanes.inj_dropped.tolist() == [0, drops, 0, 0]
    assert int(got[0].events.overflow) == 0
    assert int(got[0].events.overflow_h.sum()) == 0
