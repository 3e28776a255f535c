"""Program specialization in the port (shadow_tpu_torch.compile.specialize)
against the reference's (shadow_tpu.compile.specialize), on the CPU —
tests/test_specialize.py's contract, each case held to the reference:

- the capability vector of PHOLD (loss and timers dropped), `mode="off"`,
  a lossy table or an undeclared handler keeping capabilities live, and
  the refusals (an unknown mode, a bundle the analysis cannot read);
- the trimmed final state equal to the untrimmed state (the guard aside)
  and to the reference's trimmed state, every leaf, through run_windows
  at windows_per_dispatch 1 and 64;
- the trim is real: no reliability draw of the netstack runs in a whole
  trimmed run, and the timer handler family is out of the step function
  even when no kinds bitmask is given (the reference checks its jaxpr);
- program keys: the trimmed variant keys apart, an untrimmed specialized
  build keys as the unspecialized one and carries no guard;
- an opaque fault_fn refused on a specialized bundle;
- the guard trips fatal on a halved table and on a planted TIMER, with
  RunHealth equal to the reference's; specialization_block equal;
- a trimmed snapshot crosses between the packages both ways and resumes
  to the same final state;
- an escalation regrow under run_supervised stays trimmed and ends equal
  to the reference's.

PHOLD at 16 hosts, load 4, 1 sim-s (8 hosts for the escalation).
Tolerance zero.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.compile import specialize as jspec
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.compile import buckets
from shadow_tpu_torch.compile import specialize as tspec
from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.core.events import EmitBuffer, EventKind, pop_earliest
from shadow_tpu_torch.faults import health as thealth
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net import step as tstep
from shadow_tpu_torch.net import timers as ttimers
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt
from torch_parity import assert_leaves_equal, jax_leaves

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
HALF = SEC // 2
PKG = {"jax": (jbuild, jphold, jspec, JConfig, {}),
       "port": (tbuild, tphold, tspec, TConfig, {"device": "cpu"})}
GUARD = (".guard.loss_trips", ".guard.timer_trips")


def _build(pkg, H=16, load=4, seed=1, **cfg_kw):
    mod, phold, _, C, dev = PKG[pkg]
    cfg = C(num_hosts=H, tcp=False, end_time=SEC, seed=seed, **cfg_kw)
    hosts = [mod.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(H)]
    b = mod.build(cfg, ONE_VERTEX, hosts, **dev)
    b.sim = phold.setup(b.sim, load=load)
    return b


def _specialized(pkg, **kw):
    _, phold, spec, _, _ = PKG[pkg]
    b = spec.apply(_build(pkg, **kw), (phold.handler,))
    assert b.caps is not None and b.caps.dropped() == ("loss", "timers")
    return b


def _run(pkg, b, wpd=1, **kw):
    """run_windows in either package; (leaves, stats dict, saved, the
    specialization block of the final state)."""
    if pkg == "jax":
        sim, stats, saved = jckpt.run_windows(
            b, (jphold.handler,), windows_per_dispatch=wpd, **kw)
        sim, stats = jax.device_get((sim, stats))
        leaves = jax_leaves(sim)
    else:
        sim, stats, saved = tckpt.run_windows(
            b, (tphold.handler,), windows_per_dispatch=wpd, device="cpu",
            **kw)
        leaves = convert.sim_to_numpy(sim)
    st = {k: int(getattr(stats, k)) for k in (
        "events_processed", "windows", "micro_steps")}
    block = PKG[pkg][2].specialization_block(b.caps, sim, mode="auto")
    return leaves, st, saved, block


def _unguarded(leaves):
    return {k: v for k, v in leaves.items() if k not in GUARD}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The untrimmed port run, and the trimmed runs of both packages at
    K = 1 (each saving a snapshot at 0.5 s) and K = 64."""
    d = tmp_path_factory.mktemp("spec")
    out = {"full": _run("port", _build("port"))}
    for pkg in ("jax", "port"):
        for wpd in (1, 64):
            kw = {}
            if wpd == 1:
                kw = dict(checkpoint_every_ns=HALF,
                          checkpoint_path=str(d / pkg))
            out[pkg, wpd] = _run(pkg, _specialized(pkg), wpd, **kw)
    return out


# ---------------------------------------------------------------- vector


def test_phold_vector_trims_loss_and_timers():
    blocks = {}
    for pkg in ("jax", "port"):
        b = _specialized(pkg)
        assert b.caps.key_extra() == "no_loss-no_timers"
        assert b.sim.guard.watched() == ("loss", "timers")
        blocks[pkg] = (b.caps.as_dict(),
                       PKG[pkg][2].specialization_block(b.caps, b.sim))
    assert blocks["port"] == blocks["jax"]
    assert blocks["port"][1]["guard"] == {
        "watched": ["loss", "timers"], "loss_trips": 0, "timer_trips": 0}


def test_mode_off_detaches_vector():
    for pkg in ("jax", "port"):
        spec = PKG[pkg][2]
        b = spec.apply(_specialized(pkg), (PKG[pkg][1].handler,),
                       mode="off")
        assert b.caps is None
        assert spec.specialization_block(b.caps, b.sim) is None


def _mute_jax(sim, popped, active, buf):  # pragma: no cover - not run
    return sim, buf


def _mute_port(cfg, sim, popped, buf):  # pragma: no cover - not run
    return sim, buf


def test_lossy_or_undeclared_handler_keeps_capabilities_live():
    got = {}
    for pkg, mute in (("jax", _mute_jax), ("port", _mute_port)):
        _, phold, spec, _, _ = PKG[pkg]
        b = _build(pkg)
        b.sim = b.sim.replace(net=b.sim.net.replace(
            reliability=b.sim.net.reliability * 0.5))
        lossy = spec.apply(b, (phold.handler,))
        undeclared = spec.apply(_build(pkg), (mute,))
        assert lossy.caps.loss and "loss" not in lossy.caps.dropped()
        assert undeclared.caps.timers
        got[pkg] = (lossy.caps.as_dict(), undeclared.caps.as_dict())
    assert got["port"] == got["jax"]


def test_unknown_mode_and_unreadable_bundle_raise():
    b = _build("port")
    with pytest.raises(ValueError, match="auto|off"):
        tspec.apply(b, (tphold.handler,), mode="bogus")
    with pytest.raises(ValueError, match="reliability"):
        tspec.apply(dataclasses.replace(b, sim=None), (tphold.handler,))
    with pytest.raises(ValueError, match="reliability"):
        tspec.derive(object())


# ---------------------------------------------------------- bit-identity


@pytest.mark.parametrize("wpd", [1, 64])
def test_trimmed_final_state_identical_every_leaf(runs, wpd):
    """The trimmed port run equals the untrimmed one in every leaf (the
    guard aside) and stats, and the reference's trimmed run in every
    leaf, the guard's counters included."""
    full, fstats, _, _ = runs["full"]
    want, wstats, _, _ = runs["jax", wpd]
    got, gstats, _, _ = runs["port", wpd]
    assert int(got[".guard.loss_trips"]) == 0
    assert int(got[".guard.timer_trips"]) == 0
    assert_leaves_equal(full, _unguarded(got))
    assert_leaves_equal(want, got)
    assert gstats["events_processed"] == fstats["events_processed"] \
        == wstats["events_processed"] > 0
    if wpd == 1:
        assert gstats == fstats == wstats


def test_trimmed_sparse_shape_keeps_the_guard_through_compaction():
    """bench.py's sparse shape (4 of 16 hosts loaded, a compact-lane
    budget of 8, no bulk pass): the fixpoint runs on a compacted Sim,
    which carries the guard's counters through and back. The trimmed
    run equals the untrimmed one (the guard aside) and the reference's
    trimmed run, every leaf."""
    def sparse(pkg, trimmed):
        mod, phold, spec, C, dev = PKG[pkg]
        cfg = C(num_hosts=16, tcp=False, end_time=SEC, seed=1,
                sparse_lanes=8)
        hosts = [mod.HostSpec(name=f"peer{i}", proc_start_time=0)
                 for i in range(16)]
        b = mod.build(cfg, ONE_VERTEX, hosts, **dev)
        b.sim = phold.setup(b.sim, load=4, active_hosts=4)
        return spec.apply(b, (phold.handler,)) if trimmed else b

    got, gstats, _, _ = _run("port", sparse("port", True))
    full, fstats, _, _ = _run("port", sparse("port", False))
    want, wstats, _, _ = _run("jax", sparse("jax", True))
    assert gstats == fstats == wstats
    assert_leaves_equal(want, got)
    assert_leaves_equal(full, _unguarded(got))
    assert int(got[GUARD[0]]) == int(got[GUARD[1]]) == 0
    # the fast path ran: the compacted Sim carried the guard
    sim, stats, _ = tckpt.run_windows(sparse("port", True),
                                      (tphold.handler,), device="cpu")
    assert int(stats.fastpath_hit) > 0 and sim.guard is not None


@pytest.mark.parametrize("wpd", [1, 64])
def test_specialization_block_of_the_final_state_equals_reference(runs,
                                                                  wpd):
    assert runs["port", wpd][3] == runs["jax", wpd][3]
    assert runs["port", wpd][3]["guard"]["loss_trips"] == 0
    assert runs["full"][3] is None


# ------------------------------------------------------- the trim is real


def _count_net_draws(monkeypatch):
    """Count rng.uniform / uniform_at calls made from the netstack's
    modules (the apps' own draws are not trimmable)."""
    n = {"draws": 0}
    for name in ("uniform", "uniform_at"):
        orig = getattr(rng, name)

        def counted(*a, _orig=orig, **kw):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("shadow_tpu_torch.net."):
                n["draws"] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(rng, name, counted)
    return n


@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "serial"])
def test_no_netstack_draw_runs_in_a_trimmed_run(monkeypatch, bulk):
    """The loss trim leaves the reliability draw out of the serial NIC
    drain and the UDP bulk pass: through a whole run, not one call."""
    n = _count_net_draws(monkeypatch)
    for trimmed in (False, True):
        b = _specialized("port") if trimmed else _build("port")
        b.app_bulk = tphold.BULK if bulk else None
        n["draws"] = 0
        tckpt.run_windows(b, (tphold.handler,), device="cpu")
        if trimmed:
            assert n["draws"] == 0
        else:
            assert n["draws"] > 0


def test_timer_family_left_out_even_without_kinds(monkeypatch):
    """A dropped timers capability removes timers.handle_timer from the
    step function itself: with kinds=None (every family runs) the
    untrimmed step calls it and the trimmed one does not."""
    calls = {"n": 0}
    orig = ttimers.handle_timer

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ttimers, "handle_timer", counted)
    monkeypatch.setattr(tstep, "_PRE_APP", tuple(
        (counted if h is orig else h, k) for h, k in tstep._PRE_APP))
    b = _build("port")
    q, popped = pop_earliest(b.sim.events, b.cfg.end_time)
    sim = b.sim.replace(events=q)
    buf = EmitBuffer.create(b.cfg.num_hosts, b.cfg.emit_capacity,
                            nwords=q.words.shape[-1], device="cpu")
    caps = tspec.Capabilities(loss=False, timers=False)
    outs = []
    for c in (None, caps):
        calls["n"] = 0
        s, bf = tstep.make_step_fn(b.cfg, (tphold.handler,), caps=c)(
            sim, popped, buf, kinds=None)
        outs.append((calls["n"], convert.sim_to_numpy(s)))
    assert outs[0][0] == 1 and outs[1][0] == 0
    assert_leaves_equal(outs[0][1], outs[1][1])


# ------------------------------------------------------- program keys


def _key_for(pkg, b, caps):
    """The whole-run program key: each package's own rule
    (net/build.py _whole_run_key_fn) — the shape vector of the sim, the
    kind census, and the capability token only when something was
    dropped."""
    mod, handler = ((jbuild, jphold.handler) if pkg == "jax"
                    else (tbuild, tphold.handler))
    return mod._whole_run_key_fn(
        b, (handler,), end=b.cfg.end_time, path="whole",
        chunk_windows=0, adaptive=False, fault_fn=None, app_bulk=None,
        app_tcp_bulk=None, caps=caps)((b.sim,), {})


def _untrimmed_pair(pkg, mute):
    b = _build(pkg)
    b.sim = b.sim.replace(net=b.sim.net.replace(
        reliability=b.sim.net.reliability * 0.5))
    return b, PKG[pkg][2].apply(dataclasses.replace(b), (mute,))


def test_program_keys_relate_as_the_reference_s():
    rel = {}
    for pkg, mute in (("jax", _mute_jax), ("port", _mute_port)):
        full_b, spec_b = _build(pkg), _specialized(pkg)
        k_full = _key_for(pkg, full_b, None)
        k_spec = _key_for(pkg, spec_b, spec_b.caps)
        b, sb = _untrimmed_pair(pkg, mute)
        assert sb.caps.dropped() == () and sb.caps.key_extra() is None
        assert sb.sim.guard is None
        rel[pkg] = (k_full != k_spec,
                    _key_for(pkg, b, None) == _key_for(pkg, sb, sb.caps))
        if pkg == "port":
            assert buckets.is_program_key(k_full)
            assert buckets.is_program_key(k_spec)
    assert rel["port"] == rel["jax"] == (True, True)


def test_opaque_fault_fn_rejected_on_specialized_bundle():
    b = _specialized("port")
    for make in (lambda: tbuild.make_runner(
            b, (tphold.handler,), fault_fn=lambda s, w: s, device="cpu"),
            lambda: tbuild.make_chunked_runner(
                b, (tphold.handler,), fault_fn=lambda s, w: s,
                device="cpu"),
            lambda: tckpt.run_windows(b, (tphold.handler,),
                                      fault_fn=lambda s, w: s,
                                      device="cpu")):
        with pytest.raises(ValueError, match="opaque"):
            make()
    with pytest.raises(ValueError, match="opaque"):
        jbuild.make_runner(_specialized("jax"), (jphold.handler,),
                           fault_fn=lambda s, w: s)
    # an unspecialized bundle still takes one
    tbuild.make_runner(_build("port"), (tphold.handler,),
                       fault_fn=lambda s, w: s, device="cpu")


# ------------------------------------------------------------- guard


def _halve_table(pkg, sim):
    return sim.replace(net=sim.net.replace(
        reliability=sim.net.reliability * 0.5))


def _plant_timer(pkg, sim):
    q = sim.events
    assert int(np.asarray(q.time)[0, 0]) != simtime.INVALID
    if pkg == "jax":
        kind = q.kind.at[0, 0].set(int(EventKind.TIMER))
    else:
        kind = q.kind.clone()
        kind[0, 0] = int(EventKind.TIMER)
    return sim.replace(events=q.replace(kind=kind))


@pytest.mark.parametrize("tamper,watch", [(_halve_table, "loss"),
                                          (_plant_timer, "timer")],
                         ids=["lossy_table", "planted_timer"])
def test_guard_trips_fatal_like_the_reference(tamper, watch):
    """A trimmed program fed a sim whose table was made lossy under it
    (the snapshot-restore hazard), or whose queue holds a TIMER, latches
    the guard: a FATAL health fault, RunHealth equal to the
    reference's."""
    health = {}
    for pkg in ("jax", "port"):
        b = _specialized(pkg)
        tampered = tamper(pkg, b.sim)
        if pkg == "jax":
            sim, _, _ = jckpt.run_windows(b, (jphold.handler,),
                                          sim=tampered)
            health[pkg] = jfaults.gather(jax.device_get(sim))
        else:
            sim, _, _ = tckpt.run_windows(b, (tphold.handler,),
                                          sim=tampered, device="cpu")
            health[pkg] = thealth.gather(sim)
            assert tspec.guard_report(sim)[f"{watch}_trips"] > 0
    want, got = health["jax"], health["port"]
    assert got.guard_tripped and got.fatal
    assert getattr(got, f"guard_{watch}_trips") > 0
    assert any(sev == "fatal" and "specialization guard" in msg
               for sev, msg in got.diagnostics())
    assert got.diagnostics() == want.diagnostics()
    assert got.failure_report() == want.failure_report()
    assert got == thealth.RunHealth(**{f: getattr(want, f)
                                       for f in vars(want)})


# ----------------------------------------------------------- snapshots


def test_trimmed_snapshot_crosses_both_ways(runs):
    """A trimmed snapshot of either package loads into the other's
    trimmed bundle (the guard leaves find their slots, the watch flags
    come from the template) and resumes to the same final state."""
    jpath, jt = runs["jax", 1][2][0]
    tpath, tt = runs["port", 1][2][0]
    assert jt == tt == HALF
    # reference snapshot -> the port
    b = _specialized("port")
    sim, t, _ = tckpt.load(jpath, b.sim)
    assert sim.guard.watched() == ("loss", "timers")
    got = _run("port", b, sim=sim, start_time=t)[0]
    assert_leaves_equal(runs["port", 1][0], got)
    # port snapshot -> the reference
    jb = _specialized("jax")
    jsim, t, _ = jckpt.load(tpath, jb.sim)
    assert jsim.guard.watched() == ("loss", "timers")
    want = _run("jax", jb, sim=jsim, start_time=t)[0]
    assert_leaves_equal(runs["jax", 1][0], want)


# ----------------------------------------------------------- escalation


def test_escalation_regrow_stays_trimmed_and_equals_reference(tmp_path):
    """An undersized queue trips after the first snapshot; the heal
    rebuilds at the grown capacity, specializes again and transplants
    the snapshot (guard leaves included): the final state equals the
    reference's supervised run and, guard aside, a straight untrimmed
    run at the grown capacity."""
    results = {}
    for pkg in ("jax", "port"):
        mod, phold, spec, _, dev = PKG[pkg]
        caps = {"event_capacity": 4}

        def rebuild(overrides, pkg=pkg, caps=caps):
            caps.update(overrides)
            return _build(pkg, H=8, load=2, seed=7, in_ring=8, **caps)

        b = spec.apply(rebuild({}), (phold.handler,))
        faults = jfaults if pkg == "jax" else tfaults
        res = faults.run_supervised(
            b, (phold.handler,), checkpoint_path=str(tmp_path / pkg),
            checkpoint_every_windows=1, max_retries=0,
            escalation=faults.EscalationPolicy(), rebuild=rebuild, **dev)
        assert res.ok and res.retries_used == 0 and res.escalations
        assert res.resumed_from
        assert res.sim.guard is not None
        results[pkg] = (res, caps["event_capacity"])
    (jres, jcap), (tres, tcap) = results["jax"], results["port"]
    assert tcap == jcap > 4
    assert [e.as_dict() for e in tres.escalations] == \
        [e.as_dict() for e in jres.escalations]
    got = convert.sim_to_numpy(tres.sim)
    assert_leaves_equal(jax_leaves(jax.device_get(jres.sim)), got)
    assert int(got[".guard.loss_trips"]) == 0
    straight = _run("port", _build("port", H=8, load=2, seed=7,
                                   in_ring=8, event_capacity=tcap))[0]
    assert_leaves_equal(straight, _unguarded(got))
