"""Parity of the port's per-path packet counters (net/nic.py, the
track_paths scatter-add; ref: topology.c:2053-2063) and per-host
executed-event accounting (net/step.py ctr_events_exec; ref:
host.c:314-317) with the reference's, on tests/test_tracing.py's shape:
8 PHOLD hosts at load 2 on a two-vertex graph, 1 sim-s.

One reference program is compiled (track_paths on); its path matrix,
EngineStats and every leaf are the port's. With track_paths off the
matrix is the reference's [1, 1] zero, and the serial and bulk runs
execute the same events per host as the reference's run. With the
capture ring, the paths and the CPU gate on, the sparse fast path's
compaction leaves every leaf as the full-width run does.
Tolerance: zero.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import phold as jphold
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.compile import specialize
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from test_tracing import TWO_VERTEX

torch.set_num_threads(1)


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _build(pkg, H, load, track_paths):
    """tests/test_tracing.py's _build, in either package."""
    from shadow_tpu.core import simtime

    mod, Cfg, app, kw = ((jbuild, JConfig, jphold, {}) if pkg == "jax"
                         else (tbuild, TConfig, tphold, {"device": "cpu"}))
    cfg = Cfg(num_hosts=H, tcp=False, end_time=simtime.ONE_SECOND, seed=3,
              event_capacity=32, outbox_capacity=32, router_ring=32,
              track_paths=track_paths)
    hosts = [mod.HostSpec(name=f"p{i}", proc_start_time=0) for i in range(H)]
    b = mod.build(cfg, TWO_VERTEX, hosts, **kw)
    b.sim = app.setup(b.sim, load=load)
    return b


def _port_run(b, **kw):
    return tbuild.make_runner(b, app_handlers=(tphold.handler,),
                              device="cpu", **kw)(b.sim)


@pytest.fixture(scope="module")
def runs():
    jb = _build("jax", 8, 2, True)
    jsim, jstats = jbuild.make_runner(jb, app_handlers=(jphold.handler,))(
        jb.sim)
    tsim, tstats = _port_run(_build("port", 8, 2, True))
    return (jstats.as_dict(), _jax_leaves(jsim), tstats.as_dict(),
            convert.sim_to_numpy(tsim))


def test_path_counters_match_reference(runs):
    jstats, jleaves, tstats, tleaves = runs
    assert tstats == jstats
    assert sorted(tleaves) == sorted(jleaves)
    for k in jleaves:
        assert tleaves[k].dtype == jleaves[k].dtype, k
        np.testing.assert_array_equal(tleaves[k], jleaves[k], err_msg=k)


def test_path_counters_cover_every_remote_send(runs):
    """The reference test's checks on the port's matrix."""
    mat = runs[3][".net.ctr_path_packets"]
    assert mat.shape == (2, 2)
    assert mat.sum() == runs[3][".net.ctr_tx_packets"].sum() > 0
    assert mat[0, 1] + mat[1, 0] > 0


def test_path_counters_off_by_default():
    jb, tb = _build("jax", 4, 2, False), _build("port", 4, 2, False)
    want = np.asarray(jb.sim.net.ctr_path_packets)
    sim, _ = _port_run(tb)
    mat = sim.net.ctr_path_packets.numpy()
    assert mat.shape == want.shape == (1, 1) and mat.sum() == 0


def test_events_exec_matches_engine_total_serial_and_bulk(runs):
    """The serial and bulk runs (paths off; the counters do not change
    what executes) execute the reference's events on every host."""
    want = runs[1][".net.ctr_events_exec"]
    for bulk in (None, tphold.BULK):
        sim, stats = _port_run(_build("port", 8, 2, False), app_bulk=bulk)
        got = sim.net.ctr_events_exec.numpy()
        np.testing.assert_array_equal(got, want)
        assert int(got.sum()) == int(stats.events_processed)


def test_trimmed_program_counts_the_same_paths(runs):
    """The CLI's default trim (loss dropped on this lossless graph)
    leaves the path matrix and every other leaf as they were."""
    tb = specialize.apply(_build("port", 8, 2, True), (tphold.handler,),
                          mode="auto")
    assert "loss" in tb.caps.dropped()
    sim, stats = _port_run(tb)
    assert stats.as_dict() == runs[2]
    got = convert.sim_to_numpy(sim)
    for k, v in runs[3].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sparse_fast_path_keeps_the_observed_leaves():
    """Compaction (core/compact.py) gathers the capture ring, the CPU
    planes and the counters of the active rows and keeps the [V, V]
    path matrix whole: with 4 of 64 hosts active, the sparse run equals
    the full-width one in every leaf (EngineStats apart from hit/miss)."""
    from shadow_tpu.core import simtime

    runs = []
    for S in (16, 0):
        cfg = TConfig(num_hosts=64, tcp=False, seed=5, sparse_lanes=S,
                      end_time=simtime.ONE_SECOND // 2, event_capacity=16,
                      outbox_capacity=16, pcap=True, pcap_ring=8,
                      track_paths=True, cpu_threshold_ns=0,
                      cpu_precision_ns=10_000)
        hosts = [tbuild.HostSpec(name=f"p{i}", proc_start_time=0)
                 for i in range(64)]
        b = tbuild.build(cfg, TWO_VERTEX, hosts, device="cpu")
        b.sim = tphold.setup(b.sim, load=2, active_hosts=4)
        sim, stats = _port_run(b)
        runs.append((stats.as_dict(), convert.sim_to_numpy(sim)))
    (st16, got), (st0, want) = runs
    assert st16["fastpath_hit"] > 0 and st0["fastpath_hit"] == 0
    for k in ("events_processed", "micro_steps", "windows"):
        assert st16[k] == st0[k], k
    assert want[".net.ctr_path_packets"].sum() > 0
    assert want[".net.cap_count"].sum() > 0
    assert want[".net.ctr_cpu_blocked"].sum() > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

