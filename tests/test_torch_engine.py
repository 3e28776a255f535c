"""Parity of the port's engine loop (shadow_tpu_torch/core/engine.py,
net/step.py, net/build.py) with the reference at 16 hosts, and the
port's refusal of settings it does not implement.

The 16-host run uses two PHOLD replicas of 8 hosts (peer draws stay in
the replica, so the peer base is non-zero for half the lanes), a
different seed and load from tests/test_torch_phold.py, staggered
process starts, two hosts whose process stops mid-run (their sockets
keep receiving unread datagrams), and a second app handler that sends
one datagram to the host's own address at process start (loopback
delivery as a PACKET_LOCAL event, and two packets in one NIC drain).
One reference runner is compiled for the file. Tolerance: zero
(integer state, bit-exact f32 draws).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import shadow_tpu.core.events as jev
import shadow_tpu.net.nic as jnic
import shadow_tpu.net.state as jstate
import shadow_tpu.net.udp as judp
import shadow_tpu_torch.core.events as tev
import shadow_tpu_torch.net.nic as tnic
import shadow_tpu_torch.net.state as tstate
import shadow_tpu_torch.net.udp as tudp
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.state import QDisc, RouterQ
from shadow_tpu_torch.net.step import make_step_fn

torch.set_num_threads(1)

ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">10240</data><data key="dn">10240</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H, LOAD, SEED, REPLICA = 16, 2, 11, 8
KW = dict(num_hosts=H, tcp=False, seed=SEED, end_time=simtime.ONE_SECOND,
          event_capacity=16, outbox_capacity=16)


STOPPED = (5, 12)


def _hosts(mod):
    return [mod.HostSpec(name=f"h{i}", proc_start_time=1000 * i,
                         proc_stop_time=450_000_000 if i in STOPPED else None)
            for i in range(H)]


def _loopback_app(events, state, udp, nic):
    """At process start, send one 32-byte datagram to the host's own
    address (written once, run against either package's modules)."""
    def handler(cfg, sim, popped, buf):
        start = popped.valid & (popped.kind == events.EventKind.PROC_START)
        me = state.ip_of_hosts(cfg, sim.net, sim.net.lane_id)
        net, ok = udp.udp_enqueue_send(sim.net, start, sim.app.sock, me,
                                       sim.app.port, 32, -1)
        return nic.notify_wants_send(sim.replace(net=net), buf, ok,
                                     popped.time)
    return handler


JAX_APPS = (jphold.handler, _loopback_app(jev, jstate, judp, jnic))
PORT_APPS = (tphold.handler, _loopback_app(tev, tstate, tudp, tnic))


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _port_bundle():
    b = tbuild.build(TConfig(**KW), ONE_VERTEX, _hosts(tbuild), device="cpu")
    b.sim = tphold.setup(b.sim, load=LOAD, replica_size=REPLICA)
    return b


@pytest.fixture(scope="module")
def runs():
    jb = jbuild.build(JConfig(**KW), ONE_VERTEX, _hosts(jbuild))
    jb.sim = jphold.setup(jb.sim, load=LOAD, replica_size=REPLICA)
    jsim, jstats = jbuild.make_runner(jb, app_handlers=JAX_APPS)(jb.sim)
    tb = _port_bundle()
    tsim, tstats = tbuild.run(tb, app_handlers=PORT_APPS, device="cpu")
    return jstats.as_dict(), _jax_leaves(jsim), tb, tstats.as_dict(), tsim


def test_replica_run_takes_the_stop_and_loopback_branches(runs):
    tsim = runs[4]
    net, app = tsim.net, tsim.app
    assert net.proc_stopped.nonzero().flatten().tolist() == list(STOPPED)
    # stopped hosts still receive but their app never reads
    assert int(net.in_count[list(STOPPED)].sum(dim=1).min()) > 0
    # every host's loopback datagram left through the NIC besides the
    # PHOLD sends
    assert int(net.ctr_tx_packets.sum()) == int(app.sent.sum()) + H


def test_replica_run_stats_match_reference(runs):
    jstats, _, _, tstats, _ = runs
    assert tstats == jstats


def test_replica_run_every_leaf_matches_reference(runs):
    _, want, _, _, tsim = runs
    got = convert.sim_to_numpy(tsim)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_window_by_window_equals_whole_run(runs):
    """Driving step_window by hand (the reference's window rule) lands
    on the whole-run result."""
    _, _, tb, tstats, tsim = runs
    step = make_step_fn(tb.cfg, PORT_APPS)
    sim, stats = tb.sim, tengine.EngineStats.create()
    end = tb.cfg.end_time
    wstart = int(sim.events.min_time().amin())
    while wstart <= end:
        wend = min(wstart + tb.min_jump, end + 1)
        sim, stats, wstart = tengine.step_window(
            sim, stats, step, wend, tb.cfg.emit_capacity, sim.net.lane_id)
    assert stats.as_dict() == tstats
    got, want = convert.sim_to_numpy(sim), convert.sim_to_numpy(tsim)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


UNSUPPORTED = {
    "tcp": dict(tcp=True),
    "pcap": dict(pcap=True),
    "track_paths": dict(track_paths=True),
    "cpu_model": dict(cpu_threshold_ns=0),
    "sparse_lanes": dict(num_hosts=H, sparse_lanes=4),
    "inject": dict(inject_lanes=8),
    "rr_qdisc": dict(qdisc=QDisc.RR),
    "router_static": dict(router_qdisc=RouterQ.STATIC),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_settings_off_the_path_raise(name):
    cfg = TConfig(**{**KW, **UNSUPPORTED[name]})
    with pytest.raises(NotImplementedError):
        tbuild.build(cfg, ONE_VERTEX, _hosts(tbuild), device="cpu")


def test_default_sparse_budget_at_scale_must_be_disabled():
    cfg = TConfig(num_hosts=300, tcp=False)
    assert tengine.resolve_sparse_lanes(cfg) == 256
    with pytest.raises(NotImplementedError):
        tbuild.check_supported(cfg)
    tbuild.check_supported(dataclasses.replace(cfg, sparse_lanes=0))


def test_runner_rejects_a_bundle_from_another_device():
    b = _port_bundle()
    b.device = torch.device("cuda", 1)
    with pytest.raises(ValueError):
        tbuild.make_runner(b, app_handlers=(tphold.handler,), device="cpu")
