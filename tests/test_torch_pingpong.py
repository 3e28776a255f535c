"""Parity of the port's UDP ping/echo app (shadow_tpu_torch.apps.pingpong)
with the reference's, run through each package's net.build.run on the
CPU at three shapes:

- tests/test_udp_ping.py's 2 hosts on its two-vertex graph, 10 pings;
- __graft_entry__'s 8 hosts over TCP (the flagship entry), 3 pings;
- bench.py's pingpong at 64 hosts: 20 pings, 5 sim-s, UDP.

Each compares the boot state, EngineStats and every final leaf by flax
field path (convert.sim_to_numpy), tolerance zero (the state is
integer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from shadow_tpu.apps import pingpong as jping
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import pingpong as tping
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from test_udp_ping import PORT as PING_PORT
from test_udp_ping import TWO_VERTEX

torch.set_num_threads(1)


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _two_vertex(pkg):
    """tests/test_udp_ping.py's _build in either package (count 10)."""
    if pkg == "jax":
        build, HostSpec, Cfg, app, kw = (jbuild.build, jbuild.HostSpec,
                                         JConfig, jping, {})
    else:
        build, HostSpec, Cfg, app, kw = (tbuild.build, tbuild.HostSpec,
                                         TConfig, tping, {"device": "cpu"})
    cfg = Cfg(num_hosts=2, end_time=10 * simtime.ONE_SECOND, seed=1,
              tcp=False)
    hosts = [HostSpec(name="client", type="client",
                      proc_start_time=simtime.ONE_SECOND),
             HostSpec(name="server", type="server")]
    b = build(cfg, TWO_VERTEX, hosts, **kw)
    lanes = np.arange(2)
    client, server = (lanes == b.host_of("client"),
                      lanes == b.host_of("server"))
    if pkg == "jax":
        client, server = jnp.asarray(client), jnp.asarray(server)
    b.sim = app.setup(b.sim, client_mask=client, server_mask=server,
                      server_ip=b.ip_of("server"), server_port=PING_PORT,
                      count=10, size=64)
    return b


SHAPES = {
    "two_vertex": dict(jax=lambda: _two_vertex("jax"),
                       port=lambda: _two_vertex("port")),
    "graft_tcp": dict(
        jax=lambda: graft._build(num_hosts=8),
        port=lambda: tping.build_bench(8, device="cpu")),
    "bench_64": dict(
        jax=lambda: graft._build(num_hosts=64, end_time_s=5, count=20,
                                 tcp=False),
        port=lambda: tping.build_bench(64, end_time_s=5, count=20,
                                       tcp=False, device="cpu")),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, make in SHAPES.items():
        jb, tb = make["jax"](), make["port"]()
        boot = _jax_leaves(jb.sim)
        jsim, jstats = jbuild.run(jb, app_handlers=(jping.handler,))
        tsim, tstats = tbuild.run(tb, app_handlers=(tping.handler,),
                                  device="cpu")
        out[name] = {"boot": boot, "port_boot": convert.sim_to_numpy(tb.sim),
                     "jax_stats": jstats.as_dict(),
                     "jax_final": _jax_leaves(jsim),
                     "port_stats": tstats.as_dict(), "port_sim": tsim,
                     "min_jump": (jb.min_jump, tb.min_jump)}
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_boot_state_matches_reference(runs, name):
    r = runs[name]
    assert r["min_jump"][0] == r["min_jump"][1]
    _assert_leaves_equal(r["boot"], r["port_boot"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_run_stats_match_reference(runs, name):
    r = runs[name]
    assert r["port_stats"] == r["jax_stats"]
    assert r["port_stats"]["events_processed"] > 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_run_every_leaf_matches_reference(runs, name):
    r = runs[name]
    _assert_leaves_equal(r["jax_final"], convert.sim_to_numpy(r["port_sim"]))


def test_two_vertex_round_trips():
    """test_udp_ping's checks, on the port: 10 pings, 10 echoes, RTT =
    2 x the 25 ms west-east edge, no drops."""
    b = _two_vertex("port")
    assert b.min_jump == 25 * simtime.ONE_MILLISECOND
    sim, _ = tbuild.run(b, app_handlers=(tping.handler,), device="cpu")
    ci, si = b.host_of("client"), b.host_of("server")
    app = sim.app
    assert int(app.sent[ci]) == 10 and int(app.rcvd[si]) == 10
    assert int(app.rcvd[ci]) == 10
    assert int(app.rtt_sum[ci]) == 10 * 50 * simtime.ONE_MILLISECOND
    assert int(sim.net.ctr_tx_packets.sum()) == 20
    assert int(sim.net.ctr_tx_bytes.sum()) == 20 * (64 + 42)
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0


@pytest.mark.parametrize("name,count", [("graft_tcp", 3), ("bench_64", 20)])
def test_every_pair_completes(runs, name, count):
    """Every client and every server at `count` received, and every
    client's RTT sum equal (the pairs are independent and identical)."""
    app = runs[name]["port_sim"].app
    H = app.role.shape[0]
    assert (app.rcvd == count).all(), app.rcvd.tolist()
    rtt = app.rtt_sum[: H // 2]
    assert (rtt == rtt[0]).all() and int(rtt[0]) > 0
